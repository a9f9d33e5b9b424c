"""graph.decode: the share (%) of the window's decode steps that a replay
of the step's CUDA graph served: the engine's ``last_stats["graph_steps"]``
over its ``decode_steps``, summed over the window's batches.  None where
the engine keeps no such counter."""


def read(ctx):
    stats = [b["stats"] for b in ctx.batches]
    if not stats or any("graph_steps" not in s for s in stats):
        return None
    steps = sum(s["decode_steps"] for s in stats)
    if steps <= 0:
        return None
    return 100.0 * sum(s["graph_steps"] for s in stats) / steps
