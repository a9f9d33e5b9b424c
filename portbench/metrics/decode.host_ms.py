"""decode.host_ms: the host's mean time (ms) in one ``model.decode_step``
span of the engine, over the window's unprofiled batches: the sum of
``last_stats["decode_host_s"]`` over the sum of ``decode_steps``.  The
span covers the Python of one step and the launches it enqueues, not the
device's work (the engine does not wait for the step).  None where the
engine keeps no such span."""


def read(ctx):
    stats = [b["stats"] for b in ctx.batches]
    if not stats or any("decode_host_s" not in s for s in stats):
        return None
    steps = sum(s["decode_steps"] for s in stats)
    if steps <= 0:
        return None
    return 1e3 * sum(s["decode_host_s"] for s in stats) / steps
