"""idle.decode: the share (%) of a batch's decode phase in which no
operation ran on the device.  The busy time is read from the profiled
batches, from the start of each one's first ``decode_step`` (the
benchmark's profiler range around the model's call) to the return of
``serve``.  The wall time is that of the window's own decode phases
(``last_stats["decode_s"]``), which ran unprofiled: every batch of a cell
has the same shapes and steps, and the profiler's host cost, which
stretches a profiled decode phase to about twice its length, would
otherwise read as idle time."""


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    from portbench import trace as tl
    merged = tl.union(t.kernels)
    phases = [b["decode"] for b in t.batches if b["decode"] is not None]
    walls = [b["stats"]["decode_s"] for b in ctx.batches
             if b["stats"]["decode_steps"] > 0]
    if not phases or not walls:
        return None
    busy = sum(tl.busy_ns(merged, lo, hi) for lo, hi in phases) / len(phases)
    wall = 1e9 * sum(walls) / len(walls)
    if busy <= 0 or wall <= 0:
        return None
    return 100.0 * (1.0 - busy / wall)
