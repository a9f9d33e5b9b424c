"""idle.decode.engine: of the device's idle time in the profiled decode
phases (the first ``decode_step`` to the return of ``serve``; union of
kernels, copies and sets), the share (%) that lies outside every
``model.decode_step`` range the engine opens under the profiler: time the
device waited on the engine's own loop (sampling, readback) and not on
the model's step.  Each gap is split by containment in the ranges
(``portbench/spans.py``).  None where the trace holds no such range."""


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    from portbench import spans
    from portbench import trace as tl
    merged = tl.union(t.kernels)
    idle = outside = 0
    for b in t.batches:
        if b["decode"] is None:
            continue
        lo, hi = b["decode"]
        steps = spans.named(t.host, "model.decode_step", lo, hi)
        if not steps:
            return None
        gaps = tl.gaps(merged, lo, hi)
        gap_ns = sum(e - s for s, e in gaps)
        idle += gap_ns
        outside += gap_ns - spans.covered_ns(gaps, steps)
    if idle <= 0:
        return None
    return 100.0 * outside / idle
