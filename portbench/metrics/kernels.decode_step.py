"""kernels.decode_step: device operations (kernels, copies, sets) a decode
step launches: those whose start lies in the profiled decode phases (the
first ``decode_step`` to the return of ``serve``, the engine's sampling
included), over those batches' ``decode_steps``."""
import bisect


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    starts = [k.start for k in t.kernels]
    ops = steps = 0
    for b in t.batches:
        if b["decode"] is None or b["stats"]["decode_steps"] <= 0:
            continue
        lo, hi = b["decode"]
        ops += bisect.bisect_right(starts, hi) - bisect.bisect_left(starts,
                                                                    lo)
        steps += b["stats"]["decode_steps"]
    if steps == 0 or ops == 0:
        return None
    return ops / steps
