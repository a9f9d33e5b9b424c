"""mbu.decode: the bytes the window's decode steps must read over the
steps' time, as a share (%) of the HBM peak.  Bytes, each once: every weight
but the embedding (all experts), the embedding rows taken, the key/value
cache up to the step's position, and a hybrid's SSM and conv states
(``work.decode_bytes``).  Time: ``last_stats["decode_s"]`` of every window
batch, over its ``decode_steps``."""
import math


def read(ctx):
    w = ctx.work
    weight_bytes = sum(w.F32 * math.prod(shape) for name, shape, _ in
                       ctx.weight_spec if name != "embed")
    row = w.F32 * ctx.pc["d_model"]
    nbytes = secs = steps = 0
    for b in ctx.batches:
        st = b["stats"]
        nbytes += w.decode_bytes(ctx.pc, weight_bytes, row, b["B"], b["S"],
                                 st["decode_steps"])
        secs += st["decode_s"]
        steps += st["decode_steps"]
    if steps == 0 or secs <= 0:
        return None
    return 100.0 * nbytes / secs / w.PEAK_HBM_BYTES
