"""decode_attn_roofline: the decode-attention kernel's share (%) of its
roofline in the profiled decode phases.  The least time of a batch's
decode attention (one call a self-attention layer and step, at the step's
own position) is the larger of its operations at the float32 CUDA-core
peak and its q, K and V rows up to the position and output bytes at the
HBM peak (``work_decode``); it is divided by the device time of the
kernels named ``decode_attention`` (the split kernel and the combine)
that run in those phases.  A program without the kernel reads nothing."""
from portbench import work_decode

KERNEL = "decode_attention"


def read(ctx):
    if ctx.trace is None:
        return None
    least = took = 0.0
    for b in ctx.trace.batches:
        if b["decode"] is None:
            continue
        ks = [k for k in ctx.trace.kernels_in(*b["decode"])
              if KERNEL in k.name]
        if not ks:
            continue
        took += sum(k.end - k.start for k in ks) / 1e9
        least += work_decode.decode_attention_seconds(
            ctx.pc, b["B"], b["S"], b["stats"]["decode_steps"])
    return 100.0 * least / took if took > 0 else None
