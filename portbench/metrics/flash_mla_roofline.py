"""flash_mla_roofline: the MLA flash instance's share (%) of its roofline in
the profiled batches.  The least time of a prefill's MLA attention calls
(one a layer, at the batch's padded shape) is the larger of their
operations over the TF32 peak and their q, k, v and output bytes over the
HBM peak (``work_mla.flash_mla_call``); it is divided by the device time
of the kernels named ``flash_mla`` in those batches."""
from portbench import work_mla

KERNEL = "flash_mla"


def read(ctx):
    if ctx.trace is None:
        return None
    w, pc = ctx.work, ctx.pc
    least = took = 0.0
    for b in ctx.trace.batches:
        ks = [k for k in ctx.trace.kernels_in(b["start"], b["end"])
              if KERNEL in k.name]
        if not ks:
            continue
        took += sum(k.end - k.start for k in ks) / 1e9
        f, n = work_mla.flash_mla_call(b["B"], b["S"], pc)
        least += pc["num_layers"] * w.least_seconds(f, n)
    return 100.0 * least / took if took > 0 else None
