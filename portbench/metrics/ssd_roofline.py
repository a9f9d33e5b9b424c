"""ssd_roofline: the SSD scan kernels' share (%) of their roofline in the
profiled batches.  The least time of a prefill's scans (one a Mamba-2
block, chunked at the configuration's chunk, at the batch's padded shape)
is the larger of the chunked algorithm's operations over the TF32 peak and
its input and output bytes over the HBM peak (``work.ssd_call``); it is
divided by the device time of the kernels named ``ssd_scan`` in those
batches."""

KERNEL = "ssd_scan"


def read(ctx):
    if ctx.trace is None or ctx.work.mamba_layers(ctx.pc) == 0:
        return None
    w, pc = ctx.work, ctx.pc
    d_inner, nh, N = w.ssm_dims(pc)
    least = took = 0.0
    for b in ctx.trace.batches:
        ks = [k for k in ctx.trace.kernels_in(b["start"], b["end"])
              if KERNEL in k.name]
        if not ks:
            continue
        took += sum(k.end - k.start for k in ks) / 1e9
        f, n = w.ssd_call(b["B"], b["S"], nh, d_inner // nh, N,
                          pc["ssm"]["chunk"])
        least += w.mamba_layers(pc) * w.least_seconds(f, n)
    return 100.0 * least / took if took > 0 else None
