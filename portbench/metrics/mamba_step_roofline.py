"""mamba_step_roofline: the Mamba-2 step kernel's share (%) of its
roofline in the profiled decode phases.  The least time of a batch's
Mamba steps (one call a Mamba layer and decode step) is the larger of its
operations at the float32 CUDA-core peak and its bytes (the state read
and written once, the conv windows, the step's inputs and output, the
parameters) at the HBM peak (``work_mamba_step``); it is divided by the
device time of the kernels named ``mamba_step`` (B‖C's conv step and the
state kernel) that run in those phases.  A program without the kernel
reads nothing."""
from portbench import work_mamba_step

KERNEL = "mamba_step"


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
        least += work_mamba_step.mamba_step_seconds(
            ctx.pc, b["B"], b["stats"]["decode_steps"])
    return 100.0 * least / took if took > 0 else None
