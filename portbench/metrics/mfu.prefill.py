"""mfu.prefill: the model's operations in the window's prefills over the
prefills' time, as a share (%) of the TF32 peak.  Operations: 2 per active
non-embedding weight and unpadded prompt token, causal attention over the
unpadded positions, the last token's unembedding (``work.prefill_flops``).
Time: ``ServeEngine.last_stats["prefill_s"]`` of every window batch."""


def read(ctx):
    w = ctx.work
    flops = sum(w.prefill_flops(ctx.pc, b["prompt_lens"]) for b in ctx.batches)
    secs = sum(b["stats"]["prefill_s"] for b in ctx.batches)
    if secs <= 0 or flops <= 0:
        return None
    return 100.0 * flops / secs / w.PEAK_TF32_FLOPS
