"""mfu.prefill.mla: DeepSeek-V2's prefill operations in the window over the
prefills' time, as a share (%) of the TF32 peak.  Operations
(``work_mla.prefill_flops``): MLA's projections and causal attention, the
dense FFN, the router and the shared experts over the unpadded prompt
tokens; the routed experts of the kept choices
(``ServeEngine.last_stats["moe_kept_choices"]``, times the unpadded
share of the prefill's tokens); the last token's unembedding.  Time:
``last_stats["prefill_s"]`` of every window batch.  Nothing to read (no
kept-choice counter) gives no value."""
from portbench import work_mla


def read(ctx):
    flops = secs = 0.0
    for b in ctx.batches:
        st = b["stats"]
        if "moe_kept_choices" not in st:
            return None
        unpadded = st["prompt_tokens"] / st["prefill_tokens"]
        flops += work_mla.prefill_flops(ctx.pc, b["prompt_lens"],
                                        st["moe_kept_choices"] * unpadded)
        secs += st["prefill_s"]
    if secs <= 0 or flops <= 0:
        return None
    return 100.0 * flops / secs / ctx.work.PEAK_TF32_FLOPS
