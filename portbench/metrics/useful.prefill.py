"""useful.prefill: the share (%) of the prefilled token positions that are
prompt tokens, over the window's batches: the engine's
``last_stats["prompt_tokens"]`` (unpadded prompt lengths, summed) over
``last_stats["prefill_tokens"]`` (B x the padded length S).  The rest is
left padding to the batch's longest prompt.  None where the engine keeps
no such counters."""


def read(ctx):
    stats = [b["stats"] for b in ctx.batches]
    if not stats or any("prefill_tokens" not in s for s in stats):
        return None
    done = sum(s["prefill_tokens"] for s in stats)
    if done <= 0:
        return None
    return 100.0 * sum(s["prompt_tokens"] for s in stats) / done
