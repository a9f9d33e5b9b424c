"""useful.decode: the share (%) of the decoded rows that a request asked
for, over the window's batches: the engine's
``last_stats["requested_tokens"]`` (the requests' ``max_new_tokens``,
summed) over ``last_stats["decoded_tokens"]`` (B x the longest: every row
decodes until the longest request is done).  None where the engine keeps
no such counters."""


def read(ctx):
    stats = [b["stats"] for b in ctx.batches]
    if not stats or any("decoded_tokens" not in s for s in stats):
        return None
    done = sum(s["decoded_tokens"] for s in stats)
    if done <= 0:
        return None
    return 100.0 * sum(s["requested_tokens"] for s in stats) / done
