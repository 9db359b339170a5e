"""Search runs per traced capture: the program's ``acquire.searches``
count (cold, weak escalation, directed fallback and re-acquisition; not
the prewarm's zero-head search)."""

from gnss_bench import spans

read = spans.per_capture(
    lambda sp, counts, caps: spans.counted(counts, "acquire.searches", caps))
