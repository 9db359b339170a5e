"""Tracker chunks that missed a CUDA graph per traced capture: the
program's ``track.graph_misses`` count (a chunk run eagerly or captured,
and a prewarm's capture)."""

from gnss_bench import spans

read = spans.per_capture(
    lambda sp, counts, caps: spans.counted(counts, "track.graph_misses",
                                           caps))
