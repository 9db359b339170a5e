"""Search-table builds per traced capture: the program's
``acquire.table_builds`` count (the replica spectra or kernel code planes
built for a key the process had not built, the prewarm's included).  A
program that does not count them gives no number."""

from gnss_bench import counters, spans

NAME = "acquire.table_builds"
_read = spans.per_capture(
    lambda sp, counts, caps: spans.counted(counts, NAME, caps))


def read(ctx):
    return _read(ctx) if counters.registered(NAME) else None
