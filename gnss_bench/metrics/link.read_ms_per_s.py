"""Host milliseconds of the capture read per second of signal: the self
time of the program's ``io.read`` spans (the prefetch thread's steps of
the source's reader, which read the file) in the traced captures, over
their seconds of signal (each capture of a cell has one length: the
untraced captures' seconds per capture)."""

from gnss_bench import spans

_ms_per_capture = spans.per_capture(
    lambda sp, counts, caps: 1e3 * spans.self_s(sp, {"io.read"}, caps))


def read(ctx):
    ms = _ms_per_capture(ctx)
    if ms is None or ctx["n_captures"] <= 0:
        return None
    return ms * ctx["n_captures"] / ctx["signal_s"]
