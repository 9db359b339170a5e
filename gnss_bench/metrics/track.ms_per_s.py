"""Host milliseconds of tracking per second of signal: the tracker's
calls, graph replays and output packing (``receiver.track``), from the
program's stage timers, over the window's untraced captures."""


def read(ctx):
    if ctx["signal_s"] <= 0:
        return None
    return 1e3 * ctx["stages"]["receiver.track"] / ctx["signal_s"]
