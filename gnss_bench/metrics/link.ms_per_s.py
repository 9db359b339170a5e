"""Host milliseconds of the link per second of signal: the capture read
(``receiver.read``) and the upload with its device-side conversion
enqueued (``receiver.transfer``), from the program's stage timers, over
the window's untraced captures."""


def read(ctx):
    s = ctx["stages"]
    if ctx["signal_s"] <= 0:
        return None
    return 1e3 * (s["receiver.read"] + s["receiver.transfer"]) \
        / ctx["signal_s"]
