"""Host milliseconds of the fetch, the drain, NAV decoding and the PVT
solves per second of signal (``receiver.fetch``, ``.drain``, ``.nav``,
``.solve``), from the program's stage timers, over the window's
untraced captures."""

STAGES = ("receiver.fetch", "receiver.drain", "receiver.nav",
          "receiver.solve")


def read(ctx):
    if ctx["signal_s"] <= 0:
        return None
    return 1e3 * sum(ctx["stages"][k] for k in STAGES) / ctx["signal_s"]
