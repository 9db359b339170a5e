"""Host milliseconds of acquisition per capture: the cold search and the
re-acquisition searches (``receiver.acquire``, on the caller's and the
search threads), from the program's stage timers, over the window's
untraced captures."""


def read(ctx):
    if ctx["n_captures"] <= 0:
        return None
    return 1e3 * ctx["stages"]["receiver.acquire"] / ctx["n_captures"]
