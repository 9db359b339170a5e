"""Host milliseconds of a warm start's own work per capture: the previous
session's checkpoint loaded (``utils.checkpoint.load_state``) and the
visible PRNs predicted from its almanac (``nav.almanac.visible_prns``),
on the harness's clock around the two calls, over the window's untraced
captures.  A cold start does neither: nothing to read."""


def read(ctx):
    s = ctx["stages"].get("gnss_bench.warm_start", 0.0)
    if ctx["n_captures"] <= 0 or s <= 0.0:
        return None
    return 1e3 * s / ctx["n_captures"]
