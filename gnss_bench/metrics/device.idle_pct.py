"""The device's idle share of the traced captures: 100 less the union of
kernel, copy and set intervals over the traced block's host wall."""


def read(ctx):
    t = ctx["trace"]
    if t is None or t["window_s"] <= 0 or not t["kernels"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
