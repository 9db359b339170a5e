"""The cold and re-acquisition searches' share of their roofline: the
FFT-minimal bound of one search (``roofline/search.py``) times the
searches in the traced captures, over the device time of the search
kernels there (``fold_corr_reduce``'s two launches a search)."""

from gnss_bench import roofline, trace
from gnss_bench.roofline import search

KERNELS = ("fcr_forward", "fcr_reduce")


def read(ctx):
    t = ctx["trace"]
    if t is None:
        return None
    calls, secs = trace.kernel_stats(t, KERNELS)
    b = roofline.bound_s(*search.work(ctx["cfg"]), ctx["kind"])
    if calls == 0 or secs <= 0 or b is None:
        return None
    return 100.0 * b * calls / secs
