"""The tracking bank's share of its roofline: the time-domain bound of
one step (``roofline/track.py``) times the steps in the traced captures
(one ``track_corr`` launch a step), over the device time of the step's
two kernels there (``track_corr`` and ``loop_update``)."""

from gnss_bench import roofline, trace
from gnss_bench.roofline import track

KERNELS = ("track_corr_kernel", "loop_update_kernel")


def read(ctx):
    t = ctx["trace"]
    if t is None:
        return None
    calls, secs = trace.kernel_stats(t, KERNELS)
    b = roofline.bound_s(*track.work(ctx["cfg"], ctx["loop"]), ctx["kind"])
    if calls == 0 or secs <= 0 or b is None:
        return None
    return 100.0 * b * calls / secs
