"""Host milliseconds of acquisition per traced capture: the self time of
the program's ``receiver.acquire`` spans (the cold and re-acquisition
searches, on the caller's and the search threads) and of the
``acquire.head``, ``acquire.search`` and ``acquire.seed`` spans under
them, which leaves out the wait for the search's result
(``acquire.fetch``)."""

from gnss_bench import spans

NAMES = {"receiver.acquire", "acquire.head", "acquire.search",
         "acquire.seed"}


def _host_ms(sp, counts, caps):
    return 1e3 * spans.self_s(sp, NAMES, caps, under="receiver.acquire")


read = spans.per_capture(_host_ms)
