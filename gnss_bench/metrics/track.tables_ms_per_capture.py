"""Host milliseconds a traced capture spends building and uploading the
tracker's code spectra for a new channel-to-PRN map: the self time of the
program's ``track.tables`` spans."""

from gnss_bench import spans

read = spans.per_capture(
    lambda sp, counts, caps: 1e3 * spans.self_s(sp, {"track.tables"}, caps))
