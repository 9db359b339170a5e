"""The control at a test size: the reference in the program's place in
bfloat16 (a bfloat16 four-step correlator, the loop state held in
bfloat16) comes out as not correct, where the program does not."""

from __future__ import annotations

import pytest

from conftest import tiny_cell

TRACKING = ("prompt_gap", "carrier_gap_hz", "code_rate_gap",
            "code_nco_gap")


@pytest.mark.parametrize("fmt", ["1bit", "iq8"])
def test_bf16_control_fails_where_the_program_passes(cpu_run, fmt):
    out = cpu_run(fmt, controls=("bf16",))
    assert out["correct"], (out["bad"], out["missed"], out["errors"])
    limits = tiny_cell(fmt)[1]["limits"]
    ctl = out["control_numbers"]["bf16"]
    for k in TRACKING:
        assert out["numbers"][k] <= limits[k], k
        # each tracking number separates the two: the control past the
        # limit, and the limit well above the program's reading
        assert ctl[k] > limits[k] > 2.0 * out["numbers"][k], k
    # and the harness's own decision reads the control as not correct
    assert out["control_correct"] == {"bf16": False}
    assert set(TRACKING) <= {k for k, c in out["control_checks"]["bf16"]
                             .items() if not c["value"] <= c["limit"]}
