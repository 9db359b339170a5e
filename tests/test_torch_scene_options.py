"""The port's scene options against the reference's scene recipe.

``tpu_gnss_torch.signal.scene.build_scene`` with each option of
tests/test_e2e.py:68-190 (an SV's dropout or fade, a moving receiver, a
common Doppler ramp) must give the samples,
ephemerides and receiver position of ``tests.test_e2e.build_scene`` at
the same arguments, bit for bit.
"""

import numpy as np
import pytest

from tpu_gnss_torch.signal import scene


@pytest.mark.parametrize("kw", [
    dict(dropout=(0, 0.3, 0.6)),
    dict(degrade=(1, 0.4, 0.05)),
    dict(rx_vel_enu=[15.0, 8.0, 0.0]),
    dict(doppler_ramp_hz_s=5.0),
    dict(dropout=(2, 0.0, 1.0), degrade=(1, 0.5, 0.3), n_sv=4, noise=0.5,
         seed=7),
], ids=["dropout", "degrade", "rx_vel_enu", "doppler_ramp", "combined"])
def test_scene_options_sample_identical(kw):
    from tests.test_e2e import build_scene
    want, ephs_w, rx_w = build_scene(duration=1.0, **kw)
    got, ephs_g, rx_g = scene.build_scene(duration=1.0, **kw)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(rx_g, rx_w)
    for a, b in zip(ephs_g, ephs_w):
        assert vars(a) == vars(b)


def test_options_change_the_scene():
    """Each option moves the samples it should, and only those: a
    dropout zeroes one SV over its window (so the scene there equals the
    scene without that SV), a fade scales it from its start on."""
    base, _, _ = scene.build_scene(duration=1.0, n_sv=2, noise=0.0)
    one, _, _ = scene.build_scene(duration=1.0, n_sv=1, noise=0.0)
    drop, _, _ = scene.build_scene(duration=1.0, n_sv=2, noise=0.0,
                                   dropout=(0, 0.25, 0.5))
    a, b = int(0.25 * scene.FS), int(0.5 * scene.FS)
    np.testing.assert_array_equal(drop[:a], base[:a])
    np.testing.assert_array_equal(drop[b:], base[b:])
    np.testing.assert_allclose(drop[a:b], (base - one)[a:b], atol=1e-5)
    fade, _, _ = scene.build_scene(duration=1.0, n_sv=1, noise=0.0,
                                   degrade=(0, 0.5, 0.0))
    np.testing.assert_array_equal(fade[:b], one[:b])
    assert not fade[b:].any()


def test_enu_to_ecef_matrix_equal():
    from tests.test_e2e import enu_to_ecef_matrix
    for lat, lon in ((52.95, -1.15), (-33.9, 151.2), (0.0, 0.0)):
        m = scene.enu_to_ecef_matrix(lat, lon)
        np.testing.assert_array_equal(m, enu_to_ecef_matrix(lat, lon))
        np.testing.assert_allclose(m @ m.T, np.eye(3), atol=1e-15)
