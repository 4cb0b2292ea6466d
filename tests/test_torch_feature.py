"""The feature (AOV) renderers of tauray_torch (stages/feature.py,
renderer/feature_renderer.py) against tauray_tpu's, on
tests/test_torch_device_update's animated scene (sky included, so the miss
default shows) at 16x16, on the third frame of the animation, so the
motion features are not zero. The JAX renderer is called directly:
conftest's 8 fake devices would route create_renderer elsewhere.
instance-id must match exactly; the others within 1e-4 of the feature's
scale (1 + its largest magnitude)."""

import numpy as np
import pytest
import torch

from tauray_torch.stages.feature import FEATURES

from test_torch_device_update import FRAME_DT, advance, anim_scene

torch.set_num_threads(2)

CPU = torch.device("cpu")


def _opt(cls, feature):
    opt = cls()
    opt.renderer = feature
    opt.width = opt.height = 16
    return opt


def _frame2(renderer, pkg):
    """The third frame: the first update takes the current positions as
    the previous ones (tauray_tpu's device update), the second moves."""
    s = anim_scene(pkg)
    renderer.set_scene(s)
    renderer.render()
    for dt in FRAME_DT:
        advance(pkg, s, dt)
        renderer.update_frame()
        img = renderer.render()[0]
    return img


@pytest.mark.parametrize("feature", FEATURES)
def test_feature_matches_jax(feature):
    from tauray_torch.options import Options as TOptions
    from tauray_torch.renderer.feature_renderer import FeatureRenderer as TFR
    from tauray_tpu.options import Options as JOptions
    from tauray_tpu.renderer.feature_renderer import FeatureRenderer as JFR
    want = _frame2(JFR(_opt(JOptions, feature), feature), "tauray_tpu")
    got = _frame2(TFR(_opt(TOptions, feature), CPU, feature), "tauray_torch")
    assert got.shape == want.shape == (16, 16, 4)
    miss = np.isnan(want).all(-1) | (want == np.float32(
        TOptions().default_value)).all(-1)
    assert 0 < miss.mean() < 1, miss.mean()
    if feature == "instance-id":
        np.testing.assert_array_equal(got, want)
        assert len(np.unique(want[~miss][:, 0])) >= 3
    else:
        finite = np.isfinite(want)
        scale = 1.0 + np.abs(want[finite]).max()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)
    if feature in ("world-motion", "view-motion"):
        assert np.abs(want[~miss][:, :3]).max() > 1e-3
