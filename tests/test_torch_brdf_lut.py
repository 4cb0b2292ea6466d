"""The split-sum BRDF LUT of tauray_torch (ops/brdf_lut.py) against
tauray_tpu's. The table is generated in numpy by the same code, so it is
bit-equal; the bilinear lookup holds to 1e-6 (float32 rounding of the
same weights) on seeded inputs and at the edges (0, 1 and out of range,
which clamp). The port caches its table in its own build directory and
never in tauray_tpu's ~/.tauray_tpu_cache, and reads the reference's
asset from the checkout that TAURAY_REFERENCE_DIR names."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tauray_torch.ops import brdf_lut as tb
from tauray_tpu.ops import brdf_lut as jb

torch.set_num_threads(2)


def test_generate_bit_equal():
    np.testing.assert_array_equal(tb._generate(size=16, samples=64),
                                  jb._generate(size=16, samples=64))
    for a, b in zip(tb._hammersley(37), jb._hammersley(37)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", ["seeded", "edges"])
def test_sample_matches_jax(case):
    rng = np.random.default_rng(4)
    lut = rng.random((16, 16, 2)).astype(np.float32)
    if case == "seeded":
        cos_v = rng.random(4096).astype(np.float32)
        rough = rng.random(4096).astype(np.float32)
    else:
        vals = np.array([0.0, 1.0, -0.5, 1.5, 1 / 32, 31 / 32, 0.5,
                         1e-7, 1 - 1e-7], np.float32)
        cos_v, rough = (x.reshape(-1) for x in np.meshgrid(vals, vals))
    got = tb.sample_brdf_lut(torch.from_numpy(lut), torch.from_numpy(cos_v),
                             torch.from_numpy(rough)).numpy()
    want = np.asarray(jb.sample_brdf_lut(jnp.asarray(lut),
                                         jnp.asarray(cos_v),
                                         jnp.asarray(rough)))
    assert got.shape == want.shape == (cos_v.shape[0], 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if case == "edges":
        # out of range clamps to the edge texels
        lo = tb.sample_brdf_lut(torch.from_numpy(lut),
                                torch.tensor([-3.0]), torch.tensor([-3.0]))
        np.testing.assert_array_equal(lo.numpy()[0], lut[0, 0])
        hi = tb.sample_brdf_lut(torch.from_numpy(lut), torch.tensor([3.0]),
                                torch.tensor([3.0]))
        np.testing.assert_array_equal(hi.numpy()[0], lut[-1, -1])


def test_port_cache_is_its_own(tmp_path, monkeypatch):
    """The port writes and reads only its own cache file: a fresh HOME
    stays empty, and the table equals tauray_tpu's."""
    home = tmp_path / "home"
    home.mkdir()
    monkeypatch.setenv("HOME", str(home))
    assert os.path.basename(os.path.dirname(tb.CACHE)) == "_build"
    assert os.path.dirname(os.path.dirname(tb.CACHE)) == os.path.dirname(
        os.path.dirname(os.path.abspath(tb.__file__)))
    cache = tmp_path / "build" / "brdf_integration.npy"
    monkeypatch.setattr(tb, "CACHE", str(cache))
    monkeypatch.delenv("TAURAY_REFERENCE_DIR", raising=False)
    monkeypatch.setattr(tb, "_generate",
                        lambda: jb._generate(size=8, samples=16))
    tb._host_lut.cache_clear()
    tb.load_brdf_lut.cache_clear()
    try:
        lut = tb.load_brdf_lut(torch.device("cpu"))
        assert cache.exists() and list(home.iterdir()) == []
        np.testing.assert_array_equal(lut.numpy(), np.load(cache))
        np.testing.assert_array_equal(
            lut.numpy(), jb._generate(size=8, samples=16))
        assert lut.dtype == torch.float32 and lut.shape == (8, 8, 2)
    finally:
        tb._host_lut.cache_clear()
        tb.load_brdf_lut.cache_clear()


def test_reference_asset_is_read(tmp_path, monkeypatch):
    """With TAURAY_REFERENCE_DIR set, the table is the checkout's
    data/brdf_integration.exr (R = scale, G = bias), not the cache."""
    from tauray_torch.io.exr import write
    rng = np.random.default_rng(6)
    lut = rng.random((8, 8, 2)).astype(np.float32)
    (tmp_path / "data").mkdir()
    write(str(tmp_path / "data" / "brdf_integration.exr"),
          {"R": lut[..., 0], "G": lut[..., 1],
           "B": np.zeros((8, 8), np.float32)}, compression="zip")
    monkeypatch.setenv("TAURAY_REFERENCE_DIR", str(tmp_path))
    monkeypatch.setattr(tb, "CACHE", str(tmp_path / "absent.npy"))
    tb._host_lut.cache_clear()
    tb.load_brdf_lut.cache_clear()
    try:
        got = tb.load_brdf_lut(torch.device("cpu")).numpy()
        np.testing.assert_array_equal(got, lut)
        assert not (tmp_path / "absent.npy").exists()
    finally:
        tb._host_lut.cache_clear()
        tb.load_brdf_lut.cache_clear()
