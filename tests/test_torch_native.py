"""The port's native host library (tauray_torch/native) against
tauray_tpu's and the pure-Python paths, on the CPU (g++ builds it here as
on the card's host).

  * huf_decode bit for bit against tauray_tpu.native.huf_decode and
    io/exr._huf_decode: tests/test_native.py's stream (runs, a long tail
    and zeros), one repeated symbol (RLE only), lengths 1 and 65,537, and
    codes longer than the 14-bit table;
  * a truncated stream raises ValueError;
  * PIZ files written by the port's writer (half RGB at 37x19, odd
    wavelet edges; float RGBA at 64x32) read back bit-equal through the
    native decoder, under TAURAY_NATIVE=0 and through tauray_tpu's
    read_rgb;
  * morton_order against tauray_tpu's and the numpy lexsort of
    tests/test_native.py, with invalid entries, every entry invalid and
    duplicated centroids;
  * the build: into tauray_torch/_build/ under a hashed name, none at
    import, and a failing compiler raises instead of falling back.
"""

import os
import struct
import subprocess
import sys

import numpy as np
import pytest

from tauray_torch import native
from tauray_torch.app.exr_io import sky
from tauray_torch.io import exr
from tauray_torch.ops.bvh import morton_3d
from tauray_tpu import native as jnative
from tauray_tpu.io import exr as jexr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def jax_lib(tmp_path_factory):
    """tauray_tpu's library, built by its own get_lib into a directory of
    this module's: its default build writes every build to one shared
    temporary name beside its source, which another test process may be
    writing at the same moment, and its get_lib then returns None for
    good. A None here would fail every comparison, so it fails loudly."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "_LIB", str(
            tmp_path_factory.mktemp("tauray_tpu_native") /
            "libtauray_native.so"))
        mp.setattr(jnative, "_lib", None)
        mp.setattr(jnative, "_tried", False)
        mp.delenv("TAURAY_NATIVE", raising=False)
        lib = jnative.get_lib()
        assert lib is not None, "tauray_tpu.native's g++ build failed"
        yield lib


def _encode(data: np.ndarray):
    """(stream, nbits, hcode, rlc) of data through the shared encoder."""
    comp = exr._huf_encode(data)
    him, hiM, tlen, nbits, _ = struct.unpack_from("<IIIII", comp, 0)
    hcode, _ = exr._huf_unpack_enc_table(comp[20:20 + tlen], him, hiM)
    return comp[20 + tlen:], nbits, hcode, hiM, him


def _streams():
    rng = np.random.default_rng(3)
    yield "runs_tail_zeros", np.concatenate([
        np.repeat(rng.integers(0, 1 << 16, 64), rng.integers(1, 40, 64)),
        rng.integers(0, 1 << 16, 4096),
        np.zeros(700, np.int64)]).astype(np.uint16)
    yield "one_symbol_rle", np.full(5000, 1234, np.uint16)
    yield "length_1", np.array([7], np.uint16)
    yield "length_65537", np.random.default_rng(4).integers(
        0, 300, 65537).astype(np.uint16)
    # 16,384 symbols seen once against one symbol seen 16,384 times:
    # the rare ones get codes longer than the 14-bit short table
    yield "long_codes", np.random.default_rng(5).permutation(np.concatenate(
        [np.arange(0, 65536, 4), np.full(16384, 5)])).astype(np.uint16)


STREAMS = dict(_streams())


@pytest.mark.parametrize("name", list(STREAMS))
def test_huf_decode_matches_jax_and_python(name):
    data = STREAMS[name]
    stream, nbits, hcode, rlc, him = _encode(data)
    if name == "long_codes":
        assert int((hcode & 63).max()) > 14
    got = native.huf_decode(stream, nbits, hcode, rlc, data.size)
    assert got.dtype == np.uint16
    want_jax = jnative.huf_decode(stream, nbits, hcode, rlc, data.size)
    want_py = exr._huf_decode(stream, nbits, hcode,
                              exr._huf_build_dec_table(hcode, him, rlc),
                              rlc, data.size)
    np.testing.assert_array_equal(got, want_jax)
    np.testing.assert_array_equal(got, want_py)
    np.testing.assert_array_equal(got, data)


@pytest.mark.parametrize("cut", ["bytes", "bits"])
def test_truncated_stream_raises(cut):
    """The stream cut to half its bytes: with the header's bit count (the
    library would read past the buffer) and with the count cut to match
    (the decode runs short of its output)."""
    data = STREAMS["runs_tail_zeros"]
    stream, nbits, hcode, rlc, _ = _encode(data)
    short = stream[:len(stream) // 2]
    n = nbits if cut == "bytes" else len(short) * 8
    with pytest.raises(ValueError):
        native.huf_decode(short, n, hcode, rlc, data.size)


@pytest.mark.parametrize("kind", ["half_rgb_37x19", "float_rgba_64x32"])
def test_piz_files_read_back_bit_equal(tmp_path, monkeypatch, kind):
    # smooth skies with 1% noise: PIZ stores a chunk uncompressed when
    # that is smaller, and white noise would be
    if kind == "half_rgb_37x19":
        img, half = sky(37, 19, seed=6), True
        want = img.astype(np.float16).astype(np.float32)
    else:
        rgb = np.round(sky(64, 32, seed=7) * 1024) / 1024
        alpha = np.linspace(0, 1, 64 * 32, dtype=np.float32)
        img = np.concatenate([rgb, alpha.reshape(32, 64, 1)], axis=-1)
        img, half = img.astype(np.float32), False
        want = img
    path = str(tmp_path / f"{kind}.exr")
    exr.write_rgb(path, img, compression="piz", half=half)
    calls = []
    decode = native.huf_decode
    monkeypatch.setattr(native, "huf_decode",
                        lambda *a: calls.append(1) or decode(*a))
    got = exr.read_rgb(path)
    assert calls                      # the reader took the native decoder
    monkeypatch.setenv("TAURAY_NATIVE", "0")
    assert native.get_lib() is None
    got_py = exr.read_rgb(path)
    monkeypatch.delenv("TAURAY_NATIVE")
    got_jax = jexr.read_rgb(path)
    for g in (got, got_py, got_jax):
        assert g.shape == want.shape
        np.testing.assert_array_equal(g.view(np.uint32),
                                      want.view(np.uint32))


def _morton_reference(centroids, valid):
    """tests/test_native.py's numpy order."""
    n = centroids.shape[0]
    sel = valid if valid.any() else np.ones(n, bool)
    lo = centroids[sel].min(axis=0)
    hi = centroids[sel].max(axis=0)
    ext = np.maximum(hi - lo, 1e-12)
    grid = np.clip(((centroids - lo) / ext) * 1023.0,
                   0, 1023).astype(np.uint32)
    codes = morton_3d(grid).astype(np.uint64)
    return np.lexsort((np.arange(n),
                       codes + (~valid).astype(np.uint64) * (1 << 32)))


def _morton_case(kind):
    rng = np.random.default_rng(7)
    n = 5000
    c = (rng.random((n, 3)) * 20 - 10).astype(np.float32)
    valid = rng.random(n) > 0.1
    if kind == "all_invalid":
        valid[:] = False
    elif kind == "duplicates":
        c = c[rng.integers(0, 300, n)]          # 300 centroids, each ~17x
    return c, valid


@pytest.mark.parametrize("kind", ["random", "all_invalid", "duplicates"])
def test_morton_order_matches_jax_and_numpy(kind):
    c, valid = _morton_case(kind)
    got = native.morton_order(c, valid)
    np.testing.assert_array_equal(got, jnative.morton_order(c, valid))
    np.testing.assert_array_equal(got, _morton_reference(c, valid))
    assert sorted(got.tolist()) == list(range(c.shape[0]))


def test_library_is_built_under_build_dir():
    lib = native.get_lib()
    path = native.lib_path()
    assert os.path.dirname(path) == os.path.join(ROOT, "tauray_torch",
                                                 "_build")
    assert os.path.basename(path).startswith("libtauray_native_")
    assert os.path.exists(path) and lib._name == path


def test_import_starts_no_compiler():
    """A fresh interpreter whose subprocess functions raise imports the
    native module and the EXR reader."""
    code = (
        "import subprocess\n"
        "def boom(*a, **k):\n"
        "    raise AssertionError('a compiler was started')\n"
        "subprocess.run = subprocess.Popen = subprocess.call = boom\n"
        "import tauray_torch.native, tauray_torch.io.exr\n"
        "assert tauray_torch.native._lib is None\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("compiler", ["false", "no-such-compiler"])
def test_failing_build_raises(tmp_path, monkeypatch, compiler):
    """A compiler that fails, or is missing, raises RuntimeError from
    get_lib, huf_decode and a PIZ read: none falls back to Python."""
    path = str(tmp_path / "x.exr")
    exr.write_rgb(path, sky(32, 16), compression="piz")
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "CXX", compiler)
    monkeypatch.setattr(native, "_lib", None)
    stream, nbits, hcode, rlc, _ = _encode(STREAMS["length_1"])
    for call in (native.get_lib,
                 lambda: native.huf_decode(stream, nbits, hcode, rlc, 1),
                 lambda: exr.read_rgb(path)):
        with pytest.raises(RuntimeError, match=compiler):
            call()
    assert not os.path.exists(native.lib_path())
    assert os.listdir(tmp_path / "build") == []
