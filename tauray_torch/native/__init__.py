"""The port's native host library: tauray_native.cpp (EXR PIZ Huffman
decode, Morton order), the counterpart of tauray_tpu.native with its API
(get_lib, huf_decode, morton_order).

The library is host C++, built with g++ on first use (never at import)
from this package's source into tauray_torch/_build/, under a name that
hashes the source and the flags, and loaded with ctypes. Each build writes
a temporary file of its own and moves it into place with os.replace, so
processes that build at once never read a half-written library.

There is no silent fallback: a build or load failure raises RuntimeError
with the compiler's output. The pure-Python decoder (io/exr._huf_decode)
runs only where the caller asks for it with TAURAY_NATIVE=0, the knob
tauray_tpu reads too; then get_lib() returns None, huf_decode and
morton_order return None, and their callers take their Python paths.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "tauray_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
CXX = "g++"
# -ffp-contract=off: the Morton grid's (c - lo) / ext * 1023 rounds as
# numpy's float32 arithmetic does, on any host CPU
CXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off"]

_lib: Optional[ctypes.CDLL] = None


def lib_path() -> str:
    """The library's path under BUILD_DIR, named after a hash of the
    source and the flags."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR,
                        f"libtauray_native_{h.hexdigest()[:16]}.so")


def _build(path: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=os.path.basename(path) + ".",
                               suffix=".tmp", dir=BUILD_DIR)
    os.close(fd)
    try:
        try:
            res = subprocess.run([CXX, *CXX_FLAGS, SOURCE, "-o", tmp],
                                 capture_output=True, text=True, timeout=300)
        except OSError as e:
            raise RuntimeError(f"{CXX} could not run to build {SOURCE}: "
                               f"{e}") from e
        if res.returncode != 0:
            raise RuntimeError(f"{CXX} failed ({res.returncode}) on "
                               f"{SOURCE}:\n{res.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built first if its file is missing; None under
    TAURAY_NATIVE=0. Raises RuntimeError when the build or the load
    fails."""
    global _lib
    if os.environ.get("TAURAY_NATIVE", "1") == "0":
        return None
    if _lib is not None:
        return _lib
    path = lib_path()
    if not os.path.exists(path):
        _build(path)
    try:
        lib = ctypes.CDLL(path)
    except OSError as e:
        raise RuntimeError(f"cannot load {path}: {e}") from e
    lib.tr_huf_decode.restype = ctypes.c_int64
    lib.tr_huf_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint16), ctypes.c_int64]
    lib.tr_morton_order.restype = None
    lib.tr_morton_order.argtypes = [
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64)]
    _lib = lib
    return _lib


def huf_decode(data: bytes, nbits: int, hcode: np.ndarray, rlc: int,
               n_out: int) -> Optional[np.ndarray]:
    """ImfHuf decode of n_out uint16 symbols from data (nbits long), with
    hcode the unpacked (code << 6 | length) table and rlc the run-length
    symbol; None under TAURAY_NATIVE=0 (the caller then decodes with
    io/exr._huf_decode). Raises ValueError on a malformed stream, and on
    one shorter than nbits (which the library would read past)."""
    lib = get_lib()
    if lib is None:
        return None
    if nbits < 0 or (nbits + 7) // 8 > len(data):
        raise ValueError(f"EXR: Huffman stream of {len(data)} bytes is "
                         f"shorter than its {nbits} bits")
    hc = np.ascontiguousarray(hcode, dtype=np.int64)
    out = np.zeros(n_out, dtype=np.uint16)
    rc = lib.tr_huf_decode(
        bytes(data), nbits,
        hc.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), 0, hc.size - 1,
        rlc, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), n_out)
    if rc != 0:
        raise ValueError(f"EXR: native Huffman decode failed ({rc})")
    return out


def morton_order(centroids: np.ndarray,
                 valid: np.ndarray) -> Optional[np.ndarray]:
    """Argsort of (N, 3) float32 centroids by their 30-bit Morton code on
    a 1024^3 grid over the valid centroids' bounds (all centroids' when
    none is valid), invalid entries last, ties by index; None under
    TAURAY_NATIVE=0."""
    lib = get_lib()
    if lib is None:
        return None
    c = np.ascontiguousarray(centroids, dtype=np.float32)
    v = np.ascontiguousarray(valid, dtype=np.uint8)
    if c.ndim != 2 or c.shape[1] != 3 or v.shape != (c.shape[0],):
        raise ValueError(f"morton_order: centroids {c.shape}, valid "
                         f"{v.shape}")
    out = np.zeros(c.shape[0], dtype=np.int64)
    lib.tr_morton_order(
        c.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), c.shape[0],
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return out
