"""Host times of the port's PIZ EXR codec. Prints ONE JSON line.

    python -m tauray_torch.app.exr_io

Renders one frame of proc://sponza?tris=262144 at 1920x1080 (1 spp,
depth 4, linear tonemap) on the CUDA card, then times on the host:
  * write_s: the frame through the headless writer's defaults
    (--compression=piz, --format=rgb16: half RGB, exr.write_rgb), the
    pure-Python PIZ Huffman encoder;
  * read_native_s and read_python_s: the file back through exr.read_rgb,
    its Huffman stream decoded by the native library (tauray_torch/native)
    and under TAURAY_NATIVE=0 by the Python decoder; both arrays must be
    bit-equal to each other and to the frame rounded to half.
The line also names the card and its power limit (nvidia-smi) and the
host's CPU count. chip_smoke phase 19 runs piz_roundtrip on a seeded sky
(sky) and renders with it as --envmap."""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np

from ..io import exr


def sky(width: int, height: int, seed: int = 0) -> np.ndarray:
    """(height, width, 3) float32 lat-long sky: a smooth gradient from a
    pale horizon to a blue zenith, a sun-like lobe, and seeded noise of
    about 1% (so the Huffman stream carries real entropy)."""
    rng = np.random.default_rng(seed)
    v = (np.arange(height, dtype=np.float32) + 0.5) / height
    u = (np.arange(width, dtype=np.float32) + 0.5) / width
    elev = np.clip(1.0 - 2.0 * v, 0.0, 1.0)[:, None, None]
    zenith = np.array([0.25, 0.45, 1.0], np.float32)
    horizon = np.array([1.0, 0.95, 0.85], np.float32)
    img = horizon + (zenith - horizon) * elev ** 0.5
    d2 = (u[None, :] - 0.3) ** 2 + (v[:, None] - 0.3) ** 2
    img = img + (20.0 * np.exp(-d2 / 2e-4))[..., None]
    img = img * (1.0 + 0.01 * rng.standard_normal(img.shape))
    return np.ascontiguousarray(img, dtype=np.float32)


def _read(path: str, native: bool):
    """(read_rgb of path, seconds) with the native decoder or under
    TAURAY_NATIVE=0."""
    old = os.environ.get("TAURAY_NATIVE")
    if not native:
        os.environ["TAURAY_NATIVE"] = "0"
    try:
        t0 = time.perf_counter()
        img = exr.read_rgb(path)
        return img, time.perf_counter() - t0
    finally:
        if old is None:
            os.environ.pop("TAURAY_NATIVE", None)
        else:
            os.environ["TAURAY_NATIVE"] = old


def piz_roundtrip(path: str, img: np.ndarray) -> dict:
    """Writes img (H, W, 3) as the headless writer's default EXR (PIZ,
    half) to path and reads it back both ways, each timed. Raises when
    the two reads, or a read and the half-rounded img, are not
    bit-equal."""
    from .. import native
    native.get_lib()                     # build outside the timed read
    t0 = time.perf_counter()
    exr.write_rgb(path, img, compression="piz", half=True)
    write_s = time.perf_counter() - t0
    got_native, native_s = _read(path, True)
    got_python, python_s = _read(path, False)
    want = np.asarray(img).astype(np.float16).astype(np.float32)
    for name, got in (("native", got_native), ("python", got_python)):
        if got.shape != want.shape or not np.array_equal(
                got.view(np.uint32), want.view(np.uint32)):
            raise RuntimeError(f"{path}: the {name} PIZ read departs from "
                               "the half image written")
    h, w = want.shape[:2]
    return dict(size=f"{w}x{h}", file_bytes=os.path.getsize(path),
                write_s=write_s, read_native_s=native_s,
                read_python_s=python_s, python_over_native=python_s /
                native_s, bit_equal=True)


def main(argv=None) -> int:
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("exr_io renders its frame on a CUDA device")
    from .bench import card, make_renderer
    rr = make_renderer("proc://sponza?tris=262144", 1920, 1080, 1,
                       extra=("--tonemap=linear",))
    frame = rr.render_device()[0, ..., :3].cpu().numpy()
    del rr
    with tempfile.TemporaryDirectory() as tmp:
        res = piz_roundtrip(os.path.join(tmp, "frame.exr"), frame)
    print(json.dumps(dict(device=card(), host_cpus=os.cpu_count(),
                          frame=res)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
