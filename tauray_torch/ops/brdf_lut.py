"""Split-sum environment-BRDF integration LUT (reference:
src/scene_stage.cc:300 loads data/brdf_integration.exr; sampled by
shader/forward.frag brdf_indirect as texture(brdf_integration,
vec2(cos_v, sqrt(mat.roughness))).xy); the torch counterpart of
tauray_tpu.ops.brdf_lut.

The reference ships the table as a data asset. When that asset is
reachable (TAURAY_REFERENCE_DIR names the reference checkout) it is
loaded directly; otherwise the table is generated with the standard
Karis split-sum integration using the port's own GGX terms (separable
Smith masking, alpha = artist-roughness squared) and cached in the port's
build directory (tauray_torch/_build/brdf_integration.npy)."""

from __future__ import annotations

import os
from functools import lru_cache

import numpy as np
import torch

from .. import reference_data
from .sampling import xla_int32

CACHE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build", "brdf_integration.npy")
LUT_SIZE = 256


def _hammersley(n: int):
    bits = np.arange(n, dtype=np.uint32)
    b = bits
    b = (b << np.uint32(16)) | (b >> np.uint32(16))
    b = ((b & np.uint32(0x55555555)) << np.uint32(1)) | \
        ((b & np.uint32(0xAAAAAAAA)) >> np.uint32(1))
    b = ((b & np.uint32(0x33333333)) << np.uint32(2)) | \
        ((b & np.uint32(0xCCCCCCCC)) >> np.uint32(2))
    b = ((b & np.uint32(0x0F0F0F0F)) << np.uint32(4)) | \
        ((b & np.uint32(0xF0F0F0F0)) >> np.uint32(4))
    b = ((b & np.uint32(0x00FF00FF)) << np.uint32(8)) | \
        ((b & np.uint32(0xFF00FF00)) >> np.uint32(8))
    return (np.arange(n) + 0.5) / n, b.astype(np.float64) / 2 ** 32


def _generate(size: int = LUT_SIZE, samples: int = 1024) -> np.ndarray:
    u1, u2 = _hammersley(samples)
    phi = 2 * np.pi * u1
    out = np.zeros((size, size, 2), np.float32)
    for iy in range(size):
        ra = (iy + 0.5) / size          # artist roughness (sqrt of mat's)
        a = ra * ra
        a2 = a * a
        ct = np.sqrt((1 - u2) / (1 + (a2 - 1) * u2))
        st = np.sqrt(np.maximum(1 - ct * ct, 0))
        H = np.stack([st * np.cos(phi), st * np.sin(phi), ct], -1)
        for ix in range(size):
            nov = (ix + 0.5) / size
            V = np.array([np.sqrt(max(1 - nov * nov, 0.0)), 0.0, nov])
            voh = H @ V
            L = 2 * voh[:, None] * H - V[None]
            nol = L[:, 2]
            noh = H[:, 2]
            ok = nol > 0

            def g1(c):
                return 2 * c / (c + np.sqrt(a2 + (1 - a2) * c * c))

            G = g1(np.maximum(nol, 1e-8)) * g1(max(nov, 1e-8))
            gv = G * np.clip(voh, 0, 1) / (np.maximum(noh, 1e-8) *
                                           max(nov, 1e-8))
            fc = (1 - np.clip(voh, 0, 1)) ** 5
            out[iy, ix, 0] = np.where(ok, (1 - fc) * gv, 0).mean()
            out[iy, ix, 1] = np.where(ok, fc * gv, 0).mean()
    return out


@lru_cache(maxsize=1)
def _host_lut() -> np.ndarray:
    ref = reference_data("brdf_integration.exr")
    if ref is not None and os.path.exists(ref):
        from ..io import exr
        img = exr.read(ref)
        return np.stack([np.asarray(img["R"], np.float32),
                         np.asarray(img["G"], np.float32)], -1)
    if os.path.exists(CACHE):
        return np.load(CACHE)
    lut = _generate()
    try:
        os.makedirs(os.path.dirname(CACHE), exist_ok=True)
        tmp = f"{CACHE}.{os.getpid()}.npy"
        np.save(tmp, lut)
        os.replace(tmp, CACHE)
    except OSError:  # pragma: no cover
        pass
    return lut


@lru_cache(maxsize=4)
def load_brdf_lut(device) -> torch.Tensor:
    """(S, S, 2) float32 on `device`: [..., 0] = scale (A), [..., 1] =
    bias."""
    return torch.from_numpy(_host_lut()).to(device)


def sample_brdf_lut(lut, cos_v, rough_artist):
    """Bilinear lookup with clamp-to-edge, matching the reference's
    sampler (scene_stage.cc brdf_integration_sampler)."""
    S = lut.shape[0]
    x = torch.clamp(cos_v * S - 0.5, 0.0, S - 1.0)
    y = torch.clamp(rough_artist * S - 0.5, 0.0, S - 1.0)
    x0 = xla_int32(torch.floor(x)).long()
    y0 = xla_int32(torch.floor(y)).long()
    x1 = torch.clamp(x0 + 1, max=S - 1)
    y1 = torch.clamp(y0 + 1, max=S - 1)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    return (lut[y0, x0] * (1 - fx) * (1 - fy) + lut[y0, x1] * fx * (1 - fy) +
            lut[y1, x0] * (1 - fx) * fy + lut[y1, x1] * fx * fy)
