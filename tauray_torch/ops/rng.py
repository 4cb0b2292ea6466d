"""Counter-based RNG, bit-identical to tauray_tpu.ops.rng.

pcg / pcg4d hashes (reference: shader/math.glsl:74-120) and the
random_sampler seeding scheme (reference: shader/random_sampler.glsl).
Torch has no full uint32 arithmetic, so every uint32 value here is an
int64 tensor holding [0, 2^32): each multiply and add is masked back to
32 bits (int64 products wrap mod 2^64, which keeps the low 32 bits exact),
and right shifts of non-negative int64 values are logical."""

from __future__ import annotations

import torch

INV_UINT32_MAX = 2.3283064365386963e-10  # (reference: shader/math.glsl:10)

MASK32 = 0xFFFFFFFF


def as_u32(x) -> torch.Tensor:
    """Any integer tensor (or numpy uint32 array) -> int64 in [0, 2^32)."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x)
    return x.to(torch.int64) & MASK32


def pcg(seed: torch.Tensor) -> torch.Tensor:
    """One PCG step on uint32 values (int64 storage)."""
    seed = (seed * 747796405 + 2891336453) & MASK32
    seed = (((seed >> ((seed >> 28) + 4)) ^ seed) * 277803737) & MASK32
    return (seed >> 22) ^ seed


def pcg4d(seed: torch.Tensor) -> torch.Tensor:
    """seed: (..., 4) uint32 -> hashed (..., 4). All four lanes update from
    the OLD vector, as tauray_tpu.ops.rng.pcg4d does."""
    a = [1, 2, 0, 1]
    b = [3, 0, 1, 2]
    seed = (seed * 1664525 + 1013904223) & MASK32
    seed = (seed + seed[..., a] * seed[..., b]) & MASK32
    seed = (seed >> 16) ^ seed
    return (seed + seed[..., a] * seed[..., b]) & MASK32


def init_random_sampler(coord: torch.Tensor) -> torch.Tensor:
    """coord: (..., 4) uint32 (pixel.xy, viewport+rng_seed, sample index)
    (reference: shader/random_sampler.glsl init_random_sampler)."""
    x = coord[..., 0]
    y = coord[..., 1] ^ pcg(x)
    z = coord[..., 2] ^ pcg(y)
    w = coord[..., 3] ^ pcg(z)
    return torch.stack([x, y, z, w], dim=-1)


def generate_uniform_random_uint(seed: torch.Tensor):
    """Advance the sampler: (new_seed, uvec4) with new_seed == value."""
    v = pcg4d(seed)
    return v, v


def uint_to_float(u: torch.Tensor) -> torch.Tensor:
    return u.to(torch.float32) * INV_UINT32_MAX


def generate_uniform_random(seed: torch.Tensor):
    """Advance the sampler: (new_seed, (..., 4) float32 in [0, 1])."""
    v, _ = generate_uniform_random_uint(seed)
    return v, uint_to_float(v)
