"""Sobol low-discrepancy samplers, bit-identical to tauray_tpu.ops.sobol
(reference: shader/sobol_owen_sampler.glsl, shader/sobol_z_sampler.glsl,
src/rt_stage.hh sampler_type).

The `--sampler` options sobol-owen / sobol-z2 / sobol-z3:
  * Owen-scrambled Sobol: standard direction numbers (32 dimensions =
    4 dims x MAX_SOBOL_BOUNCES bounces) and Laine-Karras style nested
    uniform scrambling keyed per pixel;
  * Sobol Z-order: the sample index is interleaved with the pixel's Morton
    code, so neighbouring pixels get stratified-across-screen sequences.

Every uint32 value is an int64 tensor holding [0, 2^32), masked after each
multiply, add and left shift, as in ops/rng.py."""

from __future__ import annotations

import numpy as np
import torch

from .rng import MASK32, as_u32, pcg4d

# (degree, coefficient a, initial m values) for dims 2..32; dim 1 is the
# van der Corput sequence. Standard published initialisation values.
_POLY = [
    (1, 0, [1]),
    (2, 1, [1, 3]),
    (3, 1, [1, 3, 1]),
    (3, 2, [1, 1, 1]),
    (4, 1, [1, 1, 3, 3]),
    (4, 4, [1, 3, 5, 13]),
    (5, 2, [1, 1, 5, 5, 17]),
    (5, 4, [1, 1, 5, 5, 5]),
    (5, 7, [1, 1, 7, 11, 19]),
    (5, 11, [1, 1, 5, 1, 1]),
    (5, 13, [1, 1, 1, 3, 11]),
    (5, 14, [1, 3, 5, 5, 31]),
    (6, 1, [1, 3, 3, 9, 7, 49]),
    (6, 13, [1, 1, 1, 15, 21, 21]),
    (6, 16, [1, 3, 1, 13, 27, 49]),
    (6, 19, [1, 1, 1, 15, 7, 5]),
    (6, 22, [1, 3, 1, 15, 13, 25]),
    (6, 25, [1, 1, 5, 5, 19, 61]),
    (7, 1, [1, 3, 7, 11, 23, 15, 103]),
    (7, 4, [1, 3, 7, 13, 13, 15, 69]),
    (7, 7, [1, 1, 3, 13, 7, 35, 63]),
    (7, 8, [1, 3, 5, 9, 1, 25, 53]),
    (7, 14, [1, 3, 1, 13, 9, 35, 107]),
    (7, 19, [1, 3, 1, 5, 27, 61, 31]),
    (7, 21, [1, 1, 5, 11, 19, 41, 61]),
    (7, 28, [1, 3, 5, 3, 3, 13, 69]),
    (7, 31, [1, 1, 7, 13, 1, 19, 1]),
    (7, 32, [1, 3, 7, 5, 13, 19, 59]),
    (7, 37, [1, 1, 3, 9, 25, 29, 41]),
    (7, 41, [1, 3, 5, 13, 23, 1, 55]),
    (7, 42, [1, 3, 7, 3, 13, 59, 17]),
]


def _direction_numbers(n_dims: int = 32) -> np.ndarray:
    """V[dim, bit] direction numbers as uint32 (bit 0 = MSB-scaled)."""
    V = np.zeros((n_dims, 32), np.uint32)
    # dim 0: van der Corput
    for b in range(32):
        V[0, b] = np.uint32(1) << np.uint32(31 - b)
    for dim in range(1, n_dims):
        s, a, m_init = _POLY[dim - 1]
        m = list(m_init)
        for i in range(s, 32):
            new = m[i - s] ^ (m[i - s] << s)
            for k in range(1, s):
                if (a >> (s - 1 - k)) & 1:
                    new ^= m[i - k] << k
            m.append(new & 0xFFFFFFFF)
        for b in range(32):
            V[dim, b] = np.uint32((m[b] << (31 - b)) & 0xFFFFFFFF)
    return V


_V = _direction_numbers(32)
MAX_SOBOL_BOUNCES = 8  # 4 dims per bounce (reference: MAX_SOBOL_BOUNCES)


def sobol_uint(index, dims):
    """index: (...,) uint32 sample indices; dims: list of dimension ids.
    Returns (..., len(dims)) uint32 Sobol values."""
    index = as_u32(index)
    out = []
    for d in dims:
        acc = torch.zeros_like(index)
        for b in range(32):
            bit = (index >> b) & 1
            acc = acc ^ (bit * int(_V[d, b]))
        out.append(acc)
    return torch.stack(out, dim=-1)


def _lk_hash(x, seed):
    """Laine-Karras-style nested uniform scramble of reversed bits."""
    x = (as_u32(x) + seed) & MASK32
    for c in (0x6C50B47C, 0xB82F1E52, 0xC7AFE638, 0x8D22F6E6):
        x = x ^ ((x * c) & MASK32)
    return x


def _reverse_bits(x):
    x = as_u32(x)
    x = ((x & 0x55555555) << 1) | ((x >> 1) & 0x55555555)
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    return ((x << 16) & MASK32) | (x >> 16)


def owen_scramble(x, seed):
    return _reverse_bits(_lk_hash(_reverse_bits(x), seed))


def sobol_owen_sample_uint(pixel_seed, sample_index, bounce: int):
    """4D Owen-scrambled Sobol point for one bounce
    (reference: get_shuffled_scrambled_sobol_pt_uint).

    pixel_seed: (R, 4) uint32 (pixel-derived hash); sample_index: (R,);
    bounce: static int. Dimensions beyond the precomputed budget fall back
    to pcg4d hashing (reference: shader/math.glsl generate_sobol_sample)."""
    sample_index = as_u32(sample_index)
    if bounce >= MAX_SOBOL_BOUNCES:
        mix = torch.stack([sample_index,
                           torch.full_like(sample_index, bounce),
                           (sample_index * bounce) & MASK32,
                           torch.zeros_like(sample_index)], dim=-1)
        return pcg4d(mix ^ pixel_seed)
    # shuffle the sample index per pixel (decorrelates pixels)
    shuffled = owen_scramble(sample_index, pixel_seed[:, 0])
    pts = sobol_uint(shuffled, [4 * bounce + k for k in range(4)])
    # scramble each dimension with an independent per-pixel key
    keys = pcg4d((pixel_seed + bounce) & MASK32)
    return torch.stack([owen_scramble(pts[:, k], keys[:, k])
                        for k in range(4)], dim=-1)


def sobol_z_sample_uint(pixel_xy, sample_index, bounce: int,
                        bits_3d: bool = False):
    """Z-order Sobol: the sample index is bit-interleaved with the pixel
    Morton code so the screen acts as additional stratification dimensions
    (reference: shader/sobol_z_sampler.glsl). bits_3d is accepted for the
    sobol-z3 option and, as in tauray_tpu, changes nothing."""
    x = as_u32(pixel_xy[:, 0]) & 0xFFFF
    y = as_u32(pixel_xy[:, 1]) & 0xFFFF

    def spread(a):
        a = (a ^ (a << 8)) & 0x00FF00FF
        a = (a ^ (a << 4)) & 0x0F0F0F0F
        a = (a ^ (a << 2)) & 0x33333333
        a = (a ^ (a << 1)) & 0x55555555
        return a

    morton = spread(x) | (spread(y) << 1)
    idx = ((as_u32(sample_index) << 16) & MASK32) ^ morton
    if bounce >= MAX_SOBOL_BOUNCES:
        mix = torch.stack([idx, torch.full_like(idx, bounce),
                           (idx * (bounce + 1)) & MASK32,
                           torch.zeros_like(idx)], dim=-1)
        return pcg4d(mix)
    return sobol_uint(idx, [4 * bounce + k for k in range(4)])
