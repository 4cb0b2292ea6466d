"""Image-space distribution strategies (reference:
src/distribution_strategy.cc, shader/rt.glsl get_pixel_pos); the torch
counterpart of tauray_tpu.parallel.distribution.

Three strategies, as in the reference:
  * DUPLICATE — every device renders the full frame (forced for 1 device)
  * SCANLINE — interleaved rows (device i renders rows i, i+D, ...)
  * SHUFFLED_STRIPS — the image is cut into 2^b strips; each device gets a
    contiguous range of a bit-reversal permutation of strip ids, which
    equidistributes image-space variance and makes workload fractions
    continuously adjustable (reference: distribution_strategy.cc:62-126).

The index math is host-side numpy, computed once per rebalance, and equal
to tauray_tpu's bit for bit: the uint32 arithmetic of permute_region_id
runs in uint64 and is cut to 32 bits where jnp.uint32 wraps, so that a
shift by 32 gives 0 as in XLA. stitch / stitch_accumulate are torch
scatters on the device of their inputs.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

DUPLICATE = "duplicate"
SCANLINE = "scanline"
SHUFFLED_STRIPS = "shuffled-strips"

DistributionStrategy = str

_MASK32 = np.uint64(0xFFFFFFFF)


@dataclass(frozen=True)
class DistributionParams:
    """(reference: distribution UBO in shader/rt.glsl:8-16)"""
    strategy: str
    size: Tuple[int, int]   # full image size (w, h)
    index: int              # device row index / first permuted pixel
    count: int              # device count / pixel count
    primary: bool


def calculate_shuffled_strips_b(size) -> int:
    """Pick b so there are >= ~128 pixels per strip
    (reference: distribution_strategy.cc:62-69)."""
    n = size[0] * size[1]
    b = 31
    while (n >> b) < 128 and b > 0:
        b -= 1
    return b


def get_region_size(image_size: int, b: int) -> int:
    n_regions = 1 << b
    return (image_size + n_regions - 1) // n_regions


def shuffled_strips_pixels_per_device(size, max_ratio: float) -> int:
    b = calculate_shuffled_strips_b(size)
    return int(math.ceil(max_ratio * get_region_size(size[0] * size[1], b) *
                         (1 << b)))


def get_device_distribution_params(
        full_image_size, strategy: str, workload_offset: float,
        workload_size: float, device_index: int, device_count: int,
        primary: bool) -> DistributionParams:
    """(reference: distribution_strategy.cc get_device_distribution_params)"""
    if strategy in (DUPLICATE, SCANLINE):
        return DistributionParams(strategy, tuple(full_image_size),
                                  device_index, device_count, primary)
    before = shuffled_strips_pixels_per_device(full_image_size,
                                               workload_offset)
    after = shuffled_strips_pixels_per_device(
        full_image_size, workload_offset + workload_size)
    return DistributionParams(strategy, tuple(full_image_size), before,
                              after - before, primary)


def get_distribution_render_count(params: DistributionParams) -> int:
    """Number of rays this device traces."""
    w, h = params.size
    if params.strategy == DUPLICATE:
        return w * h
    if params.strategy == SCANLINE:
        return w * ((h - params.index + params.count - 1) // params.count)
    return params.count


def get_distribution_max_count(size, strategy: str,
                               device_count: int) -> int:
    """Upper bound on per-device ray count across rebalances
    (reference: get_distribution_target_max_size)."""
    w, h = size
    if strategy == DUPLICATE or device_count <= 1:
        return w * h
    if strategy == SCANLINE:
        return w * ((h + device_count - 1) // device_count)
    return w * h  # shuffled strips can in principle grow to the whole frame


def _bitreverse32(x: np.ndarray) -> np.ndarray:
    """Bit reversal of the low 32 bits of uint64 x."""
    m = np.uint64
    x = x & _MASK32
    x = ((x & m(0x55555555)) << m(1)) | ((x >> m(1)) & m(0x55555555))
    x = ((x & m(0x33333333)) << m(2)) | ((x >> m(2)) & m(0x33333333))
    x = ((x & m(0x0F0F0F0F)) << m(4)) | ((x >> m(4)) & m(0x0F0F0F0F))
    x = ((x & m(0x00FF00FF)) << m(8)) | ((x >> m(8)) & m(0x00FF00FF))
    x = ((x << m(16)) | (x >> m(16))) & _MASK32
    return x


def permute_region_id(i, size, b: int) -> np.ndarray:
    """Bit-reversal strip permutation for pixel i
    (reference: shader/rt.glsl permute_region_id). Vectorized; uint32 in
    and out, wrapping as jnp.uint32 does."""
    i = np.asarray(i).astype(np.uint64) & _MASK32
    n = size[0] * size[1]
    region_size = np.uint64(((n + (1 << b) - 1) >> b) & 0xFFFFFFFF)
    region_id = i // region_size
    k = _bitreverse32(region_id) >> np.uint64(32 - b)
    return ((k * region_size + i % region_size) & _MASK32).astype(np.uint32)


def device_pixel_positions(params: DistributionParams, max_count: int):
    """Pixel positions of the first max_count slots of one device's
    portion.

    Returns (pix (max_count, 2) i32, valid (max_count,) bool,
    write_linear (max_count,) i32 — linear index into the full frame)."""
    w, h = params.size
    if params.strategy == DUPLICATE:
        lin = np.arange(max_count, dtype=np.int64)
        valid = lin < w * h
        lin = np.minimum(lin, w * h - 1)
        pix = np.stack([lin % w, lin // w], axis=-1)
        return (pix.astype(np.int32), valid, lin.astype(np.int32))
    if params.strategy == SCANLINE:
        rows = (h - params.index + params.count - 1) // params.count
        slot = np.arange(max_count, dtype=np.int64)
        x = slot % w
        yy = slot // w
        y = yy * params.count + params.index
        valid = (slot < rows * w) & (y < h)
        y = np.minimum(y, h - 1)
        pix = np.stack([x, y], axis=-1)
        return (pix.astype(np.int32), valid, (y * w + x).astype(np.int32))
    # shuffled strips
    b = calculate_shuffled_strips_b(params.size)
    i = np.uint64(params.index) + np.arange(max_count, dtype=np.uint64)
    j = permute_region_id(i, params.size, b)
    valid = (np.arange(max_count) < params.count) & (j < w * h)
    j = np.minimum(j, w * h - 1).astype(np.int64)
    pix = np.stack([j % w, j // w], axis=-1)
    return (pix.astype(np.int32), valid, j.astype(np.int32))


def _scatter_index(write_linear, valid, total: int) -> torch.Tensor:
    """Flat write rows: each lane's pixel, or the dump row `total` for an
    invalid lane."""
    return torch.where(valid, write_linear.long(),
                       torch.full_like(write_linear, total,
                                       dtype=torch.long)).reshape(-1)


def _cover_mask(flat_idx, valid, total: int, shape) -> torch.Tensor:
    mask = torch.zeros(total + 1, dtype=torch.bool, device=valid.device)
    mask[flat_idx] = valid.reshape(-1)
    return mask[:total].reshape(shape)


def stitch_accumulate(full_shape, chunks, write_linear, valid, old, t):
    """Stitch + accumulation for the distributed renderer (reference:
    src/stitch_stage.cc composite on the display GPU +
    shader/gbuffer.glsl accumulate_gbuffer_color; the re-accumulation
    blend of src/rt_renderer.cc:178-182 folds into `t`).

    chunks: (D, V, N, 4) partial frames; write_linear / valid: (D, N);
    old: (V, H, W, 4) accumulation; t: float32 blend toward `old` (0 =
    replace, prev/(prev+new) = running mean, 1-blend_ratio = rebalance
    blend). Pixels no lane covers keep `old`."""
    H, W = full_shape
    D, V, N, C = chunks.shape
    total = H * W
    flat_idx = _scatter_index(write_linear, valid, total)
    flat = chunks.transpose(0, 1).reshape(V, D * N, C)
    scattered = chunks.new_zeros((V, total + 1, C))
    scattered[:, flat_idx] = flat
    new = scattered[:, :total].reshape(V, H, W, C)
    mask = _cover_mask(flat_idx, valid, total, (H, W))
    t = np.float32(t)
    blended = new * float(np.float32(1.0) - t) + old * float(t)
    return torch.where(mask[None, :, :, None], blended, old)


def stitch(full_shape, chunks, write_linear, valid, old=None,
           blend_ratio: float = 1.0):
    """Scatter per-device chunks into the full frame (reference:
    shader/stitch_scanline.comp / stitch_shuffled_strips.comp).

    chunks: (D, N, C); write_linear/valid: (D, N). With blend_ratio < 1 the
    result is mixed into `old` — used to emulate accumulation across
    workload rebalances (reference: rt_renderer.cc:178-182)."""
    V = chunks.shape[-1]
    total = full_shape[0] * full_shape[1]
    flat_idx = _scatter_index(write_linear, valid, total)
    out = chunks.new_zeros((total + 1, V))
    out[flat_idx] = chunks.reshape(-1, V)
    out = out[:total].reshape(full_shape[0], full_shape[1], V)
    if old is not None and blend_ratio < 1.0:
        mask = _cover_mask(flat_idx, valid, total, tuple(full_shape[:2]))
        # the weights as tauray_tpu's weakly typed Python floats round them
        blended = old * float(np.float32(1 - blend_ratio)) + \
            out * float(np.float32(blend_ratio))
        out = torch.where(mask[..., None], blended, old)
    return out
