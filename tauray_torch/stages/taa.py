"""Temporal antialiasing; the torch counterpart of tauray_tpu.stages.taa
(reference: src/taa_stage.cc, shader/taa.comp).

Per-camera jitter sequences feed the projection (scene/camera.py); the
history is motion-reprojected with a bilinear fetch and clamped to the
current 3x3 neighbourhood in a tonemap-warped colour space, with optional
edge dilation (the motion of the nearest-depth neighbour) and anti-shimmer
(log-space blending). The reference clips the history against a 22-DOP of
the neighbourhood; this, as tauray_tpu, clamps to the neighbourhood's
min/max box. Neighbourhood taps wrap around the image edges."""

from __future__ import annotations

import torch

from ..ops.sampling import xla_int32


def _map_color(c, gamma: float, anti_shimmer: bool):
    c = torch.clamp(c, min=0.0) ** gamma
    if anti_shimmer:
        c = torch.where(c > 1e-5, torch.log(torch.clamp(c, min=1e-5)), -10.0)
    return c


def _unmap_color(c, gamma: float, anti_shimmer: bool):
    if anti_shimmer:
        c = torch.exp(c)
    return torch.clamp(c, min=0.0) ** (1.0 / gamma)


def _bilinear(img, x, y):
    H, W = img.shape[:2]
    x0 = xla_int32(torch.floor(x))
    y0 = xla_int32(torch.floor(y))
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]

    def g(xi, yi):
        return img[yi.clamp(0, H - 1).long(), xi.clamp(0, W - 1).long()]

    return (g(x0, y0) * (1 - fx) * (1 - fy) + g(x0 + 1, y0) * fx * (1 - fy) +
            g(x0, y0 + 1) * (1 - fx) * fy + g(x0 + 1, y0 + 1) * fx * fy)


def _shift(img, dy: int, dx: int):
    return torch.roll(img, (dy, dx), (0, 1))


def taa(src, history, screen_motion, depth, alpha: float = 0.125,
        gamma: float = 1.0, edge_dilation: bool = True,
        anti_shimmer: bool = False):
    """src/history: (H, W, 3|4); screen_motion: (H, W, 2), the previous
    frame's uv; depth: (H, W) linear depth for edge dilation. Returns
    (out, new history)."""
    H, W = src.shape[:2]
    rgb = src[..., :3]

    motion = screen_motion
    if edge_dilation:
        # pick the motion vector of the nearest-depth 3x3 neighbour
        best_depth = depth
        best_motion = motion
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                nd = _shift(depth, dy, dx)
                nm = _shift(motion, dy, dx)
                closer = nd < best_depth
                best_depth = torch.where(closer, nd, best_depth)
                best_motion = torch.where(closer[..., None], nm, best_motion)
        motion = best_motion

    mx = motion[..., 0] * W - 0.5
    my = (1.0 - motion[..., 1]) * H - 0.5
    hist = _bilinear(history[..., :3], mx, my)

    mapped_src = _map_color(rgb, gamma, anti_shimmer)
    mapped_hist = _map_color(hist, gamma, anti_shimmer)

    # neighbourhood bounds in mapped space
    lo = mapped_src
    hi = mapped_src
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            n = _map_color(_shift(rgb, dy, dx), gamma, anti_shimmer)
            lo = torch.minimum(lo, n)
            hi = torch.maximum(hi, n)
    clamped_hist = torch.minimum(torch.maximum(mapped_hist, lo), hi)

    blended = clamped_hist * (1 - alpha) + mapped_src * alpha
    out = _unmap_color(blended, gamma, anti_shimmer)
    out = torch.where(torch.isfinite(out), out, rgb)
    if src.shape[-1] == 4:
        out = torch.cat([out, src[..., 3:]], dim=-1)
    return out, out
