"""Temporal and spatial reprojection; the torch counterpart of
tauray_tpu.stages.temporal.

* `temporal_reprojection` reuses a fraction of the previous frame along
  screen motion vectors, rejecting samples across geometry changes
  (reference: shader/temporal_reprojection.comp: bilinear taps with
  normal-cosine > 0.99 and squared-distance < 0.01 validity tests).
* `spatial_reprojection` is the light-field trick: only a subset of
  viewports is rendered; the rest are filled by projecting the rendered
  viewports' world positions (reference: shader/spatial_reprojection.comp,
  src/spatial_reprojection_stage.hh).

Motion vectors turn into pixel indices through xla_int32, the float ->
int32 conversion of the JAX package (NaN to 0, saturating), so pixels
whose motion is not finite take the same taps in both packages.
"""

from __future__ import annotations

import torch

from ..ops.sampling import xla_int32

SQRD_DIST_LIMIT = 0.01
COS_LIMIT = 0.99


def _gather2d(img, x, y):
    """img: (H, W, C); x/y: (H, W) int32, clamped to the image."""
    H, W = img.shape[:2]
    return img[y.clamp(0, H - 1).long(), x.clamp(0, W - 1).long()]


def temporal_reprojection(current_color, current_normal, current_pos,
                          screen_motion, previous_color, previous_normal,
                          previous_pos, temporal_ratio: float):
    """All images (H, W, C). screen_motion: (H, W, 2|3), the previous
    frame's uv in its first two channels (reference:
    get_camera_projection of prev_pos). Returns the blended color."""
    H, W = current_color.shape[:2]
    motion = screen_motion[..., :2]
    mx = motion[..., 0] * W - 0.5
    my = (1.0 - motion[..., 1]) * H - 0.5
    x0 = xla_int32(torch.floor(mx))
    y0 = xla_int32(torch.floor(my))
    qx = (mx - x0)[..., None]
    qy = (my - y0)[..., None]

    out_accum = torch.zeros_like(current_color)
    wsum = current_color.new_zeros(current_color.shape[:2] + (1,))
    for dy, dx, w in ((0, 0, (1 - qx) * (1 - qy)), (0, 1, qx * (1 - qy)),
                      (1, 0, (1 - qx) * qy), (1, 1, qx * qy)):
        sx = x0 + dx
        sy = y0 + dy
        inb = (sx >= 0) & (sx < W) & (sy >= 0) & (sy < H)
        pn = _gather2d(previous_normal, sx, sy)
        pp = _gather2d(previous_pos, sx, sy)
        pc = _gather2d(previous_color, sx, sy)
        dp = current_pos - pp
        keep = inb & \
            ((pn * current_normal).sum(-1) > COS_LIMIT) & \
            ((dp * dp).sum(-1) < SQRD_DIST_LIMIT)
        # a rejected tap weighs 0 even where its weight is NaN (a motion
        # vector that is not finite), as XLA's select for w * keep gives
        wk = torch.where(keep[..., None], w, 0.0)
        out_accum = out_accum + pc * wk
        wsum = wsum + wk

    ok = wsum[..., 0] > 1e-5
    r = out_accum / torch.clamp(wsum, min=1e-9)
    blended = current_color * (1 - temporal_ratio) + r * temporal_ratio
    blended = torch.where(torch.isnan(blended), current_color, blended)
    return torch.where(ok[..., None], blended, current_color)


def spatial_reprojection(target_cam_view_proj, src_colors, src_pos,
                         src_valid):
    """Fill an inactive viewport from rendered viewports' G-buffers.

    target_cam_view_proj: (4, 4); src_colors: (S, H, W, 4); src_pos:
    (S, H, W, 3) world positions; src_valid: (S, H, W) bool. Forward-splats
    each source pixel into the target viewport, nearest depth wins
    (reference: shader/spatial_reprojection.comp): a scatter-min of depth,
    then every source pixel within 1e-6 of its target's winning depth is a
    winner. Ties: where several winners land on one pixel, the one with
    the highest source index (flattened (S, H, W) order) gives the color;
    tauray_tpu's scatter-set leaves that choice unspecified. Returns
    (colors (H, W, 4), filled (H, W) bool)."""
    S, H, W = src_colors.shape[:3]
    pos = src_pos.reshape(-1, 3)
    col = src_colors.reshape(-1, 4)
    valid = src_valid.reshape(-1)
    m = target_cam_view_proj
    pr = pos @ m[:3, :3].T + m[:3, 3]
    w = pos @ m[3, :3] + m[3, 3]
    uv = pr[:, :2] / torch.clamp(w[:, None].abs(), min=1e-9) * \
        torch.sign(w[:, None]) * 0.5 + 0.5
    x = xla_int32(uv[:, 0] * W)
    y = xla_int32((1.0 - uv[:, 1]) * H)
    inb = valid & (w > 0) & (x >= 0) & (x < W) & (y >= 0) & (y < H)
    lin = torch.where(inb, y * W + x, H * W).long()
    depth = torch.where(inb, w, float("inf"))
    dbuf = torch.full((H * W + 1,), float("inf"), dtype=w.dtype,
                      device=w.device).scatter_reduce(0, lin, depth, "amin")
    winner = inb & (depth <= dbuf[lin] * (1 + 1e-6))
    src = torch.arange(col.shape[0], device=col.device)
    best = torch.full((H * W + 1,), -1, dtype=src.dtype,
                      device=col.device).scatter_reduce(
        0, torch.where(winner, lin, H * W), torch.where(winner, src, -1),
        "amax")[:H * W]
    out = torch.where(best[:, None] >= 0, col[best.clamp(min=0)], 0.0)
    filled = dbuf[:H * W] < float("inf")
    return out.reshape(H, W, 4), filled.reshape(H, W)
