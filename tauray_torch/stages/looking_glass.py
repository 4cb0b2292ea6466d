"""Looking Glass light-field composition
(reference: src/looking_glass.cc/.hh, src/looking_glass_composition_stage.*,
shader/looking_glass_composition.comp); the torch counterpart of
tauray_tpu.stages.looking_glass.

The hardware path becomes an offline output: the camera arc setup
(reference: looking_glass.hh:20-76 places N cameras on an arc toward the
convergence plane) and the lenticular quilt composition (interleaving
quilt views into the display's subpixel pattern using the device
calibration) both produce savable images. compose_quilt and lkg_compose
are integer gathers: equal to tauray_tpu's bit for bit on the same views.
"""

from __future__ import annotations

import copy
import math
from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class LKGCalibration:
    """(reference: --lkg-calibration struct, src/options.hh:541+)"""
    pitch: float = 47.58
    slope: float = -5.42
    center: float = 0.042
    viewCone: float = 40.0
    invView: int = 1
    DPI: float = 324.0
    screenW: int = 1536
    screenH: int = 2048
    flipImageX: int = 0
    flipImageY: int = 0
    flipSubp: int = 0

    @staticmethod
    def from_options(opt):
        c = opt.lkg_calibration
        cal = LKGCalibration()
        for f in ("pitch", "slope", "center", "viewCone", "invView", "DPI",
                  "screenW", "screenH", "flipImageX", "flipImageY",
                  "flipSubp"):
            v = getattr(c, f)
            if v:
                setattr(cal, f, v)
        return cal


def setup_lkg_cameras(scene, base_entity, opt):
    """Place `lkg-params.viewports` cameras on an arc looking at the
    convergence plane (reference: src/looking_glass.cc setup_cameras)."""
    from ..scene.transformable import Transformable
    p = opt.lkg_params
    n = p.viewports
    cal = LKGCalibration.from_options(opt)
    fov = 2 * math.degrees(math.atan(0.5 / p.relative_dist))
    views = []
    base_entity.camera_enabled = False
    half_cone = math.radians(cal.viewCone) * 0.5
    for i in range(n):
        frac = (i / max(n - 1, 1)) * 2 - 1  # [-1, 1]
        angle = frac * half_cone
        x = math.tan(angle) * p.midplane
        e = scene.add(f"lkg_cam_{i}")
        cam = copy.deepcopy(base_entity.camera)
        cam.perspective(fov, cal.screenW / cal.screenH, 0.01, 100.0)
        # recenter on the convergence plane via lens shift
        cam.set_pan(np.array([-2 * x / (p.midplane * 2 *
                                        math.tan(math.radians(fov) / 2) *
                                        cam.aspect), 0.0], np.float32))
        e.camera = cam
        e.transform = Transformable(position=(x, 0, 0),
                                    parent=base_entity.transform)
        e.camera_enabled = True
        e.camera_index = i
        views.append(e)
    return views


def compose_quilt(views: torch.Tensor, cols: int = 0) -> torch.Tensor:
    """Tile V views into a quilt image (bottom-left = view 0, row-major
    upward, the standard quilt layout)."""
    V, H, W, C = views.shape
    if cols == 0:
        cols = int(math.ceil(math.sqrt(V)))
    rows = int(math.ceil(V / cols))
    pad = rows * cols - V
    if pad:
        views = torch.cat([views, views.new_zeros((pad, H, W, C))])
    grid = views.reshape(rows, cols, H, W, C).flip(0)  # bottom row first
    return grid.permute(0, 2, 1, 3, 4).reshape(rows * H, cols * W, C)


def lkg_compose(views: torch.Tensor, pitch: float, slope: float,
                center: float, screen_w: int, screen_h: int, n_views: int,
                inv_view: int = 1, flip_x: int = 0, flip_y: int = 0,
                flip_subp: int = 0) -> torch.Tensor:
    """Lenticular subpixel interleave (reference:
    shader/looking_glass_composition.comp): each display subpixel selects
    the quilt view whose angle matches its position under the lens array.
    views: (V, H, W, C) -> (screen_h, screen_w, 3). Each operation rounds
    to float32 (pitch, slope and center too, as tauray_tpu's traced
    scalars do); the divisions by the screen size are products with the
    float32 reciprocal, as XLA compiles them and as torch's CUDA division
    by a scalar computes them, so the card and the CPU pick alike.
    XLA:CPU also contracts some of tauray_tpu's multiply-adds into FMAs,
    so on a subpixel whose lens phase lies within rounding of a boundary
    the two packages may pick the neighbouring view
    (tests/test_torch_looking_glass.py counts them)."""
    V, H, W, _ = views.shape
    dev = views.device
    ys, xs = torch.meshgrid(torch.arange(screen_h, device=dev),
                            torch.arange(screen_w, device=dev),
                            indexing="ij")
    f32 = torch.float32
    pitch, slope, center = (float(np.float32(x))
                            for x in (pitch, slope, center))
    u = xs.to(f32) * float(np.float32(1.0 / screen_w))
    v = ys.to(f32) * float(np.float32(1.0 / screen_h))
    if flip_x:
        u = 1.0 - u
    if flip_y:
        v = 1.0 - v
    out = []
    for sub in range(3):
        s = (2 - sub) if flip_subp else sub
        a = (u + s / (3.0 * screen_w) + v * slope) * pitch - center
        a = a - torch.floor(a)
        if inv_view:
            a = 1.0 - a
        view_idx = (a * n_views).to(torch.int32).clamp(0, V - 1)
        px = (u * W).to(torch.int32).clamp(0, W - 1)
        py = ((1 - v) * H).to(torch.int32).clamp(0, H - 1)
        out.append(views[view_idx.long(), py.long(), px.long(), sub])
    return torch.stack(out, dim=-1)
