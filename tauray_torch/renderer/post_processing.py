"""Post-processing pipeline; the torch counterpart of
tauray_tpu.renderer.post_processing (reference:
src/post_processing_renderer.cc).

The stage order is tauray_tpu's: denoiser (SVGF or BMFR, remodulated with
the first hit's albedo and metallic) -> temporal reprojection -> TAA ->
tonemap (always last). The previous frame's colour, normal and position
are held here, standing in for the reference's frame_delay_stage
(reference: src/frame_delay_stage.*); the denoisers' and TAA's histories
are per view."""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from ..ops.ggx import modulate_color
from ..stages import taa as taa_mod
from ..stages import temporal as temporal_mod
from ..stages.bmfr import BMFRState, bmfr_denoise
from ..stages.svgf import SVGFParams, SVGFState, svgf_denoise
from ..stages.tonemap import tonemap


class _Mat(NamedTuple):
    albedo: torch.Tensor
    metallic: torch.Tensor


def _numpy(x):
    """A torch tensor or any array (a JAX one included) as numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def post_state_numpy(post) -> Dict[str, Any]:
    """The history of a PostProcessingPipeline (this package's or
    tauray_tpu's: only attribute names are read) as numpy arrays:
    prev_color, prev_normal, prev_pos ((V, H, W, C) or None), taa_history
    (a list of (H, W, C) per view, or None), svgf_state and bmfr_state
    (a list of {field: array} per view; empty in this package's pipeline
    when that denoiser is off)."""
    def opt(x):
        return None if x is None else _numpy(x)
    return dict(
        prev_color=opt(post.prev_color), prev_normal=opt(post.prev_normal),
        prev_pos=opt(post.prev_pos),
        taa_history=(None if post.taa_history is None else
                     [opt(h) for h in post.taa_history]),
        svgf_state=[{k: _numpy(v) for k, v in s._asdict().items()}
                    for s in post.svgf_state],
        bmfr_state=[{k: _numpy(v) for k, v in s._asdict().items()}
                    for s in post.bmfr_state])


class PostProcessingPipeline:
    def __init__(self, opt, width: int, height: int, n_views: int, device):
        self.opt = opt
        self.W = width
        self.H = height
        self.V = n_views
        self.device = torch.device(device)
        self.use_temporal_reprojection = opt.temporal_reprojection > 0
        self.use_svgf = opt.denoiser == "svgf"
        self.use_bmfr = opt.denoiser == "bmfr"
        self.use_taa = opt.taa.sequence_length > 0
        self.svgf_params = SVGFParams.from_options(opt)
        self.reset()

    def reset(self):
        self.prev_color: Optional[torch.Tensor] = None
        self.prev_normal: Optional[torch.Tensor] = None
        self.prev_pos: Optional[torch.Tensor] = None
        self.taa_history = None
        # only the denoiser that is on holds a history (30 floats a pixel
        # for both), so a frame with no post stage allocates nothing here
        self.svgf_state = [SVGFState.zeros(self.H, self.W, self.device)
                           for _ in range(self.V if self.use_svgf else 0)]
        self.bmfr_state = [BMFRState.zeros(self.H, self.W, self.device)
                           for _ in range(self.V if self.use_bmfr else 0)]

    def load_state_numpy(self, state: Dict[str, Any]):
        """Replace the history with one from post_state_numpy (taken from
        either package), so both can continue from the same frame."""
        def dev(x):
            return None if x is None else torch.from_numpy(
                np.array(x, np.float32)).to(self.device)
        self.prev_color = dev(state["prev_color"])
        self.prev_normal = dev(state["prev_normal"])
        self.prev_pos = dev(state["prev_pos"])
        self.taa_history = (None if state["taa_history"] is None else
                            [dev(h) for h in state["taa_history"]])
        self.svgf_state = [SVGFState.from_numpy(s, self.device)
                           for s in state["svgf_state"]]
        self.bmfr_state = [BMFRState.from_numpy(s, self.device)
                           for s in state["bmfr_state"]]

    # ------------------------------------------------------------------
    def process(self, gbuf: Dict[str, torch.Tensor],
                cam_origin=None) -> torch.Tensor:
        """gbuf fields, all (V, H, W, C): color, diffuse, reflection,
        albedo, normal, pos, screen_motion, metallic_roughness, emission,
        view_z. cam_origin: (V, 4) numpy camera origins. Returns the
        tonemapped (V, H, W, 4)."""
        opt = self.opt
        color = gbuf["color"]
        out_views = []
        for v in range(self.V):
            c = color[v]
            normal = gbuf["normal"][v]
            pos = gbuf["pos"][v]
            motion = gbuf["screen_motion"][v][..., :2]
            depth = gbuf["view_z"][v]

            if self.use_svgf or self.use_bmfr:
                diffuse = gbuf["diffuse"][v]
                refl = gbuf["reflection"][v]
                if self.use_svgf:
                    co = (torch.from_numpy(np.asarray(
                        cam_origin[v][:3], np.float32)).to(self.device)
                        if cam_origin is not None else None)
                    d, s, st = svgf_denoise(
                        self.svgf_params, self.svgf_state[v], diffuse, refl,
                        motion, normal, pos, depth, cam_origin=co,
                        roughness=gbuf["metallic_roughness"][v][..., 1])
                    self.svgf_state[v] = st
                else:
                    d, s, st = bmfr_denoise(
                        self.bmfr_state[v], diffuse, refl, motion, normal,
                        pos, gbuf["albedo"][v])
                    self.bmfr_state[v] = st
                m = _Mat(gbuf["albedo"][v],
                         gbuf["metallic_roughness"][v][..., 0])
                rgb = gbuf["emission"][v] + modulate_color(m, d, s)
                c = torch.cat([rgb, c[..., 3:]], dim=-1)

            if self.use_temporal_reprojection and self.prev_color is not None:
                c = temporal_mod.temporal_reprojection(
                    c, normal, pos, gbuf["screen_motion"][v],
                    self.prev_color[v], self.prev_normal[v],
                    self.prev_pos[v], opt.temporal_reprojection)

            if self.use_taa:
                hist = (self.taa_history[v] if self.taa_history is not None
                        else c)
                c, new_hist = taa_mod.taa(
                    c, hist, motion, depth,
                    alpha=1.0 / opt.taa.sequence_length,
                    gamma=opt.gamma,
                    edge_dilation=opt.taa.edge_dilation,
                    anti_shimmer=opt.taa.anti_shimmer)
                if self.taa_history is None:
                    self.taa_history = [None] * self.V
                self.taa_history[v] = new_hist
            out_views.append(c)

        out = torch.stack(out_views)
        self.prev_color = out
        self.prev_normal = gbuf["normal"]
        self.prev_pos = gbuf["pos"]
        return tonemap(out, opt.tonemap, opt.exposure, opt.gamma)
