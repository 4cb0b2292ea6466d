"""ReSTIR renderer (reference: src/restir_renderer.cc: per view
envmap -> G-buffer -> restir -> svgf -> tonemap -> taa); the torch
counterpart of tauray_tpu.renderer.restir_renderer on one device.

A frame: the G-buffer camera wave, ReSTIR DI (stages/restir), ReSTIR GI
(stages/restir_gi, max-ray-depth >= 2, not in hybrid mode) or, in
restir-hybrid, the SH probe grid's irradiance at the nearest probe
(renderer/sh_renderer), sky pixels set to the environment factor, then
the post stack or the tonemap. Every wave goes through the flat cluster
tracer, which returns original triangle ids."""

from __future__ import annotations

import math
from typing import Optional

import torch

from .. import tracing
from ..ops.cluster import build_cluster_tracer, tri_opacity
from ..ops.lights import NEEWeights
from ..ops.sampling import xla_int32
from ..ops.sh import eval_irradiance
from ..ops.shading import (get_camera_projection, get_screen_camera_ray,
                           interpolate_vertex, sample_material)
from ..ops.trace_utils import trace_alpha
from ..scene.device import to_camera_uniforms, to_device_scene
from ..stages.restir import Reservoir, ReSTIRConfigKey, restir_di_pass
from ..stages.restir_gi import (PathReservoir, ReSTIRGIConfigKey,
                                restir_gi_pass)
from ..stages.tonemap import tonemap
from .base import Renderer
from .post_processing import PostProcessingPipeline
from .sh_renderer import SHRenderer, _mat3


def _gbuffer_pass(scene, bvh, cam, prev_cam, width, height, min_ray_dist,
                  has_alpha):
    """Primary-visibility G-buffer of view 0, pixels in scanline order
    (reference: the raster G-buffer pass of restir_renderer,
    src/restir_renderer.cc:8-160)."""
    H, W = height, width
    R = H * W
    dev = cam.view.device
    ys, xs = torch.meshgrid(torch.arange(H, device=dev),
                            torch.arange(W, device=dev), indexing="ij")
    pix = torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=-1)
    vp = torch.zeros(R, dtype=torch.int64, device=dev)
    size = torch.tensor([W, H], dtype=torch.float32, device=dev)
    origin, d = get_screen_camera_ray(cam, vp, pix, size)
    hit = trace_alpha(scene, bvh, origin, d,
                      torch.full((R,), min_ray_dist, device=dev),
                      torch.full((R,), float("inf"), device=dev), 1e-4,
                      has_alpha)
    miss = hit.tri_id < 0
    v = interpolate_vertex(scene, hit.tri_id, hit.u, hit.v, d)
    mat, v = sample_material(scene, v)
    motion = get_camera_projection(prev_cam, vp, v.prev_pos)

    def r(x, C):
        return x.reshape(H, W, C)
    return dict(
        pos=r(v.pos, 3), normal=r(v.mapped_normal, 3), view=r(d, 3),
        albedo=r(mat.albedo, 4),
        mr=r(torch.stack([mat.metallic, mat.roughness], -1), 2),
        transmittance=mat.transmittance.reshape(H, W),
        emission=r(mat.emission, 3),
        motion=r(motion, 3)[..., :2], miss=miss.reshape(H, W),
        inst=torch.where(miss, -1, v.instance_id).reshape(H, W))


def nearest_probe_irradiance(coef, w2l, pos, normal, order: int):
    """RGB irradiance (H, W, 3) from the SH grid (rz, ry, rx, C, 4) at the
    probe nearest every position (H, W, 3), its grid coordinate clipped to
    the grid. The grid's fourth channel is the probes' visibility
    distance, not radiance, and is dropped (tauray_tpu multiplies all four
    channels by the RGB albedo, which raises)."""
    H, W = pos.shape[:2]
    local = (_mat3(w2l[:3, :3], pos.reshape(-1, 3)) +
             w2l[:3, 3]).reshape(H, W, 3)
    rz, ry, rx = coef.shape[:3]
    dims = torch.tensor([rx, ry, rz], dtype=torch.float32, device=pos.device)
    g = xla_int32((local * 0.5 + 0.5) * dims).long()
    g = torch.minimum(torch.clamp(g, min=0), dims.long() - 1)
    c = coef[g[..., 2], g[..., 1], g[..., 0]]
    return eval_irradiance(c, normal, order)[..., :3]


class ReSTIRRenderer(Renderer):
    def __init__(self, opt, device, hybrid: bool = False):
        super().__init__(opt, device)
        self.hybrid = hybrid
        self._prev_cam = None
        self.sh_source = SHRenderer(opt, device) if hybrid else None

    def _scene_changed(self):
        opt = self.opt
        self.device_scene = to_device_scene(
            self.arrays, opt.transparent_background, self.device)
        # no slot_ids: traces return original triangle ids, and the scene
        # tables stay in original order
        self.bvh, self._perm = build_cluster_tracer(
            self.arrays.tri_pos, self.arrays.tri_instance,
            tri_opaque=tri_opacity(self.arrays.tri_instance,
                                   self.arrays.inst_has_alpha),
            strategy=opt.as_strategy,
            inst_dynamic=self.arrays.inst_dynamic,
            inst_entity=self.arrays.inst_entity, device=self.device)
        self._prev_cam = None
        self.frame_idx = 0
        nee = NEEWeights.from_options(opt, self.arrays)
        r = opt.restir
        self.cfg_key = ReSTIRConfigKey(
            nee=nee, canonical_samples=r.canonical_samples,
            spatial_samples=r.spatial_samples, passes=r.passes,
            max_confidence=r.max_confidence,
            temporal=r.temporal_reuse,
            min_ray_dist=opt.min_ray_dist,
            bounce_mode=opt.bounce_mode,
            max_radius=r.max_search_radius,
            temporal_visibility=not r.assume_unchanged_temporal_visibility)
        # GI path reservoirs cover bounces >= 1 (reference: restir path
        # tracing with shift mappings, restir_core.glsl); DI above covers
        # the primary vertex. Hybrid mode takes its indirect light from the
        # SH probes instead
        self.gi_cfg = None
        if opt.max_ray_depth >= 2 and not self.hybrid:
            self.gi_cfg = ReSTIRGIConfigKey(
                nee=nee, shift=r.shift_mapping_type,
                gi_depth=opt.max_ray_depth,
                canonical_samples=r.canonical_samples,
                spatial_samples=r.spatial_samples, passes=r.passes,
                max_confidence=r.max_confidence,
                temporal=r.temporal_reuse,
                min_ray_dist=opt.min_ray_dist,
                bounce_mode=opt.bounce_mode,
                max_radius=r.max_search_radius,
                has_alpha=self.arrays.any_alpha_materials,
                has_envmap=self.arrays.environment_map is not None,
                reconnection_scale=r.reconnection_scale)
        self.prev_gi: Optional[PathReservoir] = None
        self.prev_res: Optional[Reservoir] = None
        self.prev_pos = None
        self.prev_inst = None
        self.post = PostProcessingPipeline(opt, opt.width, opt.height,
                                           len(self.viewports()),
                                           self.device)

    def update_frame(self):
        self.bvh = self.device_update_frame(self.bvh, self._perm)

    def _render_device(self) -> torch.Tensor:
        opt = self.opt
        H, W = opt.height, opt.width
        dev = self.device
        cam = to_camera_uniforms(self.arrays.camera_uniforms(
            self.viewports()), dev)
        prev_cam = self._prev_cam if self._prev_cam is not None else cam
        if self.sh_source is not None:
            with tracing.span("sh_bake"):
                self.sh_source.step(self)

        with tracing.span("gbuffer"):
            gbuf = _gbuffer_pass(self.device_scene, self.bvh, cam, prev_cam,
                                 W, H, opt.min_ray_dist,
                                 self.arrays.any_alpha_materials)
        if self.prev_res is None:
            self.prev_res = Reservoir.empty(H, W, dev)
            self.prev_pos = gbuf["pos"]
            self.prev_inst = gbuf["inst"]
        gb = (gbuf["pos"], gbuf["normal"], gbuf["view"], gbuf["albedo"],
              gbuf["mr"], gbuf["transmittance"], gbuf["motion"])
        with tracing.span("restir_di"):
            di, res = restir_di_pass(
                self.device_scene, self.bvh, *gb, self.prev_res,
                self.prev_pos, self.frame_idx, self.cfg_key,
                gbuf_inst=gbuf["inst"], prev_inst=self.prev_inst)
        color = di + gbuf["emission"]
        if self.gi_cfg is not None:
            if self.prev_gi is None:
                self.prev_gi = PathReservoir.empty(H, W, dev)
            with tracing.span("restir_gi"):
                gi, self.prev_gi = restir_gi_pass(
                    self.device_scene, self.bvh, *gb, self.prev_gi,
                    self.prev_pos, self.frame_idx, self.gi_cfg,
                    gbuf_inst=gbuf["inst"], prev_inst=self.prev_inst)
            color = color + gi
        self.prev_res = res
        self.prev_pos = gbuf["pos"]
        self.prev_inst = gbuf["inst"]
        self.frame_idx += 1
        if self.sh_source is not None:
            sh = self.sh_source.current_grid_data()
            if sh is not None:
                # "fake indirect" from the SH probes (reference:
                # restir_stage.hh hybrid mode)
                E = nearest_probe_irradiance(sh[0], sh[1], gbuf["pos"],
                                             gbuf["normal"], opt.sh_order)
                color = color + torch.clamp(E, min=0.0) * \
                    gbuf["albedo"][..., :3] / math.pi
        bg = self.device_scene.env_factor[:3].expand(H, W, 3)
        color = torch.where(gbuf["miss"][..., None], bg, color)
        ones = torch.ones((H, W, 1), dtype=torch.float32, device=dev)
        img = torch.cat([color, ones], dim=-1)[None]

        self._prev_cam = cam
        if not (self.post.use_svgf or self.post.use_bmfr or
                self.post.use_taa or self.post.use_temporal_reprojection):
            return tonemap(img, opt.tonemap, opt.exposure, opt.gamma)
        view_z = -((gbuf["pos"] * cam.view[0, 2, :3]).sum(-1) +
                   cam.view[0, 2, 3])
        # DI is already albedo-modulated, so the denoiser gets a white
        # albedo (no double modulation)
        white = torch.ones((1, H, W, 4), dtype=torch.float32, device=dev)
        pp = dict(color=img,
                  diffuse=torch.cat([di, ones], -1)[None],
                  reflection=torch.zeros_like(white),
                  albedo=white,
                  normal=gbuf["normal"][None],
                  pos=gbuf["pos"][None],
                  screen_motion=torch.cat(
                      [gbuf["motion"], torch.zeros_like(ones)], -1)[None],
                  metallic_roughness=gbuf["mr"][None],
                  emission=gbuf["emission"][None],
                  view_z=view_z[None])
        return self.post.process(pp, cam_origin=cam.origin.cpu().numpy())
