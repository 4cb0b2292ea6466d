"""Path-tracing renderer (reference: rt_renderer<path_tracer_stage>,
src/rt_renderer.cc); the torch counterpart of
tauray_tpu.renderer.rt_renderer.PathTracerRenderer on one device.

Scene update -> path-tracing passes (samples_per_pixel / samples_per_pass)
split into calls of at most `rays_per_call` pixels -> accumulation ->
the post-processing pipeline (reprojection, denoiser, TAA) when an option
asks for it -> tonemap."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..ops.cluster import (build_cluster_tracer, build_instanced_from_arrays,
                           tri_opacity)
from ..ops.lights import NEEWeights
from ..scene.device import to_camera_uniforms, to_device_scene
from ..stages.path_tracer import PTConfig, accumulate, pt_trace_pass
from ..stages.tonemap import tonemap
from ..validation import check_nan
from .base import Renderer
from .post_processing import PostProcessingPipeline

# rays per wave: samples_per_pass samples of rays_per_call pixels trace as
# one wave of at most this many rays
WAVE_CAP = 1 << 20


class PathTracerRenderer(Renderer):
    def __init__(self, opt, device, direct_only: bool = False):
        super().__init__(opt, device)
        self.direct_only = direct_only
        self.accum_color: Optional[torch.Tensor] = None
        self.samples_accumulated = 0
        self._prev_cam = None

    def _scene_changed(self):
        opt = self.opt
        self.device_scene = to_device_scene(
            self.arrays, opt.transparent_background, self.device)
        # --as-strategy per-model / per-material: the instanced (TLAS)
        # tracer, where meshes are shared and nothing is skinned; every
        # other case bakes world-space clusters
        self.bvh = None
        self._perm = None
        if opt.as_strategy in ("per-model", "per-material"):
            self.bvh = build_instanced_from_arrays(self.arrays, self.device)
        if self.bvh is None:
            self.bvh, self._perm = build_cluster_tracer(
                self.arrays.tri_pos, self.arrays.tri_instance,
                tri_opaque=tri_opacity(self.arrays.tri_instance,
                                       self.arrays.inst_has_alpha),
                strategy=opt.as_strategy,
                inst_dynamic=self.arrays.inst_dynamic,
                inst_entity=self.arrays.inst_entity, device=self.device)
            # slot-id mode: traces return raw slot ids and the path tracer
            # reads SLOT-ordered triangle tables (_slot_scene)
            self.bvh.slot_ids = True
            self._perm_dev = torch.from_numpy(self._perm).long().to(
                self.device)
        self._prev_cam = None
        self.accum_color = None
        self.samples_accumulated = 0
        self.frame_counter = 0
        spp = opt.samples_per_pixel
        sppass = min(opt.samples_per_pass, spp)
        spp = ((spp + sppass - 1) // sppass) * sppass
        self.samples_per_pixel = spp
        self.samples_per_pass = sppass
        self.cfg = PTConfig(
            width=opt.width, height=opt.height,
            n_views=len(self.viewports()),
            max_bounces=max(opt.max_ray_depth, 1),
            samples_per_pass=sppass,
            film=opt.film, film_radius=opt.film_radius,
            min_ray_dist=opt.min_ray_dist,
            mis_mode=opt.multiple_importance_sampling,
            bounce_mode=opt.bounce_mode,
            tri_light_mode=opt.tri_light_mode,
            russian_roulette_delta=opt.russian_roulette,
            indirect_clamping=opt.indirect_clamping,
            regularization_gamma=opt.regularization,
            nee=NEEWeights.from_options(opt, self.arrays),
            has_envmap=self.arrays.environment_map is not None,
            has_point_lights=self.arrays.point_count > 0,
            hide_lights=opt.hide_lights,
            use_dof=opt.depth_of_field.f_stop > 0,
            transparent_background=opt.transparent_background,
            use_white_albedo_on_first_bounce=(
                opt.use_white_albedo_on_first_bounce),
            direct_only=self.direct_only,
            rng_seed=opt.rng_seed,
            has_alpha_materials=self.arrays.any_alpha_materials,
            sampler=opt.sampler,
            tex_slots=tuple(
                bool((self.arrays.inst_tex[:, k] >= 0).any())
                for k in range(4)),
            tl_textured=bool((self.arrays.tl_tex >= 0).any()),
            validate=opt.validation)
        V, H, W = self.cfg.n_views, opt.height, opt.width
        # sparse viewport rendering for light fields: only the viewports in
        # --spatial-reprojection are traced; the rest are reprojected
        # (reference: src/spatial_reprojection_stage.hh, options.hh:367-370)
        self.active_views = sorted(
            v for v in opt.spatial_reprojection if v < V) or list(range(V))
        self.use_spatial_reproj = len(self.active_views) < V
        AV = len(self.active_views)
        ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
        pix = np.stack([xs.reshape(-1), ys.reshape(-1)], axis=-1)
        # trace rays in 8x4 PIXEL BLOCKS, so a 32-ray traversal tile covers
        # a compact screen footprint; results are un-permuted once per
        # frame
        if H % 4 == 0 and W % 8 == 0:
            block = (ys // 4) * (W // 8) + (xs // 8)
            within = (ys % 4) * 8 + (xs % 8)
            order = np.argsort((block * 32 + within).reshape(-1),
                               kind="stable")
            pix = pix[order]
            un = np.argsort(order, kind="stable")
            self._ray_unorder = torch.from_numpy(
                (un[None, :] + (np.arange(AV) * H * W)[:, None])
                .reshape(-1)).long().to(self.device)
        else:
            self._ray_unorder = None
        pix = np.tile(pix, (AV, 1)).astype(np.int32)
        vp = np.repeat(np.asarray(self.active_views, np.int32), H * W)
        # pixels per call: samples_per_pass samples of them trace as one
        # wave of at most WAVE_CAP rays
        per_call = max(8192, (WAVE_CAP // max(self.samples_per_pass, 1))
                       // 8192 * 8192)
        self.rays_per_call = min(per_call, pix.shape[0])
        R = pix.shape[0]
        padr = (-R) % self.rays_per_call
        if padr:
            pix = np.concatenate([pix, np.zeros((padr, 2), np.int32)])
            vp = np.concatenate([vp, np.zeros(padr, np.int32)])
        self._n_rays = R
        self._pix = torch.from_numpy(pix).to(self.device)
        self._vp = torch.from_numpy(vp).to(self.device)
        # post-processing pipeline (reprojection / denoiser / TAA / tonemap)
        self.post = PostProcessingPipeline(opt, W, H, V, self.device)
        self.use_post = (self.post.use_svgf or self.post.use_bmfr or
                         self.post.use_taa or
                         self.post.use_temporal_reprojection or
                         self.use_spatial_reproj)
        self.last_useful_rays = None

    def update_frame(self):
        self.bvh = self.device_update_frame(self.bvh, self._perm)

    # -- checkpoint/resume: the accumulation state persists as a file ----
    def save_checkpoint(self, path: str):
        if self.accum_color is None:
            return
        with open(path, "wb") as f:
            np.savez(f, accum_color=self.accum_color.cpu().numpy(),
                     samples_accumulated=self.samples_accumulated,
                     frame_counter=self.frame_counter)

    def load_checkpoint(self, path: str) -> bool:
        if not os.path.exists(path):
            return False
        data = np.load(path)
        self.accum_color = torch.from_numpy(data["accum_color"]).to(
            self.device)
        self.samples_accumulated = int(data["samples_accumulated"])
        self.frame_counter = int(data["frame_counter"])
        return True

    def reset_accumulation(self, keep_samples: bool = False):
        if not keep_samples and not self.opt.accumulation:
            self.accum_color = None
            self.samples_accumulated = 0

    def _slot_scene(self):
        """Device scene with triangle tables permuted into traversal SLOT
        order (one small gather per frame instead of a slot -> triangle
        remap per wave); the instanced tracer returns world-triangle ids
        and reads the scene as it is."""
        if self._perm is None:
            return self.device_scene
        p = self._perm_dev
        return self.device_scene._replace(
            tri_packed=self.device_scene.tri_packed[p],
            tri_instance=self.device_scene.tri_instance[p])

    def capture_waves(self):
        """One pass of the first call's pixels with the wave capture on
        (stages/path_tracer._WAVE_DUMP). Returns [(kind, o, d, t_min,
        t_max)] of its trace waves on the renderer's device (t_min a float,
        t_max per ray); app/bench.py's wave statistics read them."""
        from ..stages import path_tracer as pt
        cam = to_camera_uniforms(
            self.arrays.camera_uniforms(self.viewports()), self.device)
        n = self.rays_per_call
        pt._WAVE_DUMP = []
        try:
            pt_trace_pass(self.cfg, self._slot_scene(), self.bvh, cam, cam,
                          self._pix[:n], self._vp[:n],
                          torch.zeros(n, dtype=torch.int64,
                                      device=self.device))
            waves = pt._WAVE_DUMP
        finally:
            pt._WAVE_DUMP = None
        return waves

    def _render_device(self) -> torch.Tensor:
        cfg = self.cfg
        cam = to_camera_uniforms(
            self.arrays.camera_uniforms(self.viewports()), self.device)
        prev_cam = self._prev_cam if self._prev_cam is not None else cam
        scene = self._slot_scene()
        n_passes = self.samples_per_pixel // self.samples_per_pass
        sample_base = self.samples_accumulated
        n_chunks = self._pix.shape[0] // self.rays_per_call
        color = None
        gchunks = []
        useful = None
        for p in range(n_passes):
            prev = sample_base + p * self.samples_per_pass
            chunks = []
            for c in range(n_chunks):
                s = slice(c * self.rays_per_call, (c + 1) * self.rays_per_call)
                prev_arr = torch.full((self.rays_per_call,), prev,
                                      dtype=torch.int64, device=self.device)
                out = pt_trace_pass(cfg, scene, self.bvh, cam, prev_cam,
                                    self._pix[s], self._vp[s], prev_arr)
                chunks.append(out.color)
                if out.useful_rays is not None:
                    useful = out.useful_rays if useful is None \
                        else useful + out.useful_rays
                if self.use_post and p == n_passes - 1:
                    gchunks.append(out)
            pass_color = torch.cat(chunks)[:self._n_rays]
            if color is None and sample_base == 0 and p == 0:
                color = pass_color
            else:
                base = self.accum_color if p == 0 else color
                color = accumulate(pass_color, base,
                                   float(self.samples_per_pass),
                                   float(sample_base +
                                         p * self.samples_per_pass))
                check_nan(cfg.validate, "accumulation", color)
        self.accum_color = color
        self.samples_accumulated = sample_base + self.samples_per_pixel
        self.last_useful_rays = useful        # device scalar or None
        self._prev_cam = cam
        self.frame_counter += 1
        # accumulation stays in ray order; outputs un-permute to scanline
        if self._ray_unorder is not None:
            color = color[self._ray_unorder]
        V, H, W = cfg.n_views, cfg.height, cfg.width
        if not self.use_post:
            img = tonemap(color.reshape(V, H, W, 4), self.opt.tonemap,
                          self.opt.exposure, self.opt.gamma)
            check_nan(cfg.validate, "tonemap", img)
            return img
        img = self._post_process(color, gchunks, cam)
        check_nan(cfg.validate, "post processing", img)
        return img

    def _gbuffer_field(self, gchunks, field: str):
        """One first-hit field of the last pass, (AV, H, W, C) in
        scanline order."""
        cfg = self.cfg
        x = torch.cat([getattr(o, field) for o in gchunks])[:self._n_rays]
        if self._ray_unorder is not None:
            x = x[self._ray_unorder]
        return x.reshape(len(self.active_views), cfg.height, cfg.width, -1)

    def _post_process(self, color, gchunks, cam) -> torch.Tensor:
        """The G-buffer of the last pass, the spatial reprojection of the
        inactive views, then the post-processing pipeline."""
        V, H, W = self.cfg.n_views, self.cfg.height, self.cfg.width
        AV = len(self.active_views)
        act = torch.tensor(self.active_views, device=self.device)

        def cat(field):
            x = self._gbuffer_field(gchunks, field)
            if AV == V:
                return x
            full = x.new_zeros((V,) + x.shape[1:])
            full[act] = x
            return full
        pos = cat("first_pos")
        view_z = torch.einsum("vhwj,vj->vhw", pos, cam.view[:, 2, :3]) + \
            cam.view[:, 2, 3][:, None, None]
        if self.use_spatial_reproj:
            # fill inactive viewports from the rendered ones
            from ..stages.temporal import spatial_reprojection
            color_av = color.reshape(AV, H, W, 4)
            pos_av = self._gbuffer_field(gchunks, "first_pos")
            valid_av = self._gbuffer_field(gchunks, "first_instance")[
                ..., 0] >= 0
            color_full = color.new_zeros((V, H, W, 4))
            color_full[act] = color_av
            for v in range(V):
                if v not in self.active_views:
                    color_full[v] = spatial_reprojection(
                        cam.view_proj[v], color_av, pos_av, valid_av)[0]
            color = color_full
        gbuf = dict(
            color=color.reshape(V, H, W, 4),
            diffuse=cat("diffuse"),
            reflection=cat("reflection"),
            albedo=cat("first_albedo"),
            normal=cat("first_normal"),
            pos=pos,
            screen_motion=cat("first_screen_motion"),
            metallic_roughness=cat("first_metallic_roughness"),
            emission=cat("first_emission"),
            view_z=-view_z)
        return self.post.process(gbuf, cam_origin=cam.origin.cpu().numpy())
