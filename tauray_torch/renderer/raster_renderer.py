"""Raster renderer (reference: src/raster_renderer.cc: shadow maps ->
z-pass -> forward raster -> post-processing); the torch counterpart of
tauray_tpu.renderer.raster_renderer on one device.

Every wave (the shadow maps, the camera pass, MSAA coverage, the
alpha-blend layer) goes through the flat cluster tracer, which returns
original triangle ids. The maps are built at set_scene and rebuilt by
every update_frame."""

from __future__ import annotations

import numpy as np
import torch

from .. import tracing
from ..ops.brdf_lut import load_brdf_lut
from ..ops.cluster import build_cluster_tracer, tri_opacity
from ..scene.device import to_camera_uniforms, to_device_scene
from ..stages.raster import (MSAA_LOCATIONS, raster_background,
                             raster_coverage, render_raster)
from ..stages.shadow_map import build_shadow_maps
from ..stages.tonemap import tonemap
from .base import Renderer
from .post_processing import PostProcessingPipeline


class FlatTracerHost(Renderer):
    """A scene on the device and the flat cluster tracer over it (original
    triangle ids), updated on the device by update_frame: what the raster
    draw and the probe bake trace against."""

    def _scene_changed(self):
        self.device_scene = to_device_scene(
            self.arrays, self.opt.transparent_background, self.device)
        self.bvh, self._perm = build_cluster_tracer(
            self.arrays.tri_pos, self.arrays.tri_instance,
            tri_opaque=tri_opacity(self.arrays.tri_instance,
                                   self.arrays.inst_has_alpha),
            strategy=self.opt.as_strategy,
            inst_dynamic=self.arrays.inst_dynamic,
            inst_entity=self.arrays.inst_entity, device=self.device)

    def update_frame(self):
        self.bvh = self.device_update_frame(self.bvh, self._perm)


class RasterRenderer(FlatTracerHost):
    def __init__(self, opt, device, sh_source=None):
        super().__init__(opt, device)
        self._prev_cam = None
        self.sh_source = sh_source  # SHRenderer, DSHGIClient or None
        self.last_gbuf = None

    def _scene_changed(self):
        super()._scene_changed()
        opt = self.opt
        self._prev_cam = None
        self.post = PostProcessingPipeline(opt, opt.width, opt.height,
                                           len(self.viewports()),
                                           self.device)
        self._build_shadow_maps()

    def _build_shadow_maps(self):
        center = self.arrays.tri_pos.reshape(-1, 3).mean(axis=0)
        # cascades center on the mean camera position (reference:
        # shadow_map.cc track_cameras)
        cam_pos = np.mean([np.asarray(t.get_global_position(), np.float32)
                           for _, t in self.viewports()], axis=0)
        with tracing.span("shadow_maps"):
            self.shadow_maps = build_shadow_maps(
                self.arrays, self.bvh, self.opt, center,
                device_scene=self.device_scene, cam_pos=cam_pos)
        self.map_table = light_map_table(self.shadow_maps, self.arrays,
                                         self.device)

    def update_frame(self):
        super().update_frame()
        self._build_shadow_maps()

    def _sh_data(self):
        if self.sh_source is None:
            return None
        return self.sh_source.current_grid_data()

    def _render_device(self) -> torch.Tensor:
        opt = self.opt
        dev = self.device
        if self.sh_source is not None:
            with tracing.span("sh_bake"):
                self.sh_source.step(self)
        vps = self.viewports()
        V = len(vps)
        cam = to_camera_uniforms(self.arrays.camera_uniforms(vps), dev)
        prev_cam = self._prev_cam if self._prev_cam is not None else cam
        sh = self._sh_data()
        has_alpha = self.arrays.any_alpha_materials
        has_env = self.arrays.environment_map is not None

        def run_pass(sample_offset=None):
            with tracing.span("raster_draw"):
                return render_raster(
                    self.device_scene, self.bvh, cam, prev_cam,
                    self.shadow_maps, self.map_table, sh, load_brdf_lut(dev),
                    opt.width, opt.height, V,
                    np.asarray(opt.ambient, np.float32), opt.min_ray_dist,
                    self.shadow_maps is not None, opt.pcf, has_alpha,
                    opt.sh_order, sh is not None, has_env,
                    getattr(self.arrays, "any_blend_materials", False),
                    int(opt.pcss), float(opt.pcss_minimum_radius),
                    bool(opt.use_probe_visibility), sample_offset,
                    max(int(opt.shadow_map_cascades), 1))

        def offset(lx, ly):
            return torch.tensor([lx * 2 - 1, ly * 2 - 1],
                                dtype=torch.float32, device=dev)

        # MSAA (reference: rr_opt.msaa_samples = opt.samples_per_pixel,
        # src/tauray.cc:571): the sample count from --samples-per-pixel at
        # the Vulkan standard sample locations. --sample-shading shades
        # every sample (supersampling); otherwise shading stays per pixel
        # and the samples only resolve geometric coverage against the
        # background, like MSAA's edge-only antialiasing.
        # --tonemap-post-resolve moves the tonemap after the resolve
        # (tonemap_stage.cc POST_RESOLVE).
        S = opt.samples_per_pixel if opt.samples_per_pixel in (2, 4, 8, 16) \
            else 1

        def tm(img):
            return tonemap(img, opt.tonemap, opt.exposure, opt.gamma)

        if S > 1 and opt.sample_shading:
            acc = None
            gbuf = None
            for lx, ly in MSAA_LOCATIONS[S]:
                g = run_pass(offset(lx, ly))
                if gbuf is None:
                    gbuf = g
                c = g["color"] if opt.tonemap_post_resolve else tm(g["color"])
                acc = c if acc is None else acc + c
            resolved = acc / S
            if opt.tonemap_post_resolve:
                resolved = tm(resolved)
            gbuf["color"] = resolved
            tonemapped = True
        elif S > 1:
            gbuf = run_pass()
            cov = torch.zeros(gbuf["color"].shape[:3], device=dev)
            with tracing.span("raster_draw"):
                for lx, ly in MSAA_LOCATIONS[S]:
                    cov = cov + raster_coverage(
                        self.device_scene, self.bvh, cam, offset(lx, ly),
                        opt.width, opt.height, V, opt.min_ray_dist,
                        has_alpha)
                cov = cov / S
                # per-pixel shading + per-sample coverage: the shaded
                # surface blended against the skybox along silhouettes
                # (pixels whose centre ray missed keep the background,
                # with alpha from the coverage)
                bg = raster_background(self.device_scene, cam, opt.width,
                                       opt.height, V, has_env)
            center_hit = gbuf["color"][..., 3] > 0
            surf = gbuf["color"][..., :3]
            if not opt.tonemap_post_resolve:
                surf = tm(gbuf["color"])[..., :3]
                bg = tm(torch.cat([bg, torch.ones_like(bg[..., :1])],
                                  -1))[..., :3]
                tonemapped = True
            else:
                tonemapped = False
            col = torch.where(center_hit[..., None],
                              cov[..., None] * surf +
                              (1 - cov[..., None]) * bg, bg)
            gbuf["color"] = torch.cat([col, cov[..., None]], -1)
        else:
            gbuf = run_pass()
            tonemapped = False

        self._prev_cam = cam
        self.last_gbuf = gbuf
        post = self.post
        if post.use_svgf or post.use_bmfr or post.use_taa or \
                post.use_temporal_reprojection:
            return post.process(gbuf, cam_origin=cam.origin.cpu().numpy())
        if not tonemapped:
            return tm(gbuf["color"])
        return gbuf["color"]


def light_map_table(maps, arrays, device):
    """The host's light -> map table: (directional light -> its first
    map, point light -> its first map, point light -> its map count), each
    an int32 tensor on `device`."""
    if maps is None:
        return (torch.zeros(1, dtype=torch.int32, device=device),
                torch.zeros(1, dtype=torch.int32, device=device),
                torch.ones(1, dtype=torch.int32, device=device))
    idx = maps.light_index.cpu().numpy()
    dir_ids = np.zeros(max(arrays.dir_count, 1), np.int32)
    for i in range(arrays.dir_count):
        m = np.nonzero(idx == -(i + 1))[0]
        dir_ids[i] = m[0] if len(m) else 0
    pt_base = np.zeros(max(arrays.point_count, 1), np.int32)
    pt_nfaces = np.ones(max(arrays.point_count, 1), np.int32)
    for i in range(arrays.point_count):
        m = np.nonzero(idx == i)[0]
        if len(m):
            pt_base[i] = m[0]
            pt_nfaces[i] = len(m)
    return tuple(torch.from_numpy(x).to(device)
                 for x in (dir_ids, pt_base, pt_nfaces))
