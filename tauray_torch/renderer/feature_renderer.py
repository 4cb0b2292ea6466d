"""AOV renderer; the torch counterpart of
tauray_tpu.renderer.feature_renderer (reference: feature_renderer =
rt_renderer<feature_stage>, src/rt_renderer.hh:76)."""

from __future__ import annotations

from ..ops.cluster import build_cluster_tracer, tri_opacity
from ..scene.device import to_camera_uniforms, to_device_scene
from ..stages.feature import render_feature
from ..stages.tonemap import tonemap
from .base import Renderer


class FeatureRenderer(Renderer):
    def __init__(self, opt, device, feature: str):
        super().__init__(opt, device)
        self.feature = feature
        self._prev_cam = None

    def _scene_changed(self):
        self.device_scene = to_device_scene(
            self.arrays, self.opt.transparent_background, self.device)
        # no slot_ids: traces return original triangle ids, and the scene
        # tables stay in original order
        self.bvh, self._perm = build_cluster_tracer(
            self.arrays.tri_pos, self.arrays.tri_instance,
            tri_opaque=tri_opacity(self.arrays.tri_instance,
                                   self.arrays.inst_has_alpha),
            strategy=self.opt.as_strategy,
            inst_dynamic=self.arrays.inst_dynamic,
            inst_entity=self.arrays.inst_entity, device=self.device)
        self._prev_cam = None

    def update_frame(self):
        """Per-frame scene refresh (animation / camera movement)."""
        self.bvh = self.device_update_frame(self.bvh, self._perm)

    def _render_device(self):
        vps = self.viewports()
        cam = to_camera_uniforms(self.arrays.camera_uniforms(vps),
                                 self.device)
        prev_cam = self._prev_cam if self._prev_cam is not None else cam
        img = render_feature(
            self.device_scene, self.bvh, cam, prev_cam,
            self.feature, self.opt.width, self.opt.height, len(vps),
            float(self.opt.default_value), float(self.opt.min_ray_dist),
            self.arrays.any_alpha_materials)
        # feature outputs are linear: the default filmic operator would
        # destroy AOV values (the reference goldens,
        # test/references/validate_*.exr, are linear)
        op = self.opt.tonemap
        if op == "filmic":
            op = "linear"
        img = tonemap(img, op, self.opt.exposure, self.opt.gamma)
        self._prev_cam = cam
        return img
