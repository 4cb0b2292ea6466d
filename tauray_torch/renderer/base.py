"""Renderer interface (reference: src/renderer.hh:9-20); the torch
counterpart of tauray_tpu.renderer.base. A renderer holds an explicit
torch.device and keeps frames on it until they are written."""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import tracing
from ..scene.arrays import SceneArrays
from ..scene.camera import Camera
from ..scene.scene import Scene
from ..scene.transformable import Transformable


class Renderer:
    def __init__(self, opt, device):
        self.opt = opt
        self.device = torch.device(device)
        self.scene: Optional[Scene] = None
        self.arrays: Optional[SceneArrays] = None

    def set_scene(self, scene: Scene):
        self.scene = scene
        self.arrays = SceneArrays(scene, self.opt)
        self._geom_static = None
        self._scene_changed()

    def _scene_changed(self):
        pass

    def device_update_frame(self, bvh, perm):
        """Per-frame scene refresh with skinning and world transforms on
        the device (reference: scene_stage dispatching skinning.comp +
        pre_transform.comp each frame, src/scene_stage.cc:1543,1685). The
        host walks the transform hierarchy and packs the (tiny) light
        tables only. Replaces self.device_scene and returns the refit
        tracer (for the instanced tracer, new instance transforms
        only)."""
        from ..ops.cluster import (InstancedClusterTracer,
                                   refit_cluster_tracer,
                                   refit_instanced_tracer)
        from ..scene.device_update import (apply_frame_update,
                                           build_geom_static,
                                           host_frame_inputs,
                                           update_geometry)
        if self._geom_static is None:
            self._geom_static, self._has_skin = build_geom_static(
                self.arrays, self.device)
            self._prev_geom = None
        self.arrays._update_lights()
        models, normals, joints = host_frame_inputs(self.arrays)
        g = update_geometry(
            self._geom_static, *(torch.from_numpy(x).to(self.device)
                                 for x in (models, normals, joints)),
            self._has_skin)
        self.device_scene = apply_frame_update(
            self.device_scene, self._geom_static, g, self._prev_geom,
            self.arrays)
        self._prev_geom = g
        if isinstance(bvh, InstancedClusterTracer):
            return refit_instanced_tracer(bvh, models)
        return refit_cluster_tracer(bvh, g.tri_pos, perm)

    def host_update_frame(self, bvh, perm):
        """Per-frame scene refresh on the host: transform hierarchy and
        lights in numpy, a fresh device scene, and a cluster refit (for
        the instanced tracer, new instance transforms only). No entry
        point calls it: it is the reference the tests hold
        device_update_frame to."""
        from ..ops.cluster import (InstancedClusterTracer,
                                   refit_cluster_tracer,
                                   refit_instanced_tracer)
        from ..scene.device import to_device_scene
        self.arrays.update(keep_prev=True)
        self.device_scene = to_device_scene(
            self.arrays, self.opt.transparent_background, self.device)
        if isinstance(bvh, InstancedClusterTracer):
            return refit_instanced_tracer(bvh, self.arrays.inst_model)
        return refit_cluster_tracer(bvh, self.arrays.tri_pos, perm)

    def viewports(self) -> List[Tuple[Camera, Transformable]]:
        cams = [(e.camera, e.transform) for e in self.scene.entities
                if e.camera is not None and e.camera_enabled]
        if not cams:
            raise RuntimeError("No enabled camera in scene")
        return cams

    def render_device(self) -> torch.Tensor:
        """Renders the current frame as a (V, H, W, 4) float32 tensor on
        the renderer's device (no host readback), as one `frame` span."""
        with tracing.span("frame", self.device):
            return self._render_device()

    def _render_device(self) -> torch.Tensor:
        raise NotImplementedError

    def render(self) -> np.ndarray:
        """Returns (V, H, W, 4) float32 for the current frame (host)."""
        return self.render_device().cpu().numpy()

    def reset_accumulation(self, keep_samples: bool = False):
        pass

    def set_device_workloads(self, ratios: List[float]):
        """Per-device workload ratios from the load balancer
        (parallel/load_balancer.py); one-device renderers ignore them."""

    def get_timing(self):
        """{(device, stage): seconds} of the newest frame the process's
        tracing record has read ({} while it is off). The record is the
        process's, not this renderer's: the frame is the newest outermost
        `frame` span of any renderer, with the stages of every renderer
        nested in it, and where several renderers take turns in one
        process it may be another's."""
        return tracing.timing()
