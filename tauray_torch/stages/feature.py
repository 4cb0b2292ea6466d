"""Feature/AOV stage; the torch counterpart of tauray_tpu.stages.feature
(reference: src/feature_stage.cc, shader/rt_feature.rgen/.rchit/.rmiss).

Renders albedo / normals / positions / distance / motion / instance-id
buffers with one primary ray per pixel centre (no AA offset)."""

from __future__ import annotations

import torch

from ..ops.shading import (get_camera_projection, get_screen_camera_ray,
                           interpolate_vertex, sample_material)
from ..ops.trace_utils import trace_alpha
from ..scene.device import CameraUniforms, DeviceScene

FEATURES = ("albedo", "world-normal", "view-normal", "world-pos", "view-pos",
            "distance", "world-motion", "view-motion", "screen-motion",
            "instance-id")


def trace_pixels(scene: DeviceScene, tracer, cam: CameraUniforms, vp,
                 pix, size, min_ray_dist: float, has_alpha: bool = False):
    """One primary ray through each pixel centre pix (R, 2) int of
    viewports vp (R,) on a screen of size (2,) = (W, H). Returns (hit,
    ray directions). The tracer must return original triangle ids (no
    slot_ids)."""
    R = pix.shape[0]
    origin, d = get_screen_camera_ray(cam, vp.long(), pix, size)
    # alpha cutoff 1e-4 matches the feature any-hit shader (reference:
    # shader/rt_feature.rahit is_material_skippable(.., 0.0001))
    hit = trace_alpha(scene, tracer, origin, d,
                      torch.full((R,), min_ray_dist, dtype=torch.float32,
                                 device=d.device),
                      torch.full((R,), float("inf"), dtype=torch.float32,
                                 device=d.device),
                      1e-4, has_alpha)
    return hit, d


def feature_values(scene: DeviceScene, cam: CameraUniforms,
                   prev_cam: CameraUniforms, feature: str, vp, hit, d,
                   default_value: float) -> torch.Tensor:
    """(R, 4) values of `feature` at the hits of trace_pixels."""
    if feature not in FEATURES:
        raise ValueError(f"unknown feature {feature}")
    R = d.shape[0]
    vp = vp.long()
    miss = hit.tri_id < 0

    v = interpolate_vertex(scene, hit.tri_id, hit.u, hit.v, d)
    mat, v = sample_material(scene, v)

    view = cam.view[vp]
    prev_view = prev_cam.view[vp]

    def viewt(m, p):
        return torch.einsum("rij,rj->ri", m[:, :3, :3], p) + m[:, :3, 3]

    def viewd(m, p):
        return torch.einsum("rij,rj->ri", m[:, :3, :3], p)

    def one(x):
        return torch.cat([x, torch.ones_like(x[:, :1])], dim=-1)

    if feature == "albedo":
        out = mat.albedo
    elif feature == "world-normal":
        out = one(v.mapped_normal)
    elif feature == "view-normal":
        out = one(viewd(view, v.mapped_normal))
    elif feature == "world-pos":
        out = one(v.pos)
    elif feature == "view-pos":
        out = one(viewt(view, v.pos))
    elif feature == "distance":
        out = one(hit.t[:, None].expand(R, 3))
    elif feature == "world-motion":
        out = one(v.pos - v.prev_pos)
    elif feature == "view-motion":
        out = one(viewt(view, v.pos) - viewt(prev_view, v.prev_pos))
    elif feature == "screen-motion":
        out = one(get_camera_projection(prev_cam, vp, v.prev_pos))
    else:                                               # instance-id
        out = one(torch.stack([v.instance_id.to(torch.float32),
                               v.primitive_id.to(torch.float32),
                               torch.zeros_like(hit.t)], dim=-1))
    return torch.where(miss[:, None], float(default_value), out)


def render_feature(scene: DeviceScene, tracer, cam: CameraUniforms,
                   prev_cam: CameraUniforms, feature: str, width: int,
                   height: int, n_views: int, default_value: float,
                   min_ray_dist: float, has_alpha: bool = False
                   ) -> torch.Tensor:
    """Returns the (V, H, W, 4) AOV image."""
    V, H, W = n_views, height, width
    dev = scene.tri_packed.device
    ys, xs = torch.meshgrid(torch.arange(H, device=dev),
                            torch.arange(W, device=dev), indexing="ij")
    pix = torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=-1).repeat(V, 1)
    vp = torch.arange(V, device=dev).repeat_interleave(H * W)
    size = torch.tensor([W, H], dtype=torch.float32, device=dev)
    hit, d = trace_pixels(scene, tracer, cam, vp, pix, size, min_ray_dist,
                          has_alpha)
    out = feature_values(scene, cam, prev_cam, feature, vp, hit, d,
                         default_value)
    return out.reshape(V, H, W, 4)
