"""Shadow map generation and PCF/PCSS filtering (reference:
src/shadow_map_stage.cc, src/shadow_map.cc, src/scene_stage.cc
update_shadow_map_params, shader/shadow_mapping.glsl, src/atlas.cc); the
torch counterpart of tauray_tpu.stages.shadow_map.

The depth maps come from the cluster tracer that traces everything else
(one wave of resolution^2 rays per map), stored as a stacked tensor (the
analogue of the reference's shadow-map atlas) holding AXIAL linear depth
along the light's forward axis. Filtering mirrors the reference:

  * 64-tap Poisson-disk PCF with a per-pixel rotation, from the
    reference's sample table (shader/poisson_samples_2d.glsl) and its
    tiled (cos, sin) noise texture (data/noise_vector_2d.exr, sampled at
    mod(screen_coord, size), shader/shadow_mapping.glsl pcf_2d_*); a
    pcg-hash rotation when the asset is unavailable;
  * bilinear COMPARISON filtering per tap (a sampler2DShadow: the
    pass/fail results are bilinearly blended);
  * the PCSS blocker search sizing the penumbra from the light's world
    radius (calc_perspective_pcss_radius / calc_directional_pcss_radius);
  * biases: perspective maps scale linear depth by (1 - bias), directional
    maps subtract the bias in depth, with the min/max biases of
    auto_assign_shadow_maps (src/tauray.cc:441-454).
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import tracing
from .. import reference_data
from ..ops.sampling import xla_int32
from ..ops.shading import _mv


class ShadowMaps(NamedTuple):
    depth: torch.Tensor      # (L, Res, Res) AXIAL linear depth
    view: torch.Tensor       # (L, 4, 4) world -> light space (-z forward)
    proj_kind: torch.Tensor  # (L,) 0 = ortho (directional), 1 = perspective
    params: torch.Tensor     # (L, 4): ortho (rx, ry, near, far) /
    #                                  persp (tan_half_fov, _, near, far)
    light_index: torch.Tensor  # (L,) point-light index; -(i+1) = dir i
    min_bias: torch.Tensor   # (L,)
    max_bias: torch.Tensor   # (L,)
    pcf_radius: torch.Tensor  # (L, 2): the reference's sm.radius
    cascade_count: torch.Tensor  # (L,) cascades remaining from this layer
    #   (directional layer k of an n-cascade group stores n - k; spot and
    #    cube-face layers store 1)
    resolution: int


def _look_at(origin, direction):
    """Light view matrix (world -> light space, -z forward)."""
    f = -np.asarray(direction, np.float32)
    f = f / np.linalg.norm(f)
    up = np.array([0, 1, 0], np.float32)
    if abs(np.dot(up, f)) > 0.99:
        up = np.array([1, 0, 0], np.float32)
    s = np.cross(up, f)
    s /= np.linalg.norm(s)
    u = np.cross(f, s)
    m = np.eye(4, dtype=np.float32)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = f
    m[:3, 3] = -m[:3, :3] @ np.asarray(origin, np.float32)
    return m


def map_layout(arrays, opt, scene_center=None, cam_pos=None):
    """Every map's view, projection kind, params, light index, biases,
    PCF radius and cascade count (numpy), in build order: each
    directional light's cascades, then each point light's spot map or 6
    cube faces (+x, -x, +y, -y, +z, -z). None when no light casts."""
    res = min(opt.shadow_map_resolution, 2048)
    views, kinds, params, lidx = [], [], [], []
    min_biases, max_biases, radii, casc = [], [], [], []
    center = (np.zeros(3, np.float32) if scene_center is None
              else np.asarray(scene_center, np.float32))

    area_size = 2.0 * opt.shadow_map_radius
    ncasc = max(int(getattr(opt, "shadow_map_cascades", 1) or 1), 1)
    for i in range(arrays.dir_count):
        d = arrays.dl_dir[i]
        origin = center - d * opt.shadow_map_depth * 0.5
        base_view = _look_at(origin, d)
        # cascades center on the mean camera position in light space
        # (reference: shadow_map.cc track_cameras cam_light_pos), each
        # level covering 2x the previous area, offsets snapped to the
        # level's texel grid (scene_stage.cc align_cascade)
        if cam_pos is not None:
            cl = base_view[:3, :3] @ np.asarray(cam_pos, np.float32) + \
                base_view[:3, 3]
            cam_xy = cl[:2]
        else:
            cam_xy = np.zeros(2, np.float32)
        ang = math.acos(min(max(float(arrays.dl_dir_cutoff[i]), -1), 1))
        for k in range(ncasc):
            scale = 2.0 ** k
            step = (area_size * scale) / res
            off = np.round(cam_xy / step) * step
            view = base_view.copy()
            view[0, 3] -= off[0]
            view[1, 3] -= off[1]
            views.append(view)
            kinds.append(0)
            params.append([opt.shadow_map_radius * scale,
                           opt.shadow_map_radius * scale,
                           0.0, opt.shadow_map_depth])
            lidx.append(-1 - i)
            # directional biases are depth-range independent
            # (scene_stage.cc:521 bias_scale = 20/|range| with range =
            # 2*depth, applied in [-1,1] NDC): in world units bias * 10.
            # Cascade k scales the bias by sqrt(2^k) (scene_stage.cc:559)
            bs = math.sqrt(scale)
            min_biases.append(opt.shadow_map_bias / 5.0 * 10.0 * bs)
            max_biases.append(opt.shadow_map_bias * 10.0 * bs)
            # sun angular radius -> PCF radius in uv (scene_stage.cc:527
            # tan(radians(angle))/area_size)
            radii.append([math.tan(ang) / max(area_size * scale,
                                              1e-6)] * 2)
            casc.append(ncasc - k)

    for i in range(arrays.point_count):
        near = 0.01
        far = max(float(arrays.pl_cutoff_radius[i]), 1e-2)
        if arrays.pl_spot_radius[i] >= 0:  # spotlight
            cutoff = float(arrays.pl_dir_cutoff[i])
            half = math.acos(min(max(cutoff, -1), 1))
            views.append(_look_at(arrays.pl_pos[i], arrays.pl_dir[i]))
            kinds.append(1)
            params.append([math.tan(max(half, 1e-3)), 0.0, near, far])
            lidx.append(i)
            min_biases.append(0.005)
            max_biases.append(opt.shadow_map_bias * 2)
            radii.append([float(arrays.pl_radius[i])] * 2)
            casc.append(1)
        else:  # omni point light: 6 cube faces
            dirs = [(1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0),
                    (0, 0, 1), (0, 0, -1)]
            for d in dirs:
                views.append(_look_at(arrays.pl_pos[i],
                                      np.array(d, np.float32)))
                kinds.append(1)
                params.append([1.0, 0.0, near, far])  # 90 deg faces
                lidx.append(i)
                min_biases.append(0.005)
                max_biases.append(opt.shadow_map_bias * 2)
                radii.append([float(arrays.pl_radius[i])] * 2)
                casc.append(1)
    if not views:
        return None
    return dict(resolution=res, view=np.stack(views),
                proj_kind=np.array(kinds, np.int32),
                params=np.array(params, np.float32),
                light_index=np.array(lidx, np.int32),
                min_bias=np.array(min_biases, np.float32),
                max_bias=np.array(max_biases, np.float32),
                pcf_radius=np.array(radii, np.float32),
                cascade_count=np.array(casc, np.int32))


def map_rays(view, kind: int, prm, res: int, device):
    """One map's wave, res^2 rays in texel row order: origins and
    directions (R, 3) float32 and the axial factor (R,) that turns a hit
    distance into axial depth. Computed in float64 and rounded once, as
    tauray_tpu's numpy does; the norm and the 3x3 products are written
    out as single operations, so every device rounds them alike."""
    f64 = torch.float64
    inv_view = np.linalg.inv(view)
    idx = torch.arange(res, dtype=f64, device=device)
    u = ((idx + 0.5) / res * 2 - 1).repeat(res)
    v = ((idx + 0.5) / res * 2 - 1).repeat_interleave(res)
    rot = torch.from_numpy(inv_view[:3, :3].astype(np.float64)).to(device)
    tr = torch.from_numpy(inv_view[:3, 3].astype(np.float64)).to(device)

    def xform(p):
        return (p[:, 0:1] * rot[:, 0] + p[:, 1:2] * rot[:, 1] +
                p[:, 2:3] * rot[:, 2])
    R = res * res
    if kind == 0:
        o_local = torch.stack([u * float(prm[0]), -v * float(prm[1]),
                               torch.zeros_like(u)], -1)
        # one direction for the whole wave (a float32 product, as numpy's)
        d = inv_view[:3, :3] @ np.array([0, 0, -1.0], np.float32)
        d = torch.from_numpy(d.astype(np.float32)).to(device).expand(R, 3)
        axial = torch.ones(R, dtype=torch.float32, device=device)
        o = (xform(o_local) + tr).to(torch.float32)
    else:
        t = float(prm[0])
        d_local = torch.stack([u * t, -v * t, -torch.ones_like(u)], -1)
        norm = torch.sqrt(d_local[:, 0:1] * d_local[:, 0:1] +
                          d_local[:, 1:2] * d_local[:, 1:2] +
                          d_local[:, 2:3] * d_local[:, 2:3])
        d_local = d_local / norm
        # AXIAL depth: radial hit distance * cos(angle to the axis)
        axial = (-d_local[:, 2]).to(torch.float32)
        d = xform(d_local).to(torch.float32)
        o = tr.to(torch.float32).expand(R, 3)
    return o.contiguous(), d.contiguous(), axial


def build_shadow_maps(arrays, tracer, opt, scene_center=None,
                      device_scene=None,
                      cam_pos=None) -> Optional[ShadowMaps]:
    """Ray-cast depth maps of every shadow-casting light, one wave of
    min(--shadow-map-resolution, 2048)^2 rays per map, on the tracer's
    device. Bias defaults mirror auto_assign_shadow_maps (reference:
    src/tauray.cc:441-454).

    Potentially transparent materials cast shadows only where their
    alpha >= 0.5, as the reference's shadow_map.frag discard (alpha_clip
    = 0.5, src/shadow_map_stage.cc:214-215, src/material.cc:7-11): pass
    `device_scene` to trace those scenes through the alpha test."""
    lay = map_layout(arrays, opt, scene_center, cam_pos)
    if lay is None:
        return None
    dev = tracer.device
    res = lay["resolution"]
    R = res * res
    alpha = device_scene is not None and \
        bool(getattr(arrays, "any_alpha_materials", False))
    depths = []
    for li in range(len(lay["view"])):
        prm = lay["params"][li]
        o, d, axial = map_rays(lay["view"][li], int(lay["proj_kind"][li]),
                               prm, res, dev)
        t_min = torch.zeros(R, dtype=torch.float32, device=dev)
        t_max = torch.full((R,), float(prm[3]), dtype=torch.float32,
                           device=dev)
        if alpha:
            from ..ops.trace_utils import trace_alpha
            hit = trace_alpha(device_scene, tracer, o, d, t_min, t_max,
                              torch.full((R,), 0.5, device=dev), True)
        else:
            hit = tracer.trace(o, d, t_min, t_max, need_uv=False)
        depth = torch.where(hit.tri_id >= 0, hit.t * axial, float(prm[3]))
        depths.append(depth.reshape(res, res))

    def t(name):
        return torch.from_numpy(lay[name]).to(dev)
    return ShadowMaps(
        depth=torch.stack(depths), view=t("view"),
        proj_kind=t("proj_kind"), params=t("params"),
        light_index=t("light_index"), min_bias=t("min_bias"),
        max_bias=t("max_bias"), pcf_radius=t("pcf_radius"),
        cascade_count=t("cascade_count"), resolution=res)


# The reference's fixed 64-sample Poisson disk (data table from
# shader/poisson_samples_2d.glsl:9-46).
_POISSON64 = np.array([
    [-0.695065, -0.317671], [0.910942, 0.412491],
    [-0.303778, 0.952665], [0.518187, -0.854809],
    [0.064410, 0.143302], [-0.897262, 0.440243],
    [-0.256688, -0.966451], [0.406177, 0.913495],
    [0.955344, -0.295435], [0.065461, -0.458306],
    [-0.372877, 0.432738], [0.564884, 0.035607],
    [0.057368, 0.607356], [-0.272403, -0.158090],
    [0.510804, -0.407973], [-0.999315, 0.007125],
    [-0.649618, -0.759558], [0.474175, 0.466568],
    [-0.598217, 0.090578], [-0.652515, 0.756754],
    [0.142136, -0.989197], [-0.317785, -0.548586],
    [0.054322, 0.991461], [0.991411, 0.062224],
    [0.258940, -0.155479], [0.796365, -0.604791],
    [0.685861, 0.727529], [-0.245210, 0.150298],
    [0.251747, -0.702386], [-0.051031, -0.741023],
    [-0.221569, 0.677006], [0.341205, 0.213390],
    [0.696124, -0.205655], [-0.086215, 0.373800],
    [-0.963839, -0.264658], [-0.831231, -0.555220],
    [-0.636080, 0.360776], [0.673304, 0.283633],
    [-0.006615, -0.198311], [0.310994, 0.670550],
    [-0.829011, 0.195663], [-0.447090, -0.334952],
    [0.160887, 0.382701], [-0.771199, -0.084460],
    [-0.406718, -0.774974], [-0.585245, -0.529782],
    [-0.156756, -0.378295], [0.567336, -0.630606],
    [-0.449549, 0.649124], [0.282586, -0.384085],
    [-0.495726, -0.112737], [0.706657, 0.504904],
    [0.478992, -0.167310], [0.781413, -0.002990],
    [-0.043730, 0.799185], [-0.094402, -0.002422],
    [-0.719609, 0.555853], [-0.441099, 0.232549],
    [0.207514, 0.851013], [0.774662, -0.398131],
    [-0.055589, -0.943590], [0.319790, -0.893468],
    [-0.488119, 0.872496], [0.863541, 0.217313]], np.float32)


_NOISE_2D = None
_NOISE_2D_TRIED = False


def _load_noise_2d():
    """The reference's tiled PCF rotation-noise texture
    (data/noise_vector_2d.exr, unit (cos, sin) vectors; sampled by
    scene_stage.cc:301 and shadow_mapping.glsl:203-207), read once from
    TAURAY_NOISE_2D, else from the reference checkout that
    TAURAY_REFERENCE_DIR names. Returns ((H*W, 2) float32 rows, (H, W)),
    or None when the asset is unavailable (pcf_visibility then takes the
    hash rotation)."""
    global _NOISE_2D, _NOISE_2D_TRIED
    if _NOISE_2D_TRIED:
        return _NOISE_2D
    _NOISE_2D_TRIED = True
    path = os.environ.get("TAURAY_NOISE_2D") or \
        reference_data("noise_vector_2d.exr")
    if path is None:
        return None
    try:
        from ..io.exr import read_rgb
        img = np.asarray(read_rgb(path))
        H, W = img.shape[:2]
        _NOISE_2D = (np.ascontiguousarray(img[..., :2].reshape(-1, 2),
                                          np.float32), (H, W))
    except Exception:
        _NOISE_2D = None
    return _NOISE_2D


def _bilinear_compare(depth_flat, base, x, y, z_cmp, res):
    """Bilinear blend of the 4 per-texel (z_cmp <= stored) results (a
    sampler2DShadow's linear filtering). depth_flat: the maps flattened;
    base: (R,) first texel of each ray's map."""
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = xla_int32(x0)
    y0i = xla_int32(y0)
    acc = 0.0
    for dy in (0, 1):
        for dx in (0, 1):
            sx = torch.clamp(x0i + dx, 0, res - 1).long()
            sy = torch.clamp(y0i + dy, 0, res - 1).long()
            d = depth_flat[base + sy * res + sx]
            w = (fx if dx else 1 - fx) * (fy if dy else 1 - fy)
            acc = acc + w * torch.where(z_cmp <= d, 1.0, 0.0)
    return acc


def pcf_visibility(maps: ShadowMaps, map_id, world_pos,
                   pcf_samples: int = 64, ndotl=None, screen_xy=None,
                   pcss_samples: int = 32, pcss_minimum_radius: float = 0.0,
                   cascades: int = 1):
    """Percentage-closer soft shadows (reference:
    shader/shadow_mapping.glsl calc_directional_shadow /
    calc_point_shadow). map_id: (R,), world_pos: (R, 3), screen_xy: (R, 2)
    pixel coords for the rotation (None = fixed rotation). cascades: the
    upper bound on directional cascade layers (--shadow-map-cascades); the
    first layer whose bounds (with a 2*pcf-radius margin) contain the
    point wins (shadow_mapping.glsl find_cascade). Per-layer bias and
    radius scaling is baked in at build time."""
    with tracing.span("pcf"):
        return _pcf_visibility(maps, map_id, world_pos, pcf_samples, ndotl,
                               screen_xy, pcss_samples, pcss_minimum_radius,
                               cascades)


def _pcf_visibility(maps: ShadowMaps, map_id, world_pos, pcf_samples, ndotl,
                    screen_xy, pcss_samples, pcss_minimum_radius, cascades):
    res = maps.resolution
    R = world_pos.shape[0]
    dev = world_pos.device
    mi = map_id.long().clamp(min=0)

    if cascades > 1:
        def _in_margin(ml):
            vw = maps.view[ml]
            pl = _mv(vw[:, :3, :3], world_pos) + vw[:, :3, 3]
            prm = maps.params[ml]
            uu = pl[:, 0] / prm[:, 0]
            vv = -pl[:, 1] / prm[:, 1]
            rad = maps.pcf_radius[ml][:, 0]
            return ((uu.abs() < 1 - 2 * rad) & (vv.abs() < 1 - 2 * rad))
        found = _in_margin(mi) | (maps.proj_kind[mi] == 1)
        sel = mi
        for k in range(1, cascades):
            valid = k < maps.cascade_count[mi]
            cand = torch.where(valid, mi + k, mi)
            take = _in_margin(cand) & valid & ~found
            sel = torch.where(take, cand, sel)
            found = found | take
        mi = sel

    view = maps.view[mi]                        # (R, 4, 4)
    p_light = _mv(view[:, :3, :3], world_pos) + view[:, :3, 3]
    z = -p_light[:, 2]                          # axial depth (positive)
    kind = maps.proj_kind[mi]
    pr = maps.params[mi]
    is_persp = kind == 1

    if ndotl is None:
        ndotl = torch.zeros(R, dtype=torch.float32, device=dev)
    bias = torch.maximum(maps.max_bias[mi] * (1.0 - ndotl),
                         maps.min_bias[mi])

    # biased comparison depth, linear-space equivalents of the reference:
    #  perspective: hyper((1-bias) * z) -> compare (1-bias)*z with stored;
    #  directional: the bias is pre-scaled to world units at build time
    z_cmp = torch.where(is_persp, (1.0 - bias) * z, z - bias)

    safe_z = torch.clamp(z, min=1e-6)
    u = torch.where(is_persp, p_light[:, 0] / (safe_z * pr[:, 0]),
                    p_light[:, 0] / pr[:, 0])
    v = torch.where(is_persp, -p_light[:, 1] / (safe_z * pr[:, 0]),
                    -p_light[:, 1] / pr[:, 1])
    in_bounds = (u.abs() < 1) & (v.abs() < 1) & (z > 0) & (z < pr[:, 3])
    u01 = u * 0.5 + 0.5
    v01 = v * 0.5 + 0.5

    # per-pixel rotation from the reference's tiled noise texture
    # (shadow_mapping.glsl:203-207: noise_pos = ivec2(mod(gl_FragCoord.xy
    # * noise_scale, textureSize)); cs = texel.xy; a complex multiply by
    # cs)
    noise = _load_noise_2d()
    if screen_xy is not None and noise is not None:
        rows, (NH, NW) = noise
        nx = torch.remainder(screen_xy[:, 0].long(), NW)
        ny = torch.remainder(screen_xy[:, 1].long(), NH)
        cs = torch.from_numpy(rows).to(dev)[ny * NW + nx]
        ca = cs[:, 0]
        sa = cs[:, 1]
    elif screen_xy is not None:
        m32 = 0xFFFFFFFF
        h = ((screen_xy[:, 0].long() * 0x9E3779B9) & m32) ^ \
            ((screen_xy[:, 1].long() * 0x85EBCA6B) & m32)
        h = (h * 0x27D4EB2D) & m32
        h = h ^ (h >> 15)
        ang = h.to(torch.float32) * (2 * np.pi / 4294967296.0)
        ca = torch.cos(ang)
        sa = torch.sin(ang)
    else:
        ca = torch.ones(R, dtype=torch.float32, device=dev)
        sa = torch.zeros(R, dtype=torch.float32, device=dev)

    base_radius = maps.pcf_radius[mi]           # (R, 2)
    # uv-space PCF radius: directional radii are in uv units already;
    # perspective ones are radius / linear depth (reference:
    # calc_perspective_pcss_radius search_radius = -radius/linear_depth)
    persp_uv = base_radius[:, 0] / safe_z
    radius_uv = torch.where(is_persp, persp_uv, base_radius[:, 0])

    disk = _POISSON64.tolist()
    depth_flat = maps.depth.reshape(-1)
    base = mi * (res * res)

    if pcss_samples > 0:
        # blocker search (reference: calc_*_pcss_radius)
        search_uv = torch.where(is_persp, persp_uv,
                                base_radius[:, 0] * pr[:, 3] / 20.0)
        occl = torch.zeros(R, dtype=torch.float32, device=dev)
        avg_z = torch.zeros(R, dtype=torch.float32, device=dev)
        for k in range(min(pcss_samples, 64)):
            px, py = disk[k]
            ox = px * ca - py * sa
            oy = px * sa + py * ca
            # textureGather semantics (shadow_mapping.glsl:127-160): the 4
            # texels of the bilinear footprint all enter the blocker
            # average, unweighted
            sx = torch.clamp((u01 + ox * search_uv) * res - 0.5, 0, res - 1)
            sy = torch.clamp((v01 + oy * search_uv) * res - 0.5, 0, res - 1)
            x0 = xla_int32(torch.floor(sx))
            y0 = xla_int32(torch.floor(sy))
            for dy in (0, 1):
                for dx in (0, 1):
                    gx = torch.clamp(x0 + dx, 0, res - 1).long()
                    gy = torch.clamp(y0 + dy, 0, res - 1).long()
                    d = depth_flat[base + gy * res + gx]
                    blocker = d < z_cmp
                    occl = occl + blocker
                    avg_z = avg_z + torch.where(blocker, d, 0.0)
        any_blocker = occl >= 1.0
        avg_z = avg_z / torch.clamp(occl, min=1.0)
        penumbra = (z_cmp - avg_z) / torch.clamp(avg_z, min=1e-6)
        penumbra = torch.clamp(penumbra, min=0.0)
        radius_pcss = torch.where(
            is_persp, search_uv * (penumbra + pcss_minimum_radius),
            5.0 * search_uv * penumbra + pcss_minimum_radius)
        radius_uv = torch.where(any_blocker, radius_pcss, radius_uv)
        skip = ~any_blocker
    else:
        skip = torch.zeros(R, dtype=torch.bool, device=dev)

    taps = max(min(pcf_samples, 64), 1)
    vis = torch.zeros(R, dtype=torch.float32, device=dev)
    for k in range(taps):
        px, py = disk[k]
        ox = px * ca - py * sa
        oy = px * sa + py * ca
        x = torch.clamp((u01 + ox * radius_uv) * res - 0.5, 0, res - 1)
        y = torch.clamp((v01 + oy * radius_uv) * res - 0.5, 0, res - 1)
        vis = vis + _bilinear_compare(depth_flat, base, x, y, z_cmp, res)
    vis = vis / taps
    vis = torch.where(skip, 1.0, vis)
    return torch.where(in_bounds, vis, 1.0)
