"""Forward "raster" stage (reference: src/raster_stage.cc,
shader/forward.vert/.frag, shader/scene_raster.glsl); the torch
counterpart of tauray_tpu.stages.raster.

Primary visibility is one camera-ray wave through the shared tracer (the
image a rasterizer would produce, without a splatting pipeline), then
forward shading: analytic GGX per punctual light with shadow-map PCF
visibility, plus indirect light from an SH probe grid or an ambient
fallback (reference: forward.frag eval_punctual_lights /
eval_indirect_light)."""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.brdf_lut import sample_brdf_lut
from ..ops.ggx import (_COLORED_FRESNEL, add_demodulated_color,
                       fresnel_schlick_attenuated, ggx_bsdf, modulate_bsdf,
                       modulate_color)
from ..ops.intersect import Hit
from ..ops.lights import environment_radiance, get_spotlight_intensity
from ..ops.sampling import (create_tangent_space, dot, length, normalize,
                            to_tangent_space, xla_int32)
from ..ops.sh import eval_ggx_specular, eval_irradiance, sh_basis
from ..ops.shading import (_mv, get_camera_projection, get_screen_camera_ray,
                           interpolate_vertex, ray_cone_lod, sample_material)
from ..ops.trace_utils import trace_alpha
from ..scene.device import CameraUniforms, DeviceScene
from .shadow_map import ShadowMaps, pcf_visibility

# Vulkan standard sample locations per MSAA count (spec table 24.2), in
# [0,1) pixel units (reference: raster_pipeline.cc msaa states).
MSAA_LOCATIONS = {
    2: [(0.75, 0.75), (0.25, 0.25)],
    4: [(0.375, 0.125), (0.875, 0.375), (0.125, 0.625), (0.625, 0.875)],
    8: [(0.5625, 0.3125), (0.4375, 0.6875), (0.8125, 0.5625),
        (0.3125, 0.1875), (0.1875, 0.8125), (0.0625, 0.4375),
        (0.6875, 0.9375), (0.9375, 0.0625)],
    16: [(0.5625, 0.5625), (0.4375, 0.3125), (0.3125, 0.625),
         (0.75, 0.4375), (0.1875, 0.375), (0.625, 0.8125),
         (0.8125, 0.6875), (0.6875, 0.1875), (0.375, 0.875),
         (0.5, 0.0625), (0.25, 0.125), (0.125, 0.75),
         (0.0, 0.5), (0.9375, 0.25), (0.875, 0.9375), (0.0625, 0.0)],
}

# Sub-pixel nudge of the single-pass camera rays, 2^-12 px: with pixel
# centres exactly on projected triangle edges (axis-aligned scenes at
# power-of-two sizes) the inclusive ray-triangle edge test picks the front
# triangle where a rasterizer's fill rule excludes it; the nudge makes the
# tie generic without visibly moving an edge (tauray_tpu's default).
SUBPIXEL_EPS = 2.0 ** -12


def _normal_from_world(world_to_local):
    """Grid normal matrix: the INVERSE ROTATION of the grid transform. The
    reference builds it from the transform's quaternion orientation alone
    (scene_stage.cc:1131 `mat4(inverse(orientation))`), so scale is
    stripped, not inverse-transposed (forward.frag:139,146,149)."""
    fwd = torch.linalg.inv(world_to_local[:3, :3])       # R @ S
    rot = fwd / torch.linalg.norm(fwd, dim=0, keepdim=True)
    return rot.T


def _pixels(cam: CameraUniforms, width: int, height: int, n_views: int):
    """(pix (R, 2), vp (R,), size (2,)) of every pixel of every view."""
    dev = cam.view.device
    V, H, W = n_views, height, width
    ys, xs = torch.meshgrid(torch.arange(H, device=dev),
                            torch.arange(W, device=dev), indexing="ij")
    pix = torch.stack([xs.reshape(-1), ys.reshape(-1)], -1).repeat(V, 1)
    vp = torch.arange(V, device=dev).repeat_interleave(H * W)
    size = torch.tensor([W, H], dtype=torch.float32, device=dev)
    return pix, vp, size


def raster_coverage(scene: DeviceScene, bvh, cam: CameraUniforms,
                    sample_offset, width: int, height: int, n_views: int,
                    min_ray_dist: float, has_alpha: bool):
    """Hit mask (V, H, W) of one MSAA sample ray per pixel: the coverage
    half of MSAA when shading stays per pixel (MSAA without
    sample_shading resolves geometry coverage only)."""
    V, H, W = n_views, height, width
    R = V * H * W
    pix, vp, size = _pixels(cam, W, H, V)
    origin, d = get_screen_camera_ray(cam, vp, pix, size,
                                      pixel_offset=sample_offset)
    dev = origin.device
    hit = trace_alpha(scene, bvh, origin, d,
                      torch.full((R,), min_ray_dist, device=dev),
                      torch.full((R,), float("inf"), device=dev), 1e-4,
                      has_alpha)
    return (hit.tri_id >= 0).reshape(V, H, W)


def raster_background(scene: DeviceScene, cam: CameraUniforms, width: int,
                      height: int, n_views: int, has_envmap: bool):
    """Skybox colour along the centre rays (V, H, W, 3): the resolve
    target for MSAA coverage blending (envmap_stage draws the background
    before the forward pass)."""
    pix, vp, size = _pixels(cam, width, height, n_views)
    _, d = get_screen_camera_ray(cam, vp, pix, size)
    bg, _ = environment_radiance(scene, d, has_envmap)
    return bg.reshape(n_views, height, width, 3)


def render_raster(scene: DeviceScene, bvh, cam: CameraUniforms,
                  prev_cam: CameraUniforms, shadow_maps: Optional[ShadowMaps],
                  map_table, sh_coefficients, brdf_lut, width: int,
                  height: int, n_views: int, ambient, min_ray_dist: float,
                  has_shadow_maps: bool, pcf_samples: int, has_alpha: bool,
                  sh_order: int = 2, has_sh: bool = False,
                  has_envmap: bool = False, has_blend: bool = False,
                  pcss_samples: int = 32, pcss_min_radius: float = 0.0,
                  probe_vis: bool = False, sample_offset=None,
                  shadow_cascades: int = 1):
    """The G-buffer images of one pass, each (V, H, W, C) (shadow_vis and
    view_z (V, H, W))."""
    V, H, W = n_views, height, width
    R = V * H * W
    pix, vp, size = _pixels(cam, W, H, V)
    dev = pix.device
    if sample_offset is None:
        sample_offset = torch.full((1, 2), SUBPIXEL_EPS, device=dev)
    origin, d = get_screen_camera_ray(cam, vp, pix, size,
                                      pixel_offset=sample_offset)
    inf = torch.full((R,), float("inf"), device=dev)
    hit = trace_alpha(scene, bvh, origin, d,
                      torch.full((R,), min_ray_dist, device=dev), inf, 1e-4,
                      has_alpha, need_uv=False)
    # x-neighbour ray differentials for the ray-cone texture LOD (the
    # reference raster's fragment derivatives; shading passes lod_uv so
    # sample_material filters trilinearly like the hardware sampler)
    d4 = d.reshape(V, H, W, 3)
    o4 = origin.reshape(V, H, W, 3)
    ddx = torch.cat([d4[:, :, 1:] - d4[:, :, :-1],
                     d4[:, :, -1:] - d4[:, :, -2:-1]], 2).reshape(R, 3)
    dox = torch.cat([o4[:, :, 1:] - o4[:, :, :-1],
                     o4[:, :, -1:] - o4[:, :, -2:-1]], 2).reshape(R, 3)
    ambient = torch.as_tensor(ambient, dtype=torch.float32, device=dev)

    def shade(hit):
        """Forward shading of one hit layer (shader/forward.frag); returns
        (rgb with the skybox on a miss, mat, v, miss, diffuse, reflection,
        shadow_vis)."""
        miss = hit.tri_id < 0
        v = interpolate_vertex(scene, hit.tri_id, hit.u, hit.v, d,
                               ray_origin=origin)
        fp = length(dox + torch.where(miss, 1.0, hit.t)[:, None] * ddx)
        mat, v = sample_material(scene, v,
                                 lod_uv=ray_cone_lod(scene, v, fp, d))

        t, b, n = create_tangent_space(v.mapped_normal)
        shading_view = to_tangent_space(-d, t, b, n)

        diffuse = torch.zeros((R, 3), device=dev)
        reflection = torch.zeros((R, 3), device=dev)
        # TAURAY_COLORED_FRESNEL=1 (validation only, ops/ggx.py): the
        # older colored-Schlick metallic Fresnel; the demodulated channels
        # cannot carry a per-channel Fresnel, so that path accumulates a
        # fully modulated colour directly
        crgb = torch.zeros((R, 3), device=dev) if _COLORED_FRESNEL else None
        n_dir = scene.dl_color.shape[0]
        n_point = scene.pl_color.shape[0]
        # debug AOV: the first directional light's shadow visibility
        vis_sum = torch.zeros(R, device=dev)
        vis_n = 0

        # directional lights (forward.frag eval_punctual_lights)
        for i in range(n_dir):
            active = 1.0 if i < scene.directional_light_count else 0.0
            ldir = -scene.dl_dir[i]
            lobes = ggx_bsdf(to_tangent_space(ldir.expand(R, 3), t, b, n),
                             shading_view, mat)
            vis = torch.ones(R, device=dev)
            if has_shadow_maps:
                vis = pcf_visibility(
                    shadow_maps, map_table[0][i].expand(R), v.pos,
                    pcf_samples, ndotl=dot(v.mapped_normal, ldir).abs(),
                    screen_xy=pix, pcss_samples=pcss_samples,
                    pcss_minimum_radius=pcss_min_radius,
                    cascades=shadow_cascades)
            facing = dot(v.hard_normal, ldir) > 0
            vis = torch.where(facing, vis, 0.0)
            contrib = active * vis
            if i == 0:
                vis_sum, vis_n = vis_sum + contrib, vis_n + 1
            color = scene.dl_color[i] * contrib[:, None]
            diffuse, reflection = add_demodulated_color(lobes, color,
                                                        diffuse, reflection)
            if crgb is not None:
                crgb = crgb + color * modulate_bsdf(mat, lobes)

        # point and spot lights
        for i in range(n_point):
            active = 1.0 if i < scene.point_light_count else 0.0
            lvec = scene.pl_pos[i] - v.pos
            dist2 = dot(lvec, lvec)
            ldir = lvec / torch.sqrt(torch.clamp(dist2, min=1e-20))[:, None]
            spot = get_spotlight_intensity(scene.pl_dir_cutoff[i],
                                           scene.pl_dir_falloff[i],
                                           scene.pl_dir[i], ldir)
            lcolor = spot[:, None] * scene.pl_color[i] / \
                torch.clamp(dist2, min=1e-20)[:, None]
            lobes = ggx_bsdf(to_tangent_space(ldir, t, b, n), shading_view,
                             mat)
            vis = torch.ones(R, device=dev)
            if has_shadow_maps:
                _, pt_base, pt_nfaces = map_table
                # cube faces ordered +x,-x,+y,-y,+z,-z (light -> point)
                dd = -ldir
                ax = torch.argmax(dd.abs(), dim=-1)
                neg = torch.gather(dd, 1, ax[:, None])[:, 0] < 0
                face = ax * 2 + neg.long()
                mid = torch.where(pt_nfaces[i] > 1, pt_base[i] + face,
                                  pt_base[i])
                vis = pcf_visibility(
                    shadow_maps, mid, v.pos, pcf_samples,
                    ndotl=dot(v.mapped_normal, ldir).abs(),
                    screen_xy=pix, pcss_samples=pcss_samples,
                    pcss_minimum_radius=pcss_min_radius)
            facing = dot(v.hard_normal, ldir) > 0
            vis = torch.where(facing, vis, 0.0)
            color = lcolor * (active * vis)[:, None]
            diffuse, reflection = add_demodulated_color(lobes, color,
                                                        diffuse, reflection)
            if crgb is not None:
                crgb = crgb + color * modulate_bsdf(mat, lobes)

        # indirect: SH grid irradiance or the ambient fallback, combined
        # with the split-sum BRDF integration as the reference
        # (forward.frag eval_indirect_light + brdf_indirect)
        if has_sh:
            inc_diffuse, inc_spec = _sh_indirect(
                sh_coefficients, v, mat, d, sh_order, probe_vis)
        else:
            inc_diffuse = ambient[None, :].expand(R, 3)
            inc_spec = inc_diffuse
        # brdf_indirect (forward.frag)
        cos_v = torch.clamp(dot(v.mapped_normal, -d), min=0.0)
        f_att = fresnel_schlick_attenuated(cos_v, mat.f0, mat.roughness)
        kd = (1.0 - f_att) * (1.0 - mat.metallic) * \
            (1.0 - mat.transmittance)
        diffuse = diffuse + kd[:, None] * inc_diffuse
        bi = sample_brdf_lut(brdf_lut, cos_v, torch.sqrt(mat.roughness))
        spec_w = f_att * bi[..., 0] + bi[..., 1]
        spec_w = spec_w + (1.0 - spec_w) * mat.metallic
        reflection = reflection + inc_spec * spec_w[:, None]

        rgb = modulate_color(mat, diffuse, reflection) + mat.emission
        if crgb is not None:
            # the older indirect: a vec3 Schlick F with F0 = mix(0.04,
            # albedo, metallic) feeds the split sum directly
            alb = mat.albedo[..., :3]
            met = mat.metallic[:, None]
            f0v = 0.04 * (1.0 - met) + alb * met
            fv = f0v + (torch.maximum(1.0 - mat.roughness[:, None], f0v) -
                        f0v) * (1.0 - cos_v[:, None]) ** 5
            spec_c = inc_spec * (fv * bi[..., 0:1] + bi[..., 1:2])
            diff_c = (kd[:, None] * inc_diffuse) * alb * (1.0 - met)
            rgb = crgb + diff_c + spec_c + mat.emission
        # skybox: the envmap along the ray, as the reference's
        # envmap_stage (shader/envmap.frag), else env_factor
        bg, _ = environment_radiance(scene, d, has_envmap)
        rgb = torch.where(miss[:, None], bg, rgb)
        svis = vis_sum / max(vis_n, 1)
        return rgb, mat, v, miss, diffuse, reflection, svis

    rgb, mat, v, miss, diffuse, reflection, shadow_vis = shade(hit)
    # alpha-BLEND materials: the front blend layer composited over the
    # next non-blend surface along the ray (one blend layer deep)
    if has_blend:
        inst = scene.tri_instance[hit.tri_id.clamp(min=0).long()].long()
        front_blend = (hit.tri_id >= 0) & scene.inst_blend[inst]
        tmin2 = torch.where(front_blend, hit.t * 1.0001 + 1e-4,
                            min_ray_dist)
        h2 = trace_alpha(scene, bvh, origin, d, tmin2, inf, 1e-4, has_alpha,
                         need_uv=False)
        for _ in range(2):
            i2 = scene.tri_instance[h2.tri_id.clamp(min=0).long()].long()
            again = (h2.tri_id >= 0) & scene.inst_blend[i2]
            tmin2 = torch.where(again, h2.t * 1.0001 + 1e-4, tmin2)
            h2b = trace_alpha(scene, bvh, origin, d, tmin2, inf, 1e-4,
                              has_alpha, need_uv=False)
            h2 = Hit(*(torch.where(again, b2, a2)
                       for a2, b2 in zip(h2, h2b)))
        rgb_back = shade(h2)[0]
        a_front = torch.clamp(mat.albedo[:, 3], 0.0, 1.0)
        blended = a_front[:, None] * rgb + (1.0 - a_front[:, None]) * rgb_back
        rgb = torch.where(front_blend[:, None], blended, rgb)
    alpha = torch.where(miss, 0.0, 1.0)
    color = torch.cat([rgb, alpha[:, None]], -1)

    screen_motion = get_camera_projection(prev_cam, vp, v.prev_pos)
    vz = cam.view[vp][:, 2]
    view_z = -(dot(vz[:, :3], v.pos) + vz[:, 3])
    ones = torch.ones((R, 1), device=dev)

    def r4(x, C):
        return x.reshape(V, H, W, C)

    return dict(
        color=r4(color, 4),
        diffuse=r4(torch.cat([diffuse, ones], -1), 4),
        reflection=r4(torch.cat([reflection, ones], -1), 4),
        albedo=r4(mat.albedo, 4),
        normal=r4(torch.where(miss[:, None], -d, v.mapped_normal), 3),
        pos=r4(v.pos, 3),
        screen_motion=r4(screen_motion, 3),
        metallic_roughness=r4(torch.stack([mat.metallic, mat.roughness],
                                          -1), 2),
        emission=r4(mat.emission, 3),
        shadow_vis=shadow_vis.reshape(V, H, W),
        view_z=view_z.reshape(V, H, W))


def _sh_indirect(sh_coefficients, v, mat, d, sh_order: int,
                 probe_vis: bool):
    """(diffuse irradiance, specular radiance), each (R, 3), from the SH
    grid (rz, ry, rx, C, 3 or 4), trilinear over the 8 probes around each
    point; with probe_vis (and a fourth, visibility channel) each probe
    also weighted by its visibility and normal factors."""
    coef_grid, world_to_local = sh_coefficients[:2]
    local = _mv(world_to_local[None, :3, :3], v.pos) + world_to_local[:3, 3]
    rz, ry, rx = coef_grid.shape[:3]
    res = torch.tensor([rx, ry, rz], dtype=torch.float32,
                       device=local.device)
    g = (local * 0.5 + 0.5) * res - 0.5         # grid-space coords
    use_vis = probe_vis and coef_grid.shape[-1] >= 4
    nfw = _normal_from_world(world_to_local)
    if use_vis:
        # probe-visibility interpolation (shader/spherical_harmonics.glsl
        # :244-309, the non-trilinear path of use_probe_visibility): each
        # corner probe weighted by its trilinear weight x a visibility
        # factor (its SH-encoded voxel-unit hit distance toward the point,
        # channel .w) x a normal factor (probes behind the surface fade)
        g = torch.minimum(torch.clamp(g, min=0.0), res - 1.0)
        grid_n = normalize(_mv(nfw[None], v.smooth_normal))
    g0 = xla_int32(torch.floor(g)).long()
    f = g - g0
    coefs = 0.0
    wsum = 0.0
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                ix = torch.clamp(g0[:, 0] + dx, 0, rx - 1)
                iy = torch.clamp(g0[:, 1] + dy, 0, ry - 1)
                iz = torch.clamp(g0[:, 2] + dz, 0, rz - 1)
                w = ((f[:, 0] if dx else 1 - f[:, 0]) *
                     (f[:, 1] if dy else 1 - f[:, 1]) *
                     (f[:, 2] if dz else 1 - f[:, 2]))
                c = coef_grid[iz, iy, ix]
                if use_vis:
                    corner = torch.stack([ix, iy, iz], -1).to(torch.float32)
                    sdir = corner - g
                    sdist = length(sdir)
                    # the clamped position can land exactly on a corner
                    # (sdir = 0): any direction works there, as sdist = 0
                    # saturates the visibility factor
                    safe = torch.where(
                        sdist[:, None] > 1e-6, sdir,
                        torch.tensor([1.0, 0.0, 0.0], device=g.device))
                    sunit = safe / torch.clamp(sdist, min=1e-6)[:, None]
                    nf = torch.clamp((dot(grid_n, sunit) + 1.0) * 0.5,
                                     0.0, 1.0)
                    # the corner probe's SH distance toward the point
                    # (basis direction in grid-LOCAL units, the
                    # projection's direction space)
                    vloc = -safe / res[None, :]
                    vdir = vloc / length(vloc, keepdim=True)
                    vis_d = (sh_basis(vdir, sh_order) * c[..., 3]).sum(-1)
                    vf = torch.clamp(vis_d - sdist + 0.4, 0.0, 1.0)
                    w = w * nf * vf
                coefs = coefs + c[..., :3] * w[:, None, None]
                wsum = wsum + w
    if use_vis:
        coefs = coefs / torch.clamp(wsum, min=1e-8)[:, None, None]
    # evaluation directions in the grid-LOCAL frame (forward.frag:146-152
    # normal_from_world * mapped_normal / ref_dir), matching the bake's
    # local-direction SH projection
    sh_n = normalize(_mv(nfw[None], v.mapped_normal))
    inc_diffuse = torch.clamp(eval_irradiance(coefs, sh_n, sh_order),
                              min=0.0)
    ref_dir = d - 2.0 * dot(d, v.mapped_normal, keepdim=True) * \
        v.mapped_normal
    sh_ref = normalize(_mv(nfw[None], ref_dir))
    inc_spec = torch.clamp(eval_ggx_specular(
        coefs, sh_ref, torch.sqrt(mat.roughness), sh_order), min=0.0)
    return inc_diffuse, inc_spec
