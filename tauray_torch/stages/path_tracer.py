"""Wavefront path tracer stage; the torch counterpart of
tauray_tpu.stages.path_tracer on its main path.

Per bounce: one closest-hit wave over all rays, vectorized NEE and an
any-hit shadow wave, then vectorized shading and GGX sampling
(reference: shader/path_tracer.glsl evaluate_ray). Sample streams are the
deterministic pcg4d streams keyed on (pixel, viewport + seed, sample
index), or the Sobol samplers' points (--sampler=sobol-*), bit-identical
to the JAX package's. Scenes with alpha-tested materials trace each wave
with stochastic-alpha re-trace rounds (_trace_alpha_program), their
cutoffs drawn from a second pcg4d stream.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import tracing
from ..ops import rng as rng_ops
from ..ops import sobol
from ..ops.ggx import (BSDFLobes, add_demodulated_color, material_bsdf_pdf,
                       material_bsdf_sample, modulate_bsdf, modulate_color)
from ..ops.intersect import RAY_MAX_DIST, Hit, intersect_spheres
from ..ops.lights import (NEEWeights, directional_light_radiance,
                          environment_radiance, point_light_radiance,
                          sample_directional_light, sample_environment_map,
                          sample_point_light, sample_point_light_pdf,
                          sample_triangle_light, sample_triangle_light_pdf)
from ..ops.sampling import (create_tangent_space, dot, from_tangent_space,
                            get_barycentric_coords, length,
                            ray_plane_intersection_dist,
                            sample_blackman_harris_concentric_disk,
                            sample_sphere, vec, view_to_tangent_space)
from ..ops.shading import (get_camera_projection, get_screen_camera_ray,
                           interpolate_vertex, rgb_to_luminance,
                           sample_material, sample_texture_quad)
from ..ops.trace_utils import per_ray, row_alpha
from ..validation import check_nan
from ..scene.device import (IP_HASALPHA, IP_LIGHTBASE, TL_EMISSION, TL_POS,
                            TL_TEX, TL_TEXBLOCK, TL_TEXSIZE, TL_UV, TP_IP,
                            TP_POS, CameraUniforms, DeviceScene)

# Wave capture for the wave-statistics tool (app/wave_stats.py): set to a
# list to collect each trace wave's (kind, o, d, t_min, t_max).
_WAVE_DUMP: Optional[list] = None


@dataclass(frozen=True)
class PTConfig:
    """Static path tracer configuration."""
    width: int
    height: int
    n_views: int
    max_bounces: int
    samples_per_pass: int = 1
    film: str = "point"
    film_radius: float = 0.5
    min_ray_dist: float = 1e-4
    mis_mode: str = "power"            # off | balance | power
    bounce_mode: str = "material"      # hemisphere | cosine | material
    tri_light_mode: str = "solid-angle"
    russian_roulette_delta: float = 0.0
    indirect_clamping: float = 0.0
    regularization_gamma: float = 0.0
    nee: NEEWeights = NEEWeights(0, 0, 0, 0)
    has_envmap: bool = False
    has_point_lights: bool = False
    hide_lights: bool = False
    use_dof: bool = False
    transparent_background: bool = False
    use_white_albedo_on_first_bounce: bool = False
    direct_only: bool = False          # `direct` renderer: 2-bounce NEE-only
    rng_seed: int = 0
    has_alpha_materials: bool = False
    sampler: str = "uniform-random"    # | sobol-owen | sobol-z2 | sobol-z3
    # SH probe tracer semantics (reference: shader/sh_path_tracer.rgen
    # defines INDIRECT_CLAMP_FIRST_BOUNCE): indirect clamping applies at
    # bounce 0 too (path_tracer.glsl:422-427, 465-467)
    clamp_first_bounce: bool = False
    count_rays: bool = False           # emit useful-ray (alive-lane) counts
    # texture slots (albedo, metallic-roughness, normal, emission) bound by
    # ANY material; unbound slots skip their texture gathers
    tex_slots: Tuple[bool, bool, bool, bool] = (True, True, True, True)
    tl_textured: bool = True           # any emissive tri with a texture
    # --validation: check each stage's outputs for NaNs (validation.py)
    validate: bool = False


class PTOutput(NamedTuple):
    color: torch.Tensor              # (R, 4)
    diffuse: torch.Tensor            # (R, 4) demodulated
    reflection: torch.Tensor         # (R, 4)
    first_albedo: torch.Tensor       # (R, 4)
    first_normal: torch.Tensor       # (R, 3)
    first_pos: torch.Tensor          # (R, 3)
    first_screen_motion: torch.Tensor  # (R, 3)
    first_instance: torch.Tensor     # (R,) i32
    first_metallic_roughness: torch.Tensor  # (R, 2)
    first_emission: torch.Tensor     # (R, 3)
    # cfg.count_rays: lanes that traced (alive bounce lanes with t_max > 0
    # and shadow lanes with a nonzero length), an int64 scalar
    useful_rays: Optional[torch.Tensor] = None


def draw_ray_sample(cfg: PTConfig, seed, coord=None, slot: int = -1):
    """Per-bounce 4D sample (reference: shader/sampling.glsl
    generate_ray_sample_uint): uniform-random advances the pcg4d stream;
    the Sobol samplers take the sample index and pixel from `coord` and
    leave the pcg stream untouched, like the reference's split sampler.
    Returns (seed, (R, 4) uint32 sample)."""
    if cfg.sampler == "uniform-random" or slot < 0:
        return rng_ops.generate_uniform_random_uint(seed)
    if cfg.sampler == "sobol-owen":
        return seed, sobol.sobol_owen_sample_uint(rng_ops.pcg4d(coord),
                                                  coord[:, 3], slot)
    return seed, sobol.sobol_z_sample_uint(coord[:, :2], coord[:, 3], slot,
                                           bits_3d=cfg.sampler == "sobol-z3")


def bsdf_mis_pdf(cfg: PTConfig, scene, nee_point, nee_dir, nee_tri, nee_env,
                 bsdf_pdf):
    """(reference: shader/path_tracer.glsl bsdf_mis_pdf)"""
    w = cfg.nee
    avg_nee_pdf = (
        nee_dir * w.directional / max(scene.directional_light_count, 1) +
        nee_tri * w.triangle / max(scene.tri_light_count, 1) +
        nee_env * w.envmap +
        nee_point * w.point / max(scene.point_light_count, 1))
    if cfg.mis_mode == "power":
        res = (avg_nee_pdf * avg_nee_pdf + bsdf_pdf * bsdf_pdf) / \
            torch.clamp(bsdf_pdf, min=1e-30)
    elif cfg.mis_mode == "balance":
        res = avg_nee_pdf + bsdf_pdf
    else:
        res = torch.where(avg_nee_pdf > 0, float("inf"), bsdf_pdf)
    return torch.where(bsdf_pdf == 0.0, 1.0, res)


def nee_mis_pdf(cfg: PTConfig, nee_pdf, bsdf_pdf):
    """(reference: shader/path_tracer.glsl nee_mis_pdf). Negative nee_pdf
    flags delta lights."""
    if cfg.mis_mode == "power":
        res = (nee_pdf * nee_pdf + bsdf_pdf * bsdf_pdf) / \
            torch.clamp(nee_pdf, min=1e-30)
    elif cfg.mis_mode == "balance":
        res = nee_pdf + bsdf_pdf
    else:
        res = nee_pdf
    return torch.where(nee_pdf <= 0.0, -nee_pdf, res)


def _light_index(u, count: int):
    return torch.clamp((u * count).to(torch.int32), 0, count - 1).long()


def sample_explicit_light(cfg: PTConfig, scene: DeviceScene, rand_uint, pos):
    """(reference: shader/path_tracer.glsl sample_explicit_light).
    Returns (color, out_dir, out_length, pdf)."""
    R = pos.shape[0]
    u = rng_ops.uint_to_float(rand_uint)
    w = cfg.nee
    uw = u[:, 3]
    pick_point = uw < w.point
    pick_tri = ~pick_point & (uw < w.point + w.triangle)
    pick_env = ~pick_point & ~pick_tri & (uw < w.point + w.triangle +
                                          w.envmap)
    pick_dir = ~pick_point & ~pick_tri & ~pick_env & \
        (uw < w.point + w.triangle + w.envmap + w.directional)

    color = torch.zeros((R, 3), dtype=torch.float32, device=pos.device)
    out_dir = torch.zeros_like(color)
    out_len = torch.zeros_like(uw)
    pdf = torch.ones_like(uw)

    def pick(mask, c, d, l, p):
        return (torch.where(mask[:, None], c, color),
                torch.where(mask[:, None], d, out_dir),
                torch.where(mask, l, out_len), torch.where(mask, p, pdf))

    if w.point > 0:
        lc = scene.point_light_count
        li = _light_index(u[:, 2], lc)
        d, l, c, p = sample_point_light(scene, li, u[:, :2], pos)
        p = p * (w.point / float(max(lc, 1)))
        color, out_dir, out_len, pdf = pick(pick_point, c, d, l, p)

    if w.triangle > 0:
        lc = scene.tri_light_count
        row = scene.tl_packed[_light_index(u[:, 2], lc)]
        A = row[:, TL_POS + 0:TL_POS + 3] - pos
        B = row[:, TL_POS + 3:TL_POS + 6] - pos
        C = row[:, TL_POS + 6:TL_POS + 9] - pos
        c = row[:, TL_EMISSION:TL_EMISSION + 3]
        d, tri_pdf = sample_triangle_light(u[:, :2], A, B, C,
                                           cfg.tri_light_mode)
        l = ray_plane_intersection_dist(d, A, B, C)
        bad = ~torch.isfinite(tri_pdf) | (tri_pdf <= 0) | \
            (l <= cfg.min_ray_dist) | ~torch.isfinite(d).all(-1)
        if cfg.tl_textured:
            bary = get_barycentric_coords(d * l[:, None], A, B, C)
            uv = (row[:, TL_UV:TL_UV + 2] * bary[:, 0:1] +
                  row[:, TL_UV + 2:TL_UV + 4] * bary[:, 1:2] +
                  row[:, TL_UV + 4:TL_UV + 6] * bary[:, 2:3])
            c = c * sample_texture_quad(
                scene, row[:, TL_TEX].to(torch.int32),
                row[:, TL_TEXSIZE:TL_TEXSIZE + 2], uv,
                block=row[:, TL_TEXBLOCK:TL_TEXBLOCK + 2])[:, :3]
        l = l - cfg.min_ray_dist
        p = w.triangle * tri_pdf / max(lc, 1)
        c = torch.where(bad[:, None], 0.0, c)
        d = torch.where(bad[:, None], 0.0, d)
        p = torch.where(bad, 1.0, p)
        color, out_dir, out_len, pdf = pick(pick_tri, c, d, l, p)

    if w.envmap > 0:
        if cfg.has_envmap:
            c, d, l, p = sample_environment_map(scene, rand_uint[:, :3])
        else:
            d = sample_sphere(u[:, :2])
            p = torch.full_like(uw, 1.0 / (4.0 * np.pi))
            c = scene.env_factor[None, :3].expand(R, 3)
            l = torch.full_like(uw, RAY_MAX_DIST)
        color, out_dir, out_len, pdf = pick(pick_env, c, d, l, p * w.envmap)

    if w.directional > 0:
        lc = scene.directional_light_count
        d, c, p = sample_directional_light(scene, _light_index(u[:, 2], lc),
                                           u[:, :2])
        p = p * (w.directional / max(lc, 1))
        color, out_dir, out_len, pdf = pick(
            pick_dir, c, d, torch.full_like(uw, RAY_MAX_DIST), p)

    return color, out_dir, out_len, pdf


def _clamp_contribution(cfg: PTConfig, contrib):
    """(reference: shader/path_tracer.glsl clamp_contribution_mul)"""
    if cfg.indirect_clamping <= 0:
        return contrib
    m = rgb_to_luminance(contrib)
    mul = torch.where(m > cfg.indirect_clamping,
                      cfg.indirect_clamping / torch.clamp(m, min=1e-30), 1.0)
    return contrib * mul[..., None]


def _correct_lobes_for_normal_map(sample_dir, geometric_normal,
                                  lobes: BSDFLobes) -> BSDFLobes:
    """(reference: shader/path_tracer.glsl correct_lobes_for_normal_map)"""
    below = dot(geometric_normal, sample_dir) < 0
    z = torch.zeros_like(lobes.diffuse)
    return BSDFLobes(
        transmission=torch.where(below, lobes.transmission, z),
        diffuse=torch.where(below, z, lobes.diffuse),
        dielectric_reflection=torch.where(below, z,
                                          lobes.dielectric_reflection),
        metallic_reflection=torch.where(below, z, lobes.metallic_reflection))


def next_event_estimation(cfg, scene, rand_uint, tbn, shading_view,
                          mat, v_pos, v_hard_normal, vis):
    """(reference: shader/path_tracer.glsl next_event_estimation). `vis` is
    the shadow visibility traced by the wavefront. Returns (contrib,
    lobes)."""
    t, b, n = tbn
    contrib, out_dir, out_len, light_pdf = \
        sample_explicit_light(cfg, scene, rand_uint, v_pos)
    shading_light = torch.stack([dot(out_dir, t), dot(out_dir, b),
                                 dot(out_dir, n)], dim=-1)
    lobes, bsdf_pdf = material_bsdf_pdf(shading_light, shading_view, mat,
                                        cfg.bounce_mode)
    lobes = _correct_lobes_for_normal_map(out_dir, v_hard_normal, lobes)
    needs_ray = (contrib > 0.0001).any(dim=-1)
    contrib = contrib * torch.where(needs_ray, vis, 1.0)[:, None]
    contrib = contrib / torch.clamp(
        nee_mis_pdf(cfg, light_pdf, bsdf_pdf), min=1e-30)[:, None]
    return contrib, lobes


def _safe_dir(v):
    return torch.where(v.abs() < 1e-30, vec([0.0, 0, 1.0], v), v)


def _shade_bounce(cfg: PTConfig, scene: DeviceScene, state, hit, vis,
                  b_idx: int, is_first: bool, max_bounces: int,
                  coord=None, sobol_bounce: int = -1):
    """Shading for one bounce: consumes the closest hit and the NEE shadow
    visibility, returns the next path state (and first-hit data at
    bounce 0). sobol_bounce >= 0 draws the NEE and bounce samples from
    Sobol slots 2b and 2b + 1."""
    (seed, alpha_seed, pos, view, attenuation, bsdf_pdf, regularization,
     pl_t, pl_d, pl_dr, pl_mr, alive, diffuse, reflection) = state
    primary_lobes = BSDFLobes(pl_t, pl_d, pl_dr, pl_mr)
    R = pos.shape[0]
    if cfg.has_alpha_materials:
        alpha_seed = rng_ops.pcg4d(alpha_seed)   # mirrors the pre-trace draw
    safe_view = _safe_dir(view)
    # point-light spheres (reference: rt_common_point_light.rint)
    see_lights = cfg.has_point_lights and \
        not (cfg.hide_lights and is_first) and not cfg.direct_only
    if see_lights:
        t_min = torch.full((R,), 0.0 if is_first else cfg.min_ray_dist,
                           dtype=torch.float32, device=pos.device)
        lt, lid = intersect_spheres(pos, safe_view, t_min, hit.t,
                                    scene.pl_pos, scene.pl_radius)
        light_hit = (lid >= 0) & (lt < hit.t)
    else:
        lid = torch.full((R,), -1, dtype=torch.int32, device=pos.device)
        light_hit = torch.zeros(R, dtype=torch.bool, device=pos.device)
    tri_hit = (hit.tri_id >= 0) & ~light_hit
    miss = ~tri_hit & ~light_hit

    # one tri_packed row per ray serves interpolation, material constants,
    # the emissive flag and the NEE corner reads
    g_row = scene.tri_packed[hit.tri_id.clamp(min=0).long()]
    v = interpolate_vertex(scene, hit.tri_id, hit.u, hit.v, safe_view,
                           ray_origin=pos, row=g_row)
    mat, v = sample_material(scene, v, slots=cfg.tex_slots, row=g_row)
    mat = mat._replace(albedo=torch.cat(
        [mat.albedo[:, :3], torch.ones_like(mat.albedo[:, 3:])], dim=-1))
    is_emissive_inst = g_row[:, TP_IP + IP_LIGHTBASE] >= 0

    zeros = torch.zeros_like(bsdf_pdf)
    nee_point, nee_dir, nee_tri, nee_env = zeros, zeros, zeros, zeros
    light = torch.zeros_like(pos)
    emission = mat.emission

    if cfg.nee.triangle > 0:
        tri_pdf = sample_triangle_light_pdf(
            v.pos - pos,
            g_row[:, TP_POS + 0:TP_POS + 3] - pos,
            g_row[:, TP_POS + 3:TP_POS + 6] - pos,
            g_row[:, TP_POS + 6:TP_POS + 9] - pos,
            cfg.tri_light_mode)
        emissive_hit = tri_hit & is_emissive_inst
        nee_tri = torch.where(emissive_hit, tri_pdf, 0.0)
        light = torch.where(emissive_hit[:, None], emission, light)
        emission = torch.where(emissive_hit[:, None], 0.0, emission)
    emission = torch.where(tri_hit[:, None], emission, 0.0)
    light = torch.where(tri_hit[:, None], light, 0.0)

    if see_lights:
        lid_s = lid.clamp(min=0).long()
        pl_col = point_light_radiance(scene, lid_s, safe_view)
        if cfg.nee.point > 0:
            light = torch.where(light_hit[:, None], pl_col, light)
            nee_point = torch.where(
                light_hit, sample_point_light_pdf(scene, lid_s, pos),
                nee_point)
        else:
            emission = torch.where(light_hit[:, None], pl_col, emission)

    env_col, env_pdf = environment_radiance(scene, safe_view, cfg.has_envmap)
    dl_col, dl_pdf = directional_light_radiance(scene, safe_view)
    if cfg.nee.directional > 0:
        light = torch.where(miss[:, None], light + dl_col, light)
        nee_dir = torch.where(miss, dl_pdf, nee_dir)
    else:
        emission = torch.where(miss[:, None], emission + dl_col, emission)
    if cfg.nee.envmap > 0:
        light = torch.where(miss[:, None], light + env_col, light)
        nee_env = torch.where(miss, env_pdf if cfg.has_envmap else 0.0,
                              nee_env)
    else:
        emission = torch.where(miss[:, None], emission + env_col, emission)

    terminal = ~tri_hit | (b_idx == max_bounces - 1)
    if cfg.direct_only and not is_first:
        # direct renderer: secondary rays must not see emitters
        light = torch.zeros_like(light)
        emission = torch.zeros_like(emission)

    # ---- MIS + emission accumulation ----------------------------------
    mis_pdf = bsdf_mis_pdf(cfg, scene, nee_point, nee_dir, nee_tri,
                           nee_env, bsdf_pdf)
    has_pdf = bsdf_pdf != 0
    attenuation = torch.where(
        has_pdf[:, None],
        attenuation / torch.clamp(bsdf_pdf, min=1e-30)[:, None], attenuation)
    mis_weight = torch.where(has_pdf,
                             bsdf_pdf / torch.clamp(mis_pdf, min=1e-30), 1.0)
    contrib = attenuation * mis_weight[:, None] * (emission + light)
    contrib = torch.where(alive[:, None], contrib, 0.0)
    if not is_first or cfg.clamp_first_bounce:
        contrib = _clamp_contribution(cfg, contrib)
    d_new, r_new = add_demodulated_color(primary_lobes, contrib,
                                         diffuse[:, :3], reflection[:, :3])
    diffuse = torch.cat([d_new, diffuse[:, 3:]], dim=-1)
    reflection = torch.cat([r_new, reflection[:, 3:]], dim=-1)

    first = None
    if is_first:
        miss_albedo = torch.where(light_hit[:, None],
                                  vec([0.0, 0, 0, 1.0], pos), 0.0)
        first = dict(
            vertex_pos=v.pos, vertex_prev_pos=v.prev_pos,
            mapped_normal=torch.where(tri_hit[:, None], v.mapped_normal,
                                      -safe_view),
            instance_id=torch.where(tri_hit, v.instance_id, -1),
            albedo=torch.where(tri_hit[:, None], mat.albedo, miss_albedo),
            metallic=torch.where(tri_hit, mat.metallic, 1.0),
            roughness=torch.where(tri_hit, mat.roughness, 1.0),
            emission=contrib)

    # ---- regularization ------------------------------------------------
    if cfg.regularization_gamma > 0:
        reg_mul = torch.clamp(
            1 - cfg.regularization_gamma /
            torch.clamp(bsdf_pdf, min=1e-30) ** 0.25, min=0.0)
        regularization = regularization * torch.where(has_pdf, reg_mul, 1.0)
        mat = mat._replace(
            roughness=1.0 - (1.0 - mat.roughness) * regularization)

    t, b, n = create_tangent_space(v.mapped_normal)
    shading_view = view_to_tangent_space(safe_view, t, b, n)

    # ---- NEE ------------------------------------------------------------
    if cfg.nee.any:
        slot = -1 if sobol_bounce < 0 else sobol_bounce * 2
        seed, rand = draw_ray_sample(cfg, seed, coord, slot)
        if cfg.has_alpha_materials:
            alpha_seed = rng_ops.pcg4d(alpha_seed)   # mirrors the NEE draw
        radiance, nee_lobes = next_event_estimation(
            cfg, scene, rand, (t, b, n), shading_view, mat,
            v.pos, v.hard_normal, vis)
        radiance = attenuation * radiance
        active_nee = alive & ~terminal
        if not is_first:
            radiance = radiance * modulate_bsdf(mat, nee_lobes)
            radiance = _clamp_contribution(cfg, radiance)
        else:
            primary_lobes = BSDFLobes(*(
                torch.where(active_nee, n_, p_)
                for n_, p_ in zip(nee_lobes, primary_lobes)))
            if cfg.clamp_first_bounce:
                radiance = _clamp_contribution(cfg, radiance)
        radiance = torch.where(active_nee[:, None], radiance, 0.0)
        d_new, r_new = add_demodulated_color(
            primary_lobes, radiance, diffuse[:, :3], reflection[:, :3])
        diffuse = torch.cat([d_new, diffuse[:, 3:]], dim=-1)
        reflection = torch.cat([r_new, reflection[:, 3:]], dim=-1)
        if not is_first:
            # bounce 1 stores 1/first-segment-length in alpha for denoisers
            set_a = active_nee & (b_idx == 1)
            inv_dist = 1.0 / torch.clamp(length(v.pos - pos), min=1e-30)
            a = torch.where(set_a, inv_dist, diffuse[:, 3])[:, None]
            diffuse = torch.cat([diffuse[:, :3], a], dim=-1)
            reflection = torch.cat([reflection[:, :3], a], dim=-1)
    else:
        seed, _ = rng_ops.generate_uniform_random_uint(seed)

    alive = alive & ~terminal

    # ---- next bounce -----------------------------------------------------
    slot2 = -1 if sobol_bounce < 0 else sobol_bounce * 2 + 1
    seed, rand = draw_ray_sample(cfg, seed, coord, slot2)
    out_dir_ts, lobes, new_bsdf_pdf = material_bsdf_sample(
        rng_ops.uint_to_float(rand), shading_view, mat, cfg.bounce_mode)
    new_view = from_tangent_space(out_dir_ts, t, b, n)
    lobes = _correct_lobes_for_normal_map(v.hard_normal, new_view, lobes)

    if not is_first:
        attenuation = torch.where(alive[:, None],
                                  attenuation * modulate_bsdf(mat, lobes),
                                  attenuation)
    else:
        primary_lobes = BSDFLobes(*(
            torch.where(alive, n_, p_)
            for n_, p_ in zip(lobes, primary_lobes)))

    bsdf_pdf = torch.where(alive, new_bsdf_pdf, bsdf_pdf)
    pos = torch.where(alive[:, None], v.pos, pos)
    view = torch.where(alive[:, None], new_view, view)

    if cfg.russian_roulette_delta > 0:
        # unbiased Russian roulette with an independent decision draw, as
        # in tauray_tpu (survivors reweighted by 1/qi)
        qi = min(1.0, 1.0 / cfg.russian_roulette_delta)
        seed, rr_rand = rng_ops.generate_uniform_random_uint(seed)
        alive = alive & (rng_ops.uint_to_float(rr_rand[:, 0]) <= qi)
        attenuation = torch.where(alive[:, None], attenuation / qi,
                                  attenuation)
    alive = alive & (attenuation.amax(dim=-1) > 0.0)

    state = (seed, alpha_seed, pos, view, attenuation, bsdf_pdf,
             regularization, *primary_lobes, alive, diffuse, reflection)
    return state, first


def _nee_prep(cfg: PTConfig, scene: DeviceScene, seed, alpha_seed, hit,
              pos, view, coord=None, slot: int = -1):
    """NEE shadow rays: redraws the same RNG values the shading pass will.
    Returns (origin, direction, length, the shadow wave's alpha cutoff).
    The cutoff is the closest-hit wave's (_advance_alpha), as in
    tauray_tpu: both read pcg4d of the same alpha state."""
    safe_view = _safe_dir(view)
    v = interpolate_vertex(scene, hit.tri_id, hit.u, hit.v, safe_view,
                           ray_origin=pos)
    _, rand = draw_ray_sample(cfg, seed, coord, slot)
    _, out_dir, out_len, _ = sample_explicit_light(cfg, scene, rand, v.pos)
    if cfg.has_alpha_materials:
        nee_alpha_u = _advance_alpha(alpha_seed)
    else:
        nee_alpha_u = torch.zeros_like(out_len)
    return v.pos, _safe_dir(out_dir), out_len, nee_alpha_u


def _advance_alpha(alpha_seed):
    """Per-ray stochastic-alpha cutoff in [0, 1) from the alpha stream."""
    return rng_ops.uint_to_float(rng_ops.pcg4d(alpha_seed)[:, 0])


# stochastic-alpha re-trace rounds of the path tracer's waves
ALPHA_ROUNDS = 6
# None, or a list to which each alpha-tested wave appends (its rays, its
# pending rays at the start of each round and after the last, as one
# device tensor); read by chip_smoke phase 8
ALPHA_PENDING = None


def _as_i32(x):
    """float32 column -> its bits as int32 (exact through gathers)."""
    return x.contiguous().view(torch.int32)


def _as_f32(x):
    return x.contiguous().view(torch.float32)


def _trace_alpha_program(scene: DeviceScene, tracer, o, d, t_min, t_max,
                         alpha_u, has_alpha: bool, any_hit: bool = False,
                         rounds: int = ALPHA_ROUNDS, sort: bool = False,
                         need_uv: bool = False) -> Hit:
    """Alpha-tested trace (tauray_tpu path_tracer._trace_alpha_program).

    The first trace's hit ids are the transparency test: the flat and the
    instanced build put alpha-capable triangles in the tail clusters, so
    trace_flagged marks "might be transparent" hits (slot >= alpha_base)
    without a material fetch. Flagged rays are then serviced compacted:
    each round moves the pending rays to the front (a stable argsort),
    alpha-tests and re-traces a sub-wave of `cap` rays past their hit,
    and scatters the results back; rays beyond `cap` stay pending for a
    later round. A serviced ray stays pending only when its re-hit is
    flagged again. The per-round state moves as one int32 row per ray
    (floats as their bits), so ids never pass through a float.

    Every round runs, with no host read, as tauray_tpu's device loop
    reads none: a round with nothing pending changes nothing."""
    R = o.shape[0]
    t_min, t_max = per_ray(t_min, o), per_ray(t_max, o)
    if not has_alpha:
        return tracer.trace(o, d, t_min, t_max, any_hit=any_hit,
                            sort_rays=sort, need_uv=need_uv)
    hit, pending = tracer.trace_flagged(o, d, t_min, t_max, any_hit=any_hit,
                                        sort_rays=sort, need_uv=need_uv)
    cutoff = per_ray(alpha_u, o)
    quantum = 8192
    cap = min(R, max(quantum, (R // 32) // quantum * quantum))
    ray_pack = _as_i32(torch.cat([o, d, cutoff[:, None], t_max[:, None]],
                                 dim=1).to(torch.float32))       # (R, 8)
    # (R, 6) int32: t, u, v, t_min, tri_id, pending
    cur = torch.stack([_as_i32(hit.t), _as_i32(hit.u), _as_i32(hit.v),
                       _as_i32(t_min), hit.tri_id,
                       pending.to(torch.int32)], dim=1)
    counts = [] if ALPHA_PENDING is not None else None
    for _ in range(rounds):
        if counts is not None:
            counts.append(pending.sum())
        with tracing.span("alpha"):
            idx = torch.argsort((~pending).to(torch.int32),
                                stable=True)[:cap]
            s = torch.cat([cur, ray_pack], dim=1)[idx]          # (cap, 14)
            t_s, u_s, v_s, tmin_s = (_as_f32(s[:, k]) for k in range(4))
            tri_s = s[:, 4]
            o_s, d_s = _as_f32(s[:, 6:9]), _as_f32(s[:, 9:12])
            cut_s, tmax_s = _as_f32(s[:, 12]), _as_f32(s[:, 13])
            # alpha test (uv interpolation + texture fetch) on the
            # sub-wave only
            skip_s, ntmin_s = _alpha_skip_impl(
                scene, t_s, tri_s, u_s, v_s, cut_s, tmin_s, o=o_s, d=d_s,
                recompute_uv=not need_uv)
            skip_s = skip_s & (s[:, 5] > 0)
        rehit, reflag = tracer.trace_flagged(
            o_s, d_s, ntmin_s, torch.where(skip_s, tmax_s, 0.0),
            any_hit=any_hit, need_uv=need_uv)
        with tracing.span("alpha"):
            out = torch.stack([
                _as_i32(torch.where(skip_s, rehit.t, t_s)),
                _as_i32(torch.where(skip_s, rehit.u, u_s)),
                _as_i32(torch.where(skip_s, rehit.v, v_s)),
                _as_i32(ntmin_s), torch.where(skip_s, rehit.tri_id, tri_s),
                (skip_s & reflag).to(torch.int32)], dim=1)
            cur[idx] = out
            pending = cur[:, 5] > 0
    if counts is not None:
        counts.append(pending.sum())
        ALPHA_PENDING.append((R, torch.stack(counts)))
    return Hit(_as_f32(cur[:, 0]), cur[:, 4].contiguous(),
               _as_f32(cur[:, 1]), _as_f32(cur[:, 2]))


def _alpha_skip_impl(scene: DeviceScene, t, tri_id, u, v, cutoff, t_min,
                     o=None, d=None, recompute_uv: bool = False):
    """One tri_packed row gather and one texture block gather per ray.
    Returns (skip: a transparent hit, the t_min past it). recompute_uv:
    barycentrics from the gathered row and the ray (pairs with
    need_uv=False traces)."""
    g = scene.tri_packed[tri_id.clamp(min=0).long()]
    may_skip = (tri_id >= 0) & (g[:, TP_IP + IP_HASALPHA] > 0.5)
    alpha = row_alpha(scene, g, u, v, o, d, recompute_uv)
    skip = may_skip & (alpha <= cutoff)
    return skip, torch.where(skip, t * (1 + 1e-5) + 1e-6, t_min)


def host_trace_alpha(scene, tracer, o, d, t_min, t_max, alpha_u,
                     has_alpha: bool, any_hit: bool = False,
                     rounds: int = ALPHA_ROUNDS, sort: bool = False,
                     need_uv: bool = False) -> Hit:
    """The path tracer's alpha-tested trace of one wave (tauray_tpu's
    host entry to _trace_alpha_program)."""
    return _trace_alpha_program(scene, tracer, o, d, t_min, t_max, alpha_u,
                                has_alpha, any_hit, rounds, sort, need_uv)


def _run_bounce(cfg: PTConfig, scene: DeviceScene, tracer, state,
                b_idx: int, is_first: bool, max_bounces: int, coord=None):
    """Closest-hit wave, NEE shadow wave, shading. Bounce and shadow waves
    are sorted by their active-set signature; camera waves keep
    pixel-block order. Both waves take the alpha re-trace rounds when the
    scene has alpha-tested materials. Returns (state, first-hit data,
    useful rays or None)."""
    seed, alpha_seed, pos, view = state[:4]
    alive = state[11]
    sobol_bounce = -1 if cfg.sampler == "uniform-random" else b_idx
    alpha_u = _advance_alpha(alpha_seed) if cfg.has_alpha_materials else 0.0
    t_min = 0.0 if is_first else cfg.min_ray_dist
    t_max = torch.where(alive, RAY_MAX_DIST, 0.0)
    if _WAVE_DUMP is not None:
        _WAVE_DUMP.append(("bounce", pos, view, t_min, t_max))
    hit = host_trace_alpha(scene, tracer, pos, view, t_min, t_max, alpha_u,
                           cfg.has_alpha_materials, sort=not is_first)
    check_nan(cfg.validate, f"bounce {b_idx} trace", *hit)
    useful = (t_max > 0.0).sum() if cfg.count_rays else None
    if cfg.nee.any and b_idx < max_bounces - 1:
        slot = -1 if sobol_bounce < 0 else sobol_bounce * 2
        with tracing.span("shade"):
            sh_o, sh_d, sh_len, nee_alpha_u = _nee_prep(
                cfg, scene, seed, alpha_seed, hit, pos, view, coord, slot)
        sh_len = torch.where(alive & (hit.tri_id >= 0), sh_len, 0.0)
        check_nan(cfg.validate, f"bounce {b_idx} NEE", sh_o, sh_d, sh_len)
        if _WAVE_DUMP is not None:
            _WAVE_DUMP.append(("shadow", sh_o, sh_d, cfg.min_ray_dist,
                               sh_len))
        sh = host_trace_alpha(scene, tracer, sh_o, sh_d, cfg.min_ray_dist,
                              sh_len, nee_alpha_u, cfg.has_alpha_materials,
                              any_hit=True, sort=True)
        vis = torch.where(sh.tri_id < 0, 1.0, 0.0)
        if cfg.count_rays:
            useful = useful + (sh_len > 0.0).sum()
    else:
        vis = torch.ones_like(t_max)
    with tracing.span("shade"):
        state, first = _shade_bounce(cfg, scene, state, hit, vis, b_idx,
                                     is_first, max_bounces, coord,
                                     sobol_bounce)
    check_nan(cfg.validate, f"bounce {b_idx} shade", *state)
    return state, first, useful


def evaluate_ray(cfg: PTConfig, scene: DeviceScene, tracer, sampler_seed,
                 pos, view, coord=None):
    """One path per ray (reference: shader/path_tracer.glsl evaluate_ray).
    coord: (R, 4) uint32 sampler coordinates (the Sobol samplers read the
    pixel and sample index there). Returns (diffuse (R, 4), reflection
    (R, 4), first-hit dict, useful rays or None)."""
    R = pos.shape[0]
    z = torch.zeros(R, dtype=torch.float32, device=pos.device)
    state = (
        sampler_seed,
        rng_ops.pcg4d(sampler_seed),          # stochastic-alpha stream
        pos, view,
        torch.ones((R, 3), dtype=torch.float32, device=pos.device),
        z,                                    # bsdf_pdf
        torch.ones_like(z),                   # regularization
        # primary lobes start at ZERO so bounce-0 emission reaches the
        # image only via first_hit.emission
        z, z, z, z,
        torch.ones(R, dtype=torch.bool, device=pos.device),   # alive
        torch.zeros((R, 4), dtype=torch.float32, device=pos.device),
        torch.zeros((R, 4), dtype=torch.float32, device=pos.device),
    )
    max_bounces = 2 if cfg.direct_only else cfg.max_bounces
    state, first, useful = _run_bounce(cfg, scene, tracer, state, 0, True,
                                       max_bounces, coord)
    for b_idx in range(1, max_bounces):
        state, _, u = _run_bounce(cfg, scene, tracer, state, b_idx, False,
                                  max_bounces, coord)
        if cfg.count_rays:
            useful = useful + u
    return state[-2], state[-1], first, useful


def _film_offset(cfg: PTConfig, seed):
    """Film filter AA offset in [-1, 1] units (reference:
    shader/path_tracer.glsl get_world_camera_ray)."""
    if cfg.film == "point":
        return seed, None
    seed, rand = rng_ops.generate_uniform_random_uint(seed)
    u = rng_ops.uint_to_float(rand[..., :2])
    if cfg.film == "box":
        off = u * 2.0 - 1.0
    else:  # blackman-harris
        off = sample_blackman_harris_concentric_disk(u) * 2.0
    return seed, off * (2.0 * cfg.film_radius)


def rng_seed_hash(rng_seed: int) -> int:
    """pcg of the user seed, on the host in numpy uint32."""
    if rng_seed == 0:
        return 0
    s = np.uint32(rng_seed)
    with np.errstate(over="ignore"):
        s = s * np.uint32(747796405) + np.uint32(2891336453)
        s = ((s >> np.uint32((s >> np.uint32(28)) + np.uint32(4))) ^ s) \
            * np.uint32(277803737)
    return int((s >> np.uint32(22)) ^ s)


def _begin_sample(cfg: PTConfig, cam: CameraUniforms, pix_pos, vp,
                  prev_plus_i):
    """Sampler init + film/DoF sampling + camera ray generation
    (reference: shader/path_tracer.rgen main + get_world_camera_ray).
    pix_pos (R, 2) i32, vp (R,) i32, prev_plus_i (R,) sample index."""
    size = torch.tensor([cfg.width, cfg.height], dtype=torch.float32,
                        device=pix_pos.device)
    coord = torch.stack([
        rng_ops.as_u32(pix_pos[:, 0]), rng_ops.as_u32(pix_pos[:, 1]),
        (rng_ops.as_u32(vp) + rng_seed_hash(cfg.rng_seed)) & rng_ops.MASK32,
        rng_ops.as_u32(prev_plus_i)], dim=-1)
    seed = rng_ops.init_random_sampler(coord)
    seed, film_off = _film_offset(cfg, seed)
    dof_u = None
    if cfg.use_dof:
        seed, rand = rng_ops.generate_uniform_random_uint(seed)
        dof_u = rng_ops.uint_to_float(rand[..., :2])
    origin, d = get_screen_camera_ray(cam, vp.long(), pix_pos, size,
                                      pixel_offset=film_off, dof_u=dof_u)
    # payload.random_seed draw (reference: evaluate_ray first line)
    seed, _ = rng_ops.generate_uniform_random_uint(seed)
    return seed, origin, d, coord


def _finalize_sample(cfg: PTConfig, prev_cam: CameraUniforms, vp, diffuse,
                     refl, fh_albedo, fh_metallic, fh_emission,
                     fh_prev_pos):
    """Per-sample color modulation (reference: shader/path_tracer.rgen
    sum_color) + screen motion projection."""
    albedo = fh_albedo
    if cfg.use_white_albedo_on_first_bounce:
        albedo = torch.cat([torch.ones_like(fh_albedo[:, :3]),
                            fh_albedo[:, 3:]], dim=-1)

    color = fh_emission + modulate_color(_FirstHit(albedo, fh_metallic),
                                         diffuse[:, :3], refl[:, :3])
    return color, get_camera_projection(prev_cam, vp.long(), fh_prev_pos)


class _FirstHit(NamedTuple):
    albedo: torch.Tensor
    metallic: torch.Tensor


def pt_trace_pass(cfg: PTConfig, scene: DeviceScene, tracer,
                  cam: CameraUniforms, prev_cam: CameraUniforms,
                  pix_pos, vp, previous_samples) -> PTOutput:
    """One pass of `samples_per_pass` samples per pixel, averaged
    (reference: shader/path_tracer.rgen main). All samples of the pass
    trace as ONE wavefront of R*S rays, pixel-major; every RNG stream is
    keyed on (pixel, viewport, sample index), never on wave shape."""
    R = pix_pos.shape[0]
    S = cfg.samples_per_pass
    if S == 1:
        pix_b, vp_b, prev_b = pix_pos, vp, previous_samples
    else:
        pix_b = pix_pos.repeat_interleave(S, dim=0)
        vp_b = vp.repeat_interleave(S, dim=0)
        prev_b = previous_samples.repeat_interleave(S, dim=0) + \
            torch.arange(S, dtype=previous_samples.dtype,
                         device=previous_samples.device).repeat(R)

    seed, origin, d, coord = _begin_sample(cfg, cam, pix_b, vp_b, prev_b)
    check_nan(cfg.validate, "camera rays", origin, d)
    diffuse, refl, fh, useful = evaluate_ray(cfg, scene, tracer, seed,
                                             origin, d, coord)
    color, screen_motion = _finalize_sample(
        cfg, prev_cam, vp_b, diffuse, refl, fh["albedo"], fh["metallic"],
        fh["emission"], fh["vertex_prev_pos"])
    check_nan(cfg.validate, "sample colour", color)

    if S == 1:
        sum_color, sum_diffuse, sum_reflection = color, diffuse, refl
        first, first_motion = fh, screen_motion
    else:
        def mean_s(x):
            return x.reshape(R, S, -1).mean(dim=1)
        sum_color = mean_s(color)
        sum_diffuse = mean_s(diffuse)
        sum_reflection = mean_s(refl)
        # first-hit G-buffer from sample 0 (row r*S)
        first = {k: v[::S] for k, v in fh.items()}
        first_motion = screen_motion[::S]

    if cfg.transparent_background:
        alpha = first["albedo"][:, 3]
    else:
        alpha = torch.ones_like(sum_color[:, 0])
    return PTOutput(
        color=torch.cat([sum_color, alpha[:, None]], dim=-1),
        diffuse=sum_diffuse, reflection=sum_reflection,
        first_albedo=first["albedo"], first_normal=first["mapped_normal"],
        first_pos=first["vertex_pos"], first_screen_motion=first_motion,
        first_instance=first["instance_id"],
        first_metallic_roughness=torch.stack(
            [first["metallic"], first["roughness"]], dim=-1),
        first_emission=first["emission"], useful_rays=useful)


def accumulate(new, prev, samples: float, previous_samples: float):
    """Running mean (reference: shader/gbuffer.glsl
    accumulate_gbuffer_color)."""
    total = samples + previous_samples
    t = np.float32(previous_samples) / np.float32(max(total, 1))
    return new * (1.0 - float(t)) + prev * float(t)
