"""Alpha-tested ray traversal; the torch counterpart of
tauray_tpu.ops.trace_utils.

The reference handles alpha-masked/blended materials in any-hit shaders:
closest-hit queries skip texels with albedo.a <= cutoff (deterministic
1e-4 cutoff for feature/AOV rays, a per-ray uniform random cutoff for path
tracing — stochastic transparency; reference: shader/rt_feature.rahit,
shader/rt_common.rahit, shader/rt.glsl is_material_skippable).

Wavefront formulation: trace, evaluate alpha at hits on
transparency-capable instances, and re-trace skipped rays with t_min
advanced past the hit, for a fixed number of rounds. The path tracer's
main path services its alpha hits compacted instead
(stages/path_tracer._trace_alpha_program); these fixed-round versions are
for the feature, ReSTIR and raster stages."""

from __future__ import annotations

import torch

from ..scene.device import (IP_ALBEDO, IP_TEX, IP_TEXBLOCK, IP_TEXSIZE,
                            TP_IP, TP_UV, DeviceScene)
from .intersect import Hit
from .shading import bary_from_row, sample_texture_quad


def row_alpha(scene: DeviceScene, g, u, v, o=None, d=None,
               recompute_uv: bool = False):
    """albedo.a at a hit on the triangle whose tri_packed row is g
    (reference: shader/rt.glsl is_material_skippable: albedo_factor.a *
    albedo_texture.a): one texture block gather. recompute_uv:
    barycentrics from the row and the ray (pairs with need_uv=False
    traces)."""
    if recompute_uv:
        u, v = bary_from_row(g, o, d)
    b0 = (1.0 - u - v)[:, None]
    uv = (g[:, TP_UV:TP_UV + 2] * b0 +
          g[:, TP_UV + 2:TP_UV + 4] * u[:, None] +
          g[:, TP_UV + 4:TP_UV + 6] * v[:, None])
    m = g[:, TP_IP:]
    tex_a = sample_texture_quad(
        scene, m[:, IP_TEX].to(torch.int32),
        m[:, IP_TEXSIZE:IP_TEXSIZE + 2], uv,
        block=m[:, IP_TEXBLOCK:IP_TEXBLOCK + 2])[:, 3]
    return m[:, IP_ALBEDO + 3] * tex_a


def _hit_alpha(scene: DeviceScene, tri_id, u, v, o=None, d=None,
               recompute_uv: bool = False):
    """albedo.a at a hit: one tri_packed row gather, then row_alpha."""
    return row_alpha(scene, scene.tri_packed[tri_id.clamp(min=0).long()],
                      u, v, o, d, recompute_uv)


def per_ray(x, like: torch.Tensor) -> torch.Tensor:
    """A scalar or (R,) value as an (R,) float32 tensor on like's
    device."""
    return torch.as_tensor(x, dtype=torch.float32,
                           device=like.device).expand(like.shape[0])


def trace_alpha(scene: DeviceScene, tracer, origins, dirs, t_min, t_max,
                alpha_cutoff, has_alpha_materials: bool,
                any_hit: bool = False, rounds: int = 2,
                sort: bool = False, need_uv: bool = True) -> Hit:
    """Closest-hit (or shadow any-hit) trace with alpha skipping.

    alpha_cutoff: scalar or (R,) per-ray cutoff; hits with
    albedo.a <= cutoff are transparent and skipped. sort: the tracer's
    signature sort of the first trace (incoherent bounce/shadow waves)."""
    hit = tracer.trace(origins, dirs, t_min, t_max, any_hit=any_hit,
                       sort_rays=sort, need_uv=need_uv)
    if not has_alpha_materials:
        return hit
    cutoff, t_min, t_max = (per_ray(x, hit.t)
                            for x in (alpha_cutoff, t_min, t_max))
    for _ in range(rounds):
        valid = hit.tri_id >= 0
        inst = scene.tri_instance[hit.tri_id.clamp(min=0).long()].clamp(
            min=0).long()
        may_skip = valid & scene.inst_has_alpha[inst]
        alpha = _hit_alpha(scene, hit.tri_id, hit.u, hit.v, origins, dirs,
                           recompute_uv=not need_uv)
        skip = may_skip & (alpha <= cutoff)
        # re-trace skipped rays past the transparent hit; everyone else
        # gets t_max = 0, so the traversal resolves them in 0 steps
        new_tmin = torch.where(skip, hit.t * (1 + 1e-5) + 1e-6, t_min)
        new_tmax = torch.where(skip, t_max, 0.0)
        rehit = tracer.trace(origins, dirs, new_tmin, new_tmax,
                             any_hit=any_hit, need_uv=need_uv)
        hit = Hit(*(torch.where(skip, a, b) for a, b in zip(rehit, hit)))
    return hit


def shadow_visibility_alpha(scene: DeviceScene, tracer, origins, dirs,
                            t_min, t_max, alpha_cutoff,
                            has_alpha_materials: bool,
                            rounds: int = 2) -> torch.Tensor:
    """1 where the shadow ray reaches t_max through alpha-skipped hits,
    else 0."""
    hit = trace_alpha(scene, tracer, origins, dirs, t_min, t_max,
                      alpha_cutoff, has_alpha_materials, any_hit=True,
                      rounds=rounds)
    return torch.where(hit.tri_id < 0, 1.0, 0.0)
