"""ReSTIR GI: path-space reservoirs with the reference's three shift
mappings (reference: src/restir_stage.cc + shader/restir_core.glsl
shift_map(): reconnection shift restir_core.glsl:1514, random replay
restir_core.glsl:1645, hybrid restir_core.glsl:1695,1880); the torch
counterpart of tauray_tpu.stages.restir_gi.

* A path sample is stored as (rng seed, reconnection vertex data): the
  seed alone reproduces the whole path (the random replay shift is exact
  primary-sample-space reuse, Jacobian 1), while the reconnection data
  lets the reconnection shift evaluate a neighbour's path suffix again
  with two BSDF evaluations and one geometric Jacobian, without a trace.
* The suffix light estimate at the reconnection vertex splits into a
  direction-independent part (emission + NEE with its own pdf folded in)
  and the BSDF factors at both reconnection endpoints, evaluated per
  receiving pixel (the reference's analogous approximation is
  restir.assume-unchanged-reconnection-radiance).
* Suffix estimator: NEE samples all enabled strategies; BSDF
  continuation rays carry only non-emissive transport, so NEE and BSDF
  techniques stay disjoint.
* Replay shifts batch every pixel's paths into the same full-frame trace
  waves through the shared tracer.

Sample streams are tauray_tpu's pcg4d streams, keyed on (x, y, 7,
frame); uint32 values are int64 tensors masked to 32 bits (ops/rng)."""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import numpy as np
import torch

from ..ops import rng as rng_ops
from ..ops.ggx import material_bsdf_pdf, material_bsdf_sample, modulate_bsdf
from ..ops.lights import environment_radiance
from ..ops.sampling import (create_tangent_space, from_tangent_space,
                            to_tangent_space)
from ..ops.shading import (SampledMaterial, interpolate_vertex,
                           rgb_to_luminance, sample_material)
from ..ops.trace_utils import trace_alpha
from ..scene.device import DeviceScene
from .restir import (_eval_light_sample, _numpy_fields, disk_neighbour,
                     gbuffer_material, light_cdf, pick_light, pixel_seeds,
                     reproject)

M_PI = math.pi

RC_NONE = 0     # no valid path (absorbed / zero throughput)
RC_SURF = 1     # reconnection vertex is a surface hit
RC_ENV = 2      # first bounce escaped to the environment


class PathReservoir(NamedTuple):
    """Per-pixel path reservoir; (H, W, ...) tensors (the reference packs
    the same data in ris_data/reconnection_data/reconnection_radiance/
    rng_seeds textures, restir_stage.hh:230-270)."""
    seed: torch.Tensor       # (H, W, 4) uint32 values in int64
    rc_kind: torch.Tensor    # (H, W) i32 RC_*
    rc_pos: torch.Tensor     # (H, W, 3) x1 position (or escape direction)
    rc_normal: torch.Tensor  # (H, W, 3)
    rc_alb: torch.Tensor     # (H, W, 4) albedo+alpha at x1
    rc_mr: torch.Tensor      # (H, W, 2) metallic/roughness at x1
    rc_emit: torch.Tensor    # (H, W, 3) Le(x1) (RC_SURF) or env radiance
    rc_nee_dir: torch.Tensor  # (H, W, 3) NEE direction at x1
    rc_nee_L: torch.Tensor    # (H, W, 3) NEE Le*vis/pdf at x1
    rc_in_dir: torch.Tensor   # (H, W, 3) continuation direction at x1
    rc_in_L: torch.Tensor     # (H, W, 3) suffix radiance / pdf from there
    w_sum: torch.Tensor       # (H, W)
    M: torch.Tensor           # (H, W)
    target_p: torch.Tensor    # (H, W)

    @staticmethod
    def empty(H, W, device):
        def z(*c):
            return torch.zeros((H, W) + c, dtype=torch.float32,
                               device=device)
        return PathReservoir(
            torch.zeros((H, W, 4), dtype=torch.int64, device=device),
            torch.zeros((H, W), dtype=torch.int32, device=device),
            z(3), z(3), z(4), z(2), z(3), z(3), z(3), z(3), z(3), z(), z(),
            z())

    @property
    def W(self):
        return torch.where(
            self.target_p > 0,
            self.w_sum / (torch.clamp(self.M, min=1e-6) *
                          torch.clamp(self.target_p, min=1e-9)), 0.0)

    def to_numpy(self) -> dict:
        """numpy fields; seed as uint32."""
        f = _numpy_fields(self)
        f["seed"] = f["seed"].astype(np.uint32)
        return f

    @staticmethod
    def from_numpy(fields, device) -> "PathReservoir":
        """fields: a mapping of field name -> array, or a path reservoir
        of either package (tauray_tpu's included)."""
        f = _numpy_fields(fields)
        out = {k: torch.from_numpy(np.array(f[k])).to(device)
               for k in PathReservoir._fields if k != "seed"}
        out["seed"] = rng_ops.as_u32(
            torch.from_numpy(f["seed"].astype(np.int64))).to(device)
        return PathReservoir(**out)


def _mat_from_stored(alb, mr, R: int) -> SampledMaterial:
    dev = alb.device
    ior = torch.full((R,), 1.45, dtype=torch.float32, device=dev)
    ones = torch.ones(R, dtype=torch.float32, device=dev)
    return SampledMaterial(
        albedo=alb.reshape(R, 4), metallic=mr.reshape(R, 2)[:, 0],
        roughness=mr.reshape(R, 2)[:, 1],
        emission=torch.zeros((R, 3), dtype=torch.float32, device=dev),
        transmittance=torch.zeros(R, dtype=torch.float32, device=dev),
        ior_in=ones, ior_out=ior, f0=((ior - 1) / (ior + 1)) ** 2,
        double_sided=torch.ones(R, dtype=torch.bool, device=dev),
        shadow_terminator_mul=ones)


def _eval_bsdf(mat, normal, view, out_dir, bounce_mode):
    """Modulated BSDF f(view->out) in world space; view points toward the
    surface (the camera convention used throughout)."""
    t, b, n = create_tangent_space(normal)
    sview = -to_tangent_space(view, t, b, n)
    sout = to_tangent_space(out_dir, t, b, n)
    lobes, pdf = material_bsdf_pdf(sout, sview, mat, bounce_mode)
    return modulate_bsdf(mat, lobes), pdf


def _sample_bsdf(mat, normal, view, rnd, bounce_mode):
    t, b, n = create_tangent_space(normal)
    sview = -to_tangent_space(view, t, b, n)
    sout, lobes, pdf = material_bsdf_sample(rnd, sview, mat, bounce_mode)
    return (from_tangent_space(sout, t, b, n),
            modulate_bsdf(mat, lobes), pdf)


def _safe_dir(d):
    """Directions whose components sum in magnitude below 1e-30 become
    +z."""
    return torch.where(d.abs().sum(-1, keepdim=True) < 1e-30,
                       torch.tensor([0.0, 0.0, 1.0], device=d.device), d)


def _nee_once(scene, tracer, nee, seed, pos, has_alpha, min_ray_dist):
    """One NEE light sample: (seed', dir, Le*vis/pdf), the strategy
    picked over the weights' sum (stages/restir's storage format)."""
    R = pos.shape[0]
    seed, rnd = rng_ops.generate_uniform_random(seed)
    w, _ = light_cdf(nee)
    total = max(float(w.sum(dtype=np.float32)), 1e-9)
    strat, lidx = pick_light(scene, nee, rnd[:, 3] * total, rnd[:, 2])
    color, dirs, dist, pdf = _eval_light_sample(
        scene, nee, strat, lidx, rnd[:, :2], pos)
    # the strategy-selection pdf weights[s] / total: the nee.* scaling of
    # _eval_light_sample folds weights[s] in, the total is divided here
    pdf = pdf / total
    sh = trace_alpha(scene, tracer, pos, _safe_dir(dirs),
                     torch.full((R,), min_ray_dist, device=pos.device),
                     torch.clamp(dist, max=1e30), 1e-4, has_alpha,
                     any_hit=True)
    vis = torch.where(sh.tri_id < 0, 1.0, 0.0)
    L = color * (vis / torch.clamp(pdf.abs(), min=1e-9))[:, None]
    L = torch.where((strat >= 0)[:, None], L, 0.0)
    return seed, dirs, L


def _generate_path(scene, tracer, seed0, pos, normal, view, mat, nee,
                   depth, bounce_mode, min_ray_dist, has_alpha,
                   has_envmap):
    """Trace one GI path from the G-buffer vertex; returns (C (R, 3)
    solid-angle-measure contribution, p1 (R,) first-bounce pdf, fields
    dict with the reconnection data). Deterministic in seed0."""
    R = pos.shape[0]
    dev = pos.device
    plus_z = torch.tensor([0.0, 0.0, 1.0], device=dev)
    t_min = torch.full((R,), min_ray_dist, device=dev)
    t_far = torch.full((R,), float("inf"), device=dev)
    seed, rnd = rng_ops.generate_uniform_random(seed0)
    d1, _, p1 = _sample_bsdf(mat, normal, view, rnd, bounce_mode)
    ok = p1 > 0
    safe_d1 = torch.where(ok[:, None], d1, plus_z)
    hit = trace_alpha(scene, tracer, pos, safe_d1, t_min, t_far, 1e-4,
                      has_alpha)
    missed = hit.tri_id < 0
    env_L, _ = environment_radiance(scene, safe_d1, has_envmap)

    v = interpolate_vertex(scene, hit.tri_id, hit.u, hit.v, safe_d1)
    mat1, v = sample_material(scene, v)
    x1 = v.pos
    n1 = v.mapped_normal

    # NEE at x1
    seed, nee_dir, nee_L = _nee_once(scene, tracer, nee, seed, x1,
                                     has_alpha, min_ray_dist)

    # continuation at x1 (+ the suffix loop, same convention)
    seed, rnd2 = rng_ops.generate_uniform_random(seed)
    d2, _, p2 = _sample_bsdf(mat1, n1, safe_d1, rnd2, bounce_mode)
    in_L = torch.zeros((R, 3), dtype=torch.float32, device=dev)
    if depth > 2:
        tau = torch.where((p2 > 0)[:, None], 1.0 / torch.clamp(
            p2, min=1e-9)[:, None], 0.0)
        cur_pos, cur_dir = x1, d2
        cur_alive = (p2 > 0) & ~missed
        for b in range(depth - 2):
            h = trace_alpha(scene, tracer, cur_pos, cur_dir, t_min, t_far,
                            1e-4, has_alpha)
            m = h.tri_id < 0
            if nee.envmap <= 0:
                eL, _ = environment_radiance(scene, cur_dir, has_envmap)
                in_L = in_L + torch.where((cur_alive & m)[:, None],
                                          tau * eL, 0.0)
            vv = interpolate_vertex(scene, h.tri_id, h.u, h.v, cur_dir)
            mm, vv = sample_material(scene, vv)
            nn = vv.mapped_normal
            alive = cur_alive & ~m
            seed, nd, nL = _nee_once(scene, tracer, nee, seed, vv.pos,
                                     has_alpha, min_ray_dist)
            fn, _ = _eval_bsdf(mm, nn, cur_dir, nd, bounce_mode)
            in_L = in_L + torch.where(alive[:, None], tau * fn * nL, 0.0)
            if b + 1 < depth - 2:
                seed, r3 = rng_ops.generate_uniform_random(seed)
                nd2, fc, pc = _sample_bsdf(mm, nn, cur_dir, r3,
                                           bounce_mode)
                tau = tau * torch.where(
                    (alive & (pc > 0))[:, None],
                    fc / torch.clamp(pc, min=1e-9)[:, None], 0.0)
                cur_pos, cur_dir = vv.pos, nd2
                cur_alive = alive & (pc > 0)
    kind = torch.where(ok, torch.where(missed, RC_ENV, RC_SURF),
                       RC_NONE).to(torch.int32)
    mcol = missed[:, None]
    fields = dict(
        seed=seed0, rc_kind=kind, rc_pos=torch.where(mcol, safe_d1, x1),
        rc_normal=torch.where(mcol, 0.0, n1),
        rc_alb=mat1.albedo,
        rc_mr=torch.stack([mat1.metallic, mat1.roughness], -1),
        rc_emit=torch.where(mcol, env_L, mat1.emission),
        rc_nee_dir=nee_dir, rc_nee_L=torch.where(mcol, 0.0, nee_L),
        rc_in_dir=d2, rc_in_L=torch.where(mcol, 0.0, in_L))
    C = _reconnect_eval(scene, fields, pos, normal, view, mat,
                        bounce_mode, nee)
    return C, torch.clamp(p1, min=1e-9), fields


def _reconnect_eval(scene, fields, pos, normal, view, mat, bounce_mode,
                    nee):
    """Contribution of a stored path re-rooted at (pos, normal, mat),
    solid-angle measure, visibility excluded (reference: restir_core.glsl
    reconnection_shift; visibility deferred to the final shade).

    Transport split against the DI reservoirs: light already integrated by
    DI at the primary vertex is excluded here: env escapes count only when
    envmap NEE is off, first-vertex emission only when triangle NEE is
    off."""
    kind = fields["rc_kind"]
    surf = kind == RC_SURF
    env = kind == RC_ENV
    delta = fields["rc_pos"] - pos
    dist = torch.linalg.norm(delta, dim=-1)
    d01 = torch.where(surf[:, None],
                      delta / torch.clamp(dist, min=1e-9)[:, None],
                      fields["rc_pos"])
    f0, p0 = _eval_bsdf(mat, normal, view, d01, bounce_mode)
    mat1 = _mat_from_stored(fields["rc_alb"], fields["rc_mr"],
                            pos.shape[0])
    f1n, _ = _eval_bsdf(mat1, fields["rc_normal"], d01,
                        fields["rc_nee_dir"], bounce_mode)
    f1i, _ = _eval_bsdf(mat1, fields["rc_normal"], d01,
                        fields["rc_in_dir"], bounce_mode)
    emit1 = fields["rc_emit"] if nee.triangle <= 0 else \
        torch.zeros_like(fields["rc_emit"])
    Lout = emit1 + f1n * fields["rc_nee_L"] + f1i * fields["rc_in_L"]
    # env escapes: balance-heuristic MIS between the BSDF pdf here and
    # DI's env NEE pdf (reference: path_tracer.glsl bsdf_mis_pdf applied
    # to escaped rays)
    env_emit = fields["rc_emit"]
    if nee.envmap > 0:
        _, env_pdf = environment_radiance(scene, d01, True)
        wsum = nee.point + nee.triangle + nee.envmap + nee.directional
        p_nee = env_pdf * (nee.envmap / max(wsum, 1e-9))
        misw = p0 / torch.clamp(p0 + p_nee, min=1e-9)
        env_emit = env_emit * misw[:, None]
    Lout = torch.where(surf[:, None], Lout, env_emit)
    C = f0 * Lout
    return torch.where((surf | env)[:, None], C, 0.0)


def _geom_term(fields, pos):
    """|cos(psi)| / dist^2 at the reconnection vertex: the reconnection
    shift's Jacobian is the ratio of this between domains (reference:
    restir_core.glsl reconnection_shift jacobian)."""
    surf = fields["rc_kind"] == RC_SURF
    delta = fields["rc_pos"] - pos
    d2 = torch.clamp((delta * delta).sum(-1), min=1e-12)
    cos = ((fields["rc_normal"] * delta / torch.sqrt(d2)[:, None])
           .sum(-1)).abs()
    return torch.where(surf, torch.clamp(cos, min=1e-6) / d2, 1.0)


def _merge(res: PathReservoir, cand, w, M_new, rand):
    take = (rand * torch.clamp(res.w_sum + w, min=1e-20)) < w
    t2 = take[..., None]
    out = {k: torch.where(take if getattr(res, k).dim() == 2 else t2,
                          cand[k], getattr(res, k))
           for k in PathReservoir._fields[:11]}
    return PathReservoir(
        **out, w_sum=res.w_sum + w, M=res.M + M_new,
        target_p=torch.where(take, cand["target_p"], res.target_p))


def _fields_of(res: PathReservoir):
    return {k: getattr(res, k) for k in PathReservoir._fields[:11]}


def _shift(scene, tracer, src_fields, src_pos, pos, normal, view, mat,
           cfg, gi_depth):
    """Shift a candidate path into the receiving pixel's domain.
    Returns (phat, |J|, fields') per the configured mapping."""
    (nee, shift, bounce_mode, min_ray_dist, has_alpha, has_envmap,
     reconnection_scale) = cfg
    R = pos.shape[0]

    def reconnect():
        C = _reconnect_eval(scene, src_fields, pos, normal, view, mat,
                            bounce_mode, nee)
        J = _geom_term(src_fields, pos) / _geom_term(src_fields, src_pos)
        return rgb_to_luminance(C), J, src_fields

    def replay():
        C, _, f2 = _generate_path(scene, tracer, src_fields["seed"], pos,
                                  normal, view, mat, nee, gi_depth,
                                  bounce_mode, min_ray_dist, has_alpha,
                                  has_envmap)
        return rgb_to_luminance(C), torch.ones(R, device=pos.device), f2

    if shift == "reconnection-shift":
        return reconnect()
    if shift == "random-replay-shift":
        return replay()
    # hybrid: reconnect when the vertex is far and rough enough
    # (reference: restir_core.glsl hybrid shift reconnection condition)
    pr, Jr, fr = reconnect()
    pp, Jp, fp = replay()
    dist = torch.linalg.norm(src_fields["rc_pos"] - src_pos, dim=-1)
    rough = src_fields["rc_mr"][:, 1] > 0.25
    connectable = (src_fields["rc_kind"] == RC_ENV) | \
        ((src_fields["rc_kind"] == RC_SURF) & rough &
         (dist > reconnection_scale * min_ray_dist * 100.0))
    phat = torch.where(connectable, pr, pp)
    J = torch.where(connectable, Jr, Jp)
    fsel = {k: torch.where(
        connectable.reshape(connectable.shape + (1,) * (fr[k].dim() - 1)),
        fr[k], fp[k]) for k in fr}
    return phat, J, fsel


class ReSTIRGIConfigKey(NamedTuple):
    nee: Any
    shift: str               # reconnection-shift/random-replay-shift/hybrid
    gi_depth: int            # total path depth budget for the GI suffix
    canonical_samples: int
    spatial_samples: int
    passes: int
    max_confidence: float
    temporal: bool
    min_ray_dist: float
    bounce_mode: str
    max_radius: float
    has_alpha: bool
    has_envmap: bool
    reconnection_scale: float


def restir_gi_pass(scene: DeviceScene, tracer, gbuf_pos, gbuf_normal,
                   gbuf_view, gbuf_albedo, gbuf_mr, gbuf_transmittance,
                   motion, prev_res: PathReservoir, prev_pos, frame_idx,
                   cfg_key: ReSTIRGIConfigKey, gbuf_inst=None,
                   prev_inst=None):
    """One ReSTIR GI frame: canonical path generation -> temporal reuse
    -> spatial reuse -> final shade with one visibility wave. Returns
    (indirect color (H, W, 3), reservoir)."""
    k = cfg_key
    H, W = gbuf_pos.shape[:2]
    R = H * W
    dev = gbuf_pos.device
    shift_cfg = (k.nee, k.shift, k.bounce_mode, k.min_ray_dist,
                 k.has_alpha, k.has_envmap, k.reconnection_scale)

    pos = gbuf_pos.reshape(-1, 3)
    normal = gbuf_normal.reshape(-1, 3)
    view = gbuf_view.reshape(-1, 3)
    mat = gbuffer_material(gbuf_albedo, gbuf_mr, gbuf_transmittance)
    xs, ys, seed = pixel_seeds(H, W, 7, frame_idx, dev)

    def rand():
        nonlocal seed
        seed, r = rng_ops.generate_uniform_random(seed)
        return r

    def rsh(f):
        return {kk: v.reshape((H, W) + v.shape[1:]) for kk, v in f.items()}

    def rfl(f):
        return {kk: v.reshape((R,) + v.shape[2:]) for kk, v in f.items()}

    def reuse(res, src, src_pos, ok):
        """Shift the reservoir src ((H, W) fields) into every pixel and
        stream it in where ok."""
        capM = torch.clamp(src.M, max=k.max_confidence).reshape(-1)
        phat, J, f2 = _shift(scene, tracer, rfl(_fields_of(src)), src_pos,
                             pos, normal, view, mat, shift_cfg, k.gi_depth)
        w = torch.where(ok & (phat > 0), phat * J * src.W.reshape(-1) * capM,
                        0.0)
        cand = rsh(f2)
        cand["target_p"] = phat.reshape(H, W)
        return _merge(res, cand, w.reshape(H, W),
                      torch.where(ok, capM, 0.0).reshape(H, W),
                      rand()[:, 0].reshape(H, W))

    res = PathReservoir.empty(H, W, dev)
    for c in range(k.canonical_samples):
        path_seed = rng_ops.pcg4d((seed + c) & rng_ops.MASK32)
        rand()
        C, p1, fields = _generate_path(
            scene, tracer, path_seed, pos, normal, view, mat, k.nee,
            k.gi_depth, k.bounce_mode, k.min_ray_dist, k.has_alpha,
            k.has_envmap)
        phat = rgb_to_luminance(C)
        cand = rsh(fields)
        cand["target_p"] = phat.reshape(H, W)
        res = _merge(res, cand, (phat / p1).reshape(H, W),
                     torch.ones((H, W), device=dev),
                     rand()[:, 0].reshape(H, W))

    if k.temporal:
        px, py = reproject(motion, H, W)
        pr = PathReservoir(*(x[py, px] for x in prev_res))
        dp = gbuf_pos - prev_pos[py, px]
        ok = ((dp * dp).sum(-1) < 0.05).reshape(-1)
        if gbuf_inst is not None and prev_inst is not None:
            # the prev<->cur instance id validity (reference:
            # src/scene_stage.hh:241-250 temporal tables)
            ok = ok & (prev_inst[py, px] == gbuf_inst).reshape(-1)
        res = reuse(res, pr, prev_pos[py, px].reshape(-1, 3), ok)

    for _ in range(k.passes):
        for _ in range(k.spatial_samples):
            nx, ny = disk_neighbour(rand(), xs, ys, H, W, k.max_radius)
            nb = PathReservoir(*(x[ny, nx] for x in res))
            dpn = gbuf_pos - gbuf_pos[ny, nx]
            nrm_ok = (gbuf_normal * gbuf_normal[ny, nx]).sum(-1) > 0.9
            ok = (((dpn * dpn).sum(-1) < 0.05) & nrm_ok).reshape(-1)
            res = reuse(res, nb, gbuf_pos[ny, nx].reshape(-1, 3), ok)

    # final shade: evaluated again at this pixel + one visibility wave
    fields = rfl(_fields_of(res))
    C = _reconnect_eval(scene, fields, pos, normal, view, mat,
                        k.bounce_mode, k.nee)
    res = res._replace(target_p=rgb_to_luminance(C).reshape(H, W))
    surf = fields["rc_kind"] == RC_SURF
    delta = fields["rc_pos"] - pos
    dist = torch.linalg.norm(delta, dim=-1)
    d01 = torch.where(surf[:, None],
                      delta / torch.clamp(dist, min=1e-9)[:, None],
                      fields["rc_pos"])
    vis_far = torch.where(surf, dist - 2.0 * k.min_ray_dist, 1e30)
    sh = trace_alpha(scene, tracer, pos, _safe_dir(d01),
                     torch.full((R,), k.min_ray_dist, device=dev),
                     torch.clamp(vis_far, min=k.min_ray_dist), 1e-4,
                     k.has_alpha, any_hit=True)
    vis = torch.where(sh.tri_id < 0, 1.0, 0.0)
    out = C * (vis * res.W.reshape(-1))[:, None]
    return out.reshape(H, W, 3), res
