"""ReSTIR direct illumination (reference: src/restir_stage.cc +
shader/restir_canonical.comp, restir_temporal.comp,
restir_spatial_trace.comp, restir_spatial_gather.comp, restir_core.glsl);
the torch counterpart of tauray_tpu.stages.restir.

ReSTIR DI over all four light types with
  * canonical RIS over `canonical_samples` candidates
    (reference: restir.canonical-samples),
  * temporal reservoir reuse along motion vectors with confidence capping
    (reference: restir.max-confidence / temporal-reuse), its reused
    sample's visibility traced again against the current scene unless
    --restir.assume-unchanged-temporal-visibility,
  * `restir.passes` spatial reuse passes over disk neighborhoods
    (reference: restir.spatial-samples / sample-spatial-disk),
  * final visibility by one any-hit wave through the shared tracer.

Reservoir samples are stored as (strategy, light index, u1, u2) and
evaluated again at the receiving pixel. Reservoirs are (H, W, ...)
tensors on the G-buffer's device; the sample streams are tauray_tpu's
pcg4d streams, keyed on (x, y, 0, frame)."""

from __future__ import annotations

import math
from typing import Any, Mapping, NamedTuple

import numpy as np
import torch

from ..ops import rng as rng_ops
from ..ops.ggx import material_bsdf_pdf, modulate_bsdf
from ..ops.intersect import RAY_MAX_DIST
from ..ops.lights import (sample_directional_light, sample_environment_map,
                          sample_point_light, sample_triangle_light)
from ..ops.sampling import (create_tangent_space,
                            ray_plane_intersection_dist, to_tangent_space,
                            view_to_tangent_space, xla_int32)
from ..ops.shading import SampledMaterial, rgb_to_luminance
from ..scene.device import DeviceScene

M_PI = math.pi


def _numpy_fields(obj) -> dict:
    """A reservoir of either package (or a mapping of its fields) as a
    dict of numpy arrays."""
    if not isinstance(obj, Mapping):
        obj = obj._asdict()
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for k, v in obj.items()}


class Reservoir(NamedTuple):
    strategy: torch.Tensor   # (H, W) i32: 0 point, 1 tri, 2 env, 3 dir, -1
    light_idx: torch.Tensor  # (H, W) i32
    u: torch.Tensor          # (H, W, 2) sample numbers
    w_sum: torch.Tensor      # (H, W)
    M: torch.Tensor          # (H, W) confidence
    target_p: torch.Tensor   # (H, W) p-hat of the kept sample

    @staticmethod
    def empty(H, W, device):
        z = torch.zeros((H, W), dtype=torch.float32, device=device)
        return Reservoir(
            torch.full((H, W), -1, dtype=torch.int32, device=device),
            torch.zeros((H, W), dtype=torch.int32, device=device),
            torch.zeros((H, W, 2), dtype=torch.float32, device=device),
            z, z, z)

    @property
    def W(self):
        return torch.where(
            self.target_p > 0,
            self.w_sum / (torch.clamp(self.M, min=1e-6) *
                          torch.clamp(self.target_p, min=1e-9)), 0.0)

    def to_numpy(self) -> dict:
        return _numpy_fields(self)

    @staticmethod
    def from_numpy(fields, device) -> "Reservoir":
        """fields: a mapping of field name -> array, or a reservoir of
        either package (tauray_tpu's included)."""
        f = _numpy_fields(fields)
        return Reservoir(**{k: torch.from_numpy(np.array(f[k])).to(device)
                            for k in Reservoir._fields})


def _share(weight: float, count: int) -> float:
    """weight / max(count, 1) rounded as float32 operands divide."""
    return float(np.float32(weight) / np.float32(max(count, 1)))


def _eval_light_sample(scene: DeviceScene, nee, strategy, light_idx, u,
                       pos):
    """Evaluate a stored light sample again at shading point `pos`.
    Returns (radiance (..., 3), dir, dist, source_pdf)."""
    shp = pos.shape[:-1]
    pos_f = pos.reshape(-1, 3)
    strat = strategy.reshape(-1)
    li = light_idx.reshape(-1).long()
    uf = u.reshape(-1, 2)
    R = pos_f.shape[0]
    dev = pos.device

    color = torch.zeros((R, 3), dtype=torch.float32, device=dev)
    dirs = torch.zeros((R, 3), dtype=torch.float32, device=dev)
    dist = torch.full((R,), RAY_MAX_DIST, dtype=torch.float32, device=dev)
    pdf = torch.ones(R, dtype=torch.float32, device=dev)

    if nee.point > 0:
        lc = scene.point_light_count
        pli = li.clamp(0, max(lc - 1, 0))
        d, l, c, p = sample_point_light(scene, pli, uf, pos_f)
        p = p * _share(nee.point, lc)
        m = strat == 0
        color = torch.where(m[:, None], c, color)
        dirs = torch.where(m[:, None], d, dirs)
        dist = torch.where(m, l, dist)
        pdf = torch.where(m, p, pdf)
    if nee.triangle > 0:
        lc = scene.tri_light_count
        tli = li.clamp(0, max(lc - 1, 0))
        tl = scene.tl_pos[tli]
        A = tl[:, 0] - pos_f
        B = tl[:, 1] - pos_f
        Cc = tl[:, 2] - pos_f
        d, tri_pdf = sample_triangle_light(uf, A, B, Cc, "solid-angle")
        l = ray_plane_intersection_dist(d, A, B, Cc)
        c = scene.tl_emission[tli]
        p = tri_pdf * float(np.float32(nee.triangle)) / max(lc, 1)
        bad = ~torch.isfinite(tri_pdf) | (tri_pdf <= 0)
        m = strat == 1
        color = torch.where((m & ~bad)[:, None], c, color)
        dirs = torch.where(m[:, None],
                           torch.where(bad[:, None], 0.0, d), dirs)
        dist = torch.where(m, l, dist)
        pdf = torch.where(m, torch.where(bad, 1.0, p), pdf)
    if nee.envmap > 0:
        # u in [0, 1] to uint32 as XLA converts: toward zero, saturating
        ue = torch.nan_to_num(uf * 4294967296.0, nan=0.0).clamp(
            0.0, 4294967296.0).to(torch.int64).clamp(max=rng_ops.MASK32)
        rand3 = torch.cat([ue, rng_ops.pcg(ue[:, 0:1] ^ ue[:, 1:2])],
                          dim=-1)
        c, d, l, p = sample_environment_map(scene, rand3)
        p = p * float(np.float32(nee.envmap))
        m = strat == 2
        color = torch.where(m[:, None], c, color)
        dirs = torch.where(m[:, None], d, dirs)
        dist = torch.where(m, l, dist)
        pdf = torch.where(m, p, pdf)
    if nee.directional > 0:
        lc = scene.directional_light_count
        dlit = li.clamp(0, max(lc - 1, 0))
        d, c, p = sample_directional_light(scene, dlit, uf)
        p = p * _share(nee.directional, lc)
        m = strat == 3
        color = torch.where(m[:, None], c, color)
        dirs = torch.where(m[:, None], d, dirs)
        dist = torch.where(m, RAY_MAX_DIST, dist)
        pdf = torch.where(m, p, pdf)

    color = torch.where((strat < 0)[:, None], 0.0, color)
    return (color.reshape(shp + (3,)), dirs.reshape(shp + (3,)),
            dist.reshape(shp), pdf.reshape(shp))


def _light_terms(scene, nee, strategy, light_idx, u, pos, normal, view,
                 mat, bounce_mode):
    """A stored light sample evaluated again at `pos`, with the BSDF
    toward it. Returns (radiance (R, 3), f (R, 3), dir, dist,
    source_pdf)."""
    color, dirs, dist, pdf = _eval_light_sample(scene, nee, strategy,
                                                light_idx, u, pos)
    t, b, n = create_tangent_space(normal.reshape(-1, 3))
    sview = view_to_tangent_space(view.reshape(-1, 3), t, b, n)
    sl = to_tangent_space(dirs.reshape(-1, 3), t, b, n)
    lobes, bpdf = material_bsdf_pdf(sl, sview, mat, bounce_mode)
    f = modulate_bsdf(mat, lobes)
    # env samples: balance-heuristic MIS against the GI stage's
    # BSDF-sampled env escapes, which carry the complementary weight
    # (reference: nee_mis_pdf)
    if nee.envmap > 0:
        apdf = pdf.reshape(-1).abs()
        env_m = strategy.reshape(-1) == 2
        misw = apdf / torch.clamp(apdf + bpdf, min=1e-9)
        f = f * torch.where(env_m, misw, 1.0)[:, None]
    return color.reshape(-1, 3), f, dirs, dist, pdf


def _phat(color, f, pdf):
    """luminance(f * Le / |pdf|) per row; |pdf| resolves delta lights'
    negative marker."""
    return rgb_to_luminance(
        color * f / torch.clamp(pdf.reshape(-1).abs(), min=1e-9)[:, None])


def _target_phat(scene, nee, strategy, light_idx, u, pos, normal, view,
                 mat, bounce_mode):
    """Unshadowed target function p-hat = luminance(f * Le)
    (reference: restir_core.glsl target function). Returns (p-hat, dir,
    dist)."""
    color, f, dirs, dist, pdf = _light_terms(
        scene, nee, strategy, light_idx, u, pos, normal, view, mat,
        bounce_mode)
    return _phat(color, f, pdf).reshape(pos.shape[:-1]), dirs, dist


def _merge(res: Reservoir, cand_strategy, cand_idx, cand_u, cand_phat,
           cand_w, cand_M, rand):
    """Stream one candidate into the reservoir (weighted reservoir
    sampling; reference: restir_core.glsl update_reservoir)."""
    w_new = res.w_sum + cand_w
    take = (rand * torch.clamp(w_new, min=1e-20)) < cand_w
    return Reservoir(
        strategy=torch.where(take, cand_strategy, res.strategy),
        light_idx=torch.where(take, cand_idx, res.light_idx),
        u=torch.where(take[..., None], cand_u, res.u),
        w_sum=w_new,
        M=res.M + cand_M,
        target_p=torch.where(take, cand_phat, res.target_p))


def gbuffer_material(albedo, mr, transmittance) -> SampledMaterial:
    """The G-buffer's material at every pixel: albedo, metallic and
    roughness as stored, ior 1.45 outside, double sided."""
    R = albedo.shape[0] * albedo.shape[1]
    dev = albedo.device
    ior = torch.full((R,), 1.45, dtype=torch.float32, device=dev)
    ones = torch.ones(R, dtype=torch.float32, device=dev)
    return SampledMaterial(
        albedo=albedo.reshape(-1, 4), metallic=mr.reshape(-1, 2)[:, 0],
        roughness=mr.reshape(-1, 2)[:, 1],
        emission=torch.zeros((R, 3), dtype=torch.float32, device=dev),
        transmittance=transmittance.reshape(-1), ior_in=ones, ior_out=ior,
        f0=((ior - 1) / (ior + 1)) ** 2,
        double_sided=torch.ones(R, dtype=torch.bool, device=dev),
        shadow_terminator_mul=ones)


def pixel_seeds(H: int, W: int, lane: int, frame_idx: int, device):
    """(xs, ys, seed): the pixel grid (H, W) and the pcg4d seeds of
    (x, y, lane, frame), one row per pixel."""
    ys, xs = torch.meshgrid(torch.arange(H, device=device),
                            torch.arange(W, device=device), indexing="ij")
    R = H * W
    coord = torch.stack([
        xs.reshape(-1), ys.reshape(-1),
        torch.full((R,), lane, dtype=torch.int64, device=device),
        torch.full((R,), int(frame_idx) & rng_ops.MASK32,
                   dtype=torch.int64, device=device)], dim=-1)
    return xs, ys, rng_ops.init_random_sampler(coord)


def light_cdf(nee):
    """(weights, cumulative weights) of the four strategies as float32,
    summed in order on the host."""
    w = np.array([nee.point, nee.triangle, nee.envmap, nee.directional],
                 np.float32)
    return w, np.cumsum(w, dtype=np.float32)


def pick_light(scene, nee, uw, ul):
    """Strategy by the light CDF at uw, light index by ul (float32 (R,)
    each). Returns (strategy i32, light index i32)."""
    w, cum = light_cdf(nee)
    strat = torch.full(uw.shape, -1, dtype=torch.int32, device=uw.device)
    for si in range(4):
        if w[si] > 0:
            lo = float(cum[si] - w[si])
            strat = torch.where((uw >= lo) & (uw < float(cum[si])), si,
                                strat)
    counts = torch.tensor([max(scene.point_light_count, 1),
                           max(scene.tri_light_count, 1), 1,
                           max(scene.directional_light_count, 1)],
                          dtype=torch.int32, device=uw.device)
    n_lights = counts[strat.clamp(min=0).long()]
    lidx = torch.minimum(torch.clamp(xla_int32(ul * n_lights), min=0),
                         n_lights - 1)
    return strat, lidx


def reproject(motion, H: int, W: int):
    """Previous-frame pixel (px, py) of every pixel: the motion vector's
    nearest pixel, clamped to the image; a non-finite motion lands on
    index 0 as XLA converts NaN."""
    mx = torch.clamp(motion[..., 0] * W - 0.5, 0, W - 1)
    my = torch.clamp((1 - motion[..., 1]) * H - 0.5, 0, H - 1)
    return (xla_int32(torch.round(mx)).long(),
            xla_int32(torch.round(my)).long())


def disk_neighbour(r, xs, ys, H: int, W: int, max_radius: float):
    """A neighbour in a disk of max_radius pixels around every pixel,
    from the two sample numbers r[:, 0], r[:, 1]; clamped to the image."""
    ang = r[:, 0].reshape(H, W) * (2 * M_PI)
    rad = torch.sqrt(r[:, 1].reshape(H, W)) * max_radius
    dx = xla_int32(torch.round(torch.cos(ang) * rad))
    dy = xla_int32(torch.round(torch.sin(ang) * rad))
    return (torch.clamp(xs + dx, 0, W - 1).long(),
            torch.clamp(ys + dy, 0, H - 1).long())


def _safe_dir(d):
    """Directions with every component below 1e-30 replaced by +z."""
    return torch.where(d.abs() < 1e-30,
                       torch.tensor([0.0, 0.0, 1.0], device=d.device), d)


def restir_di_pass(scene: DeviceScene, tracer, gbuf_pos, gbuf_normal,
                   gbuf_view, gbuf_albedo, gbuf_mr, gbuf_transmittance,
                   motion, prev_res: Reservoir, prev_pos, frame_idx,
                   cfg_key, gbuf_inst=None, prev_inst=None):
    """One full ReSTIR DI frame: canonical -> temporal -> spatial -> shade.
    cfg_key: a ReSTIRConfigKey. Returns (color (H, W, 3), reservoir)."""
    (nee, canonical_samples, spatial_samples, passes, max_conf, temporal,
     min_ray_dist, bounce_mode, max_radius) = cfg_key[:9]
    H, W = gbuf_pos.shape[:2]
    R = H * W
    dev = gbuf_pos.device
    mat = gbuffer_material(gbuf_albedo, gbuf_mr, gbuf_transmittance)
    xs, ys, seed = pixel_seeds(H, W, 0, frame_idx, dev)
    ones = torch.ones((H, W), dtype=torch.float32, device=dev)

    def rand():
        nonlocal seed
        seed, r = rng_ops.generate_uniform_random(seed)
        return r

    def phat_of(res):
        return _target_phat(scene, nee, res.strategy, res.light_idx, res.u,
                            gbuf_pos, gbuf_normal, gbuf_view, mat,
                            bounce_mode)[0]

    res = Reservoir.empty(H, W, dev)
    # ---- canonical candidates (reference: restir_canonical.comp) -------
    for _ in range(canonical_samples):
        rnd = rand()
        strat, lidx = pick_light(scene, nee, rnd[:, 3], rnd[:, 2])
        strat, lidx = strat.reshape(H, W), lidx.reshape(H, W)
        u2 = rnd[:, :2].reshape(H, W, 2)
        phat, _, _ = _target_phat(scene, nee, strat, lidx, u2, gbuf_pos,
                                  gbuf_normal, gbuf_view, mat, bounce_mode)
        # the RIS weight is p-hat: _target_phat already folds in the
        # 1/source_pdf factor (delta pdfs included)
        w = torch.where(strat >= 0, phat, 0.0)
        res = _merge(res, strat, lidx, u2, phat, w, ones,
                     rand()[:, 0].reshape(H, W))

    # ---- temporal reuse (reference: restir_temporal.comp) --------------
    if temporal:
        px, py = reproject(motion, H, W)
        pr = Reservoir(*(x[py, px] for x in prev_res))
        # geometry validity: the position delta, and the instance id
        # through the previous frame's instance G-buffer (instance ids
        # are frame-stable, so the prev<->cur table is the identity;
        # reference: src/scene_stage.hh:241-250)
        dp = gbuf_pos - prev_pos[py, px]
        ok = (dp * dp).sum(-1) < 0.05
        if gbuf_inst is not None and prev_inst is not None:
            ok = ok & (prev_inst[py, px] == gbuf_inst)
        capM = torch.clamp(pr.M, max=max_conf)
        phat_prev = phat_of(pr)
        if cfg_key.temporal_visibility:
            # the reused sample's visibility against the CURRENT scene
            # (reference: restir_temporal.comp shadow ray)
            _, tdirs, tdist, _ = _eval_light_sample(
                scene, nee, pr.strategy, pr.light_idx, pr.u, gbuf_pos)
            tdist = tdist.reshape(-1)
            l_f = torch.where(torch.isfinite(tdist), tdist - min_ray_dist,
                              1e7)
            sh = tracer.trace(gbuf_pos.reshape(-1, 3),
                              _safe_dir(tdirs.reshape(-1, 3)),
                              torch.full((R,), min_ray_dist, device=dev),
                              torch.clamp(l_f, min=0.0), any_hit=True)
            phat_prev = torch.where((sh.tri_id < 0).reshape(H, W),
                                    phat_prev, 0.0)
        w_prev = torch.where(ok & (pr.strategy >= 0),
                             phat_prev * pr.W * capM, 0.0)
        res = _merge(res, pr.strategy, pr.light_idx, pr.u, phat_prev,
                     w_prev, torch.where(ok, capM, 0.0),
                     rand()[:, 0].reshape(H, W))

    # ---- spatial reuse (reference: restir_spatial_*.comp) --------------
    for _ in range(passes):
        for _ in range(spatial_samples):
            nx, ny = disk_neighbour(rand(), xs, ys, H, W, max_radius)
            nb = Reservoir(*(x[ny, nx] for x in res))
            dpn = gbuf_pos - gbuf_pos[ny, nx]
            nrm_ok = (gbuf_normal * gbuf_normal[ny, nx]).sum(-1) > 0.9
            ok = ((dpn * dpn).sum(-1) < 0.05) & nrm_ok
            phat_nb = phat_of(nb)
            capM = torch.clamp(nb.M, max=max_conf)
            w_nb = torch.where(ok & (nb.strategy >= 0),
                               phat_nb * nb.W * capM, 0.0)
            res = _merge(res, nb.strategy, nb.light_idx, nb.u, phat_nb,
                         w_nb, torch.where(ok, capM, 0.0),
                         rand()[:, 0].reshape(H, W))

    # ---- final shade + visibility --------------------------------------
    # one evaluation of the kept sample serves the target, the shade
    # and the visibility ray
    color, f, ldirs, ldist, lpdf = _light_terms(
        scene, nee, res.strategy, res.light_idx, res.u, gbuf_pos,
        gbuf_normal, gbuf_view, mat, bounce_mode)
    res = res._replace(target_p=_phat(color, f, lpdf).reshape(H, W))
    sh = tracer.trace(gbuf_pos.reshape(-1, 3),
                      _safe_dir(ldirs).reshape(-1, 3),
                      torch.full((R,), min_ray_dist, device=dev),
                      torch.clamp(ldist.reshape(-1), max=1e30), any_hit=True)
    vis = torch.where(sh.tri_id < 0, 1.0, 0.0).reshape(H, W)
    Le_over_pdf = color / torch.clamp(lpdf.reshape(-1).abs(),
                                      min=1e-9)[:, None]
    out = (Le_over_pdf * f).reshape(H, W, 3) * (res.W * vis)[..., None] * \
        torch.clamp(res.target_p, min=0.0)[..., None] / \
        torch.clamp(res.target_p, min=1e-9)[..., None]
    return out, res


class ReSTIRConfigKey(NamedTuple):
    nee: Any
    canonical_samples: int
    spatial_samples: int
    passes: int
    max_confidence: float
    temporal: bool
    min_ray_dist: float
    bounce_mode: str
    max_radius: float
    # trace temporal candidates' shadow rays again against the CURRENT
    # scene unless --restir.assume-unchanged-temporal-visibility
    # (reference: restir_temporal.comp visibility validation)
    temporal_visibility: bool = False
