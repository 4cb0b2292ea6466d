"""SVGF denoiser; the torch counterpart of tauray_tpu.stages.svgf
(reference: src/svgf_stage.cc + shader/svgf_temporal.comp,
svgf_atrous.comp, svgf_disocclusion_fix.comp, svgf_firefly_suppression.comp,
svgf.glsl).

Pipeline, in the reference's stage order (src/svgf_stage.hh):
  1. temporal: motion-reprojected accumulation of demodulated diffuse and
     specular radiance and their first and second luminance moments, with
     geometry validity tests and a per-pixel history length;
  2. disocclusion fix: freshly disoccluded pixels take a wide spatial
     average instead of raw 1-spp values;
  3. firefly suppression: a luminance clamp against the neighbourhood;
  4. variance-guided a-trous wavelet filtering, with separate iteration
     counts for diffuse and specular (svgf.atrous-diffuse-iter /
     atrous-spec-iter, sigmas l/n/z; reference: src/options.hh:419-437).

Every neighbourhood tap wraps around the image edges (torch.roll), as
tauray_tpu's jnp.roll does. The history is an SVGFState the
post-processing pipeline carries per view.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import numpy as np
import torch

from ..ops.sampling import xla_int32
from ..ops.shading import rgb_to_luminance


class SVGFParams(NamedTuple):
    atrous_diffuse_iter: int = 5
    atrous_spec_iter: int = 5
    atrous_kernel_radius: int = 2
    sigma_l: float = 10.0
    sigma_z: float = 1.0
    sigma_n: float = 128.0
    min_alpha_color: float = 0.02
    min_alpha_moments: float = 0.2

    @staticmethod
    def from_options(opt) -> "SVGFParams":
        s = opt.svgf
        return SVGFParams(s.atrous_diffuse_iter, s.atrous_spec_iter,
                          s.atrous_kernel_radius, s.sigma_l, s.sigma_z,
                          s.sigma_n, s.min_alpha_color, s.min_alpha_moments)


class SVGFState(NamedTuple):
    color: torch.Tensor        # (H, W, 6) diffuse rgb + specular rgb
    moments: torch.Tensor      # (H, W, 4) mean/second moment, both channels
    history_len: torch.Tensor  # (H, W)
    normal: torch.Tensor       # (H, W, 3)
    pos: torch.Tensor          # (H, W, 3)

    @staticmethod
    def zeros(H, W, device) -> "SVGFState":
        def z(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=device)
        return SVGFState(color=z(H, W, 6), moments=z(H, W, 4),
                         history_len=z(H, W), normal=z(H, W, 3),
                         pos=z(H, W, 3))

    @staticmethod
    def from_numpy(fields: Dict[str, Any], device) -> "SVGFState":
        """From a {field: numpy array} dict with this class's field names
        (for example tauray_tpu's SVGFState fields via np.asarray)."""
        return SVGFState(**{k: torch.from_numpy(np.array(
            fields[k], np.float32)).to(device) for k in SVGFState._fields})


def _gather(img, x, y):
    H, W = img.shape[:2]
    return img[y.clamp(0, H - 1).long(), x.clamp(0, W - 1).long()]


def _reproject(state: SVGFState, motion, cur_normal, cur_pos):
    """Bilinear history fetch with validity tests (reference:
    shader/svgf_temporal.comp)."""
    H, W = motion.shape[:2]
    mx = motion[..., 0] * W - 0.5
    my = (1.0 - motion[..., 1]) * H - 0.5
    x0 = xla_int32(torch.floor(mx))
    y0 = xla_int32(torch.floor(my))
    fx = (mx - x0)[..., None]
    fy = (my - y0)[..., None]

    def z(c):
        return motion.new_zeros((H, W, c))
    csum, msum, hsum, wsum = z(6), z(4), z(1), z(1)
    for dy, dx, w in ((0, 0, (1 - fx) * (1 - fy)), (0, 1, fx * (1 - fy)),
                      (1, 0, (1 - fx) * fy), (1, 1, fx * fy)):
        sx = x0 + dx
        sy = y0 + dy
        inb = (sx >= 0) & (sx < W) & (sy >= 0) & (sy < H)
        pn = _gather(state.normal, sx, sy)
        pp = _gather(state.pos, sx, sy)
        dpos = cur_pos - pp
        keep = inb & ((pn * cur_normal).sum(-1) > 0.9) & \
            ((dpos * dpos).sum(-1) < 0.02)
        # a rejected tap weighs 0 even where its weight is NaN (a motion
        # vector that is not finite), as XLA's select for w * keep gives
        wk = torch.where(keep[..., None], w, 0.0)
        csum = csum + _gather(state.color, sx, sy) * wk
        msum = msum + _gather(state.moments, sx, sy) * wk
        hsum = hsum + _gather(state.history_len[..., None], sx, sy) * wk
        wsum = wsum + wk
    ok = wsum[..., 0] > 1e-4
    inv = 1.0 / torch.clamp(wsum, min=1e-9)
    return csum * inv, msum * inv, hsum[..., 0] * inv[..., 0], ok


def _box_blur(img, radius: int):
    """Separable box filter over (H, W, ...), wrapping at the edges."""
    out = img
    for axis in (0, 1):
        acc = out
        for r in range(1, radius + 1):
            acc = acc + torch.roll(out, r, axis) + torch.roll(out, -r, axis)
        out = acc / (2 * radius + 1)
    return out


def svgf_temporal(params: SVGFParams, state: SVGFState, diffuse, specular,
                  motion, normal, pos):
    """Returns (filter-input color (H, W, 6), variance (H, W, 2), new
    state)."""
    cur = torch.cat([diffuse[..., :3], specular[..., :3]], dim=-1)
    lum_d = rgb_to_luminance(diffuse[..., :3])
    lum_s = rgb_to_luminance(specular[..., :3])
    cur_m = torch.stack([lum_d, lum_d * lum_d, lum_s, lum_s * lum_s], dim=-1)

    prev_c, prev_m, prev_len, ok = _reproject(state, motion, normal, pos)
    hist = torch.where(ok, prev_len + 1.0, 1.0)
    alpha_c = torch.clamp(1.0 / hist, min=params.min_alpha_color)[..., None]
    alpha_m = torch.clamp(1.0 / hist,
                          min=params.min_alpha_moments)[..., None]
    okc = ok[..., None]
    color = torch.where(okc, prev_c * (1 - alpha_c) + cur * alpha_c, cur)
    moments = torch.where(okc, prev_m * (1 - alpha_m) + cur_m * alpha_m,
                          cur_m)

    var = torch.stack([
        torch.clamp(moments[..., 1] - moments[..., 0] ** 2, min=0.0),
        torch.clamp(moments[..., 3] - moments[..., 2] ** 2, min=0.0)],
        dim=-1)
    # disocclusion fix: young pixels get a spatially estimated variance
    # and blurred color (reference: shader/svgf_disocclusion_fix.comp)
    young = (hist < 4.0)[..., None]
    color = torch.where(young, _box_blur(color, 2), color)
    var = torch.where(young, _box_blur(var, 2) + 1e-3, var)

    # firefly suppression: clamp luminance to k * neighbourhood mean
    # (reference: shader/svgf_firefly_suppression.comp)
    mean_l = _box_blur(torch.stack([rgb_to_luminance(color[..., :3]),
                                    rgb_to_luminance(color[..., 3:])],
                                   dim=-1), 1)
    parts = []
    for ch, sl in ((0, slice(0, 3)), (1, slice(3, 6))):
        c = color[..., sl]
        lum = rgb_to_luminance(c)
        limit = mean_l[..., ch] * 4.0 + 0.5
        scale = torch.where(lum > limit,
                            limit / torch.clamp(lum, min=1e-9), 1.0)
        parts.append(c * scale[..., None])
    color = torch.cat(parts, dim=-1)

    new_state = SVGFState(color=color, moments=moments, history_len=hist,
                          normal=normal, pos=pos)
    return color, var, new_state


def _atrous_pass(color, var, normal, depth, step: int, radius: int,
                 sigma_l: float, sigma_n: float, sigma_z: float):
    """One a-trous iteration with edge-stopping weights (reference:
    shader/svgf_atrous.comp, svgf.glsl)."""
    lum = rgb_to_luminance(color)
    var_blur = _box_blur(var[..., None], 1)[..., 0]
    denom_l = sigma_l * torch.sqrt(var_blur + 1e-10)

    csum = color
    vsum = var
    wsum = torch.ones_like(var)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            if dx == 0 and dy == 0:
                continue
            shift = (dy * step, dx * step)
            nc = torch.roll(color, shift, (0, 1))
            nv = torch.roll(var, shift, (0, 1))
            nn = torch.roll(normal, shift, (0, 1))
            nz = torch.roll(depth, shift, (0, 1))
            nl = rgb_to_luminance(nc)
            w_l = torch.exp(-(nl - lum).abs() /
                            torch.clamp(denom_l, min=1e-10))
            w_n = torch.clamp((nn * normal).sum(-1), min=0.0) ** sigma_n
            w_z = torch.exp(-(nz - depth).abs() /
                            (sigma_z * depth.abs() + 1e-4))
            w = w_l * w_n * w_z
            csum = csum + nc * w[..., None]
            vsum = vsum + nv * w * w
            wsum = wsum + w
    return csum / wsum[..., None], vsum / (wsum * wsum)


def svgf_atrous(params: SVGFParams, color6, var2, normal, depth):
    """Separate diffuse and specular filtering chains (reference: separate
    iteration counts, src/options.hh:419-424)."""
    outs = []
    for ch, (sl, iters) in enumerate((
            (slice(0, 3), params.atrous_diffuse_iter),
            (slice(3, 6), params.atrous_spec_iter))):
        c = color6[..., sl]
        v = var2[..., ch]
        for i in range(iters):
            c, v = _atrous_pass(c, v, normal, depth, 1 << i,
                                params.atrous_kernel_radius,
                                params.sigma_l, params.sigma_n,
                                params.sigma_z)
        outs.append(c)
    return torch.cat(outs, dim=-1)


def _lobe_similarity(axis1, rough1, axis2, rough2):
    """Isotropic-SG specular lobe similarity (reference:
    shader/svgf.glsl specular_lobe_similarity, approximate branch)."""
    inv_r1 = 1.0 / torch.clamp(rough1, min=1e-3)
    inv_r2 = 1.0 / torch.clamp(rough2, min=1e-3)
    s1 = inv_r1 * inv_r1
    s2 = inv_r2 * inv_r2
    dm2 = 2.0 * s1 * s2 * (axis1 * axis2).sum(-1) + s2 * s2 + s1 * s1
    dm = torch.sqrt(torch.clamp(dm2, min=1e-12))
    return torch.clamp(torch.exp2(0.7689564567938175 * (dm - s1 - s2) + 1.0)
                       * inv_r1 * inv_r2 / dm, 0.0, 1.0)


def svgf_hit_dist_reconstruction(specular4, normal, pos, roughness,
                                 cam_origin):
    """Fill zero specular hit distances (alpha channel) from the 3x3
    neighbours, weighted by plane distance and specular-lobe similarity
    (reference: shader/svgf_hit_dist_reconstruction.comp)."""
    view = cam_origin[None, None, :] - pos
    view = view / torch.clamp(torch.linalg.norm(view, dim=-1, keepdim=True),
                              min=1e-9)
    # reflect(view_away, n): the reference reflects the AWAY-pointing V
    axis = 2.0 * (view * normal).sum(-1, keepdim=True) * normal - view
    rough = torch.clamp(roughness, min=0.01)
    dist_to_cam = torch.linalg.norm(cam_origin[None, None, :] - pos, dim=-1)
    inv_dist = 1.0 / torch.clamp(dist_to_cam, min=1e-6)

    a = specular4[..., 3]
    w_sum = torch.where(a != 0.0, 1.0, 0.0)
    acc = a
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dx == 0 and dy == 0:
                continue
            shift = (-dy, -dx)
            qs = torch.roll(specular4[..., 3], shift, (0, 1))
            qp = torch.roll(pos, shift, (0, 1))
            qa = torch.roll(axis, shift, (0, 1))
            qr = torch.roll(rough, shift, (0, 1))
            w = torch.where(qs != 0.0, 1.0, 0.0)
            plane_d = ((qp - pos) * normal).sum(-1).abs()
            w = w * torch.where(plane_d * inv_dist < 0.005, 1.0, 0.0)
            w = w * _lobe_similarity(axis, rough, qa, qr) ** 16.0
            w_sum = w_sum + w
            acc = acc + qs * w
    recon = torch.where(w_sum > 1e-3, acc / torch.clamp(w_sum, min=1e-3),
                        0.0)
    new_a = torch.where(a == 0.0, recon, a)
    return torch.cat([specular4[..., :3], new_a[..., None]], dim=-1)


def svgf_denoise(params: SVGFParams, state: SVGFState, diffuse, specular,
                 motion, normal, pos, depth, cam_origin=None,
                 roughness=None):
    """The whole pipeline; returns (diffuse, specular, new state)."""
    if cam_origin is not None and specular.shape[-1] == 4:
        # specular hit-distance reconstruction before temporal reuse
        # (reference: svgf_stage.cc dispatch order)
        r = roughness if roughness is not None else \
            torch.zeros_like(specular[..., 3]) + 0.5
        specular = svgf_hit_dist_reconstruction(
            specular, normal, pos, r, cam_origin)
    color, var, new_state = svgf_temporal(params, state, diffuse, specular,
                                          motion, normal, pos)
    filtered = svgf_atrous(params, color, var, normal, depth)
    return filtered[..., :3], filtered[..., 3:], new_state
