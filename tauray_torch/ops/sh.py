"""Real spherical harmonics basis, order <= 4
(reference: shader/spherical_harmonics.glsl, src/sh_grid.hh); the torch
counterpart of tauray_tpu.ops.sh.

Used by the SH probe path tracer (probe radiance projection), the
restir-hybrid indirect lookup and the raster renderer's."""

from __future__ import annotations

import math

import numpy as np
import torch


def sh_basis(dirs, order: int):
    """dirs: (..., 3) normalized. Returns (..., (order+1)^2) SH basis values
    in the standard real-SH ordering (l, m): (0,0), (1,-1), (1,0), (1,1)...
    """
    x = dirs[..., 0]
    y = dirs[..., 1]
    z = dirs[..., 2]
    out = [torch.full_like(x, 0.2820947917738781)]  # Y00
    if order >= 1:
        out += [-0.48860251190291987 * y,
                0.48860251190291987 * z,
                -0.48860251190291987 * x]
    if order >= 2:
        out += [1.0925484305920792 * x * y,
                -1.0925484305920792 * y * z,
                0.31539156525252005 * (3 * z * z - 1),
                -1.0925484305920792 * x * z,
                0.5462742152960396 * (x * x - y * y)]
    if order >= 3:
        out += [
            -0.5900435899266435 * y * (3 * x * x - y * y),
            2.890611442640554 * x * y * z,
            -0.4570457994644658 * y * (5 * z * z - 1),
            0.3731763325901154 * z * (5 * z * z - 3),
            -0.4570457994644658 * x * (5 * z * z - 1),
            1.445305721320277 * z * (x * x - y * y),
            -0.5900435899266435 * x * (x * x - 3 * y * y)]
    if order >= 4:
        x2, y2, z2 = x * x, y * y, z * z
        out += [
            2.5033429417967046 * x * y * (x2 - y2),
            -1.7701307697799304 * y * z * (3 * x2 - y2),
            0.9461746957575601 * x * y * (7 * z2 - 1),
            -0.6690465435572892 * y * z * (7 * z2 - 3),
            0.10578554691520431 * (35 * z2 * z2 - 30 * z2 + 3),
            -0.6690465435572892 * x * z * (7 * z2 - 3),
            0.47308734787878004 * (x2 - y2) * (7 * z2 - 1),
            -1.7701307697799304 * x * z * (x2 - y2),
            0.6258357354491761 * (x2 * x2 - 6 * x2 * y2 + y2 * y2)]
    return torch.stack(out, dim=-1)


def project_radiance(dirs, radiance, order: int):
    """MC projection of sampled radiance onto SH: coefficients (..., C, 3).
    dirs (N, 3) uniform-sphere samples; radiance (N, 3)."""
    basis = sh_basis(dirs, order)                 # (N, C)
    w = 4.0 * math.pi / dirs.shape[0]
    return torch.einsum("nc,nk->ck", basis, radiance) * w


def eval_irradiance(coefficients, normal, order: int):
    """Lambertian irradiance from SH radiance coefficients
    (standard cosine-lobe convolution weights A_l)."""
    A = [math.pi, 2.0 * math.pi / 3.0, math.pi / 4.0, 0.0, -math.pi / 24.0]
    basis = sh_basis(normal, order)              # (..., C)
    weights = []
    for l in range(order + 1):
        weights += [A[l]] * (2 * l + 1)
    w = torch.tensor(weights, dtype=basis.dtype, device=basis.device)
    # coefficients: (..., C, 3), broadcast against (..., C)
    return torch.sum(basis[..., None] * coefficients * w[:, None],
                     dim=-2) / math.pi


def _ggx_zh_table(order: int, n_rough: int = 64):
    """Zonal band factors of the GGX reflection lobe per ARTIST roughness
    (reference: shader/spherical_harmonics.glsl get_ggx_specular_lobe —
    the reference ships a fitted curve; here the factors are projected
    numerically: the NDF-importance reflected-direction lobe at normal
    incidence, band l moment over band 0 moment)."""
    from numpy.polynomial import legendre
    th = np.linspace(1e-4, np.pi - 1e-4, 4096)   # reflected polar angle
    cl = np.cos(th)
    table = np.ones((n_rough, order + 1), np.float32)
    # high-roughness limit = the clamped-cosine band factors, low = delta
    lo = [1.0, 2.0 / 3.0, 1.0 / 4.0, 0.0, -1.0 / 24.0]
    for i in range(n_rough):
        ra = max((i + 0.5) / n_rough, 1e-3)
        a = ra * ra                   # mat.roughness
        a2 = a * a                    # the reference's D uses a=mat.roughness
        ch = np.cos(th / 2)
        D = a2 / (np.pi * (ch * ch * (a2 - 1) + 1) ** 2)

        def g1(c):
            c = np.maximum(c, 1e-6)
            return 2 * c / (c + np.sqrt(a2 + (1 - a2) * c * c))

        # full specular response at normal incidence: D*G/(4 cos_l)*cos_l
        G = g1(np.abs(cl)) * g1(1.0)
        w = D * G / 4.0 * np.sin(th) * (cl > 0)
        z0 = np.trapezoid(w, th)
        for l in range(1, order + 1):
            pl = legendre.legval(cl, [0] * l + [1])
            v = np.trapezoid(w * pl, th) / max(z0, 1e-12)
            table[i, l] = np.clip(v, min(lo[l], 1.0), 1.0)
    return table


def _ggx_zh_fitted(roughness):
    """The reference's EXACT fitted GGX zonal-band curve
    (shader/spherical_harmonics.glsl get_ggx_specular_lobe:120-151 —
    three cosine/fma terms per band, constants verbatim). Differs from
    the numeric projection in _ggx_zh_table by up to 15% on band 2 at
    mid roughness, a visible glossy-indirect shift in the dshgi golden.
    roughness: (...,) ARTIST roughness. Returns (..., 4) bands 1..4."""
    r = roughness[..., None]

    def c(*v):
        return torch.tensor(v, dtype=r.dtype, device=r.device)
    zh = c(0.27793123, 0.59372022, 0.2400839, 0.000250700498)
    zh = zh + c(0.905501229, 10.57518269, 21.6480923, 5.53340572) * \
        torch.cos(r * c(2.49220829, 3.49132073, 3.92510137, 3.98902127) +
                  c(2.88755638, 0.56672964, 0.50116945, 0.705097221))
    zh = zh + c(1.98743320, 9.52855312, 19.90690569, 3.23348085) * \
        torch.cos(r * c(1.79537159, 3.58608449, 4.01505002, 4.63841986) +
                  c(0.636261278, 3.60689811, 3.55551139, 3.25144230))
    zh = zh + r * (
        torch.rsqrt(c(0.329615862, 0.29109984, 0.25094573, 0.211655471) +
                    r * r) *
        c(1.54054310, 4.35171889, 7.58146856, 9.84410536) +
        c(-4.73179141e-04, -3.58678416, -6.47567145, -8.76804538))
    return zh


def eval_ggx_specular(coefficients, ref_dir, rough_artist, order: int):
    """Glossy radiance lookup from SH coefficients along the reflection
    direction (reference: shader/spherical_harmonics.glsl
    calc_sh_ggx_specular). rough_artist = sqrt(mat.roughness)."""
    zh4 = _ggx_zh_fitted(rough_artist)              # (..., 4) bands 1..4
    ones = torch.ones_like(zh4[..., :1])
    zh = torch.cat([ones, zh4], dim=-1)             # (..., order bands)
    bands = []
    for l in range(order + 1):
        bands += [l] * (2 * l + 1)
    zw = zh[..., bands]                             # (..., C)
    dirs = ref_dir / torch.clamp(
        torch.linalg.norm(ref_dir, dim=-1, keepdim=True), min=1e-30)
    basis = sh_basis(dirs, order)
    return torch.clamp(
        torch.sum(basis[..., None] * coefficients * zw[..., None], dim=-2),
        min=0.0)
