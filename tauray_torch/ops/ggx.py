"""GGX metallic-roughness BSDF (reference: shader/ggx.glsl); the torch
counterpart of tauray_tpu.ops.ggx.

Tangent-space BSDF with diffuse, dielectric+metallic reflection and
transmission lobes, VNDF sampling (Heitz 2017), and the reference's lobe
selection probabilities. All branches are evaluated and blended with
torch.where. Convention: directions in tangent space, normal == +z."""

from __future__ import annotations

import math
import os
from typing import NamedTuple, Tuple

import torch

from .sampling import (cross, dot, length, normalize, pdf_cosine_hemisphere,
                       pow5, sample_cosine_hemisphere, sample_hemisphere,
                       sample_sphere, vec)

M_PI = math.pi

BOUNCE_MATERIAL = "material"
BOUNCE_HEMISPHERE = "hemisphere"
BOUNCE_COSINE = "cosine"


class BSDFLobes(NamedTuple):
    """(reference: shader/material.glsl bsdf_lobes)"""
    transmission: torch.Tensor
    diffuse: torch.Tensor
    dielectric_reflection: torch.Tensor
    metallic_reflection: torch.Tensor


def _clamp0(x, lo):
    return torch.clamp(x, min=lo)


def modulate_bsdf(mat, bsdf: BSDFLobes):
    """(reference: shader/material.glsl modulate_bsdf)"""
    lobes = bsdf.metallic_reflection + bsdf.transmission + bsdf.diffuse
    return mat.albedo[..., :3] * lobes[..., None] + \
        bsdf.dielectric_reflection[..., None]


def modulate_color(mat, diffuse, reflected):
    """(reference: shader/material.glsl modulate_color)"""
    approx_fresnel = 0.02
    albedo = mat.albedo[..., :3]
    metallic = mat.metallic[..., None]
    d = diffuse * albedo * (1 - metallic)
    r = reflected * (approx_fresnel * (1 - metallic) + albedo * metallic) / \
        (approx_fresnel * (1 - metallic[..., 0]) + metallic[..., 0])[..., None]
    return d + r


def add_demodulated_color(primary: BSDFLobes, light_color, diffuse,
                          reflected):
    """(reference: shader/material.glsl add_demodulated_color)"""
    diffuse = diffuse + light_color * (primary.diffuse +
                                       primary.transmission)[..., None]
    reflected = reflected + light_color * (
        primary.dielectric_reflection + primary.metallic_reflection)[..., None]
    return diffuse, reflected


# ---------------------------------------------------------------------------
# Fresnel / masking / distribution terms
# ---------------------------------------------------------------------------

def ggx_fresnel_schlick(cos_d, f0):
    return f0 + (1.0 - f0) * pow5(_clamp0(1.0 - cos_d, 0.0))


def _cos_eff(cos_d, mat):
    inv_eta = mat.ior_in / mat.ior_out
    sin2 = inv_eta * inv_eta * (1.0 - cos_d * cos_d)
    tir = (mat.ior_in > mat.ior_out) & (sin2 >= 1.0)
    cos_eff = torch.where(mat.ior_in > mat.ior_out,
                          torch.sqrt(_clamp0(1.0 - sin2, 0.0)), cos_d)
    return cos_eff, tir


def ggx_fresnel(cos_d, mat):
    """(reference: shader/ggx.glsl ggx_fresnel) — handles TIR."""
    cos_eff, tir = _cos_eff(cos_d, mat)
    f = torch.where(tir, 1.0, ggx_fresnel_schlick(cos_eff, mat.f0))
    return torch.where(mat.ior_in == mat.ior_out, 0.0, f)


def fresnel_importance(cos_d, mat):
    """(reference: shader/ggx.glsl fresnel_importance)"""
    cos_eff, tir = _cos_eff(cos_d, mat)
    f = mat.f0 + (torch.maximum(1.0 - mat.roughness, mat.f0) - mat.f0) * \
        pow5(_clamp0(1.0 - cos_eff, 0.0))
    f = torch.where(tir, 1.0, f)
    return torch.where(mat.ior_in == mat.ior_out, 0.0, f)


def fresnel_schlick_attenuated(cos_d, f0, roughness):
    """(reference: shader/ggx.glsl fresnel_schlick_attenuated) — grazing
    response damped by roughness, used for integrated (indirect) light."""
    return f0 + (torch.maximum(1.0 - roughness, f0) - f0) * \
        pow5(_clamp0(1.0 - cos_d, 0.0))


def _step(edge, x):
    return torch.where(x >= edge, 1.0, 0.0)


def ggx_masking(v_dot_n, v_dot_h, a):
    a2 = a * a
    return _step(0.0, v_dot_n * v_dot_h) * 2.0 / \
        (1.0 + torch.sqrt(1.0 + a2 / _clamp0(v_dot_n * v_dot_n, 1e-18) - a2))


def ggx_masking_shadowing(v_dot_n, v_dot_h, l_dot_n, l_dot_h, a):
    a2 = a * a
    return _step(0.0, v_dot_n * v_dot_h) * _step(0.0, l_dot_n * l_dot_h) * \
        4.0 / ((1.0 + torch.sqrt(1.0 + a2 / _clamp0(v_dot_n * v_dot_n, 1e-18)
                                 - a2)) *
               (1.0 + torch.sqrt(1.0 + a2 / _clamp0(l_dot_n * l_dot_n, 1e-18)
                                 - a2)))


def ggx_masking_shadowing_predivided(v_dot_n, v_dot_h, l_dot_n, l_dot_h, a):
    a2 = a * a
    denom1 = l_dot_n.abs() * torch.sqrt(a2 + (1.0 - a2) * (v_dot_n * v_dot_n))
    denom2 = v_dot_n.abs() * torch.sqrt(a2 + (1.0 - a2) * (l_dot_n * l_dot_n))
    return _step(0.0, v_dot_n * v_dot_h) * _step(0.0, l_dot_n * l_dot_h) * \
        0.5 / _clamp0(denom1 + denom2, 1e-20)


def ggx_distribution(h_dot_n, a):
    a2 = a * a
    denom = h_dot_n * h_dot_n * (a2 - 1.0) + 1.0
    return a2 / (M_PI * denom * denom)


# --- colored metallic Fresnel (validation flag, docs/PT_DEFICIT.md) -----
# Non-default; reproduces the older colored-Schlick metal model of the
# path-tracer golden. Off unless TAURAY_COLORED_FRESNEL=1, as in
# tauray_tpu.ops.ggx, so the default computes what the JAX default does.
_COLORED_FRESNEL = os.environ.get("TAURAY_COLORED_FRESNEL", "0") == "1"


def _colored_fresnel_split(dielectric, metallic, cos_d):
    if not _COLORED_FRESNEL:
        return dielectric, metallic
    s = pow5(1.0 - torch.clamp(cos_d, 0.0, 1.0))
    return dielectric + metallic * s, metallic * (1.0 - s)


def _ggx_brdf_inner(out_dir, view_dir, h, fresnel, distribution, cos_d, mat):
    """(reference: shader/ggx.glsl ggx_brdf_inner) -> BSDFLobes delta."""
    cos_l = out_dir[..., 2]
    cos_v = view_dir[..., 2]
    geometry = ggx_masking_shadowing_predivided(
        cos_v, cos_d, cos_l, dot(out_dir, h), mat.roughness)
    kd = (1.0 - fresnel) * (1.0 - mat.metallic) * (1.0 - mat.transmittance)
    cos_l = _clamp0(cos_l, 0.0)
    diel, metal = _colored_fresnel_split(
        fresnel * geometry * distribution * cos_l * (1.0 - mat.metallic),
        geometry * distribution * cos_l * mat.metallic, cos_d)
    return BSDFLobes(transmission=torch.zeros_like(cos_l),
                     diffuse=kd * cos_l / M_PI,
                     dielectric_reflection=diel, metallic_reflection=metal)


def ggx_bsdf(out_dir, view_dir, mat) -> BSDFLobes:
    """Full two-sided eval (reference: shader/ggx.glsl ggx_bsdf)."""
    cos_l = out_dir[..., 2]
    cos_v = view_dir[..., 2]
    h_refl = normalize(view_dir + out_dir)
    sgn = torch.where(mat.ior_in > mat.ior_out, 1.0, -1.0)[..., None]
    h_refr = sgn * normalize(mat.ior_out[..., None] * out_dir +
                             mat.ior_in[..., None] * view_dir)
    h = torch.where((cos_l > 0)[..., None], h_refl, h_refr)
    cos_h = h[..., 2]
    cos_d = dot(view_dir, h)
    cos_o = dot(out_dir, h)
    fresnel = ggx_fresnel(cos_d, mat)
    geometry = ggx_masking_shadowing_predivided(cos_v, cos_d, cos_l, cos_o,
                                                mat.roughness)
    zero_rough = mat.roughness < 0.001
    distribution = torch.where(zero_rough, 0.0,
                               ggx_distribution(cos_h, mat.roughness))
    # BRDF side
    kd = (1.0 - fresnel) * (1.0 - mat.metallic) * (1.0 - mat.transmittance)
    diffuse = kd * _clamp0(cos_l, 0.0) / M_PI
    dielectric, metallic_r = _colored_fresnel_split(
        fresnel * geometry * distribution * cos_l * (1.0 - mat.metallic),
        geometry * distribution * cos_l * mat.metallic, cos_d)
    # BTDF side
    geometry4 = geometry * 4.0
    denom = mat.ior_in / mat.ior_out * cos_d + cos_o
    transmission = -cos_l * (cos_d * cos_o).abs() * mat.transmittance * \
        (1.0 - mat.metallic) * (1.0 - fresnel) * geometry4 * distribution / \
        _clamp0(denom * denom, 1e-20)
    refl = cos_l > 0
    z = torch.zeros_like(cos_l)
    return BSDFLobes(
        transmission=torch.where(refl, z, transmission),
        diffuse=torch.where(refl, diffuse, z),
        dielectric_reflection=torch.where(refl, dielectric, z),
        metallic_reflection=torch.where(refl, metallic_r, z))


def _lobe_probabilities(view_dir, mat):
    """(reference: shader/ggx.glsl specular/diffuse cutoffs)"""
    max_albedo = mat.albedo[..., :3].amax(dim=-1)
    specular_cutoff = 1.0 + (fresnel_importance(view_dir[..., 2], mat) -
                             1.0) * ((1 - mat.metallic) * max_albedo)
    diffuse_cutoff = 1.0 - mat.transmittance
    spec_p = specular_cutoff
    diff_p = (1.0 - specular_cutoff) * diffuse_cutoff
    trans_p = (1.0 - specular_cutoff) * (1.0 - diffuse_cutoff)
    return specular_cutoff, diffuse_cutoff, spec_p, diff_p, trans_p


def ggx_vndf_sample(view, roughness, u1, u2):
    """(reference: shader/ggx.glsl ggx_vndf_sample, Heitz 2017 VNDF)."""
    r = roughness[..., None]
    v = normalize(torch.cat([r * view[..., :2], view[..., 2:3]], dim=-1))
    vz_ok = v[..., 2] < 0.9999
    ex = vec([1.0, 0, 0], v)
    t1_raw = cross(v, vec([0.0, 0, 1.0], v).expand_as(v))
    t1 = torch.where(vz_ok[..., None], normalize(
        torch.where(length(t1_raw, keepdim=True) < 1e-20, ex, t1_raw)), ex)
    t2 = cross(t1, v)
    inv_a = 1.0 + v[..., 2]
    a = 1.0 / inv_a
    rr = torch.sqrt(u1)
    lower = u2 < a
    phi = torch.where(lower, u2 * inv_a * M_PI,
                      M_PI + (u2 - a) / _clamp0(1.0 - a, 1e-12) * M_PI)
    p1 = rr * torch.cos(phi)
    p2 = rr * torch.sin(phi) * torch.where(lower, 1.0, v[..., 2])
    p3 = torch.sqrt(_clamp0(1.0 - p1 * p1 - p2 * p2, 0.0))
    n = p1[..., None] * t1 + p2[..., None] * t2 + p3[..., None] * v
    out = torch.cat([r * n[..., :2], _clamp0(n[..., 2], 0.0)[..., None]],
                    dim=-1)
    return normalize(out)


def _reflect(i, n):
    return i - 2.0 * dot(i, n, True) * n


def _refract(i, n, eta):
    """GLSL refract(); returns zero vector on TIR."""
    cos_i = dot(-i, n)
    sin2_t = eta * eta * (1.0 - cos_i * cos_i)
    tir = sin2_t > 1.0
    cos_t = torch.sqrt(_clamp0(1.0 - sin2_t, 0.0))
    r = eta[..., None] * i + (eta * cos_i - cos_t)[..., None] * n
    return torch.where(tir[..., None], 0.0, r), tir


def ggx_bsdf_sample(uniform_random, view_dir, mat
                    ) -> Tuple[torch.Tensor, BSDFLobes, torch.Tensor]:
    """Sample an outgoing direction (reference: shader/ggx.glsl
    ggx_bsdf_sample_core). Returns (out_dir, lobes, pdf); pdf == 0 flags
    delta lobes whose weight was pre-divided."""
    zero_rough = mat.roughness < 0.001
    h = ggx_vndf_sample(view_dir, mat.roughness,
                        uniform_random[..., 0], uniform_random[..., 1])
    h = torch.where(zero_rough[..., None], vec([0.0, 0, 1.0], h), h)
    cos_d = dot(view_dir, h)
    fresnel = ggx_fresnel(cos_d, mat)
    cos_v = view_dir[..., 2]
    spec_cut, diff_cut, spec_p, diff_p, trans_p = \
        _lobe_probabilities(view_dir, mat)
    u = uniform_random[..., 2]

    # --- branch 1: specular reflection -------------------------------
    out_s = _reflect(-view_dir, h)
    cos_l_s = out_s[..., 2]
    G1 = ggx_masking(cos_v, cos_d, mat.roughness)
    D_s = torch.where(zero_rough, 4 * cos_l_s * cos_v,
                      ggx_distribution(h[..., 2], mat.roughness))
    pdf_s = G1 * D_s / (4 * cos_v.abs()) * spec_p
    diffuse_pdf_s = torch.where(zero_rough, 0.0,
                                pdf_cosine_hemisphere(out_s) * diff_p)
    pdf_s_all = pdf_s + diffuse_pdf_s
    lobes_s = _ggx_brdf_inner(out_s, view_dir, h, fresnel, D_s, cos_d, mat)
    # zero-roughness: pre-divide by the (infinite) pdf
    inv_pdf_s = torch.where(pdf_s > 0, 1.0 / _clamp0(pdf_s, 1e-30), 0.0)
    lobes_s = BSDFLobes(
        transmission=lobes_s.transmission,
        diffuse=torch.where(zero_rough, 0.0, lobes_s.diffuse),
        dielectric_reflection=torch.where(
            zero_rough, lobes_s.dielectric_reflection * inv_pdf_s,
            lobes_s.dielectric_reflection),
        metallic_reflection=torch.where(
            zero_rough, lobes_s.metallic_reflection * inv_pdf_s,
            lobes_s.metallic_reflection))
    pdf_s_final = torch.where(zero_rough, 0.0, pdf_s_all)

    # --- branch 2: diffuse -------------------------------------------
    u_renorm = torch.clamp((u - spec_cut) / _clamp0(1 - spec_cut, 1e-12),
                           0.0, 0.99999)
    u_diff = torch.clamp(u_renorm / _clamp0(diff_cut, 1e-12), 0.0, 0.99999)
    out_d = sample_cosine_hemisphere(
        torch.stack([u_diff, uniform_random[..., 3]], dim=-1))
    h_d = normalize(view_dir + out_d)
    cos_d_d = dot(view_dir, h_d)
    fres_d = ggx_fresnel_schlick(cos_d_d, mat.f0)
    G1_d = ggx_masking(cos_v, cos_d_d, mat.roughness)
    D_d = torch.where(zero_rough, 0.0,
                      ggx_distribution(h_d[..., 2], mat.roughness))
    pdf_d = pdf_cosine_hemisphere(out_d) * diff_p
    spec_pdf_d = G1_d * D_d / (4 * cos_v.abs()) * spec_p
    pdf_d_all = pdf_d + spec_pdf_d
    lobes_d = _ggx_brdf_inner(out_d, view_dir, h_d, fres_d, D_d, cos_d_d,
                              mat)
    lobes_d = lobes_d._replace(
        dielectric_reflection=torch.where(zero_rough, 0.0,
                                          lobes_d.dielectric_reflection),
        metallic_reflection=torch.where(zero_rough, 0.0,
                                        lobes_d.metallic_reflection))

    # --- branch 3: transmission --------------------------------------
    out_t, tir = _refract(-view_dir, h, mat.ior_in / mat.ior_out)
    out_t = normalize(torch.where(out_t.abs() < 1e-30,
                                  vec([0.0, 0, -1.0], out_t), out_t))
    cos_l_t = out_t[..., 2]
    cos_o_t = dot(out_t, h)
    G2_t = ggx_masking_shadowing(cos_v, cos_d, cos_l_t, cos_o_t,
                                 mat.roughness)
    G1_t = ggx_masking(cos_v, cos_d, mat.roughness)
    D_t = torch.where(zero_rough, 4 * cos_l_t * cos_v,
                      ggx_distribution(h[..., 2], mat.roughness))
    denom_t = mat.ior_in / mat.ior_out * cos_d + cos_o_t
    denom2 = _clamp0(denom_t * denom_t, 1e-20)
    trans_val = (cos_d * cos_o_t).abs() * mat.transmittance * \
        (1.0 - mat.metallic) * (1.0 - fresnel) * G2_t * D_t / \
        (denom2 * _clamp0(cos_v.abs(), 1e-12))
    pdf_t = ((cos_d * cos_o_t).abs() * G1_t * D_t) / \
        (denom2 * _clamp0(cos_v.abs(), 1e-12)) * trans_p
    inv_pdf_t = torch.where(pdf_t > 0, 1.0 / _clamp0(pdf_t, 1e-30), 0.0)
    trans_final = torch.where(zero_rough, trans_val * inv_pdf_t, trans_val)
    pdf_t_final = torch.where(zero_rough, 0.0, pdf_t)
    trans_final = torch.where(tir, 0.0, trans_final)
    pdf_t_final = torch.where(tir, 0.0, pdf_t_final)
    out_t = torch.where(tir[..., None], 0.0, out_t)

    # --- select ------------------------------------------------------
    pick_s = u <= spec_cut
    pick_d = ~pick_s & (u_renorm <= diff_cut)
    pick_t = ~pick_s & ~pick_d

    out = torch.where(pick_s[..., None], out_s,
                      torch.where(pick_d[..., None], out_d, out_t))
    pdf = torch.where(pick_s, pdf_s_final,
                      torch.where(pick_d, pdf_d_all, pdf_t_final))
    z = torch.zeros_like(u)
    lobes = BSDFLobes(
        transmission=torch.where(pick_t, trans_final, z),
        diffuse=torch.where(pick_s, lobes_s.diffuse,
                            torch.where(pick_d, lobes_d.diffuse, z)),
        dielectric_reflection=torch.where(
            pick_s, lobes_s.dielectric_reflection,
            torch.where(pick_d, lobes_d.dielectric_reflection, z)),
        metallic_reflection=torch.where(
            pick_s, lobes_s.metallic_reflection,
            torch.where(pick_d, lobes_d.metallic_reflection, z)))
    return out, lobes, pdf


def ggx_bsdf_pdf(out_dir, view_dir, mat) -> Tuple[BSDFLobes, torch.Tensor]:
    """Eval + pdf for a given direction (reference: shader/ggx.glsl
    ggx_bsdf_lobe_pdf with MATERIAL_LOBE_ALL). Returns (lobes, pdf)."""
    cos_l = out_dir[..., 2]
    cos_v = view_dir[..., 2]
    h_refl = normalize(view_dir + out_dir)
    sgn = torch.where(mat.ior_in > mat.ior_out, 1.0, -1.0)[..., None]
    h_refr = sgn * normalize(mat.ior_out[..., None] * out_dir +
                             mat.ior_in[..., None] * view_dir)
    h = torch.where((cos_l > 0)[..., None], h_refl, h_refr)
    cos_h = h[..., 2]
    cos_d = dot(view_dir, h)
    cos_o = dot(out_dir, h)
    fresnel = ggx_fresnel(cos_d, mat)
    geometry = ggx_masking_shadowing_predivided(cos_v, cos_d, cos_l, cos_o,
                                                mat.roughness)
    zero_rough = mat.roughness < 0.001
    distribution = torch.where(zero_rough, 0.0,
                               ggx_distribution(cos_h, mat.roughness))
    spec_cut, diff_cut, spec_p, diff_p, trans_p = \
        _lobe_probabilities(view_dir, mat)
    G1 = ggx_masking(cos_v, cos_d, mat.roughness)

    z = torch.zeros_like(cos_l)
    refl = cos_l > 0

    kd = (1.0 - fresnel) * (1.0 - mat.metallic) * (1.0 - mat.transmittance)
    diffuse_pdf = pdf_cosine_hemisphere(out_dir) * diff_p
    diff_ok = refl & torch.isfinite(diffuse_pdf) & (diffuse_pdf > 0)
    diffuse = torch.where(diff_ok, kd * cos_l / M_PI, z)

    specular_pdf = G1 * distribution / (4 * cos_v.abs()) * spec_p
    spec_ok = refl & torch.isfinite(specular_pdf) & (specular_pdf > 0)
    diel_cf, metal_cf = _colored_fresnel_split(
        fresnel * geometry * distribution * cos_l * (1.0 - mat.metallic),
        geometry * distribution * cos_l * mat.metallic, cos_d)
    dielectric = torch.where(spec_ok, diel_cf, z)
    metallic_r = torch.where(spec_ok, metal_cf, z)

    denom = mat.ior_in / mat.ior_out * cos_d + cos_o
    denom2 = _clamp0(denom * denom, 1e-20)
    geometry4 = geometry * 4.0
    transmit_pdf = ((cos_d * cos_o).abs() * G1 * distribution) / \
        (_clamp0(cos_v.abs(), 1e-12) * denom2 * M_PI) * trans_p
    trans_ok = ~refl & torch.isfinite(transmit_pdf) & (transmit_pdf > 0)
    transmission = torch.where(
        trans_ok,
        -cos_l * (cos_d * cos_o).abs() * mat.transmittance *
        (1.0 - mat.metallic) * (1.0 - fresnel) * geometry4 * distribution /
        denom2, z)

    pdf = torch.where(diff_ok, diffuse_pdf, z) + \
        torch.where(spec_ok, specular_pdf, z) + \
        torch.where(trans_ok, transmit_pdf, z)
    return BSDFLobes(transmission, diffuse, dielectric, metallic_r), pdf


# ---------------------------------------------------------------------------
# Bounce-mode dispatch (reference: shader/ggx.glsl material_bsdf_sample/pdf)
# ---------------------------------------------------------------------------

def material_bsdf_sample(uniform_random, view_dir, mat, bounce_mode: str):
    if bounce_mode == BOUNCE_HEMISPHERE:
        transmissive = mat.transmittance > 0.0
        out = torch.where(transmissive[..., None],
                          sample_sphere(uniform_random[..., :2]),
                          sample_hemisphere(uniform_random[..., :2]))
        pdf = torch.where(transmissive, 0.25 / M_PI, 0.5 / M_PI)
        lobes, _ = ggx_bsdf_pdf(out, view_dir, mat)
        return out, lobes, pdf
    if bounce_mode == BOUNCE_COSINE:
        split = mat.transmittance * 0.5
        flip = uniform_random[..., 2] < split
        out = sample_cosine_hemisphere(uniform_random[..., :2])
        out = torch.where(flip[..., None], -out, out)
        pdf = (out[..., 2] / M_PI).abs() * torch.where(flip, split,
                                                       1.0 - split)
        lobes, _ = ggx_bsdf_pdf(out, view_dir, mat)
        return out, lobes, pdf
    return ggx_bsdf_sample(uniform_random, view_dir, mat)


def material_bsdf_pdf(out_dir, view_dir, mat, bounce_mode: str):
    lobes, pdf = ggx_bsdf_pdf(out_dir, view_dir, mat)
    if bounce_mode == BOUNCE_HEMISPHERE:
        blocked = (mat.transmittance == 0) & (out_dir[..., 2] <= 0)
        p = torch.where(mat.transmittance > 0.0, 0.25 / M_PI, 0.5 / M_PI)
        return lobes, torch.where(blocked, 0.0, p)
    if bounce_mode == BOUNCE_COSINE:
        blocked = (mat.transmittance == 0) & (out_dir[..., 2] <= 0)
        split = mat.transmittance * 0.5
        p = (out_dir[..., 2] / M_PI).abs() * \
            torch.where(out_dir[..., 2] < 0, split, 1.0 - split)
        return lobes, torch.where(blocked, 0.0, p)
    return lobes, pdf
