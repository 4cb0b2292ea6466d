"""Camera rays, vertex interpolation, texture and material sampling; the
torch counterpart of tauray_tpu.ops.shading (reference:
shader/camera.glsl, shader/rt.glsl get_interpolated_vertex,
shader/scene.glsl sample_material). Flat ray batches (R, ...)."""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..scene.device import (IP_ALBEDO, IP_DOUBLE, IP_EMISSION, IP_IOR,
                            IP_METAL, IP_NORMAL_F, IP_ROUGH, IP_STMUL,
                            IP_TEX, IP_TEXBLOCK, IP_TEXSIZE, IP_TRANSMIT,
                            TP_HARDN, TP_INST, TP_IP, TP_NORMAL, TP_POS,
                            TP_PREV, TP_TANGENT, TP_UV, CameraUniforms,
                            DeviceScene)
from .sampling import cross, dot, length, normalize, xla_int32


def _mv(m, v):
    """Batched (R, i, j) @ (R, j) -> (R, i)."""
    return (m * v[:, None, :]).sum(-1)


# ---------------------------------------------------------------------------
# Camera rays
# ---------------------------------------------------------------------------

def get_camera_ray(cam: CameraUniforms, vp, pixel_coord, screen_size):
    """Pinhole/ortho/equirect camera ray (reference: shader/camera.glsl
    get_camera_ray). vp: (R,) viewport index; pixel_coord: (R, 2) pixels;
    screen_size: (2,). Returns (origin (R, 3), dir (R, 3))."""
    uv = pixel_coord / screen_size * 2.0 - 1.0
    proj_inv = cam.proj_inverse[vp]
    view_inv = cam.view_inverse[vp]
    t = _mv(proj_inv, torch.cat([uv, torch.ones_like(uv)], dim=-1))
    d = normalize(_mv(view_inv[:, :3, :3], t[:, :3]))
    # equirectangular branch (reference: shader/camera.glsl:107-124)
    eq = cam.proj_type[vp] == 2
    ang = uv * cam.pan[vp][:, :2]
    c = torch.cos(ang)
    s = torch.sin(ang)
    teq = torch.stack([s[:, 0] * c[:, 1], s[:, 1], -c[:, 0] * c[:, 1]], -1)
    deq = normalize(_mv(view_inv[:, :3, :3], teq))
    d = torch.where(eq[:, None], deq, d)
    return cam.origin[vp][:, :3], d


def get_camera_ray_dof(cam: CameraUniforms, vp, pixel_coord, screen_size,
                       dof_u):
    """Thin-lens depth of field (reference: shader/camera.glsl
    USE_DEPTH_OF_FIELD branch)."""
    from .sampling import sample_concentric_disk, sample_regular_polygon
    uv = pixel_coord / screen_size * 2.0 - 1.0
    dof = cam.dof_params[vp]
    sides = dof[:, 3]
    aperture = torch.where(sides[:, None] == 0, sample_concentric_disk(dof_u),
                           sample_regular_polygon(dof_u, dof[:, 2], sides))
    view_origin = torch.cat(
        [aperture * dof[:, 1:2], torch.zeros_like(sides)[:, None]], dim=-1)
    t = _mv(cam.proj_inverse[vp],
            torch.cat([uv, torch.ones_like(uv)], dim=-1))
    view_dir = normalize(t[:, :3] * dof[:, 0:1] - view_origin)
    view_inv = cam.view_inverse[vp]
    origin = _mv(view_inv[:, :3, :3], view_origin) + view_inv[:, :3, 3]
    d = normalize(_mv(view_inv[:, :3, :3], view_dir))
    eq = cam.proj_type[vp] == 2
    o_pin, d_pin = get_camera_ray(cam, vp, pixel_coord, screen_size)
    return (torch.where(eq[:, None], o_pin, origin),
            torch.where(eq[:, None], d_pin, d))


def get_screen_camera_ray(cam: CameraUniforms, vp, pixel_pos, screen_size,
                          pixel_offset=None, dof_u=None):
    """(reference: shader/rt.glsl get_screen_camera_ray)
    pixel_pos: (R, 2) integer pixel positions; OpenGL-style y flip."""
    size = screen_size
    if pixel_offset is None:
        p = pixel_pos.to(torch.float32) + 0.5
    else:
        p = pixel_pos.to(torch.float32) + (pixel_offset * 0.5 + 0.5)
    p = torch.stack([p[:, 0], size[1] - p[:, 1]], dim=-1)
    if dof_u is None:
        return get_camera_ray(cam, vp, p, size)
    return get_camera_ray_dof(cam, vp, p, size, dof_u)


def get_camera_projection(cam: CameraUniforms, vp, world_pos):
    """(reference: shader/camera.glsl get_camera_projection, equirect
    variant camera.glsl:126-134)"""
    vpm = cam.view_proj[vp]
    pr = _mv(vpm[:, :3, :3], world_pos) + vpm[:, :3, 3]
    w = (vpm[:, 3, :3] * world_pos).sum(-1) + vpm[:, 3, 3]
    uv = pr[:, :2] / w[:, None] * 0.5 + 0.5
    eq = cam.proj_type[vp] == 2
    vm = cam.view[vp]
    t = _mv(vm[:, :3, :3], world_pos) + vm[:, :3, 3]
    t_len = torch.clamp(length(t), min=1e-12)
    tn = t / t_len[:, None]
    fov = torch.clamp(cam.pan[vp][:, :2], min=1e-9)
    uv_eq = torch.stack([torch.atan2(tn[:, 0], -tn[:, 2]),
                         torch.asin(torch.clamp(tn[:, 1], -1, 1))],
                        dim=-1) / fov * 0.5 + 0.5
    uv = torch.where(eq[:, None], uv_eq, uv)
    w = torch.where(eq, t_len, w)
    return torch.cat([uv, w[:, None]], dim=-1)


# ---------------------------------------------------------------------------
# Texture sampling
# ---------------------------------------------------------------------------

def sample_texture_quad(scene: DeviceScene, tex_id, size, uv, block=None):
    """Bilinear sample from the 4x4-block mip atlas: one row gather per
    sample (scene.tex_atlas from build_tex_atlas). tex_id: (R,) (negative
    = unbound, returns 1); size: (R, 2) (w, h) of the sampled level;
    block: (R, 2) atlas block offset of the level; uv: (R, 2). REPEAT
    wrapping; floor-mod as jnp.mod does."""
    if block is None:
        block = torch.zeros_like(size)
    w = torch.clamp(size[..., 0], min=1.0)
    h = torch.clamp(size[..., 1], min=1.0)
    u = uv[:, 0] * w - 0.5
    v = uv[:, 1] * h - 0.5
    x0 = torch.floor(u)
    y0 = torch.floor(v)
    fu = (u - x0)[:, None]
    fv = (v - y0)[:, None]
    x0i = torch.remainder(x0.to(torch.int32), w.to(torch.int32))
    y0i = torch.remainder(y0.to(torch.int32), h.to(torch.int32))
    px = (x0i >> 1) + block[..., 0].to(torch.int32)
    py = (y0i >> 1) + block[..., 1].to(torch.int32)
    lx = (x0i & 1)[:, None]
    ly = (y0i & 1)[:, None]
    wa = scene.tex_atlas.shape[1]
    flat = scene.tex_atlas.reshape(-1, 16)
    w32 = flat[py.long() * wa + px.long()]                   # (R, 16) i32
    q = torch.stack([(w32 >> (8 * k)) & 0xFF for k in range(4)],
                    dim=-1).reshape(-1, 4, 4, 4).to(torch.float32)
    # rows y0, y0+1 live at block rows (ly, ly+1), ly in {0, 1}
    rA = torch.where(ly[..., None] == 0, q[:, 0], q[:, 1])  # (R, 4, 4)
    rB = torch.where(ly[..., None] == 0, q[:, 1], q[:, 2])
    lxm = lx == 0
    c00 = torch.where(lxm, rA[:, 0], rA[:, 1])
    c10 = torch.where(lxm, rA[:, 1], rA[:, 2])
    c01 = torch.where(lxm, rB[:, 0], rB[:, 1])
    c11 = torch.where(lxm, rB[:, 1], rB[:, 2])
    col = (c00 * (1 - fu) * (1 - fv) + c10 * fu * (1 - fv) +
           c01 * (1 - fu) * fv + c11 * fu * fv) * (1.0 / 255.0)
    return torch.where(tex_id[:, None] >= 0, col, 1.0)


def sample_texture_lod(scene: DeviceScene, tex_id, uv, lod):
    """True trilinear mip sample (reference: src/texture.cc
    generate_mipmaps + the sampler's hardware trilinear): bilinear at
    floor(lod) and floor(lod)+1, blended by the lod fraction. lod: (R,)
    float."""
    tid = tex_id.to(torch.int64).clamp(min=0)
    nmips = scene.tex_nmips[tid].to(torch.int64)
    l0 = torch.minimum(torch.clamp(xla_int32(torch.floor(lod)).long(),
                                   min=0), nmips - 1)
    l1 = torch.minimum(l0 + 1, nmips - 1)
    f = torch.clamp(lod - l0.to(torch.float32), 0.0, 1.0)[:, None]
    m0 = scene.tex_meta[tid, l0].to(torch.float32)
    m1 = scene.tex_meta[tid, l1].to(torch.float32)
    c0 = sample_texture_quad(scene, tex_id, m0[:, 2:4], uv, block=m0[:, 0:2])
    c1 = sample_texture_quad(scene, tex_id, m1[:, 2:4], uv, block=m1[:, 0:2])
    # when l1 == l0 (last level) the blend is a no-op by construction
    return c0 * (1 - f) + c1 * f


def ray_cone_lod(scene: DeviceScene, v: "VertexData", footprint_world,
                 view_dir):
    """log2 of the UV-space pixel footprint at the hit, from a ray-cone
    width in world units (the ray-cast raster's analogue of fragment
    derivatives; the reference raster samples with implicit derivatives
    and hardware trilinear, shader/forward.frag). Texel density comes
    from the hit triangle's uv-area / world-area ratio; grazing incidence
    widens the footprint by 1/|n.d| (clamped)."""
    g = scene.tri_packed[v.primitive_id.clamp(min=0).long()]
    p0 = g[:, TP_POS:TP_POS + 3]
    p1 = g[:, TP_POS + 3:TP_POS + 6]
    p2 = g[:, TP_POS + 6:TP_POS + 9]
    u0 = g[:, TP_UV:TP_UV + 2]
    u1 = g[:, TP_UV + 2:TP_UV + 4]
    u2 = g[:, TP_UV + 4:TP_UV + 6]
    wa = length(cross(p1 - p0, p2 - p0))
    e1 = u1 - u0
    e2 = u2 - u0
    ua = (e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]).abs()
    density = torch.sqrt(ua / torch.clamp(wa, min=1e-20))
    n = g[:, TP_HARDN:TP_HARDN + 3]
    spread = 1.0 / torch.clamp(dot(n, view_dir).abs(), 0.1, 1.0)
    return torch.log2(torch.clamp(footprint_world * density * spread,
                                  min=1e-20))


def inverse_srgb_correction(col):
    """(reference: shader/color.glsl:7-12) — the exact polynomial."""
    low = col * 0.07739938
    high = (col * 0.94786729 + 0.05213270) ** 2.4
    return torch.where(col > 0.04045, high, low)


def rgb_to_luminance(col):
    return col[..., 0] * 0.2126 + col[..., 1] * 0.7152 + col[..., 2] * 0.0722


# ---------------------------------------------------------------------------
# Vertex interpolation + material
# ---------------------------------------------------------------------------

class VertexData(NamedTuple):
    """(reference: shader/scene.glsl vertex_data)"""
    pos: torch.Tensor
    prev_pos: torch.Tensor
    hard_normal: torch.Tensor
    smooth_normal: torch.Tensor
    mapped_normal: torch.Tensor
    uv: torch.Tensor
    tangent: torch.Tensor
    bitangent: torch.Tensor
    back_facing: torch.Tensor
    instance_id: torch.Tensor
    primitive_id: torch.Tensor


class SampledMaterial(NamedTuple):
    """(reference: shader/material.glsl sampled_material)"""
    albedo: torch.Tensor        # (R, 4)
    metallic: torch.Tensor
    roughness: torch.Tensor
    emission: torch.Tensor      # (R, 3)
    transmittance: torch.Tensor
    ior_in: torch.Tensor
    ior_out: torch.Tensor
    f0: torch.Tensor
    double_sided: torch.Tensor
    shadow_terminator_mul: torch.Tensor


def bary_from_row(g, origin, direction):
    """Barycentrics (u, v) from a gathered tri_packed row and the ray
    (Möller-Trumbore), so traces can skip their barycentric post-pass."""
    v0 = g[:, TP_POS:TP_POS + 3]
    e1 = g[:, TP_POS + 3:TP_POS + 6] - v0
    e2 = g[:, TP_POS + 6:TP_POS + 9] - v0
    h = cross(direction, e2)
    a = dot(e1, h)
    f = torch.where(a != 0, 1.0 / torch.where(a == 0, 1.0, a), 0.0)
    s = origin - v0
    return f * dot(s, h), f * dot(direction, cross(s, e1))


def interpolate_vertex(scene: DeviceScene, tri_id, bary_u, bary_v, view_dir,
                       ray_origin=None, row=None) -> VertexData:
    """(reference: shader/rt.glsl get_interpolated_vertex). One tri_packed
    row per ray feeds the whole interpolation. ray_origin: when given,
    (bary_u, bary_v) are recomputed from the row and the ray (view_dir is
    the ray direction). row: an already-gathered tri_packed row."""
    tid = tri_id.clamp(min=0)
    g = scene.tri_packed[tid.long()] if row is None else row
    if ray_origin is not None:
        bary_u, bary_v = bary_from_row(g, ray_origin, view_dir)
    b0 = (1.0 - bary_u - bary_v)[:, None]
    b1 = bary_u[:, None]
    b2 = bary_v[:, None]

    def lerp3(base, n):
        return (g[:, base:base + n] * b0 + g[:, base + n:base + 2 * n] * b1 +
                g[:, base + 2 * n:base + 3 * n] * b2)

    pos = lerp3(TP_POS, 3)
    prev_pos = lerp3(TP_PREV, 3)
    smooth_n = normalize(lerp3(TP_NORMAL, 3))
    avg_tan = lerp3(TP_TANGENT, 4)
    tangent = normalize(avg_tan[:, :3])
    uv = lerp3(TP_UV, 2)
    hard_n = g[:, TP_HARDN:TP_HARDN + 3]
    back = dot(hard_n, view_dir) > 0
    sgn = torch.where(back, -1.0, 1.0)[:, None]
    smooth_n = smooth_n * sgn
    hard_n = hard_n * sgn
    bitangent = normalize(cross(smooth_n, tangent) * avg_tan[:, 3:4])
    return VertexData(
        pos=pos, prev_pos=prev_pos, hard_normal=hard_n,
        smooth_normal=smooth_n, mapped_normal=smooth_n, uv=uv,
        tangent=tangent, bitangent=bitangent, back_facing=back,
        instance_id=g[:, TP_INST].to(torch.int32), primitive_id=tid)


def sample_material(scene: DeviceScene, v: VertexData,
                    slots: Optional[Tuple[bool, ...]] = None, lod_uv=None,
                    row=None) -> Tuple[SampledMaterial, VertexData]:
    """(reference: shader/scene.glsl sample_material). Returns the material
    and the vertex with normal mapping applied. The material constants
    come from the same tri_packed row as the vertex (pass `row`).

    slots: per-scene (albedo, mr, normal, emission) "any material binds
    this slot" flags; unbound slots skip their texture gather.

    lod_uv: optional (R,) log2 UV footprint (ray_cone_lod); the raster
    path passes it for the reference's fragment-derivative trilinear
    filtering (scene.glsl USE_EXPLICIT_GRADIENTS textureGrad). Ray-traced
    paths leave it None: the base level, as the reference's texture()
    outside fragment stages."""
    m = (scene.tri_packed[v.primitive_id.long()] if row is None
         else row)[:, TP_IP:]
    tex = m[:, IP_TEX:IP_TEX + 4].to(torch.int32)
    if slots is None:
        slots = (True, True, True, True)

    def tex_at(slot):
        size = m[:, IP_TEXSIZE + 2 * slot:IP_TEXSIZE + 2 * slot + 2]
        if lod_uv is not None:
            # texture-space lod: footprint in texels of this texture
            lod = lod_uv + 0.5 * torch.log2(torch.clamp(
                size[:, 0] * size[:, 1], min=1.0))
            return sample_texture_lod(scene, tex[:, slot], v.uv, lod)
        blk = m[:, IP_TEXBLOCK + 2 * slot:IP_TEXBLOCK + 2 * slot + 2]
        return sample_texture_quad(scene, tex[:, slot], size, v.uv,
                                   block=blk)

    albedo = m[:, IP_ALBEDO:IP_ALBEDO + 4]
    if slots[0]:
        tex_col = tex_at(0)
        tex_rgb = inverse_srgb_correction(tex_col[:, :3])
        albedo = albedo * torch.cat([tex_rgb, tex_col[:, 3:4]], dim=-1)

    if slots[1]:
        mr_tex = tex_at(1)
        # glTF: metallic in B, roughness in G (reference: scene.glsl .bg)
        metallic = m[:, IP_METAL] * mr_tex[:, 2]
        r = m[:, IP_ROUGH] * mr_tex[:, 1]
    else:
        metallic = m[:, IP_METAL]
        r = m[:, IP_ROUGH]
    roughness = r * r                 # artist-space squaring

    mapped_normal = v.smooth_normal
    if slots[2]:
        has_normal_tex = tex[:, 2] >= 0
        nf = m[:, IP_NORMAL_F:IP_NORMAL_F + 1]
        ts_n = normalize(tex_at(2)[:, :3] * 2.0 - 1.0)
        tbn_n = normalize(v.tangent * ts_n[:, 0:1] * nf +
                          v.bitangent * ts_n[:, 1:2] * nf +
                          v.smooth_normal * ts_n[:, 2:3])
        mapped_normal = torch.where(
            has_normal_tex[:, None] &
            torch.isfinite(tbn_n).all(-1, keepdim=True),
            tbn_n, mapped_normal)

    emission = m[:, IP_EMISSION:IP_EMISSION + 3]
    if slots[3]:
        emission = emission * tex_at(3)[:, :3]

    transmittance = m[:, IP_TRANSMIT]
    ior = m[:, IP_IOR]
    refr_back = v.back_facing & (transmittance > 0.0001)
    ior_in = torch.where(refr_back, ior, 1.0)
    ior_out = torch.where(refr_back, 1.0, ior)
    f0 = (ior_out - ior_in) / (ior_out + ior_in)
    mat = SampledMaterial(
        albedo=albedo, metallic=metallic, roughness=roughness,
        emission=emission, transmittance=transmittance,
        ior_in=ior_in, ior_out=ior_out, f0=f0 * f0,
        double_sided=m[:, IP_DOUBLE] > 0.5,
        shadow_terminator_mul=m[:, IP_STMUL])
    return mat, v._replace(mapped_normal=mapped_normal)
