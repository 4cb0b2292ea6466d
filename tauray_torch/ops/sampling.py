"""Sampling primitives (reference: shader/math.glsl:200-470); the torch
counterpart of tauray_tpu.ops.sampling, vectorized over (R, ...) batches."""

from __future__ import annotations

import math

import torch

M_PI = math.pi
M_1_SQRT3 = 0.57735026918962576451


def dot(a, b, keepdim: bool = False):
    return (a * b).sum(-1, keepdim=keepdim)


def cross(a, b):
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def length(v, keepdim: bool = False):
    return torch.sqrt(dot(v, v, keepdim))


def normalize(v):
    return v / length(v, keepdim=True)


def vec(values, like):
    """Constant vector on `like`'s device and dtype."""
    return torch.tensor(values, dtype=like.dtype, device=like.device)


def xla_int32(x):
    """float32 -> int32 as XLA converts: toward zero, NaN to 0, saturating
    at the int32 range. A plain torch cast is undefined outside the range
    and differs between CPU and CUDA (NaN gives INT_MIN on x86, 0 on
    CUDA)."""
    i = torch.nan_to_num(x, nan=0.0).clamp(-2147483648.0, 2147483520.0)
    return torch.where(x >= 2147483648.0, 2147483647, i.to(torch.int32))


def pow5(x):
    """x**5 as integer_pow evaluates it: x * (x*x)*(x*x)."""
    x2 = x * x
    return x * (x2 * x2)


def create_tangent(normal):
    """(reference: shader/math.glsl create_tangent)"""
    ax = normal[..., 0:1].abs()
    ay = normal[..., 1:2].abs()
    major = torch.where(ax < M_1_SQRT3, vec([1.0, 0, 0], normal),
                        torch.where(ay < M_1_SQRT3, vec([0, 1.0, 0], normal),
                                    vec([0, 0, 1.0], normal)))
    return normalize(cross(normal, major))


def create_tangent_space(normal):
    """Returns (tangent, bitangent, normal); tangent-space z is the normal."""
    t = create_tangent(normal)
    return t, cross(normal, t), normal


def to_tangent_space(v, t, b, n):
    return torch.stack([dot(v, t), dot(v, b), dot(v, n)], dim=-1)


def from_tangent_space(v, t, b, n):
    return v[..., 0:1] * t + v[..., 1:2] * b + v[..., 2:3] * n


def view_to_tangent_space(view, t, b, n):
    """(reference: shader/math.glsl view_to_tangent_space)"""
    tview = to_tangent_space(-view, t, b, n)
    z = torch.clamp(tview[..., 2], min=1e-5)
    return normalize(torch.cat([tview[..., :2], z[..., None]], dim=-1))


def _concentric_theta(uo):
    abs_uo = uo.abs()
    x_major = abs_uo[..., 0] > abs_uo[..., 1]
    safe = torch.where(uo.abs() < 1e-12, 1e-12, uo)
    theta = torch.where(x_major,
                        M_PI / 4 * (uo[..., 1] / safe[..., 0]),
                        M_PI / 2 - M_PI / 4 * (uo[..., 0] / safe[..., 1]))
    zero = (abs_uo < 0.0001).all(-1, keepdim=True)
    return x_major, theta, zero


def sample_concentric_disk(u):
    """(reference: shader/math.glsl sample_concentric_disk)"""
    uo = 2.0 * u - 1.0
    x_major, theta, zero = _concentric_theta(uo)
    r = torch.where(x_major, uo[..., 0], uo[..., 1])
    d = r[..., None] * torch.stack([torch.cos(theta), torch.sin(theta)], -1)
    return torch.where(zero, 0.0, d)


def sample_blackman_harris(u):
    """(reference: shader/math.glsl sample_blackman_harris)"""
    flip = u > 0.5
    u = torch.where(flip, 1.0 - u, u)
    powers = torch.stack([u ** 0.5, u ** (1.0 / 3.0), u ** 0.25, u ** 0.2],
                         dim=-1)
    coef = vec([-0.33518669, -0.51620529, 1.87406934, -0.66315464], u)
    s = 0.29627329 * u + (powers * coef).sum(-1)
    return torch.where(flip, 1.0 - s, s)


def sample_blackman_harris_concentric_disk(u):
    """(reference: shader/math.glsl sample_blackman_harris_concentric_disk)"""
    uo = 2.0 * u - 1.0
    x_major, theta, zero = _concentric_theta(uo)
    rt_x = torch.where(x_major, u[..., 0], u[..., 1])
    r = 2.0 * sample_blackman_harris(rt_x) - 1.0
    d = r[..., None] * torch.stack([torch.cos(theta), torch.sin(theta)], -1)
    return torch.where(zero, 0.0, d)


def sample_regular_polygon(u, angle, sides):
    """(reference: shader/math.glsl sample_regular_polygon)"""
    sides = torch.clamp(sides, min=3.0)
    side = torch.floor(u[..., 0] * sides)
    ux = u[..., 0] * sides - side
    uy = u[..., 1]
    side_radians = (2.0 * M_PI) / sides
    a1 = side_radians * side + angle
    a2 = side_radians * (side + 1) + angle
    b = torch.stack([torch.sin(a1), torch.cos(a1)], dim=-1)
    c = torch.stack([torch.sin(a2), torch.cos(a2)], dim=-1)
    flip = ux + uy > 1
    ux = torch.where(flip, 1 - ux, ux)
    uy = torch.where(flip, 1 - uy, uy)
    return b * ux[..., None] + c * uy[..., None]


def sample_cosine_hemisphere(u):
    d = sample_concentric_disk(u)
    z = torch.sqrt(torch.clamp(1.0 - dot(d, d), min=0.0))
    return torch.cat([d, z[..., None]], dim=-1)


def pdf_cosine_hemisphere(dir):
    return torch.clamp(dir[..., 2], min=0.0) * (1.0 / M_PI)


def _sphere_dir(cos_theta, u1):
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    phi = u1 * 2 * M_PI
    return torch.stack([torch.cos(phi) * sin_theta,
                        torch.sin(phi) * sin_theta, cos_theta], dim=-1)


def sample_sphere(u):
    return _sphere_dir(2 * u[..., 0] - 1, u[..., 1])


def sample_hemisphere(u):
    return _sphere_dir(u[..., 0], u[..., 1])


def sample_cone(u, dir, cos_theta_min):
    """(reference: shader/math.glsl sample_cone)"""
    cos_theta = 1.0 + (cos_theta_min - 1.0) * u[..., 0]
    t, b, n = create_tangent_space(dir)
    o = from_tangent_space(_sphere_dir(cos_theta, u[..., 1]), t, b, n)
    bad = dot(o, dir) <= cos_theta_min
    return torch.where(bad[..., None], dir, o)


# -- triangle light sampling (reference: shader/math.glsl:360-460) ----------

def sample_triangle_area(u, A, B, C):
    alpha = u[..., 0]
    beta = u[..., 1]
    flip = alpha + beta > 1
    alpha = torch.where(flip, 1 - alpha, alpha)
    beta = torch.where(flip, 1 - beta, beta)
    gamma = 1 - beta - alpha
    return alpha[..., None] * A + beta[..., None] * B + gamma[..., None] * C


def triangle_area_pdf(p, a, b, c):
    normal = cross(a - b, a - c)
    p_dist2 = dot(p, p)
    return 2.0 * p_dist2 * torch.sqrt(p_dist2) / dot(normal, p).abs()


def _householder(nB):
    div = 1.0 / torch.sqrt(2.0 * nB[..., 0].abs() + 2.0)
    e = torch.where(nB[..., 0] > 0, div, -div)
    z = torch.zeros_like(e)
    return div, e, nB * div[..., None] + torch.stack([e, z, z], dim=-1)


def spherical_triangle_solid_angle(nA, nB, nC):
    """(reference: shader/math.glsl spherical_triangle_solid_angle)"""
    _, _, h = _householder(nB)
    a = nA - 2.0 * h * dot(h, nA, True)
    c = nC - 2.0 * h * dot(h, nC, True)
    det = (a[..., 1] * c[..., 2] - c[..., 1] * a[..., 2]).abs()
    return 2.0 * torch.atan2(
        det, 1.0 + dot(nA, nB) + dot(nB, nC) + dot(nA, nC))


def sample_spherical_triangle(xi, A, B, C):
    """(reference: shader/math.glsl sample_spherical_triangle). Returns
    (dir, pdf)."""
    nA, nB, nC = normalize(A), normalize(B), normalize(C)
    dAB, dBC, dAC = dot(nA, nB), dot(nB, nC), dot(nA, nC)
    div, e, h = _householder(nB)
    a = nA - 2.0 * h * (dAB * div + e * nA[..., 0])[..., None]
    c = nC - 2.0 * h * (dBC * div + e * nC[..., 0])[..., None]
    G0 = (a[..., 1] * c[..., 2] - c[..., 1] * a[..., 2]).abs()
    G1 = dAC + dBC
    G2 = 1.0 + dAB
    solid_angle = 2.0 * torch.atan2(G0, G1 + G2)
    pdf = 1.0 / solid_angle
    split = xi[..., 0] * solid_angle * 0.5
    r = ((G0 * torch.cos(split) - G1 * torch.sin(split))[..., None] * nA +
         (G2 * torch.sin(split))[..., None] * nC)
    Ch = 2.0 * (dot(nA, r) / dot(r, r))[..., None] * r - nA
    d = dot(Ch, nB)
    z = 1 - xi[..., 1] + d * xi[..., 1]
    st = torch.sqrt(torch.clamp(
        (1.0 - z * z) / torch.clamp(1.0 - d * d, min=1e-20), min=0.0))
    return (z - st * d)[..., None] * nB + st[..., None] * Ch, pdf


def ray_plane_intersection_dist(dir, A, B, C):
    """(reference: shader/math.glsl ray_plane_intersection_dist)"""
    n = normalize(cross(A - B, A - C))
    return (dot(A, n) / dot(n, dir)).abs()


def get_barycentric_coords(p, A, B, C):
    ba = B - A
    ca = C - A
    pa = p - A
    bb, bc, cc = dot(ba, ba), dot(ba, ca), dot(ca, ca)
    pb, pc = dot(pa, ba), dot(pa, ca)
    denom = 1.0 / (bb * cc - bc * bc)
    y = (cc * pb - bc * pc) * denom
    z = (bb * pc - bc * pb) * denom
    return torch.stack([1.0 - y - z, y, z], dim=-1)
