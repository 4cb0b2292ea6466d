"""The plain reference of the benchmark: the scene's triangles in world
space, worked out from the benchmark's own records (benchmark/scene.py),
and the closest hit of a ray against every one of them (Moller-Trumbore,
by brute force, in float64 by default). Plain torch and numpy only: this
module imports nothing of the program.

`tf32` rounds to TensorFloat-32 (10 explicit mantissa bits), the precision
of the control: the nearest below the float32 the configurations state."""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch


def quat_matrix(q) -> np.ndarray:
    """3x3 rotation of a unit quaternion (x, y, z, w)."""
    x, y, z, w = (float(v) for v in q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])


def world_triangles(scene) -> np.ndarray:
    """(T, 3, 3) float64 vertices of every triangle of every entity with a
    model, placed by its translation, rotation and scale."""
    out = []
    for e in scene.entities:
        if e.model is None:
            continue
        tr = e.transform
        M = quat_matrix(tr.orientation) * np.asarray(tr.scaling, np.float64)
        for _, mesh in e.model.groups:
            p = mesh.positions.astype(np.float64) @ M.T + \
                np.asarray(tr.position, np.float64)
            out.append(p[mesh.indices])
    return np.concatenate(out)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest (ties to even) at 10 mantissa bits."""
    i = x.float().contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def _identity(x):
    return x


def closest_hits(o, d, t_min, t_max, tris, t_ans=None, margin=None,
                 block: int = 64, rnd: Optional[Callable] = None,
                 dtype: torch.dtype = torch.float64):
    """Closest hits of each ray (o, d: (N, 3); t_min, t_max: (N,)) against
    every triangle of tris (T, 3, 3), both faces, by Moller-Trumbore in
    `dtype`, every operation's result rounded with `rnd` (default: none);
    rays in blocks of `block` against all triangles. A hit has barycentrics
    u, v >= 0, u + v <= 1 and t in [t_min, t_max).

    Returns {"t": the closest hit's t (N,) float64, +inf on a miss}. With
    `margin`, a relative rounding error (a few ulps of the tested
    precision), each ray-triangle pair also gets the error a test in that
    precision could make: in t, dt = margin x (1 + |o| + |v0| + |t|) / g,
    g the cosine between the ray and the triangle's normal, and in the
    barycentrics the same error over the triangle's width. Then "robust"
    is the least t + dt of the hits that stay hits with t and the
    barycentrics moved inward by their errors, "loose" the least t of those
    that are hits with them moved outward, and, with t_ans (N,), "near"
    the least |t - t_ans| - dt over the loose hits (+inf where none)."""
    r = rnd or _identity
    dev = tris.device
    tris = r(tris.to(dtype))
    v0 = [tris[:, 0, k][None] for k in range(3)]
    e1 = [r(tris[:, 1, k] - tris[:, 0, k])[None] for k in range(3)]
    e2 = [r(tris[:, 2, k] - tris[:, 0, k])[None] for k in range(3)]
    N = o.shape[0]
    keys = ["t"] + (["robust", "loose"] if margin else []) + \
        (["near"] if margin and t_ans is not None else [])
    out = {k: torch.full((N,), math.inf, dtype=torch.float64, device=dev)
           for k in keys}

    def mul(x, y):
        return r(x * y)

    def cross(x, y):
        return [r(mul(x[1], y[2]) - mul(x[2], y[1])),
                r(mul(x[2], y[0]) - mul(x[0], y[2])),
                r(mul(x[0], y[1]) - mul(x[1], y[0]))]

    def dot(x, y):
        return r(r(mul(x[0], y[0]) + mul(x[1], y[1])) + mul(x[2], y[2]))

    def closest(ok, t):
        return torch.where(ok, t, math.inf).amin(dim=1).to(torch.float64)
    if margin:
        # per triangle: |e1 x e2|, the longest edge, the largest coordinate
        n = cross(e1, e2)
        area2 = torch.sqrt(dot(n, n))
        e3 = [e2[k] - e1[k] for k in range(3)]
        longest = torch.stack([torch.sqrt(dot(e, e)) for e in (e1, e2, e3)]
                              ).amax(dim=0)
        vmag = torch.stack([x.abs() for x in v0]).amax(dim=0)
        width = longest / torch.where(area2 > 0, area2, 1.0)
    for a in range(0, N, block):
        b = min(N, a + block)
        oo = [r(o[a:b, k].to(dev, dtype))[:, None] for k in range(3)]
        dd = [r(d[a:b, k].to(dev, dtype))[:, None] for k in range(3)]
        lo = r(t_min[a:b].to(dev, dtype))[:, None]
        hi = t_max[a:b].to(dev, dtype)[:, None]
        p = cross(dd, e2)
        det = dot(e1, p)
        inv = r(1.0 / torch.where(det == 0, 1.0, det))
        s = [r(oo[k] - v0[k]) for k in range(3)]
        u = mul(dot(s, p), inv)
        q = cross(s, e1)
        v = mul(dot(dd, q), inv)
        t = mul(dot(e2, q), inv)
        w = r(u + v)
        front = det != 0
        out["t"][a:b] = closest(front & (u >= 0) & (v >= 0) & (w <= 1) &
                                (t >= lo) & (t < hi), t)
        if not margin:
            continue
        dlen = torch.sqrt(dot(dd, dd))
        olen = torch.stack([x.abs() for x in oo]).amax(dim=0)
        g = det.abs() / (torch.where(area2 > 0, area2, 1.0) * dlen)
        scale = margin * (1.0 + olen + vmag + t.abs())
        dt = scale / torch.clamp(g, min=1e-12)
        db = (dt * dlen + scale) * width
        front = front & (area2 > 0)
        robust = front & (u >= db) & (v >= db) & (w <= 1 - db) & \
            (t - dt >= lo) & (t + dt < hi)
        out["robust"][a:b] = closest(robust, t + dt)
        loose = front & (u >= -db) & (v >= -db) & (w <= 1 + db) & \
            (t + dt >= lo) & (t - dt < hi)
        out["loose"][a:b] = closest(loose, t)
        if t_ans is not None:
            ta = t_ans[a:b].to(dev, dtype)[:, None]
            out["near"][a:b] = closest(loose, (t - ta).abs() - dt)
    return out


def control_hits(o, d, t_min, t_max, tris, block: int = 64):
    """Closest hits (closest_hits' "t") in TF32: float32 with every input
    and every result rounded to 10 mantissa bits."""
    return closest_hits(o, d, t_min, t_max, tris, block=block, rnd=tf32,
                        dtype=torch.float32)["t"]
