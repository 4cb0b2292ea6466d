"""The waves and scenes the traversal kernels are checked and timed on:
the camera and signature-sorted bounce waves of a scene, a re-trace-sized
slice of a sorted wave, a stack of exact duplicate triangles (flat, and
under two instances) with rays aimed at it, and rays that plant the slab
test's edge cases on a table of cluster boxes. chip_smoke.py, app/bw_bench.py
and the tests share them."""

from __future__ import annotations

import json

import numpy as np
import torch

from tauray_torch.ops.cluster import (instanced_tracer_from_numpy,
                                      tracer_from_numpy)

SCENE = "proc://sponza?tris=262144"
SCENE_FOLIAGE = "proc://sponza?tris=262144&foliage=1"
RETRACE_RAYS = 32768   # the sub-wave of one alpha re-trace round


def kernel_waves(device, scene=SCENE, size=512, seed=0,
                 strategy="all-merged-static", shadow=False, height=None):
    """(tracer, {name: rays8 (R, 8)}): a size x size (or size x height)
    camera wave in pixel-block order and a signature-sorted wave of random
    directions leaving the camera wave's hits (for the instanced tracer also
    that wave unsorted; with shadow, a signature-sorted wave from those hits
    to the first point light, t_max short of it)."""
    from tauray_torch.options import Options
    from tauray_torch.io.gltf import load_scene
    from tauray_torch.ops.cluster import _sig_sort_perm
    from tauray_torch.renderer.rt_renderer import PathTracerRenderer
    from tauray_torch.scene.device import to_camera_uniforms
    from tauray_torch.scene.scene import Scene
    from tauray_torch.stages.path_tracer import _begin_sample
    opt = Options()
    opt.width = size
    opt.height = height or size
    opt.as_strategy = strategy
    s = Scene()
    load_scene(scene, s)
    rr = PathTracerRenderer(opt, device)
    rr.set_scene(s)
    cam = to_camera_uniforms(rr.arrays.camera_uniforms(rr.viewports()),
                             device)
    prev = torch.zeros(rr._pix.shape[0], dtype=torch.int64, device=device)
    _, o, d, _ = _begin_sample(rr.cfg, cam, rr._pix, rr._vp, prev)
    R = o.shape[0]
    ones = torch.ones(R, dtype=torch.float32, device=device)
    camera = torch.cat([o, d, 0 * ones[:, None],
                        float("inf") * ones[:, None]], 1)
    hit = rr.bvh.trace(o, d, 0.0, float("inf"), need_uv=False)
    p = torch.where((hit.tri_id >= 0)[:, None], o + hit.t[:, None] * d, o)
    rng = np.random.default_rng(seed)
    nd = rng.standard_normal((R, 3)).astype(np.float32)
    nd /= np.linalg.norm(nd, axis=1, keepdims=True)
    bounce = torch.cat([p, torch.from_numpy(nd).to(device),
                        1e-3 * ones[:, None], float("inf") * ones[:, None]],
                       1)
    waves = {"camera": camera,
             "bounce": bounce[_sig_sort_perm(rr.bvh, bounce)].contiguous()}
    if strategy != "all-merged-static":
        waves["bounce_unsorted"] = bounce
    if shadow:
        light = torch.from_numpy(rr.arrays.pl_pos[0]).to(device)
        to_l = light[None] - p
        dist = to_l.norm(dim=1, keepdim=True)
        sh = torch.cat([p, to_l / dist, 1e-4 * ones[:, None], dist - 1e-4],
                       1)
        waves["shadow"] = sh[_sig_sort_perm(rr.bvh, sh)].contiguous()
    print(json.dumps(dict(waves=scene, strategy=strategy, size=size,
                          height=opt.height,
                          tracer=type(rr.bvh).__name__,
                          clusters=rr.bvh.n_clusters)), flush=True)
    return rr.bvh, waves


def retrace_slice(rays8: torch.Tensor, n: int = RETRACE_RAYS):
    """n contiguous rays from the middle of a sorted wave."""
    mid = (rays8.shape[0] - n) // 2 // 32 * 32
    return rays8[mid:mid + n].contiguous()


QUAD = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]],
                np.float32)


def _tie_fields(n_main, tie_every):
    """tie_stack's clusters as tracer_from_numpy fields."""
    C = n_main + 1
    v0 = np.zeros((C, 128, 3), np.float32)
    e1 = np.zeros((C, 128, 3), np.float32)
    e2 = np.zeros((C, 128, 3), np.float32)

    def put(k, lane, q):
        v0[k, lane] = q[0]
        e1[k, lane], e2[k, lane] = q[1] - q[0], q[2] - q[0]
        v0[k, lane + 1] = q[0]
        e1[k, lane + 1], e2[k, lane + 1] = q[2] - q[0], q[3] - q[0]
    for k in range(C):
        tie = k % tie_every == 0 or k == n_main
        q = QUAD + np.array([0, 0, 1.0 if tie else 3.0 + 0.25 * k],
                            np.float32)
        if k == n_main:
            q = q + np.array([11, 11, 0], np.float32)
        v0[k] = q[0]                              # degenerate fillers
        put(k, 2 * (k % 7), q)
        if tie and k < n_main:
            put(k, 100, q)
            if (k // tie_every) % 3 == 1:
                v0[k, 127] = (0.0, 0.0, 0.5 + 0.01 * k)
    corners = np.concatenate([v0, v0 + e1, v0 + e2], 1)
    return dict(
        v0=v0, e1=e1, e2=e2, tri_valid=np.ones((C, 128), bool),
        to_orig=np.arange(C * 128, dtype=np.int32), cmin=corners.min(1),
        cmax=corners.max(1), n_clusters=C,
        opaque=(np.arange(C) % 4 != 2).astype(np.int32))


def tie_stack(device, n_main=29, tie_every=3):
    """A flat tracer built so that hits tie exactly: n_main clusters of
    quads over x, y in [-1, 1], every tie_every-th holding the same quad at
    z = 1 (twice: at lanes 2m, 2m + 1 and at lanes 100, 101), the others
    one quad each at z = 3 + k / 4, far from it. Every third tie cluster
    also holds a degenerate triangle at z = 0.5 + k / 100, which moves its
    entry t forward, so the entry-t walk takes it before lower ids. One
    more cluster holds the z = 1 quad alone at x, y in [10, 12]. Every
    fourth cluster is not opaque."""
    return tracer_from_numpy(_tie_fields(n_main, tie_every), device)


# tie_stack_instanced's second instance: object -> world moves it by
# -0.5 in z (exact in float32), so its copy of the tied quads, at z = 0.5,
# lies in front of the first instance's
TIE_SHIFT = -0.5


def tie_stack_instanced(device, n_main=29, tie_every=3):
    """tie_stack's clusters as shared object geometry under two
    instances: instance 0 in place, instance 1 moved by TIE_SHIFT in z.
    Cluster-instance k is object cluster k % C of instance k // C, and
    keeps that cluster's opacity. Hits tie exactly within an instance (one
    transform, the same rows); tie_rays' tied tiles hit instance 1's quads
    first."""
    f = _tie_fields(n_main, tie_every)
    C = f["n_clusters"]
    shift = np.array([0, 0, TIE_SHIFT], np.float32)
    inv = np.zeros((2, 3, 4), np.float32)
    inv[:, :, :3] = np.eye(3, dtype=np.float32)
    inv[1, :, 3] = -shift                         # world -> object
    return instanced_tracer_from_numpy(dict(
        v0=f["v0"], e1=f["e1"], e2=f["e2"], tri_valid=f["tri_valid"],
        to_orig=np.arange(2 * C * 128, dtype=np.int32),
        cmin=np.concatenate([f["cmin"], f["cmin"] + shift]),
        cmax=np.concatenate([f["cmax"], f["cmax"] + shift]),
        n_clusters=2 * C,
        k_cluster=np.tile(np.arange(C, dtype=np.int32), 2),
        k_inst=np.repeat(np.arange(2, dtype=np.int32), C), inv=inv,
        obj_min=f["cmin"], obj_max=f["cmax"], opaque=np.tile(f["opaque"], 2),
        alpha_base=2 * C * 128), device)


def tie_rays(n_tiles, seed=0):
    """(n_tiles * 32, 8) f32 rays for tie_stack, by tile in turn: toward
    the tied quads from z = 0; away from every cluster (count 0); toward
    the lone cluster (count 1); toward the tied quads with t_max 1.5 (only
    the tie clusters count), on a quarter of its lanes a NaN t_max or
    t_max < t_min."""
    rng = np.random.default_rng(seed)
    R = n_tiles * 32
    kind = np.repeat(np.arange(n_tiles) % 4, 32)
    o = np.zeros((R, 3), np.float32)
    o[:, :2] = rng.uniform(-0.9, 0.9, (R, 2))
    o[kind == 2, :2] += 11
    d = np.concatenate([rng.uniform(-0.05, 0.05, (R, 2)),
                        np.ones((R, 1))], 1).astype(np.float32)
    d[kind == 1, 2] = -1
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmin = np.zeros(R, np.float32)
    tmax = np.full(R, np.inf, np.float32)
    lane = np.arange(R) % 32
    tmax[kind == 3] = 1.5
    tmax[(kind == 3) & (lane % 8 == 1)] = np.nan
    tmin[(kind == 3) & (lane % 8 == 5)] = 0.5
    tmax[(kind == 3) & (lane % 8 == 5)] = 0.25
    return np.concatenate([o, d, tmin[:, None], tmax[:, None]],
                          1).astype(np.float32)


# denormal float32 direction components: 1 / d overflows to +-inf
DENORMALS = np.array([1e-40, 1e-39, 1.4e-45], np.float32)


def planted_rays(cmin, cmax, n=64, seed=0):
    """(R, 8) f32 rays at the boxes cmin / cmax (C, 3) that plant the edge
    cases of phase 1's slab test, n of each of 9 kinds in turn (n a
    multiple of 32), the last padded up to a multiple of 128 rays (the
    tracer's padded wave): rays from outside toward a random box; origins
    inside a box; a direction component +0.0 or -0.0 (1 / d taken as 3e38),
    with the origin on that axis on a face of the box, inside its slab, or
    one ulp outside; a denormal component (an infinite inverse), the origin
    on a face (0 * inf is NaN), inside the slab or one ulp outside; a NaN
    t_min, direction component or origin component; all three direction
    components signed zeros, the origin on faces, inside or one ulp
    outside; rays that touch a box at one corner (entry t == exit t = s,
    some with t_max = s or t_min = s); t_min > 0 and a finite t_max cutting
    the segment; the tracer's dead filler rays (d = 1, t_min = 1,
    t_max = 0)."""
    rng = np.random.default_rng(seed)
    lo = np.asarray(cmin, np.float32)
    hi = np.asarray(cmax, np.float32)
    # the boxes aimed at: the non-empty ones (every box is tested)
    boxes = np.flatnonzero((lo <= hi).all(1))
    boxes = boxes if len(boxes) else np.arange(lo.shape[0])
    ext = float(np.max(hi[boxes].max(0) - lo[boxes].min(0)))
    rows = np.arange(n)

    def box_ids():
        return rng.choice(boxes, n)

    def aimed():
        c = box_ids()
        target = lo[c] + (hi[c] - lo[c]) * rng.random((n, 3), np.float32)
        d = rng.standard_normal((n, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        o = (target - d * np.float32(0.5 + ext * rng.random((n, 1)))
             ).astype(np.float32)
        return c, o, d

    def on_axis(c, o, a):
        """o[:, a] on a face, inside the slab, or one ulp outside."""
        pick = rng.integers(0, 5, n)
        inside = lo[c, a] + (hi[c, a] - lo[c, a]) * rng.random(n,
                                                                np.float32)
        o[:, a] = np.select(
            [pick == 0, pick == 1, pick == 2, pick == 3],
            [lo[c, a], hi[c, a], inside,
             np.nextafter(lo[c, a], np.float32(-np.inf))],
            np.nextafter(hi[c, a], np.float32(np.inf)))

    def signed_zero(k):
        return np.where(rng.random(k) < 0.5, np.float32(0.0),
                        np.float32(-0.0))

    kinds = []
    c, o, d = aimed()
    kinds.append((o, d, 0.0, np.inf))
    c = box_ids()
    o = lo[c] + (hi[c] - lo[c]) * rng.random((n, 3), np.float32)
    kinds.append((o, aimed()[2], 0.0, np.inf))
    for comp in ("zero", "denormal"):
        c, o, d = aimed()
        a = rng.integers(0, 3, n)
        for ax in range(3):
            sel = a == ax
            if comp == "zero":
                d[sel, ax] = signed_zero(int(sel.sum()))
            else:
                d[sel, ax] = rng.choice(DENORMALS, int(sel.sum())) * \
                    np.where(rng.random(int(sel.sum())) < 0.5, 1, -1
                             ).astype(np.float32)
            o_ax = o.copy()
            on_axis(c, o_ax, ax)
            o[sel, ax] = o_ax[sel, ax]
        kinds.append((o, d, 0.0, np.inf))
    # a NaN t_min, direction component or origin component
    c, o, d = aimed()
    tmin = np.zeros(n, np.float32)
    pick = rng.integers(0, 3, n)
    a = rng.integers(0, 3, n)
    tmin[pick == 0] = np.nan
    d[rows[pick == 1], a[pick == 1]] = np.nan
    o[rows[pick == 2], a[pick == 2]] = np.nan
    kinds.append((o, d, tmin, np.inf))
    c, o, _ = aimed()
    for ax in range(3):
        on_axis(c, o, ax)
    d = np.stack([signed_zero(n) for _ in range(3)], 1)
    kinds.append((o, d, 0.0, np.inf))
    # corner touches: leave slab a through its hi face at t = s while
    # entering slab b through its hi face at t = s; the third axis held
    # at the box's middle with d = 0
    c = box_ids()
    a = rng.integers(0, 3, n)
    b = (a + rng.integers(1, 3, n)) % 3
    third = 3 - a - b
    s = np.float32(2.0) ** rng.integers(-2, 2, n).astype(np.float32)
    o = ((lo[c] + hi[c]) * np.float32(0.5)).astype(np.float32)
    d = np.zeros((n, 3), np.float32)
    o[rows, a] = hi[c, a] - s
    o[rows, b] = hi[c, b] + s
    d[rows, a] = 1.0
    d[rows, b] = -1.0
    d[rows, third] = signed_zero(n)
    tmin = np.where(rows % 4 == 1, s, 0).astype(np.float32)
    tmax = np.where(rows % 4 == 2, s, np.inf).astype(np.float32)
    kinds.append((o, d, tmin, tmax))
    c, o, d = aimed()
    dist = np.linalg.norm(((lo[c] + hi[c]) * 0.5 - o), axis=1)
    kinds.append((o, d, (dist * rng.random(n)).astype(np.float32),
                  (dist * (0.5 + rng.random(n))).astype(np.float32)))
    m = n + (-9 * n) % 128
    kinds.append((np.zeros((m, 3), np.float32), np.ones((m, 3), np.float32),
                  1.0, 0.0))
    out = []
    for o, d, tmin, tmax in kinds:
        k = o.shape[0]
        t = np.broadcast_to(np.asarray(tmin, np.float32), (k,))
        T = np.broadcast_to(np.asarray(tmax, np.float32), (k,))
        out.append(np.concatenate([o, d, t[:, None], T[:, None]], 1))
    return np.concatenate(out).astype(np.float32)


def flush_denormals(rays8: np.ndarray) -> np.ndarray:
    """rays8 with each denormal number replaced by a zero of its sign, as
    a processor that flushes denormals reads them (XLA on the CPU, the
    TPU)."""
    x = np.asarray(rays8, np.float32)
    tiny = (x != 0) & (np.abs(x) < np.finfo(np.float32).tiny)
    return np.where(tiny, np.copysign(np.float32(0), x), x)


def one_per_tile(rays8: np.ndarray) -> np.ndarray:
    """Each ray of rays8 (N, 8) alone in its 32-ray tile, the other 31 the
    tracer's dead filler rays, so a tile's key row is that ray's."""
    out = np.zeros((rays8.shape[0], 32, 8), np.float32)
    out[:, 1:, 3:7] = 1.0
    out[:, 0] = rays8
    return out.reshape(-1, 8)
