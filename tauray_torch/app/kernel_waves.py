"""The waves and scenes the traversal kernels are checked and timed on:
the camera and signature-sorted bounce waves of a scene, a re-trace-sized
slice of a sorted wave, and a stack of exact duplicate triangles (flat, and
under two instances) with rays aimed at it. chip_smoke.py, app/bw_bench.py
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
                 strategy="all-merged-static", shadow=False):
    """(tracer, {name: rays8 (R, 8)}): a size x size camera wave in
    pixel-block order and a signature-sorted wave of random directions
    leaving the camera wave's hits (for the instanced tracer also that wave
    unsorted; with shadow, a signature-sorted wave from those hits to the
    first point light, t_max short of it)."""
    from tauray_torch.options import Options
    from tauray_torch.io.gltf import load_scene
    from tauray_torch.ops.cluster import _sig_sort_perm
    from tauray_torch.renderer.rt_renderer import PathTracerRenderer
    from tauray_torch.scene.device import to_camera_uniforms
    from tauray_torch.scene.scene import Scene
    from tauray_torch.stages.path_tracer import _begin_sample
    opt = Options()
    opt.width = opt.height = size
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
