"""What the TPU labs share: the constants of scripts/kernel_lab.py,
kernel_lab2-5.py, kernel_lab8-11.py and mxu_lab.py, their seeded inputs
(made with numpy.random.default_rng exactly as each script makes them), a
CUDA-event timer, the card's name and power limit, and each lab's
entry-point plumbing (--device, the bound of a mode)."""

from __future__ import annotations

import argparse
import statistics
import subprocess
import time
from typing import Callable, Dict, Iterator, NamedTuple, Sequence, Tuple

import numpy as np
import torch

TILE = 32          # rays per tile
CLUSTER = 128      # triangles per cluster
KBV = 8            # clusters per step
G = 32             # tiles per group (one TPU grid step)
KC = 128           # key-head lanes per tile
BIG = 3.0e38

# H100 SXM peaks (NVIDIA's data sheet, at the 700 W limit): FP32 outside
# the tensor cores, TF32 in them, HBM3
PEAK_FP32 = 67e12
PEAK_TF32 = 495e12
PEAK_BYTES = 3.35e12
# FP32 operations of one Baldwin-Weber test (csrc/trace_tiles.cu) and of
# one Möller-Trumbore test: 9 for h, 5 for a, the reciprocal, 3 for s, 6
# each for u, v and t (q's 9 once), u + v
FLOPS_BW = 32
FLOPS_MT = 46

# scripts/kernel_lab2-5.py (L4-L7): a synthetic table of CC clusters of
# BRICK triangles, ROW meta entries a tile, R_BRICK rays a configuration
# (L7: L7_TILES tiles of 32)
CC = 636
BRICK = CLUSTER
ROW = 1024
R_BRICK = 65536
L7_TILES = 32768

# scripts/kernel_lab.py (L1-L3): R_TILE rays in tiles of TILE_L1 over CC
# clusters, KB_L1 clusters a step; a tile's meta row holds CPAD cluster
# entries, then from CPAD on the tnear bits the exit reads, ROW_L1 in all
TILE_L1 = 128
KB_L1 = 8
CPAD = 1024
ROW_L1 = 3 * CPAD
R_TILE = 65536

# scripts/mxu_lab.py (L12): N_TILES_L12 tiles of TILE rays, STEPS_L12
# steps of KBV clusters a tile, ORDER_L12 cluster entries a tile
N_TILES_L12 = 2048
STEPS_L12 = 6
ORDER_L12 = 64

SCENE = "proc://sponza?tris=262144"


def lab8_inputs(n_rays: int = 1 << 20, seed: int = 0):
    """scripts/kernel_lab8.py main's o3, d3 (n_tiles, 32, 3) f32, mm2
    (n_tiles, 32, 2) f32 and heads (n_tiles, 128) i32 (zeros)."""
    n_tiles = n_rays // TILE
    rng = np.random.default_rng(seed)
    o3 = rng.standard_normal((n_tiles, TILE, 3)).astype(np.float32)
    d3 = rng.standard_normal((n_tiles, TILE, 3)).astype(np.float32)
    mm2 = rng.standard_normal((n_tiles, TILE, 2)).astype(np.float32)
    heads = np.zeros((n_tiles, KC), np.int32)
    return o3, d3, mm2, heads


def lab9_inputs(n_clusters: int, n_rays: int = 1 << 20, seed: int = 0):
    """scripts/kernel_lab9.py main's o3, d3, mm2 ([0, 1e30]) and heads,
    uniform in [0, n_clusters)."""
    n_tiles = n_rays // TILE
    rng = np.random.default_rng(seed)
    o3 = rng.standard_normal((n_tiles, TILE, 3)).astype(np.float32)
    d3 = rng.standard_normal((n_tiles, TILE, 3)).astype(np.float32)
    mm2 = np.stack([np.zeros((n_tiles, TILE)),
                    np.full((n_tiles, TILE), 1e30)], -1).astype(np.float32)
    heads = rng.integers(0, n_clusters, (n_tiles, KC)).astype(np.int32)
    return o3, d3, mm2, heads


def lab11_inputs(C: int = 1024, n_tiles: int = 4096, n_steps: int = 8,
                 seed: int = 0):
    """scripts/kernel_lab11.py main's synthetic stream: steps (n_tiles,)
    i32, rays (n_tiles, 32, 8) f32 (t_min 0, t_max BIG), the Baldwin-Weber
    rows tris12 (C, 12, 1, 128) f32 and the matrix form (C, 3, 4, 128) f32
    [type (n, r1, r2), row (x, y, z, -v.v0), triangle], built by the
    script's own numpy code."""
    rng = np.random.default_rng(seed)
    rays = rng.standard_normal((n_tiles, TILE, 8)).astype(np.float32)
    rays[:, :, 6] = 0.0
    rays[:, :, 7] = BIG
    v0 = rng.standard_normal((C * CLUSTER, 3)).astype(np.float32)
    e1 = rng.standard_normal((C * CLUSTER, 3)).astype(np.float32) * 0.1
    e2 = rng.standard_normal((C * CLUSTER, 3)).astype(np.float32) * 0.1
    n = np.cross(e1, e2)
    det = (n * n).sum(-1, keepdims=True)
    inv = np.where(det > 0, 1.0 / np.where(det == 0, 1, det), 0)
    r1 = np.cross(e2, n) * inv
    r2 = np.cross(n, e1) * inv

    def dv(x):
        return (x * v0).sum(-1, keepdims=True)
    bw = np.concatenate([n, dv(n), r1, dv(r1), r2, dv(r2)], -1)
    tris12 = np.swapaxes(bw.reshape(C, CLUSTER, 12), 1, 2)[:, :, None, :]
    tris12 = np.ascontiguousarray(tris12.reshape(C, 12, 1, CLUSTER))
    m = np.zeros((C, 3, 4, CLUSTER), np.float32)
    for t, (vec, dd) in enumerate(((n, dv(n)), (r1, dv(r1)),
                                   (r2, dv(r2)))):
        vr = vec.reshape(C, CLUSTER, 3)
        m[:, t, 0] = vr[..., 0]
        m[:, t, 1] = vr[..., 1]
        m[:, t, 2] = vr[..., 2]
        m[:, t, 3] = -dd.reshape(C, CLUSTER)
    steps = np.full((n_tiles,), n_steps, np.int32)
    return steps, rays, tris12, m


def lab1_inputs():
    """scripts/kernel_lab.py's module-level draws from one default_rng(0),
    in its order (:31-35): the 8 ray columns (R_TILE, 1) f32 in [0, 1),
    returned stacked as (8, R_TILE) [ox, oy, oz, dx, dy, dz, t_min,
    t_max]; tris9 (CC, 9, 1, 128) f32 in [0, 1); meta (R_TILE / TILE_L1 x
    ROW_L1,) i32 in [0, CC)."""
    rng = np.random.default_rng(0)
    rays = np.stack([rng.random((R_TILE, 1), dtype=np.float32)[:, 0]
                     for _ in range(8)])
    tris9 = rng.random((CC, 9, 1, CLUSTER), dtype=np.float32)
    meta = rng.integers(0, CC, R_TILE // TILE_L1 * ROW_L1, dtype=np.int32)
    return rays, tris9, meta


def lab12_inputs():
    """scripts/mxu_lab.py's module-level draws from one default_rng(0), in
    its order (:34-42): o3 (N_TILES_L12, 32, 3) f32 in [0, 1), d3 (the same
    shape, standard normal in f64, cast), mm2 (N_TILES_L12, 32, 2) [0 |
    3e38] (no draw), tris9 (CC, 9, 1, 128), tris24 (CC, 24, 1, 128) and
    order (N_TILES_L12, 64) i32 in [0, CC)."""
    rng = np.random.default_rng(0)
    o3 = rng.random((N_TILES_L12, TILE, 3), dtype=np.float32)
    d3 = rng.standard_normal((N_TILES_L12, TILE, 3)).astype(np.float32)
    mm2 = np.concatenate(
        [np.zeros((N_TILES_L12, TILE, 1), np.float32),
         np.full((N_TILES_L12, TILE, 1), BIG, np.float32)], -1)
    tris9 = rng.random((CC, 9, 1, CLUSTER), dtype=np.float32)
    tris24 = rng.random((CC, 24, 1, CLUSTER), dtype=np.float32)
    order = rng.integers(0, CC, (N_TILES_L12, ORDER_L12), dtype=np.int32)
    return dict(o3=o3, d3=d3, mm2=mm2, tris9=tris9, tris24=tris24,
                order=order)


class BrickConfig(NamedTuple):
    """One configuration of an L4-L7 script's main: the lab (lab4-lab7),
    its mode (lab_kernel.MODES), rays a tile, clusters a step, steps,
    tiles, and the script's label."""
    lab: str
    mode: str
    tile: int
    kb: int
    steps: int
    n_tiles: int
    label: str


# each script's targets of tests a ray, by rays a tile
_TARGET = {8: 14, 16: 26, 32: 52}
LAB4_NAMES = ("k6", "k7", "k6f", "k7f")


def lab4_configs(names: Sequence[str] = LAB4_NAMES):
    """scripts/kernel_lab2.py main's runs: k8 / k6 / k7 (8, 16 or 32 rays a
    tile), an f suffix for the deferred-division body, KB 4, 8 and 16."""
    out = []
    for name in names:
        tile = 8 if name.startswith("k8") else \
            16 if name.startswith("k6") else 32
        for kb in (4, 8, 16):
            out.append(BrickConfig(
                "lab4", "mtfast" if name.endswith("f") else "mt", tile, kb,
                max(_TARGET[tile] // kb, 1), R_BRICK // tile,
                f"{name} TILE={tile} KB={kb}"))
    return out


def lab5_configs():
    """scripts/kernel_lab3.py main's runs: TILE 8, 16, 32 x KB 1, 2, 4, 8."""
    return [BrickConfig("lab5", "mt", tile, kb, max(_TARGET[tile] // kb, 1),
                        R_BRICK // tile, f"vmem TILE={tile} KB={kb}")
            for tile in (8, 16, 32) for kb in (1, 2, 4, 8)]


def lab6_configs():
    """scripts/kernel_lab4.py main's runs: each variant (fixed, slot, cid,
    while, while2) at (TILE, KB) = (32, 8), (32, 16), (16, 8)."""
    out = []
    for v in ("fixed", "slot", "cid", "while", "while2"):
        for tile, kb in ((32, 8), (32, 16), (16, 8)):
            steps = {8: 6, 16: 3}[kb] if tile == 32 else 3
            out.append(BrickConfig("lab6", v, tile, kb, steps,
                                   R_BRICK // tile,
                                   f"{v:6s} TILE={tile} KB={kb:2d}"))
    return out


def lab7_configs():
    """scripts/kernel_lab5.py main's runs: mt then bw, each at (KB, steps)
    = (8, 6), (8, 4), (4, 8); 32,768 tiles of 32."""
    return [BrickConfig("lab7", v, TILE, kb, steps, L7_TILES,
                        f"{v:3s} KB={kb:2d}")
            for v in ("mt", "bw") for kb, steps in ((8, 6), (8, 4), (4, 8))]


Inputs = Iterator[Tuple[BrickConfig, np.ndarray, np.ndarray]]


def _brick_inputs(tables: Sequence[Tuple[str, int]],
                  configs) -> Tuple[Dict[str, np.ndarray], Inputs]:
    """The draws of an L4-L7 script from its one default_rng(0): the tables
    (name, floats a triangle) when called, as the script draws them at
    import; then, as the generator is read, each configuration's meta
    (n_tiles x 1,024,) i32 in [0, CC) and rays (n_tiles, tile, 8) f32 in
    [0, 1), in main's order, as its run draws them. A configuration's
    inputs so depend on every one before it."""
    rng = np.random.default_rng(0)
    tabs = {name: rng.random((CC, nf, 1, BRICK), dtype=np.float32)
            for name, nf in tables}

    def draws():
        for cfg in configs:
            meta = rng.integers(0, CC, cfg.n_tiles * ROW, dtype=np.int32)
            rays = rng.random((cfg.n_tiles, cfg.tile, 8), dtype=np.float32)
            yield cfg, meta, rays
    return tabs, draws()


def lab4_inputs(names: Sequence[str] = LAB4_NAMES):
    """scripts/kernel_lab2.py's tris9 (CC, 9, 1, 128), then main's inputs
    for names."""
    return _brick_inputs((("tris9", 9),), lab4_configs(names))


def lab5_inputs():
    """scripts/kernel_lab3.py's tris9, then main's inputs."""
    return _brick_inputs((("tris9", 9),), lab5_configs())


def lab6_inputs():
    """scripts/kernel_lab4.py's tris9, then main's inputs."""
    return _brick_inputs((("tris9", 9),), lab6_configs())


def lab7_inputs():
    """scripts/kernel_lab5.py's tris9, tris12 (CC, 12, 1, 128), then main's
    inputs (128 MB of meta a configuration)."""
    return _brick_inputs((("tris9", 9), ("tris12", 12)), lab7_configs())


def scene_tracer(device, scene: str = SCENE):
    """The port's flat tracer of `scene` as scripts/kernel_lab9.py builds
    its own (build_cluster_tracer over the scene's triangles, the default
    grouping, no opacity)."""
    from ..io.gltf import load_scene
    from ..ops.cluster import build_cluster_tracer
    from ..scene.arrays import SceneArrays
    from ..scene.scene import Scene
    arrays = SceneArrays(load_scene(scene, Scene()))
    return build_cluster_tracer(arrays.tri_pos, arrays.tri_instance,
                                device=device)[0]


def bound(flops: float, nbytes: float, peak: float = PEAK_FP32):
    """(least ms the card could take, what sets it): the larger of the
    operations at `peak` and the bytes at HBM3's rate."""
    f_ms = flops / peak * 1e3
    b_ms = nbytes / PEAK_BYTES * 1e3
    return (f_ms, "operations") if f_ms >= b_ms else (b_ms, "bytes")


def time_cuda(fn: Callable[[], object], reps: int = 5) -> Dict[str, float]:
    """fn's median, min and max ms over reps calls after one warm-up call,
    each call between two CUDA events (the window holds the call's host
    path too)."""
    fn()
    ms = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ms.append(a.elapsed_time(b))
    return {"ms": statistics.median(ms), "min_ms": min(ms), "max_ms": max(ms)}


def time_back_to_back(fn: Callable[[], object], reps: int = 5,
                      n: int = 20) -> Dict[str, float]:
    """fn's ms a call enqueued back to back: one pair of CUDA events around
    n calls, the time over n, after one warm-up call; the median, min and
    max over reps such windows. Where fn's kernel runs longer than its
    host path, the launches queue on the card and the host path stays out
    of the reading, which time_cuda's single call holds; where it runs
    shorter, the card waits on the host and the reading is the host
    path's rate."""
    fn()
    ms = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        ms.append(a.elapsed_time(b) / n)
    return {"ms_back_to_back": statistics.median(ms),
            "min_ms_back_to_back": min(ms), "max_ms_back_to_back": max(ms)}


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def parse_args(argv, doc: str) -> torch.device:
    """A lab entry point's device: cuda unless --device=cpu; cuda with no
    card raises."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the lab runs on a CUDA device and none is "
                           "available (pass --device=cpu for the plain "
                           "version)")
    return torch.device(args.device)


def timed_run(fn: Callable[[], torch.Tensor], device: torch.device,
              reps: int):
    """(fn's output, {ms, min_ms}): CUDA events on the card; on the CPU
    the plain version runs once and its host ms stand in (printed as
    such by the entry points)."""
    if device.type == "cuda":
        t = time_cuda(fn, reps)
        out = fn()
        torch.cuda.synchronize()
        return out, t
    t0 = time.perf_counter()
    out = fn()
    ms = (time.perf_counter() - t0) * 1e3
    return out, {"ms": ms, "min_ms": ms, "max_ms": ms}


# ---------------------------------------------------------------------------
# The tie-aware hold of the labs whose kernels take FMA bodies (L7, L9)
# ---------------------------------------------------------------------------

# FP32's unit roundoff, and gamma_k = k u / (1 - k u), the bound on the
# relative error of k roundings in a row (Higham, Accuracy and Stability
# of Numerical Algorithms, sec. 3.1)
U32 = 2.0 ** -24
# the share of the rays that may take the hold's FP64 rule for a verdict
# that rounding decides (as kernel_lab11's and mxu_lab's)
ILL_SHARE = 1e-4


def _gamma(k: int) -> float:
    return k * U32 / (1 - k * U32)


def _quotient_bound(num, e_num, den, e_den, q):
    """The bound on |fl(num' * fl(1 / den')) - q| for q = num / den, when
    |num' - num| <= e_num and |den' - den| <= e_den: (e_num + |q| e_den) /
    (|den| - e_den) before the reciprocal's and the product's roundings,
    (1 + gamma_2) that + gamma_2 |q| after them; inf where den's sign is
    not certain."""
    a = (e_num + q.abs() * e_den) / (den.abs() - e_den)
    b = (1 + _gamma(2)) * a + _gamma(2) * q.abs()
    return torch.where(den.abs() > e_den, b, float("inf"))


def _verdict(u, e_u, v, e_v, t, b_t, tmin, nonzero):
    """(FP64's hit, margin): the hit test u >= 0, v >= 0, u + v <= 1, t >=
    t_min, and the smallest |value| / its bound over u, v, 1 - u - v and t
    - t_min: at most 1 where an FP32 body's rounding can turn the verdict."""
    e_uv = e_u + e_v + U32 * (u + v).abs()
    hit = nonzero & (u >= 0) & (v >= 0) & (u + v <= 1) & (t >= tmin)
    ratios = torch.stack([u.abs() / e_u, v.abs() / e_v,
                          (1 - u - v).abs() / e_uv, (t - tmin).abs() / b_t])
    margin = torch.nan_to_num(ratios, nan=0.0).min(0).values
    return hit, torch.where(nonzero, margin, 0.0)


def bw_fp64(rows, o, d, tmin) -> dict:
    """The Baldwin-Weber test of each ray against one triangle each, in
    FP64: rows (m, 12) [n | n.v0 | r1 | r1.v0 | r2 | r2.v0], o and d (m,
    3), tmin (m,). Returns t, FP64's verdict (hit), b_t, the bound on
    |t_fp32 - t| that holds for the unfused body (trace_kernel._bw_test)
    and for the FMA body (csrc/lab_common.cuh bw_hit_fma) alike, and
    margin (_verdict).

    b_t: den = n.d has 3 roundings in either body (3 products and 2 sums,
    or a product and 2 FMAs), num = n.v0 - n.o at most 4, so |den' - den|
    <= gamma_3 sum |n_i d_i| and |num' - num| <= gamma_4 (|n.v0| + sum |n_i
    o_i|); then _quotient_bound. For a well-conditioned test (no
    cancellation in num or den) b_t is about 9 u |t|, so two bodies' t
    differ by at most about 18 u |t|: 9-18 ulps; it grows with the
    condition. u and v: p = o + t d (2 roundings, or 1 FMA) is off by
    gamma_2 (|o_i| + |t d_i|) + |d_i| b_t, u = r1.p - r1.v0 (4 roundings)
    by gamma_4 (sum |r1_i p_i| + |r1.v0|) + sum |r1_i| |p_i' - p_i|."""
    w, o, d, tmin = rows.double(), o.double(), d.double(), tmin.double()
    n = w[:, 0:3]
    den = (n * d).sum(1)
    num = w[:, 3] - (n * o).sum(1)
    t = num / den
    e_den = _gamma(3) * (n * d).abs().sum(1)
    e_num = _gamma(4) * (w[:, 3].abs() + (n * o).abs().sum(1))
    b_t = _quotient_bound(num, e_num, den, e_den, t)
    p = o + t[:, None] * d
    e_p = _gamma(2) * (o.abs() + (t[:, None] * d).abs()) + \
        d.abs() * b_t[:, None]

    def edge(r):
        val = (r[:, 0:3] * p).sum(1) - r[:, 3]
        err = _gamma(4) * ((r[:, 0:3] * p).abs().sum(1) + r[:, 3].abs()) + \
            (r[:, 0:3].abs() * e_p).sum(1)
        return val, err
    u, e_u = edge(w[:, 4:8])
    v, e_v = edge(w[:, 8:12])
    hit, margin = _verdict(u, e_u, v, e_v, t, b_t, tmin, den != 0)
    return dict(t=t, hit=hit, b_t=b_t, margin=margin)


def _abs_cross(a, b):
    """|a_y b_z| + |a_z b_y| and its like: what a x b's rounding scales
    with."""
    return (a[:, [1, 2, 0]] * b[:, [2, 0, 1]]).abs() + \
        (a[:, [2, 0, 1]] * b[:, [1, 2, 0]]).abs()


def mt_fp64(rows, o, d, tmin) -> dict:
    """The Möller-Trumbore test of each ray against one triangle each, in
    FP64: rows (m, 9) [v0 | e1 | e2], o, d (m, 3), tmin (m,). Returns t,
    hit, b_t (the bound on |t_fp32 - t| of the unfused body,
    trace_kernel._mt_test, and of the FMA body, lab_common.cuh mt_hit_fma,
    alike) and margin, as bw_fp64.

    Each component of h = d x e2 has 2 roundings (gamma_2 |d| x |e2|), of
    s = o - v0 one, of q = s x e1 3 with s's (gamma_3 |s| x |e1|); a = e1.h,
    u_n = s.h, v_n = d.q and t_n = e2.q each add 3 to the errors of their
    factors; u, v and t are u_n, v_n, t_n times the reciprocal of a
    (_quotient_bound)."""
    w, o, d, tmin = rows.double(), o.double(), d.double(), tmin.double()
    v0, e1, e2 = w[:, 0:3], w[:, 3:6], w[:, 6:9]
    g3 = _gamma(3)
    h = torch.cross(d, e2, dim=1)
    e_h = _gamma(2) * _abs_cross(d, e2)
    s = o - v0
    e_s = U32 * s.abs()
    q = torch.cross(s, e1, dim=1)
    e_q = g3 * _abs_cross(s, e1)

    def dot(x, e_x, y, e_y):
        val = (x * y).sum(1)
        err = g3 * (x * y).abs().sum(1) + (1 + g3) * (
            x.abs() * e_y + y.abs() * e_x + e_x * e_y).sum(1)
        return val, err
    zero = torch.zeros_like(d)
    a, e_a = dot(e1, zero, h, e_h)
    u_n, e_un = dot(s, e_s, h, e_h)
    v_n, e_vn = dot(d, zero, q, e_q)
    t_n, e_tn = dot(e2, zero, q, e_q)
    u, v, t = u_n / a, v_n / a, t_n / a
    b_u = _quotient_bound(u_n, e_un, a, e_a, u)
    b_v = _quotient_bound(v_n, e_vn, a, e_a, v)
    b_t = _quotient_bound(t_n, e_tn, a, e_a, t)
    hit, margin = _verdict(u, b_u, v, b_v, t, b_t, tmin, a != 0)
    return dict(t=t, hit=hit, b_t=b_t, margin=margin)


def _fma(a, b, c):
    """fl32(a b + c) by way of FP64: the product is exact there, the sum
    rounds once to 53 bits, then to 24 (in rare ties this double rounding
    can differ from the card's single one by an ulp)."""
    return (a.double() * b.double() + c.double()).float()


def bw_test_fma(rows, ox, oy, oz, dx, dy, dz):
    """csrc/lab_common.cuh bw_hit_fma's arithmetic on the CPU, in its
    order (trace_kernel._bw_test's signature): (den, t, u, v)."""
    nx, ny, nz, nd, r1x, r1y, r1z, r1d, r2x, r2y, r2z, r2d = rows
    den = _fma(nz, dz, _fma(ny, dy, nx * dx))
    num = _fma(-nz, oz, _fma(-ny, oy, _fma(-nx, ox, nd)))
    tt = num * (1.0 / den.double()).float()
    px, py, pz = _fma(tt, dx, ox), _fma(tt, dy, oy), _fma(tt, dz, oz)
    uu = _fma(r1z, pz, _fma(r1y, py, _fma(r1x, px, -r1d)))
    vv = _fma(r2z, pz, _fma(r2y, py, _fma(r2x, px, -r2d)))
    return den, tt, uu, vv


def mt_test_fma(rows, ox, oy, oz, dx, dy, dz):
    """csrc/lab_common.cuh mt_hit_fma's arithmetic on the CPU, in its
    order (trace_kernel._mt_test's signature): (a, t, u, v)."""
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = rows
    hx = _fma(dy, e2z, -(dz * e2y))
    hy = _fma(dz, e2x, -(dx * e2z))
    hz = _fma(dx, e2y, -(dy * e2x))
    a = _fma(e1z, hz, _fma(e1y, hy, e1x * hx))
    f = (1.0 / a.double()).float()
    sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
    uu = f * _fma(sz, hz, _fma(sy, hy, sx * hx))
    qx = _fma(sy, e1z, -(sz * e1y))
    qy = _fma(sz, e1x, -(sx * e1z))
    qz = _fma(sx, e1y, -(sy * e1x))
    vv = f * _fma(dz, qz, _fma(dy, qy, dx * qx))
    tt = f * _fma(e2z, qz, _fma(e2y, qy, e2x * qx))
    return a, tt, uu, vv


def tie_aware_hold(t_k, id_k, t_p, id_p, t_start, analyse,
                   ill_share: float = ILL_SHARE) -> dict:
    """The hold of a lab kernel whose test is an FMA body against its
    unfused plain version, ray by ray (flat (n,) tensors: t f32, the
    winning triangle's id (-1: none), t_start the t a ray keeps on a miss).
    analyse(rays (m,), ids (m,)) gives each ray's test against the
    triangle an id names in FP64 (bw_fp64, mt_fp64: t, hit, b_t, margin).
      * Ids equal: t equal, or, with a hit, |t_k - t_p| <= 2 b_t, the sum
        of the two bodies' bounds;
      * ids differ at an FP64 tie: both winners pass FP64's test or come
        within rounding of it (margin <= 1), each side's t lies within
        b_t of its winner's FP64 t, and the two FP64 t within the sum of
        their b_t: rounding, not the walk, picked the winner;
      * on at most ill_share of the rays, a turned verdict: a winner of
        either side whose test rounding decides (margin <= 1), the
        kernel's t within b_t of its winner's FP64 t, or, where the
        kernel hit nothing, its t_start.
    Returns the rays, the ids that differ, the ties, the turned rays
    (ill_conditioned, each in `held` with its margin and whose winner it
    is), the largest |t_k - t_p| and |t_k - t_p| / (2 b_t) over the rays
    with equal ids (max_abs_t, max_t_over_bound), the rays that break every
    rule (rays_off) and ok."""
    n = t_k.numel()
    same_bits = t_k.view(torch.int32) == t_p.view(torch.int32)
    same_id = id_k == id_p
    off = torch.zeros(n, dtype=torch.bool, device=t_k.device)
    diff_t = torch.where(same_id, (t_k - t_p).abs(), 0.0)
    worst = 0.0
    # ids equal, t not bit-equal
    sel = torch.nonzero(same_id & ~same_bits).squeeze(1)
    if sel.numel():
        hit = id_k[sel] >= 0
        f = analyse(sel, id_k[sel].clamp(min=0))
        d = (t_k[sel] - t_p[sel]).double().abs()
        ok = hit & (d <= 2 * f["b_t"])
        off[sel] = ~ok
        ratio = torch.where(hit, d / (2 * f["b_t"]), float("inf"))
        worst = float(torch.nan_to_num(ratio, nan=float("inf")).max())
    held, tie = [], torch.zeros_like(off)
    turn = torch.zeros_like(off)
    sel = torch.nonzero(~same_id).squeeze(1)
    if sel.numel():
        ik, ip = id_k[sel], id_p[sel]
        tk, tp = t_k[sel].double(), t_p[sel].double()
        fk = analyse(sel, ik.clamp(min=0))
        fp = analyse(sel, ip.clamp(min=0))

        def legit(f, ids, t):
            return (ids >= 0) & (f["hit"] | (f["margin"] <= 1)) & \
                ((t - f["t"]).abs() <= f["b_t"])
        lk, lp = legit(fk, ik, tk), legit(fp, ip, tp)
        is_tie = lk & lp & ((fk["t"] - fp["t"]).abs() <=
                            fk["b_t"] + fp["b_t"])
        turn_k = (ik >= 0) & (fk["margin"] <= 1)
        turn_p = (ip >= 0) & (fp["margin"] <= 1)
        kernel_ok = lk | ((ik < 0) & (t_k[sel].view(torch.int32) ==
                                      t_start[sel].view(torch.int32)))
        is_turn = ~is_tie & (turn_k | turn_p) & kernel_ok
        tie[sel], turn[sel] = is_tie, is_turn
        off[sel] = ~(is_tie | is_turn)
        for i in torch.nonzero(is_turn).reshape(-1).tolist():
            k = bool(turn_k[i])
            f, ids = (fk, ik) if k else (fp, ip)
            held.append(dict(ray=int(sel[i]), id_k=int(ik[i]),
                             id_p=int(ip[i]),
                             turned="kernel's" if k else "plain's",
                             margin=float(f["margin"][i]),
                             fp64_hit=bool(f["hit"][i]),
                             t_k=float(t_k[sel[i]]), t_p=float(t_p[sel[i]]),
                             t64=float(f["t"][i]), b_t=float(f["b_t"][i])))
    n_turn = int(turn.sum())
    return dict(rays=n, ids_differ=int((~same_id).sum()),
                ties=int(tie.sum()), ill_conditioned=n_turn, held=held,
                t_bits_differ=int((same_id & ~same_bits).sum()),
                max_abs_t=float(diff_t.max()) if n else 0.0,
                max_t_over_bound=worst, rays_off=int(off.sum()),
                ok=not bool(off.any()) and n_turn <= ill_share * n)


def steps_hold(res: dict, steps, t_k, id_k, t_p, id_p, tile_rays: int,
               bound, analyse) -> dict:
    """tie_aware_hold's result res, extended by the steps each side's walk
    needed per tile (steps: the kernel's and the plain version's, (n_tiles,)
    each, as walked_steps gives them) where an exit may stop a tile. A tile
    whose two differ is held only where rounding may have decided it: where
    the hold's ids differ on one of its rays (a tie or a turned verdict), or
    where a ray's t on the side that stopped first lies within 2 b_t of the
    exit's bound after those s steps (bound(tile, s), a float). t and ids
    are tie_aware_hold's flat (n,) inputs, tiles of tile_rays rays; analyse
    as it takes it. Adds steps_differ and steps_off (the tiles so held and
    not)."""
    s_k, s_p = (torch.as_tensor(x, device=t_k.device).long()
                for x in steps)
    differ = torch.nonzero(s_k != s_p).squeeze(1)
    explained = (id_k != id_p).reshape(-1, tile_rays).any(1)
    off = 0
    for tile in differ.tolist():
        if explained[tile]:
            continue
        s = int(min(s_k[tile], s_p[tile]))
        t, ids = (t_k, id_k) if s_k[tile] < s_p[tile] else (t_p, id_p)
        rays_t = torch.arange(tile * tile_rays, (tile + 1) * tile_rays,
                              device=t_k.device)
        hit = rays_t[ids[rays_t] >= 0]
        near = False
        if s > 0 and hit.numel():
            f = analyse(hit, ids[hit])
            near = bool(((t[hit].double() - bound(tile, s)).abs() <=
                         2 * f["b_t"]).any())
        off += not near
    res.update(steps_differ=int(differ.numel()), steps_off=off,
               ok=res["ok"] and off == 0)
    return res
