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
    """fn's median and min ms over reps calls after one warm-up call, each
    call between two CUDA events."""
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
    return {"ms": statistics.median(ms), "min_ms": min(ms)}


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
    return out, {"ms": ms, "min_ms": ms}
