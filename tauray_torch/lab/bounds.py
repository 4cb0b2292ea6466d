"""The least time the card could take for each TPU lab kernel L1-L12 of the
repo (the pl.pallas_call sites of scripts/), reckoned from its script's
shapes at the largest configuration its main runs: the larger of the FP32
operations at 67 TFLOP/s (TF32 at 495 for a matrix form) and the bytes at
3.35 TB/s, each input read once. L10's bound depends on its wave's keys;
chip_smoke phase 20 reckons it from the wave. brick_bound gives L4-L7's
bound of each configuration of their scripts' mains, tile_bound L1-L3's
and lab12_bound L12's. A matrix form's TF32 products count three times,
for the split in two that brings them near FP32 (kernel_lab11.SPLIT, which
L11 and L12 share).

    python -m tauray_torch.lab.bounds

prints one line per kernel."""

from __future__ import annotations

import sys

from .common import (CC, CLUSTER, FLOPS_BW, FLOPS_MT, KB_L1, KBV,
                     N_TILES_L12, PEAK_FP32, PEAK_TF32, R_TILE, ROW_L1,
                     STEPS_L12, TILE, TILE_L1, BrickConfig, bound)
from .kernel_lab8 import lab8_bound
from .kernel_lab9 import lab9_bound
from .kernel_lab11 import SPLIT, lab11_bound

C_LABS = CC            # clusters of the scripts' synthetic tables
# FP32 operations of one deferred-division Möller-Trumbore test
# (kernel_lab2.py mtfast_body): h, a, s, the numerators of u, v and t (41),
# the four products by a's sign, u + v, t_min |a|, best |a| and the one
# division
FLOPS_MTFAST = 49
# lab -> (site, rays, tests a ray, FP32 operations a test, floats a
# triangle, what the configuration is)
CONFIGS = {
    "L1": ("scripts/kernel_lab.py:61", 65536, 8 * 8 * CLUSTER, FLOPS_MT, 9,
           "128-ray tiles, 8 steps of 8 clusters"),
    "L2": ("scripts/kernel_lab.py:424", 65536, 8 * 8 * CLUSTER, FLOPS_MT, 9,
           "as L1, 8 tiles a grid step"),
    "L3": ("scripts/kernel_lab.py:586", 65536, 8 * 8 * CLUSTER, FLOPS_MT, 9,
           "as L1, G tiles a grid step"),
    "L4": ("scripts/kernel_lab2.py:234", 65536, 13 * 4 * CLUSTER, FLOPS_MT,
           9, "32-ray tiles, 13 steps of 4 clusters of 128"),
    "L5": ("scripts/kernel_lab3.py:172", 65536, 52 * 1 * CLUSTER, FLOPS_MT, 9,
           "32-ray tiles, 52 steps of 1 cluster"),
    "L6": ("scripts/kernel_lab4.py:199", 65536, 6 * 8 * CLUSTER, FLOPS_MT, 9,
           "32-ray tiles, 6 steps of 8 clusters"),
    "L7": ("scripts/kernel_lab5.py:159", 32768 * 32, 6 * 8 * CLUSTER,
           FLOPS_MT, 9, "32,768 tiles of 32, 6 steps of 8 clusters"),
    "L12": ("scripts/mxu_lab.py:66", 65536, 6 * 8 * CLUSTER, FLOPS_MT, 9,
            "6 steps of 8 clusters, the Möller-Trumbore body"),
}
# L12's matrix form: three products of K = 6 and one of K = 4 a test (44
# TF32 operations, each product taken SPLIT times), and an FP32 epilogue of
# 14 (the three-term sum, six sign tests, the reciprocal, t, the two range
# tests, the minimum), which can run at once: the larger of the two times
L12_TF32_OPS = 3 * 12 + 8
L12_EPILOGUE = 14


def lab_bound(lab: str, flops_per_test=None):
    """(ms, what sets it) of CONFIGS[lab]: the tests' FP32 operations, or
    flops_per_test in their place; the rays (o, d, t_min, t_max), the
    output and the table once."""
    _, rays, per_ray, flops, floats, _ = CONFIGS[lab]
    tests = rays * per_ray
    nbytes = rays * (32 + 8) + C_LABS * floats * CLUSTER * 4
    return bound(tests * (flops_per_test or flops), nbytes)


def brick_bound(cfg: BrickConfig, tile_steps=None):
    """(ms, what sets it) of one L4-L7 configuration: its tests' FP32
    operations (46 a Möller-Trumbore test, 49 deferred-division, 32
    Baldwin-Weber); the rays (o, d, t_min, t_max) and the output once, the
    meta entries the walk reads (with while / while2 the exit's too) and
    the table. tile_steps: the steps the tiles walked, where an exit ended
    walks early; every step of every tile by default."""
    if tile_steps is None:
        tile_steps = cfg.n_tiles * cfg.steps
    flops = {"mtfast": FLOPS_MTFAST, "bw": FLOPS_BW}.get(cfg.mode, FLOPS_MT)
    floats = 12 if cfg.mode == "bw" else 9
    tests = tile_steps * cfg.tile * cfg.kb * CLUSTER
    meta = tile_steps * (cfg.kb + cfg.mode.startswith("while"))
    nbytes = (cfg.n_tiles * cfg.tile * (32 + 8) + 4 * meta +
              C_LABS * floats * CLUSTER * 4)
    return bound(tests * flops, nbytes)


def tile_bound(kernel: str, steps: int, n_tiles: int = R_TILE // TILE_L1,
               tile_steps=None):
    """(ms, what sets it) of scripts/kernel_lab.py's kernel k0-k5 at steps
    steps of KB_L1 clusters a tile: t_max read and t and the id written
    (12 bytes a ray); from k1 on the tiles' meta rows (ROW_L1 int32 each);
    from k2 on, where a step is walked, the table (tris9); from k3 on the
    other seven floats of each ray and 46 FP32 operations a test. k1's and
    k2's are bounds on the copies they make, the lab's question: their
    output needs one meta entry a tile (k1) or one float a step (k2), whose
    bound is k0's, ~10x lower. tile_steps: the steps the tiles walked,
    where an exit ended walks early; every step of every tile by default."""
    if tile_steps is None:
        tile_steps = n_tiles * steps
    rays = n_tiles * TILE_L1
    nbytes = rays * 12
    flops = 0
    if kernel != "k0":
        nbytes += n_tiles * ROW_L1 * 4
    if kernel not in ("k0", "k1") and tile_steps:
        nbytes += C_LABS * 9 * CLUSTER * 4
    if kernel not in ("k0", "k1", "k2"):
        nbytes += rays * 28
        flops = tile_steps * TILE_L1 * KB_L1 * CLUSTER * FLOPS_MT
    return bound(flops, nbytes)


def staged_bytes(steps: int, n_tiles: int = R_TILE // TILE_L1) -> int:
    """The bytes k2-k5 copy into shared memory: KB_L1 clusters of 9 rows of
    128 floats a tile and step."""
    return n_tiles * steps * KB_L1 * 9 * CLUSTER * 4


def lab12_bound(mode: str, n_tiles: int = N_TILES_L12):
    """(ms, what sets it) of scripts/mxu_lab.py's mode over n_tiles tiles
    of 32 rays at its STEPS_L12 steps of 8 clusters: mt 46 FP32 operations a test;
    plucker the larger of its TF32 products (L12_TF32_OPS a test, SPLIT
    times over) and its FP32 epilogue (lab12_epilogue_ms). Bytes: o3, d3,
    mm2 and the output once, the order entries walked and the table rows
    read (9, or 22 of tris24's 24)."""
    rays = n_tiles * TILE
    tests = rays * STEPS_L12 * KBV * CLUSTER
    rows = 9 if mode == "mt" else 22
    nbytes = rays * (32 + 8) + n_tiles * STEPS_L12 * KBV * 4 + \
        C_LABS * rows * CLUSTER * 4
    if mode == "mt":
        return bound(tests * FLOPS_MT, nbytes)
    ops_ms = max(tests * L12_TF32_OPS * SPLIT / PEAK_TF32 * 1e3,
                 lab12_epilogue_ms(n_tiles))
    b_ms, b_by = bound(0, nbytes)
    return (ops_ms, "operations") if ops_ms >= b_ms else (b_ms, b_by)


def lab12_epilogue_ms(n_tiles: int = N_TILES_L12) -> float:
    """The least ms of plucker's FP32 epilogue on the CUDA cores."""
    tests = n_tiles * TILE * STEPS_L12 * KBV * CLUSTER
    return tests * L12_EPILOGUE / PEAK_FP32 * 1e3


def rows():
    """(lab, site, configuration, ms, what sets it) of every lab kernel
    but L10."""
    out = [(lab, c[0], c[5], *lab_bound(lab)) for lab, c in CONFIGS.items()]
    for k in ("k0", "k1", "k2"):
        staged = f"; {staged_bytes(8) / 1e6:.0f} MB staged" if k == "k2" \
            else ""
        out.append((f"L1 {k}", CONFIGS["L1"][0], f"8 steps{staged}",
                    *tile_bound(k, 8)))
    out.append(("L12 matrix", CONFIGS["L12"][0],
                f"the Plücker products x {SPLIT}; FP32 epilogue "
                f"{lab12_epilogue_ms():.4f} ms", *lab12_bound("plucker")))
    out.append(("L4 deferred division", CONFIGS["L4"][0], "mtfast_body",
                *lab_bound("L4", FLOPS_MTFAST)))
    out.append(("L7 Baldwin-Weber", CONFIGS["L7"][0], "its tris12 body",
                *lab_bound("L7", FLOPS_BW)))
    out.append(("L8", "scripts/kernel_lab8.py:105", "2^20 rays, mode 3, "
                "count 16", *lab8_bound(32768, 3, 16)))
    out.append(("L9", "scripts/kernel_lab9.py:189", "2^20 rays, full, "
                "4 steps, C = 2,116", *lab9_bound(32768, "full", 32, 2116)))
    for mode in ("vpu", "mxu"):
        out.append((f"L11 {mode}", "scripts/kernel_lab11.py:139",
                    "4,096 tiles x 8 steps, C = 1,024",
                    *lab11_bound(4096, 8, 1024, mode)))
    return out


def main() -> int:
    for lab, site, config, ms, by in rows():
        print(f"{lab}: {site} ({config}): {ms:.4f} ms ({by})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
