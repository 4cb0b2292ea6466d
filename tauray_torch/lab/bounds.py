"""The least time the card could take for each TPU lab kernel L1-L12 of the
repo (the pl.pallas_call sites of scripts/), reckoned from its script's
shapes at the largest configuration its main runs: the larger of the FP32
operations at 67 TFLOP/s (TF32 at 495 for a matrix form) and the bytes at
3.35 TB/s, each input read once. L10's bound depends on its wave's keys;
chip_smoke phase 20 reckons it from the wave. brick_bound gives L4-L7's
bound of each configuration of their scripts' mains.

    python -m tauray_torch.lab.bounds

prints one line per kernel."""

from __future__ import annotations

import sys

from .common import (CC, CLUSTER, FLOPS_BW, FLOPS_MT, PEAK_TF32,
                     BrickConfig, bound)
from .kernel_lab8 import lab8_bound
from .kernel_lab9 import lab9_bound
from .kernel_lab11 import lab11_bound

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
# TF32 operations), and an FP32 epilogue of 14 (the three-term sum, six
# sign tests, the reciprocal, t, the two range tests, the minimum), which
# can run at once: the larger of the two times
L12_MATRIX = (3 * 12 + 8, 14)


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


def rows():
    """(lab, site, configuration, ms, what sets it) of every lab kernel
    but L10."""
    out = [(lab, c[0], c[5], *lab_bound(lab)) for lab, c in CONFIGS.items()]
    _, rays, per_ray, *_ = CONFIGS["L12"]
    tests = rays * per_ray
    tf32_ms = tests * L12_MATRIX[0] / PEAK_TF32 * 1e3
    out.append(("L12 matrix", CONFIGS["L12"][0], "the Plücker products",
                *max(bound(tests * L12_MATRIX[1], 0),
                     (tf32_ms, "operations"))))
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
