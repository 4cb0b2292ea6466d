"""L7, the counterpart of scripts/kernel_lab5.py: Möller-Trumbore over tris9
against Baldwin-Weber over tris12 (12 floats a triangle: n, n.v0, r1,
r1.v0, r2, r2.v0) in L5's loop, the table read in place. main runs mt,
then bw, each at (KB, steps) = (8, 6), (8, 4) and (4, 8) over 32,768 tiles
of 32 random rays. The cluster of slot k is min(meta entry & 1023, 635);
t starts at 3e38 (t_max is not read) and the id at 0; the id column holds
float(id), not its bits.

The plain version takes the unfused bodies; the card's kernel (csrc/
brick_lab.cu lab7_kernel) their FMA counterparts, so it is held to the
plain version by lab7_agreement (common.tie_aware_hold).

    python -m tauray_torch.lab.kernel_lab5 [--device=cpu]

prints the script's line per configuration (ms, us a tile, G tests/s),
then its bound, after the card's name and power limit."""

from __future__ import annotations

import sys

import torch

from .brick import brick, entry_point, run_configs, walk_reference
from .common import (BIG, CLUSTER, ROW, bw_fp64, lab7_inputs, mt_fp64,
                     tie_aware_hold)


def lab7(meta: torch.Tensor, rays: torch.Tensor, tris: torch.Tensor,
         body: str, kb: int, steps: int) -> torch.Tensor:
    """L7's walk: meta (n_tiles x 1,024,) i32, rays (n_tiles, 32, 8) f32,
    tris (C, 9, 1, 128) for body mt or (C, 12, 1, 128) for bw. Returns
    (n_tiles, 32, 2) f32: the best t (3e38 on a miss), then float(id) (0
    on a miss)."""
    return brick("lab7", body, meta, rays, tris, kb, steps)


def lab7_reference(meta, rays, tris, body: str, kb: int, steps: int):
    """Plain torch version of lab7 (kernel_lab5.py:30-132)."""
    return walk_reference("lab7", body, meta, rays, tris, kb, steps)


def lab7_agreement(out: torch.Tensor, ref: torch.Tensor, meta, rays, tris,
                   body: str) -> dict:
    """The tie-aware hold of body's kernel output against its plain
    version (both (n_tiles, 32, 2): t, float(id)) on their inputs:
    common.tie_aware_hold, a ray's winner, the order slot its id names,
    analysed in FP64 (common.bw_fp64 or mt_fp64). A ray that hit nothing
    keeps t = 3e38 (its id 0 is then no slot)."""
    n_tiles = rays.shape[0]
    C, nf = tris.shape[:2]
    rows = tris.reshape(C, nf, CLUSTER)
    m2 = meta.reshape(n_tiles, ROW)
    r8 = rays.reshape(-1, 8)
    test = bw_fp64 if body == "bw" else mt_fp64

    def analyse(ray, ids):
        c = (m2[ray // rays.shape[1], ids // CLUSTER] & 1023).clamp(
            max=C - 1).long()
        return test(rows[c, :, (ids % CLUSTER).long()], r8[ray, 0:3],
                    r8[ray, 3:6], r8[ray, 6])

    def flat(x):
        t = x[..., 0].reshape(-1)
        return t, torch.where(t < BIG, x[..., 1].reshape(-1).int(), -1)
    t_start = torch.full_like(r8[:, 0], BIG)
    return tie_aware_hold(*flat(out), *flat(ref), t_start, analyse)


def run(device, reps: int = 5, tiles=None):
    """Every configuration of main, at the script's size (or its first
    `tiles` tiles): brick.run_configs' results."""
    tables, draws = lab7_inputs()
    return run_configs(device, tables, draws, reps, tiles)


def main(argv=None) -> int:
    return entry_point(sys.argv[1:] if argv is None else argv, __doc__, run,
                       0)


if __name__ == "__main__":
    sys.exit(main())
