"""L7, the counterpart of scripts/kernel_lab5.py: Möller-Trumbore over tris9
against Baldwin-Weber over tris12 (12 floats a triangle: n, n.v0, r1,
r1.v0, r2, r2.v0) in L5's loop, the table read in place. main runs mt,
then bw, each at (KB, steps) = (8, 6), (8, 4) and (4, 8) over 32,768 tiles
of 32 random rays. The cluster of slot k is min(meta entry & 1023, 635);
t starts at 3e38 (t_max is not read) and the id at 0; the id column holds
float(id), not its bits.

The plain version takes the unfused bodies; the card's kernel (csrc/
brick_lab.cu brick_walk_kernel) their FMA counterparts, so it is held to
the plain version by lab7_agreement (brick.brick_agreement).

    python -m tauray_torch.lab.kernel_lab5 [--device=cpu]

prints the script's line per configuration (ms, us a tile, G tests/s),
then its bound, after the card's name and power limit."""

from __future__ import annotations

import sys

import torch

from .brick import (brick, brick_agreement, entry_point, run_configs,
                    walk_reference)
from .common import lab7_inputs


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
    brick.brick_agreement's for lab7."""
    return brick_agreement("lab7", body, out, ref, meta, rays, tris)


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
