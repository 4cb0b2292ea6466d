"""L5, the counterpart of scripts/kernel_lab3.py: L4's Möller-Trumbore step
over the triangle table read in place, with no per-step copy. main runs
TILE 8, 16 and 32 x KB 1, 2, 4 and 8 over 65,536 random rays, steps =
max(target // KB, 1) for targets 14, 26 and 52.

On the TPU the table (2.9 MB) is copied into VMEM once and indexed there;
on the card its rows are read in place through the read-only path, since
the table stays in the 50 MB L2 (csrc/brick_lab.cu brick_walk_kernel, L6
fixed's instance). Its function is L4 mt's (lab/brick.py). The plain
version takes the unfused body, the card's kernel its FMA counterpart, so
the kernel is held to the plain version by brick.brick_agreement.

    python -m tauray_torch.lab.kernel_lab3 [--device=cpu]

prints the script's line per configuration (ms, us a tile, G tests/s),
then its bound, after the card's name and power limit."""

from __future__ import annotations

import sys

import torch

from .brick import brick, entry_point, run_configs, walk_reference
from .common import lab5_inputs


def lab5(meta: torch.Tensor, rays: torch.Tensor, tris9: torch.Tensor,
         kb: int, steps: int) -> torch.Tensor:
    """L5's walk: as kernel_lab2.lab4 in mode mt, the rows read in
    place."""
    return brick("lab5", "mt", meta, rays, tris9, kb, steps)


def lab5_reference(meta, rays, tris9, kb: int, steps: int):
    """Plain torch version of lab5 (kernel_lab3.py:29-141)."""
    return walk_reference("lab5", "mt", meta, rays, tris9, kb, steps)


def run(device, reps: int = 5, tiles=None):
    """Every configuration of main, at the script's size (or its first
    `tiles` tiles): brick.run_configs' results."""
    tables, draws = lab5_inputs()
    return run_configs(device, tables, draws, reps, tiles)


def main(argv=None) -> int:
    return entry_point(sys.argv[1:] if argv is None else argv, __doc__, run,
                       28)


if __name__ == "__main__":
    sys.exit(main())
