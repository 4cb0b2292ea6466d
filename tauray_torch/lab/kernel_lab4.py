"""L6, the counterpart of scripts/kernel_lab4.py: the cost of the
per-step machinery, on L5's loop (the table read in place). main runs each
variant at (TILE, KB, steps) = (32, 8, 6), (32, 16, 3) and (16, 8, 3) over
65,536 random rays:

  fixed   L5's loop;
  slot    the same (the winner kept as its order slot, step * BK + arg);
  cid     the winner's cluster id resolved: the clipped meta entry of slot
          arg // 128, times 128, plus arg % 128;
  while   the tile stops after a step once every ray's best t bits are <=
          the unclipped meta entry min((step + 1) * KB, 1023);
  while2  the same test after odd steps only.

On the script's inputs the exit never fires: a meta entry is a cluster id
(< 636), below the bits of every t in (0, 1), so while and while2 equal
fixed (ROADMAP Queue 3). On the card a warp walks a tile and the exit is
its vote (__all_sync) after the step (csrc/brick_lab.cu
brick_walk_kernel); the kernel takes the FMA body and is held to the plain
version by brick.brick_agreement.

    python -m tauray_torch.lab.kernel_lab4 [--device=cpu]

prints the script's line per configuration (ms, us a tile, G tests/s),
then its bound, after the card's name and power limit."""

from __future__ import annotations

import sys

import torch

from .brick import brick, entry_point, run_configs, walk_reference
from .common import lab6_inputs


def lab6(meta: torch.Tensor, rays: torch.Tensor, tris9: torch.Tensor,
         variant: str, kb: int, steps: int) -> torch.Tensor:
    """L6's walk in variant: as kernel_lab2.lab4 in mode mt, with cid's ids
    (cluster * 128 + lane) or while / while2's exit."""
    return brick("lab6", variant, meta, rays, tris9, kb, steps)


def lab6_reference(meta, rays, tris9, variant: str, kb: int, steps: int,
                   stats=None):
    """Plain torch version of lab6 (kernel_lab4.py:58-172); `stats` (a
    dict), when given, receives the steps the tiles walked."""
    return walk_reference("lab6", variant, meta, rays, tris9, kb, steps,
                          stats)


def run(device, reps: int = 5, tiles=None):
    """Every configuration of main, at the script's size (or its first
    `tiles` tiles): brick.run_configs' results."""
    tables, draws = lab6_inputs()
    return run_configs(device, tables, draws, reps, tiles)


def main(argv=None) -> int:
    return entry_point(sys.argv[1:] if argv is None else argv, __doc__, run,
                       0)


if __name__ == "__main__":
    sys.exit(main())
