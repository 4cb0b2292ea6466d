"""L4, the counterpart of scripts/kernel_lab2.py: KB whole clusters of 128
triangles ("bricks") a step, staged per tile one step ahead, at 8, 16 or 32
rays a tile. The script names its runs k8 (TILE 8), k6 (16) and k7 (32),
with an f suffix for the deferred-division body; main runs k6, k7, k6f and
k7f, each at KB 4, 8 and 16 over 65,536 random rays, steps = max(target //
KB, 1) for targets 14, 26 and 52 tests a ray / 128 at TILE 8, 16 and 32.
Bodies (lab/brick.py states them):

  mt      Möller-Trumbore, the first smallest hit of each step;
  mtfast  deferred division and one packed (t bits & ~1023 | lane) int32
          minimum, kept as written: t < 0 for a hit with a < 0, and the
          lane's bit 10 lost at KB = 16 (ROADMAP Queue 3).

On the card a warp walks a tile (csrc/brick_lab.cu brick_walk_kernel, L5's
walk with the FMA bodies), its clusters staged one at a time into a ring
of the warp's own in shared memory; mt is held by brick.brick_agreement,
mtfast by brick.mtfast_agreement.

    python -m tauray_torch.lab.kernel_lab2 [--device=cpu]

prints the script's line per configuration (ms, us a tile, G tests/s),
then its bound, after the card's name and power limit."""

from __future__ import annotations

import sys

import torch

from .brick import brick, entry_point, run_configs, walk_reference
from .common import lab4_inputs


def lab4(meta: torch.Tensor, rays: torch.Tensor, tris9: torch.Tensor,
         mode: str, kb: int, steps: int) -> torch.Tensor:
    """L4's walk: meta (n_tiles x 1,024,) i32, rays (n_tiles, 8 | 16 | 32,
    8) f32 [o | d | t_min | t_max], tris9 (C, 9, 1, 128) f32 [v0 | e1 |
    e2]; mode mt or mtfast. Returns (n_tiles, tile, 2) f32: the best t
    (min(t_max, 3e38) on a miss), then the id's int32 bits (-1 on a
    miss)."""
    return brick("lab4", mode, meta, rays, tris9, kb, steps)


def lab4_reference(meta, rays, tris9, mode: str, kb: int, steps: int):
    """Plain torch version of lab4 (kernel_lab2.py:43-117, :120-196)."""
    return walk_reference("lab4", mode, meta, rays, tris9, kb, steps)


def run(device, reps: int = 5, tiles=None):
    """Every configuration of main, at the script's size (or its first
    `tiles` tiles): brick.run_configs' results."""
    tables, draws = lab4_inputs()
    return run_configs(device, tables, draws, reps, tiles)


def main(argv=None) -> int:
    return entry_point(sys.argv[1:] if argv is None else argv, __doc__, run,
                       34)


if __name__ == "__main__":
    sys.exit(main())
