"""L8, the counterpart of scripts/kernel_lab8.py: a traversal tile's fixed
cost with no triangle work, taken apart by four micro-kernels that add one
component at a time:

  0  writes only: out = (1, 2);
  1  + the ray loads: out = (ox + oy + oz + dx + dy + dz + tmin, tmax);
  2  + the copy of the group's (32, 128) key heads into shared memory
     (cp.async; the TPU double-buffers it by DMA); the output is mode 1's;
  3  + a loop of ceil(count / 8) steps, each adding the head
     heads[tile, min(step, 127)] as a float to a second sum, which is added
     to out[..., 0].

    python -m tauray_torch.lab.kernel_lab8 [--device=cpu]

prints one line per mode and count (0, and for mode 3 also 8 and 16): ms
(CUDA events around one call, the median of 5 after a warm-up) and us per
tile, as the script does, with the bound; on the card also the ms a call
back to back (20 calls a window) and by CUDA-graph replay (20 calls
captured in one graph: the host path left out). On the CPU the plain
version runs and its host ms are printed as such.

On the card (csrc/k1_lab.cu lab8_kernel) a warp takes a tile, 8 tiles a
block: its lanes copy the tile's rows (the heads first, then o3, d3 and
mm2) into shared memory as 16-byte cp.async copies and wait once; the sums
keep the script's order, so the card's output equals the plain version's
bit for bit."""

from __future__ import annotations

import sys

import torch

from ..ops.trace_kernel import _check
from .common import (KC, TILE, bound, card, lab8_inputs, parse_args,
                     time_back_to_back, time_graph, timed_run)
from .lab_kernel import check_tiles, launch, on_card

NAMES = {0: "write-only", 1: "+ray loads", 2: "+head DMA",
         3: "+while(count/8) smem reads"}


def lab8(counts: torch.Tensor, heads: torch.Tensor, o3: torch.Tensor,
         d3: torch.Tensor, mm2: torch.Tensor, mode: int) -> torch.Tensor:
    """Mode 0-3 of the fixed-cost kernel. counts (n_tiles,) i32 with
    n_tiles a multiple of 32; heads (n_tiles, 128) i32; o3, d3 (n_tiles,
    32, 3) and mm2 (n_tiles, 32, 2) f32. Returns (n_tiles, 32, 2) f32."""
    if not on_card(o3):
        return lab8_reference(counts, heads, o3, d3, mm2, mode)
    check_tiles(counts, o3, 3, "lab8")
    n_tiles = counts.shape[0]
    _check(heads, "heads", torch.int32, 2, o3.device)
    _check(d3, "d3", torch.float32, 3, o3.device)
    _check(mm2, "mm2", torch.float32, 3, o3.device)
    if (tuple(heads.shape) != (n_tiles, KC) or d3.shape != o3.shape or
            tuple(mm2.shape) != (n_tiles, TILE, 2)):
        raise ValueError("lab8: inconsistent shapes")
    return launch("lab8", mode, counts, heads, o3, d3, mm2)


def lab8_reference(counts, heads, o3, d3, mm2, mode: int) -> torch.Tensor:
    """Plain torch version of lab8, in the script's order of operations
    (kernel_lab8.py:49-80)."""
    if mode not in NAMES:
        raise ValueError(f"lab8: no mode {mode}")
    if mode == 0:
        return torch.stack([torch.ones_like(mm2[..., 0]),
                            torch.full_like(mm2[..., 0], 2.0)], -1)
    acc = (o3[..., 0] + o3[..., 1] + o3[..., 2] + d3[..., 0] + d3[..., 1] +
           d3[..., 2] + mm2[..., 0])
    if mode == 3:
        steps = (counts.long() + 7) // 8
        acc2 = torch.zeros_like(acc)
        for s in range(int(steps.max()) if steps.numel() else 0):
            k = heads[:, min(s, KC - 1)].float()[:, None]
            acc2 = torch.where((steps > s)[:, None], acc2 + k, acc2)
        acc = acc + acc2
    return torch.stack([acc, mm2[..., 1]], -1)


def lab8_bound(n_tiles: int, mode: int, count: int):
    """(ms, what sets it): the bytes the mode's function moves (each input
    read once, the output written once) or its operations."""
    R = n_tiles * TILE
    nbytes = 8 * R                                  # the output
    flops = 0
    if mode >= 1:
        nbytes += 32 * R                            # o3, d3, mm2
        flops += 6 * R
    if mode >= 2:
        nbytes += 4 * KC * n_tiles                  # the heads
    if mode == 3:
        nbytes += 4 * n_tiles                       # the counts
        flops += (1 + (count + 7) // 8) * R
    return bound(flops, nbytes)


def run(device, n_rays: int = 1 << 20, reps: int = 5, seed: int = 0):
    """Every mode at the script's sizes: (inputs, [one dict per mode and
    count: mode, count, ms, min_ms, max_ms, ms_back_to_back and ms_graph
    (None on the CPU) with their min and max, us_per_tile, bound_ms,
    bound_by, out, counts])."""
    o3, d3, mm2, heads = (torch.from_numpy(x).to(device)
                          for x in lab8_inputs(n_rays, seed))
    n_tiles = o3.shape[0]
    res = []
    for mode in NAMES:
        for count in ((0,) if mode < 3 else (0, 8, 16)):
            counts = torch.full((n_tiles,), count, dtype=torch.int32,
                                device=device)
            def call():
                return lab8(counts, heads, o3, d3, mm2, mode)
            out, t = timed_run(call, device, reps)
            if device.type == "cuda":
                t.update(time_back_to_back(call, reps))
                t.update(time_graph(call, reps))
            else:
                t.update(dict.fromkeys((
                    "ms_back_to_back", "min_ms_back_to_back",
                    "max_ms_back_to_back", "ms_graph", "min_ms_graph",
                    "max_ms_graph")))
            b_ms, b_by = lab8_bound(n_tiles, mode, count)
            res.append(dict(mode=mode, count=count, **t,
                            us_per_tile=t["ms"] * 1e3 / n_tiles,
                            bound_ms=b_ms, bound_by=b_by, out=out,
                            counts=counts))
    return dict(o3=o3, d3=d3, mm2=mm2, heads=heads), res


def main(argv=None) -> int:
    dev = parse_args(sys.argv[1:] if argv is None else argv, __doc__)
    unit = "ms" if dev.type == "cuda" else "host ms (cpu plain)"
    if dev.type == "cuda":
        print(card(), flush=True)
    for r in run(dev)[1]:
        card_ms = "" if r["ms_graph"] is None else (
            f"; {r['ms_back_to_back']:.4f} ms back to back, "
            f"{r['ms_graph']:.4f} ms by graph replay")
        print(f"mode{r['mode']} ({NAMES[r['mode']]}) counts={r['count']:3d}"
              f": {r['ms']:7.3f} {unit}  {r['us_per_tile']:5.3f} us/tile  "
              f"(min {r['min_ms']:.3f}; bound {r['bound_ms']:.4f} ms, "
              f"{r['bound_by']}{card_ms})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
