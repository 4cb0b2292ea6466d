"""The roofline arithmetic of the traversal kernel K1 (csrc/trace_tiles.cu
by way of ops/trace_kernel.trace_tiles_vm3): a frozen copy of
chip_smoke.py's `bound` and its peaks (commit ccf5a6c), with K1's
operations and bytes from one launch's tile counts as chip_smoke.py's
`kernel_check` counts them.

Peaks: NVIDIA's data sheet for the H100 SXM at its 700 W limit, FP32
outside the tensor cores and HBM3 bandwidth."""

from __future__ import annotations

PEAK_FP32 = 67e12           # FLOP/s
PEAK_BYTES = 3.35e12        # bytes/s
TILE = 32                   # rays a tile
CLUSTER = 128               # triangles a cluster
FLOPS_BW = 32               # FP32 operations of one Baldwin-Weber test


def bound(flops: float, nbytes: float):
    """(least ms the card could take, what sets it)."""
    f_ms = flops / PEAK_FP32 * 1e3
    b_ms = nbytes / PEAK_BYTES * 1e3
    return (f_ms, "operations") if f_ms >= b_ms else (b_ms, "bytes")


def k1_bound(tiles: int, clusters: int, visits: int):
    """bound() of one K1 launch over `tiles` tiles of 32 rays, a table of
    `clusters` clusters, and `visits` cluster visits (the sum of its
    counts): 128 x 32 tests a visit at FLOPS_BW operations each, against
    the counts and keys read (4 bytes a tile and a visit), the rays read
    (32 bytes a ray), the whole table (12 x 128 floats a cluster) and the
    answers written (8 bytes a ray)."""
    rays = tiles * TILE
    return bound(visits * CLUSTER * TILE * FLOPS_BW,
                 4 * (tiles + visits) + 32 * rays +
                 clusters * 12 * CLUSTER * 4 + 8 * rays)
