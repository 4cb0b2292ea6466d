"""L9, the counterpart of scripts/kernel_lab9.py: one Baldwin-Weber step of 8
clusters (K1's step) bisected, at uniform counts of 8, 16 and 32 (1, 2 and
4 steps a tile) over 2^20 random rays. The orders of a tile's slot k are
min(heads[tile, min(k, 127)] & 1023, C - 1), as in the script. Modes:

  full   the step: the 8 clusters' 1,024 triangles tested against the best
         from before the step, the first smallest hit taken;
  exit   full, and the tile stops once every ray's best t bits are <= the
         next step's first key & ~1023;
  loads  the 8 clusters' rows summed per triangle (0 + row 0 + ... + row
         11) and the smallest sum folded into t: the loads without the
         test (ids stay -1);
  math   full over cluster 0's rows for every order (staged once, no copy
         in the loop; ids still name the orders);
  nocat  the 8 clusters one at a time with a running best (the same t and
         ids as full, by another instruction stream).

The script reads a captured table from a file outside the repo; this lab
takes the port's own tracer of proc://sponza?tris=262144 (C = 2,116,
13.0 MB of rows), t_min 0, t_max 1e30 and heads uniform in [0, C).

The plain version (lab9_reference) takes the unfused Baldwin-Weber test.
The card's kernel (csrc/k1_lab.cu lab9_kernel) takes its FMA body, so
every mode with a test is held to the plain version by lab9_agreement
(common.tie_aware_hold: t within the two bodies' rounding bound, ids equal
or at an FP64 tie, or on at most 1e-4 of the rays a verdict that rounding
decides); loads, which has no test, stays bit for bit.

    python -m tauray_torch.lab.kernel_lab9 [--device=cpu]

prints one line per mode with, per count, ms (CUDA events) and us per
tile and the hits, as the script does, then the bounds."""

from __future__ import annotations

import sys

import torch

from ..ops.trace_kernel import _bw_test, _check
from .common import (BIG, CLUSTER, FLOPS_BW, KBV, KC, TILE, bound, bw_fp64,
                     card, lab9_inputs, parse_args, scene_tracer,
                     tie_aware_hold, timed_run)
from .lab_kernel import MODES, check_tiles, launch, on_card

COUNTS = (8, 16, 32)
# tiles per batched block of the plain version: (tiles, 32, 1024) f32
# temporaries of 32 MB each
_REF_TILES = 256


def lab9(counts: torch.Tensor, heads: torch.Tensor, o3: torch.Tensor,
         d3: torch.Tensor, mm2: torch.Tensor, tris12: torch.Tensor,
         mode: str) -> torch.Tensor:
    """One mode of the step bisection. counts (n_tiles,) i32; heads
    (n_tiles, 128) i32; o3, d3 (n_tiles, 32, 3), mm2 (n_tiles, 32, 2) f32
    [t_min | t_max]; tris12 (C, 12, 1, 128) f32. Returns (n_tiles, 32, 2)
    f32: the best t (min(t_max, 3e38) on a miss), then the id's int32
    bits (-1 on a miss)."""
    if not on_card(o3):
        return lab9_reference(counts, heads, o3, d3, mm2, tris12, mode)
    check_tiles(counts, o3, 3, "lab9", group=False)
    n_tiles = counts.shape[0]
    dev = o3.device
    _check(heads, "heads", torch.int32, 2, dev)
    _check(d3, "d3", torch.float32, 3, dev)
    _check(mm2, "mm2", torch.float32, 3, dev)
    _check(tris12, "tris12", torch.float32, 4, dev)
    if (tuple(heads.shape) != (n_tiles, KC) or d3.shape != o3.shape or
            tuple(mm2.shape) != (n_tiles, TILE, 2) or
            tuple(tris12.shape[1:]) != (12, 1, CLUSTER) or
            tris12.shape[0] < 1):
        raise ValueError("lab9: inconsistent shapes")
    return launch("lab9", mode, counts, heads, o3, d3, mm2, tris12)


def _hit(rows, o, d, tmin, bt):
    """The Baldwin-Weber test of rays (n, 32, 1) against rows (n, 1, L):
    (hit closer than bt, t)."""
    den, tt, uu, vv = _bw_test(rows, *(o[..., k, None] for k in range(3)),
                               *(d[..., k, None] for k in range(3)))
    hit = (den != 0) & (uu >= 0) & (vv >= 0) & (uu + vv <= 1) & \
        (tt >= tmin[..., None]) & (tt < bt[..., None])
    return hit, tt


def lab9_reference(counts, heads, o3, d3, mm2, tris12, mode: str,
                   stats=None) -> torch.Tensor:
    """Plain torch version of lab9 (kernel_lab9.py:76-160): every tile
    still walking takes step s as one batched block. `stats` (a dict),
    when given, receives the steps walked."""
    if mode not in MODES["lab9"]:
        raise ValueError(f"lab9: no mode {mode}")
    dev = o3.device
    n_tiles = counts.shape[0]
    C = tris12.shape[0]
    rows = tris12.reshape(C, 12, CLUSTER)
    bt = torch.where(mm2[..., 1] > BIG, BIG, mm2[..., 1])
    bi = torch.full((n_tiles, TILE), -1, dtype=torch.int32, device=dev)
    steps = (counts.long() + KBV - 1) // KBV
    walking = steps > 0
    walked = 0
    for s in range(int(steps.max()) if n_tiles else 0):
        active = torch.nonzero(walking & (steps > s)).squeeze(1)
        walked += active.numel()
        slots = (s * KBV + torch.arange(KBV, device=dev)).clamp(max=KC - 1)
        for sel in active.split(_REF_TILES):
            n = sel.numel()
            orders = (heads[sel][:, slots] & 1023).clamp(max=C - 1).long()
            o, d, tmin = o3[sel], d3[sel], mm2[sel][..., 0]
            bt_s = bt[sel]
            if mode == "loads":
                tri = rows[orders]                       # (n, 8, 12, 128)
                acc = 0 + tri[:, :, 0]
                for i in range(1, 12):
                    acc = acc + tri[:, :, i]
                bt[sel] = torch.minimum(bt_s, acc.reshape(n, -1).min(
                    dim=1).values[:, None])
                continue
            if mode == "nocat":
                bi_s = bi[sel]
                for j in range(KBV):
                    tri = rows[orders[:, j]][:, None]    # (n, 1, 12, 128)
                    hit, tt = _hit([tri[:, :, i] for i in range(12)], o, d,
                                   tmin, bt_s)
                    cand, arg = torch.where(hit, tt, BIG).min(dim=2)
                    closer = cand < bt_s
                    bt_s = torch.where(closer, cand, bt_s)
                    bi_s = torch.where(
                        closer, (orders[:, j, None] * CLUSTER + arg).int(),
                        bi_s)
                bt[sel], bi[sel] = bt_s, bi_s
                continue
            src = orders if mode != "math" else torch.zeros_like(orders)
            tri = rows[src].permute(0, 2, 1, 3).reshape(n, 1, 12,
                                                        KBV * CLUSTER)
            hit, tt = _hit([tri[:, :, i] for i in range(12)], o, d, tmin,
                           bt_s)
            cand, arg = torch.where(hit, tt, BIG).min(dim=2)
            closer = cand < bt_s
            win = torch.gather(orders, 1, arg // CLUSTER)
            bt[sel] = torch.where(closer, cand, bt_s)
            bi[sel] = torch.where(
                closer, (win * CLUSTER + arg % CLUSTER).int(), bi[sel])
            if mode == "exit":
                nk = heads[sel, min((s + 1) * KBV, KC - 1)] & ~1023
                done = (bt[sel].view(torch.int32) <= nk[:, None]).all(dim=1)
                walking[sel] = ~done
    if stats is not None:
        stats["steps"] = walked
    return torch.stack([bt, bi.view(torch.float32)], -1)


def lab9_agreement(out: torch.Tensor, ref: torch.Tensor, o3, d3, mm2,
                   tris12, mode: str) -> dict:
    """The tie-aware hold of mode's kernel output against its plain
    version (both (n_tiles, 32, 2)) on their inputs: common.tie_aware_hold,
    each ray's winner analysed in FP64 by common.bw_fp64 (math: the rows of
    cluster 0 at the id's lane, which math tests for every order)."""
    if mode == "loads":
        raise ValueError("lab9 loads has no test: it is held bit for bit")
    C = tris12.shape[0]
    rows = tris12.reshape(C, 12, CLUSTER)
    o, d, mm = o3.reshape(-1, 3), d3.reshape(-1, 3), mm2.reshape(-1, 2)

    def analyse(rays, ids):
        c = torch.zeros_like(ids) if mode == "math" else ids // CLUSTER
        return bw_fp64(rows[c.long(), :, (ids % CLUSTER).long()], o[rays],
                       d[rays], mm[rays, 0])

    def flat(x):
        return (x[..., 0].reshape(-1),
                x[..., 1].contiguous().view(torch.int32).reshape(-1))
    t_start = torch.where(mm[:, 1] > BIG, BIG, mm[:, 1])
    return tie_aware_hold(*flat(out), *flat(ref), t_start, analyse)


def lab9_bound(n_tiles: int, mode: str, count: int, n_clusters: int):
    """(ms, what sets it): every step of every tile (exit's walk may end
    sooner: lab9_exits says whether it could have), 32 FP32 operations a
    test (loads: 12 additions a triangle and step, once per tile), the
    rays, keys, counts and output once, and the rows of the clusters the
    orders can name (math: cluster 0's only)."""
    R = n_tiles * TILE
    steps = (count + KBV - 1) // KBV
    if mode == "loads":
        flops = n_tiles * steps * KBV * CLUSTER * 12
    else:
        flops = R * steps * KBV * CLUSTER * FLOPS_BW
    # orders are key & 1023: at most 1,024 distinct clusters
    table = 12 * CLUSTER * 4 * (1 if mode == "math" else
                                min(n_clusters, 1024))
    keys = 4 * n_tiles * (steps * KBV + (mode == "exit"))
    return bound(flops, 40 * R + 4 * n_tiles + keys + table)


def lab9_exits(out: torch.Tensor, n_clusters: int) -> int:
    """Tiles of an exit run whose walk could have ended early: those where
    every ray's final t bits are <= the largest key & ~1023 (bt only
    falls, so a tile with one ray above it walked every step)."""
    top = (n_clusters - 1) & ~1023
    return int((out[..., 0].view(torch.int32) <= top).all(dim=1).sum())


def run(device, reps: int = 5, seed: int = 0, tracer=None):
    """Every mode at every count over 2^20 rays: (inputs, [one dict per
    mode and count: mode, count, ms, min_ms, us_per_tile, gtests_s (the
    tests the step computes, or would, a second), hits, bound_ms,
    bound_by, out])."""
    if tracer is None:
        tracer = scene_tracer(device)
    C = tracer.n_clusters
    o3, d3, mm2, heads = (torch.from_numpy(x).to(device)
                          for x in lab9_inputs(C, seed=seed))
    n_tiles = o3.shape[0]
    res = []
    for mode in MODES["lab9"]:
        for count in COUNTS:
            counts = torch.full((n_tiles,), count, dtype=torch.int32,
                                device=device)
            out, t = timed_run(lambda: lab9(counts, heads, o3, d3, mm2,
                                            tracer.tris12, mode), device,
                               reps)
            b_ms, b_by = lab9_bound(n_tiles, mode, count, C)
            tests = n_tiles * TILE * -(-count // KBV) * KBV * CLUSTER
            res.append(dict(mode=mode, count=count, **t,
                            us_per_tile=t["ms"] * 1e3 / n_tiles,
                            gtests_s=tests / (t["ms"] * 1e6),
                            hits=int((out[..., 1].view(torch.int32) >= 0)
                                     .sum()), bound_ms=b_ms, bound_by=b_by,
                            out=out, counts=counts))
    return dict(o3=o3, d3=d3, mm2=mm2, heads=heads,
                tris12=tracer.tris12, n_clusters=C), res


def main(argv=None) -> int:
    dev = parse_args(sys.argv[1:] if argv is None else argv, __doc__)
    unit = "ms" if dev.type == "cuda" else "host ms (cpu plain)"
    if dev.type == "cuda":
        print(card(), flush=True)
    _, res = run(dev)
    for mode in MODES["lab9"]:
        line = f"{mode:6s}:"
        for r in (r for r in res if r["mode"] == mode):
            line += (f"  s{r['count'] // 8}: {r['ms']:6.2f}{unit} "
                     f"({r['us_per_tile']:4.3f}us/t h={r['hits']}; "
                     f"{r['gtests_s']:.0f} Gtests/s; bound "
                     f"{r['bound_ms']:.3f} {r['bound_by']})")
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
