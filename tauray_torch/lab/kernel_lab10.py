"""L10, the counterpart of scripts/kernel_lab10.py: K1's walk stripped, one
component at a time, on a real signature-sorted bounce wave, to find what
a tile costs beyond its tests. Modes:

  full     K1 (trace_kernel.trace_tiles_vm3), with the script's raw output;
  noray    the rays replaced by constants, o (0.1, 0.2, 0.3), d (0.4, 0.5,
           0.6), t_min 0, t_max 1e30 (tiles with no cluster keep their own
           t_max);
  fixord   the orders 0..7 every step instead of the keys;
  nowrite  no tile's result written: every tile keeps its pre-set best
           (min(t_max, 3e38), id -1), and tile 0 of each group of 32 takes
           the t of the group's last tile with a cluster (0 with none).

The waves are app/kernel_waves' sorted bounce waves of
proc://sponza?tris=262144 at 512x512 (2^18 rays) and 1024x1024 (2^20),
their counts and keys from the port's own phase 1 (ops/cluster._phase1),
so that full sees exactly what K1 sees in a frame. Where the script reads
only a tile's first 128 keys (its heads), this lab reads the whole key row
as K1 does; the two agree on every tile of at most 128 clusters.

    python -m tauray_torch.lab.kernel_lab10 [--device=cpu]

prints one line per wave and mode: ms (CUDA events) and us per tile, as
the script does, with the bound."""

from __future__ import annotations

import sys

import torch

from ..ops import trace_kernel
from ..ops.cluster import _phase1, key_idmask
from ..ops.trace_kernel import _check
from .common import (BIG, CLUSTER, FLOPS_BW, G, KBV, KC, TILE, bound, card,
                     parse_args, timed_run)
from .kernel_lab9 import _hit
from .lab_kernel import MODES, check_tiles, launch, on_card

SIZES = (512, 1024)     # 2^18 and 2^20 rays
# tiles per batched block of the plain version
_REF_TILES = 1024


def lab10(counts: torch.Tensor, keys: torch.Tensor, rays8: torch.Tensor,
          tris12: torch.Tensor, mode: str, idmask: int,
          warps=None) -> torch.Tensor:
    """One mode of the stripped walk. counts (n_tiles,) i32, n_tiles a
    multiple of 32; keys (n_tiles, W) i32, each row's first counts[tile]
    entries the ascending active cluster ids; rays8 (n_tiles, 32, 8) f32
    [o | d | t_min | t_max]; tris12 (C, 12, 1, 128) f32; the orders are
    min(key & idmask, C - 1). warps: the warps sharing a tile (4 or 8;
    by default K1's choice, trace_kernel.bw_warps). Returns (n_tiles, 32,
    2) f32: t (the pre-set best on a miss), then the id's int32 bits."""
    if not on_card(rays8):
        return lab10_reference(counts, keys, rays8, tris12, mode, idmask)
    n_tiles = check_tiles(counts, rays8, 8, "lab10")
    dev = rays8.device
    _check(keys, "keys", torch.int32, 2, dev)
    _check(tris12, "tris12", torch.float32, 4, dev)
    if (keys.shape[0] != n_tiles or keys.shape[1] < 1 or
            tuple(tris12.shape[1:]) != (12, 1, CLUSTER) or
            tris12.shape[0] < 1 or not 0 < idmask < 1 << 30 or
            idmask & (idmask + 1)):
        raise ValueError("lab10: inconsistent shapes or id mask")
    if warps is None:
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        warps = trace_kernel.bw_warps(n_tiles, n_sm, "trace_vm3")
    return launch("lab10", mode, counts, keys, rays8, tris=tris12,
                  idmask=idmask, warps=warps)


def lab10_reference(counts, keys, rays8, tris12, mode: str,
                    idmask: int) -> torch.Tensor:
    """Plain torch version of lab10, walking key column j for every tile
    with count > j (trace_kernel.trace_tiles_vm3_reference's order, which
    gives the script's per-step argmin: strict <, the lowest slot on a
    tie)."""
    if mode not in MODES["lab10"]:
        raise ValueError(f"lab10: no mode {mode}")
    dev = rays8.device
    n_tiles = counts.shape[0]
    C = tris12.shape[0]
    rows = tris12.reshape(C, 12, CLUSTER)
    pre = torch.where(rays8[..., 7] > BIG, BIG, rays8[..., 7])
    counts_l = counts.long()
    if mode == "noray":
        const = torch.tensor([0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.0],
                             dtype=torch.float32, device=dev)
        rays = const.expand(n_tiles, TILE, 7)
        bt = torch.where(counts_l[:, None] > 0, 1e30, pre)
    else:
        rays = rays8[..., :7]
        bt = pre.clone()
    bi = torch.full((n_tiles, TILE), -1, dtype=torch.int32, device=dev)
    for j in range(int(counts_l.max()) if n_tiles else 0):
        for sel in torch.nonzero(counts_l > j).squeeze(1).split(_REF_TILES):
            if mode == "fixord":
                c = torch.full_like(sel, j % KBV)
            else:
                c = torch.clamp(keys[sel, j] & idmask, max=C - 1).long()
            tri = rows[c][:, None]                       # (n, 1, 12, 128)
            r = rays[sel]
            bt_s = bt[sel]
            hit, tt = _hit([tri[:, :, i] for i in range(12)], r[..., 0:3],
                           r[..., 3:6], r[..., 6], bt_s)
            cand, arg = torch.where(hit, tt, BIG).min(dim=2)
            closer = cand < bt_s
            bt[sel] = torch.where(closer, cand, bt_s)
            bi[sel] = torch.where(closer, (c[:, None] * CLUSTER + arg).int(),
                                  bi[sel])
    if mode != "nowrite":
        return torch.stack([bt, bi.view(torch.float32)], -1)
    t = pre.clone()
    act = (counts_l > 0).reshape(-1, G)
    idx = torch.arange(G, device=dev).expand_as(act)
    last = torch.where(act, idx, -1).max(dim=1).values       # (groups,)
    first = torch.arange(0, n_tiles, G, device=dev)
    t[first] = torch.where((last >= 0)[:, None],
                           bt[first + last.clamp(min=0)], 0.0)
    return torch.stack([t, torch.full_like(bi, -1).view(torch.float32)], -1)


def lab10_bound(counts: torch.Tensor, mode: str, n_clusters: int):
    """(ms, what sets it): 32 FP32 operations a test over every (tile,
    key) visit; the counts, keys, rays and output once (noray: only the
    t_max of the pre-set; fixord: no keys) and the rows of the clusters
    the orders name."""
    n_tiles = counts.shape[0]
    R = n_tiles * TILE
    visits = int(counts.sum())
    flops = visits * CLUSTER * TILE * FLOPS_BW
    rays = 4 * R if mode == "noray" else 32 * R
    keys = 0 if mode == "fixord" else 4 * visits
    table = 12 * CLUSTER * 4 * (min(n_clusters, KBV) if mode == "fixord"
                                else n_clusters)
    return bound(flops, 4 * n_tiles + keys + rays + table + 8 * R)


def wave_args(tracer, rays8: torch.Tensor):
    """(counts, keys, rays8 as (n_tiles, 32, 8), idmask) of a wave: the
    port's phase 1, as K1 takes it."""
    counts, keys = _phase1(tracer, rays8)
    return (counts, keys, rays8.reshape(-1, TILE, 8).contiguous(),
            key_idmask(tracer.n_clusters))


def run(device, reps: int = 5, waves=None):
    """Every mode on each wave: waves is (tracer, {name: rays8 (R, 8)}),
    by default the sorted bounce waves of SIZES. Returns (tracer, {name:
    wave_args}, [one dict per wave and mode: wave, mode, ms, min_ms,
    us_per_tile, gtests_s, tiles_over_heads, bound_ms, bound_by,
    out])."""
    if waves is None:
        from ..app.kernel_waves import kernel_waves
        rays = {}
        for size in SIZES:
            tr, w = kernel_waves(device, size=size)
            if not rays:       # the same scene each time: keep one tracer
                tracer = tr
            rays[f"bounce_{size}"] = w["bounce"]
        waves = (tracer, rays)
    tracer, rays = waves
    args, res = {}, []
    for name, r8 in rays.items():
        a = args[name] = wave_args(tracer, r8)
        n_tiles = a[0].shape[0]
        for mode in MODES["lab10"]:
            out, t = timed_run(lambda: lab10(a[0], a[1], a[2], tracer.tris12,
                                             mode, a[3]), device, reps)
            b_ms, b_by = lab10_bound(a[0], mode, tracer.n_clusters)
            tests = int(a[0].sum()) * CLUSTER * TILE
            res.append(dict(wave=name, rays=r8.shape[0], mode=mode, **t,
                            us_per_tile=t["ms"] * 1e3 / n_tiles,
                            gtests_s=tests / (t["ms"] * 1e6),
                            tiles_over_heads=int((a[0] > KC).sum()),
                            bound_ms=b_ms, bound_by=b_by, out=out))
    return tracer, args, res


def main(argv=None) -> int:
    dev = parse_args(sys.argv[1:] if argv is None else argv, __doc__)
    unit = "ms" if dev.type == "cuda" else "host ms (cpu plain)"
    if dev.type == "cuda":
        print(card(), flush=True)
    for r in run(dev)[2]:
        print(f"{r['wave']} {r['mode']:8s}: {r['ms']:7.3f} {unit}  "
              f"({r['us_per_tile']:5.3f}us/t; {r['gtests_s']:.0f} Gtests/s;"
              f" bound {r['bound_ms']:.3f} ms,"
              f" {r['bound_by']}; {r['tiles_over_heads']} tiles over "
              f"{KC} clusters)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
