"""L1-L3, the counterparts of scripts/kernel_lab.py: K2's Möller-Trumbore
tile walk at 128-ray tiles, taken apart to find a tile's fixed cost. 65,536
random rays in 512 tiles over CC = 636 random clusters (tris9); a tile's
meta row holds 3 x 1,024 int32 entries: the cluster of slot k at k,
clipped to [0, C) where it is read, and from 1,024 on the tnear bits the
exit reads. A tile of count slots walks ceil(count / 8) steps of 8
clusters (1,024 triangles); the script's counts are steps * 8 for every
tile. Modes (the script's kernels):

  k0  writes t = min(t_max, 3e38) and id -1 only;
  k1  + the tile's meta row copied in; its id is the row's first entry,
      unclipped;
  k2  + every step's 8 clusters copied in, no test; t is the FP32 sum, in
      step order, of each step's first element tris9[clip(meta[min(8s,
      1,023)]), 0, 0, 0] (k1's t where the tile walks no step), id -1;
  k3  + the Möller-Trumbore test of each ray against the step's 1,024
      triangles, from t = min(t_max, 3e38) and id -1: a step takes its
      first smallest hit (slots at or past count skipped) when strictly
      closer than the best before it; the id is the slot's cluster x 128
      + the triangle's lane in it;
  k4  (L2) k3 plus the tile's exit after each step: it stops once every
      ray's best t, as int32 bits, is <= the unclipped meta entry 1,024 +
      min(8 (s + 1), 1,023) of its row; 8 tiles a TPU grid step, rays as
      planes (n_tiles, 8, 128), out (n_tiles, 2, 128);
  k5  (L3) k4 with rays as rows (n_tiles, 128, 8), out (n_tiles, 128, 2)
      and G tiles a grid step (k5 G = 8, k5<G> any G dividing 512).

L1 takes the script's 8 ray columns stacked, (8, n_tiles * 128)
[ox, oy, oz, dx, dy, dz, t_min, t_max], and returns t (R, 1) f32 and the
id (R, 1) i32. On the script's meta the exit never fires (its entries are
cluster ids below 636, far below the bits of any t > 0), so k4 and k5
equal k3 bit for bit there; it fires where the tnear entries are set high.
On the card: csrc/tile_lab.cu, one template for k0-k5 (one block of 8
warps a tile whatever G is, 4 rays a lane, the meta row copied into shared
memory, each step's rows staged one step ahead, 8 warps over a step's
quads with the FMA body; k3's warps combine once after the walk, k4's and
k5's after every step). k3-k5 so round otherwise than their plain
versions and are held to them by lab3_agreement (common.tie_aware_hold;
the exit's steps per tile by walked_steps); k0-k2 bit for bit. On the
card run also times each configuration back to back
(common.time_back_to_back), which leaves the wrapper's host path out of
the reading where the kernel runs longer than it.

    python -m tauray_torch.lab.kernel_lab [k0 k1 k2 k3 k4 k5 k5<G>]
                                          [--device=cpu]

prints, after the card's name and power limit, the script's line per
configuration (label, steps, ms, us a tile) with G tests/s, the bound and
the bytes staged (on the card also the ms back to back), then the
intercept and slope of ms over steps of k2-k5 (and of the ms back to
back). The default runs
are the script's, k0 k1 k2 k3 k4: k0 and k1 at 0 and 1 steps, the others
at 0, 1, 2, 4 and 8."""

from __future__ import annotations

import sys
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..ops.trace_kernel import _mt_test
from .bounds import staged_bytes, tile_bound
from .common import (BIG, CLUSTER, CPAD, KB_L1, ROW_L1, TILE_L1, card,
                     lab1_inputs, mt_fp64, parse_args, steps_hold,
                     tie_aware_hold, time_back_to_back, timed_run)
from .lab_kernel import launch_tile, on_card

BK = KB_L1 * CLUSTER     # triangles a step
G_L2 = 8                 # k4's tiles a block (the script's G)
NAMES = ("k0", "k1", "k2", "k3", "k4")
_K4_HEAD = f"{'k4 (8 tiles/step, packed io)':38s} "
# elements of each (tiles, 128, 1,024) temporary of the plain version:
# 64 MB in f32
_REF_ELEMS = 1 << 24


class TileConfig(NamedTuple):
    """One run of the script's main: its kernel (k0-k5), tiles a block,
    steps, and the head of its line as the script prints it."""
    name: str
    group: int
    steps: int
    head: str


def configs(names: Sequence[str] = NAMES):
    """The runs of the script's main for names (k0-k4, k5, k5<G>), in its
    order (kernel_lab.py:595-609)."""
    out = []
    for name in names:
        if name == "k4":
            out += [TileConfig("k4", G_L2, n, _K4_HEAD)
                    for n in (0, 1, 2, 4, 8)]
        elif name.startswith("k5"):
            g = int(name[2:]) if len(name) > 2 else 8
            out += [TileConfig("k5", g, n,
                               f"k5 G={g:2d} (no transpose, lane-pad)     ")
                    for n in (0, 1, 2, 4, 8)]
        elif name in ("k0", "k1", "k2", "k3"):
            out += [TileConfig(name, 1, n, f"{name:38s} ") for n in
                    ((0, 1) if name in ("k0", "k1") else (0, 1, 2, 4, 8))]
        else:
            raise ValueError(f"kernel_lab: no kernel {name}")
    return out


def lab1(counts: torch.Tensor, meta: torch.Tensor, rays: torch.Tensor,
         tris9: torch.Tensor, mode: str):
    """L1's mode (k0-k3): counts (n_tiles,) i32, meta (n_tiles x 3,072,)
    i32, rays (8, n_tiles * 128) f32 columns, tris9 (C, 9, 1, 128) f32.
    Returns t (R, 1) f32 and id (R, 1) i32."""
    if not on_card(rays):
        return lab1_reference(counts, meta, rays, tris9, mode)
    out = launch_tile("lab1", mode, counts, meta, rays, tris9)
    return out[0].view(-1, 1), out[1].view(torch.int32).view(-1, 1)


def lab2(counts: torch.Tensor, meta: torch.Tensor, rays: torch.Tensor,
         tris9: torch.Tensor) -> torch.Tensor:
    """L2 (k4): rays (n_tiles, 8, 128) f32 planes (the script's 8 tiles a
    grid step; the card walks one tile a block). Returns (n_tiles, 2,
    128) f32: t, then the id's int32 bits."""
    if not on_card(rays):
        return lab2_reference(counts, meta, rays, tris9)
    return launch_tile("lab2", "k4", counts, meta, rays, tris9, G_L2)


def lab3(counts: torch.Tensor, meta: torch.Tensor, rays: torch.Tensor,
         tris9: torch.Tensor, group: int = 8) -> torch.Tensor:
    """L3 (k5): rays (n_tiles, 128, 8) f32 rows; group, the script's G
    (tiles a TPU grid step), divides n_tiles (the card walks one tile a
    block whatever it is). Returns (n_tiles, 128, 2) f32: t, then the id's
    int32 bits."""
    if not on_card(rays):
        return lab3_reference(counts, meta, rays, tris9)
    return launch_tile("lab3", "k5", counts, meta, rays, tris9, group)


def _steps(counts: torch.Tensor) -> torch.Tensor:
    """Each tile's steps, (count + 7) // 8 as the script reckons them."""
    return torch.div(counts.long() + KB_L1 - 1, KB_L1, rounding_mode="floor")


def _start(tmax: torch.Tensor) -> torch.Tensor:
    return torch.where(tmax > BIG, BIG, tmax)     # jnp.minimum keeps NaN


def walk_reference(counts, meta, rays, tris9, exit: bool, stats=None):
    """Plain torch version of k3 (exit False) and k4 / k5 (exit True):
    rays (n_tiles, 128, 8) f32 rows; every tile still walking takes step s
    as one batched block. Returns the best t and id, (n_tiles, 128) f32
    and i32. `stats` (a dict), when given, receives the steps the tiles
    walked."""
    dev = rays.device
    n_tiles = rays.shape[0]
    C = tris9.shape[0]
    rows = tris9.reshape(C, 9, CLUSTER)
    m2 = meta.reshape(n_tiles, ROW_L1)
    count = counts.long()
    steps = _steps(counts)
    bt = _start(rays[..., 7])
    bi = torch.full((n_tiles, TILE_L1), -1, dtype=torch.int32, device=dev)
    walking = torch.ones(n_tiles, dtype=torch.bool, device=dev)
    j = torch.arange(KB_L1, device=dev)
    block = torch.arange(BK, device=dev) // CLUSTER
    chunk = max(1, _REF_ELEMS // (TILE_L1 * BK))
    walked, s = 0, 0
    while True:
        active = torch.nonzero(walking & (steps > s)).squeeze(1)
        if active.numel() == 0:
            break
        walked += active.numel()
        k = (s * KB_L1 + j).clamp(max=CPAD - 1)
        for sel in active.split(chunk):
            n = sel.numel()
            orders = m2[sel][:, k].clamp(0, C - 1).long()          # (n, 8)
            tri = rows[orders].permute(0, 2, 1, 3).reshape(n, 9, 1, BK)
            ray = rays[sel]
            o = [ray[..., q, None] for q in range(3)]
            d = [ray[..., 3 + q, None] for q in range(3)]
            bt_s = bt[sel]
            a, tt, uu, vv = _mt_test([tri[:, i] for i in range(9)], *o, *d)
            slot_ok = (s * KB_L1 + block)[None] < count[sel, None]
            hit = (a != 0) & (uu >= 0) & (vv >= 0) & (uu + vv <= 1) & \
                (tt >= ray[..., 6, None]) & (tt < bt_s[..., None]) & \
                slot_ok[:, None, :]
            cand, arg = torch.where(hit, tt, BIG).min(dim=2)
            closer = cand < bt_s
            win = torch.gather(orders, 1, arg // CLUSTER) * CLUSTER + \
                arg % CLUSTER
            bt[sel] = torch.where(closer, cand, bt_s)
            bi[sel] = torch.where(closer, win.int(), bi[sel])
            if exit:
                nxt = m2[sel, CPAD + min((s + 1) * KB_L1, CPAD - 1)]
                done = (bt[sel].view(torch.int32) <= nxt[:, None]).all(dim=1)
                walking[sel] = ~done
        s += 1
    if stats is not None:
        stats["steps"] = walked
    return bt, bi


def lab1_reference(counts, meta, rays, tris9, mode: str):
    """Plain torch version of lab1 (kernel_lab.py:72-261)."""
    if mode not in ("k0", "k1", "k2", "k3"):
        raise ValueError(f"lab1: no mode {mode}")
    dev = rays.device
    n_tiles = counts.shape[0]
    rows = rays.t().reshape(n_tiles, TILE_L1, 8)
    m2 = meta.reshape(n_tiles, ROW_L1)
    bt = _start(rows[..., 7])
    bi = torch.full((n_tiles, TILE_L1), -1, dtype=torch.int32, device=dev)
    if mode == "k1":
        bi = m2[:, :1].expand(n_tiles, TILE_L1)
    elif mode == "k2":
        C = tris9.shape[0]
        first = tris9.reshape(C, -1)[:, 0]
        steps = _steps(counts)
        acc = torch.zeros(n_tiles, dtype=torch.float32, device=dev)
        for s in range(int(steps.max()) if n_tiles else 0):
            c = m2[:, min(s * KB_L1, CPAD - 1)].clamp(0, C - 1).long()
            acc = torch.where(steps > s, acc + first[c], acc)
        bt = torch.where((steps > 0)[:, None], acc[:, None], bt)
    elif mode == "k3":
        bt, bi = walk_reference(counts, meta, rows, tris9, False)
    return bt.reshape(-1, 1), bi.reshape(-1, 1)


def lab2_reference(counts, meta, rays, tris9, stats=None):
    """Plain torch version of lab2 (kernel_lab.py:271-398)."""
    bt, bi = walk_reference(counts, meta, rays.transpose(1, 2), tris9, True,
                            stats)
    return torch.stack([bt, bi.view(torch.float32)], 1)


def lab3_reference(counts, meta, rays, tris9, stats=None):
    """Plain torch version of lab3 (kernel_lab.py:433-561)."""
    bt, bi = walk_reference(counts, meta, rays, tris9, True, stats)
    return torch.stack([bt, bi.view(torch.float32)], -1)


def lab3_agreement(out, ref, meta, rays, tris9, steps=None,
                   name: str = "k5") -> dict:
    """The hold of the output of name's kernel (k3, k4 or k5) against its
    plain version, both as name's wrapper returns them (flat reads them in
    ray order), on their inputs, rays as tile_inputs' rows (n_tiles, 128,
    8) whatever name's layout: common.tie_aware_hold, each ray's
    winner (its id names the cluster and the lane) analysed in FP64 by
    common.mt_fp64. steps, when given, is (the kernel's, the plain
    version's) walked_steps, held by common.steps_hold; the exit's bound
    after s steps is the tnear entry meta[1,024 + min(8 s, 1,023)] read as
    a float."""
    n_tiles = rays.shape[0]
    C = tris9.shape[0]
    rows = tris9.reshape(C, 9, CLUSTER)
    r8 = rays.reshape(-1, 8)

    def analyse(ray, ids):
        return mt_fp64(rows[(ids // CLUSTER).long(), :,
                            (ids % CLUSTER).long()], r8[ray, 0:3],
                       r8[ray, 3:6], r8[ray, 6])

    (t_k, id_k), (t_p, id_p) = flat(name, out), flat(name, ref)
    res = tie_aware_hold(t_k, id_k, t_p, id_p, _start(r8[:, 7]), analyse)
    if steps is None:
        return res
    m2 = meta.reshape(n_tiles, ROW_L1)

    def bound(tile, s):
        return m2[tile, CPAD + min(KB_L1 * s, CPAD - 1)].view(
            torch.float32).double()
    return steps_hold(res, steps, t_k, id_k, t_p, id_p, TILE_L1, bound,
                      analyse)


def walked_steps(fn, counts: torch.Tensor) -> torch.Tensor:
    """Per tile, the fewest steps s whose output, fn(min(counts, 8 s)),
    equals fn(counts)'s bit for bit ((n_tiles,) int64): the steps the walk
    needed, the exit's among them. fn(counts) returns L2's (n_tiles, 2,
    128) or L3's (n_tiles, 128, 2) block."""
    full = fn(counts).view(torch.int32)
    n = _steps(counts)
    for s in range(int(n.max()) - 1 if n.numel() else -1, -1, -1):
        part = fn(counts.clamp(max=s * KB_L1)).view(torch.int32)
        n = torch.where((part == full).flatten(1).all(1), s, n)
    return n


def tile_inputs(device, tiles=None):
    """The script's rays (as L1's columns, L2's planes and L3's rows),
    tris9 and meta on device, or their first `tiles` tiles."""
    cols, tris9, meta = lab1_inputs()
    if tiles is not None:
        cols, meta = cols[:, :tiles * TILE_L1], meta[:tiles * ROW_L1]
    n_tiles = cols.shape[1] // TILE_L1
    rows = np.ascontiguousarray(cols.T).reshape(n_tiles, TILE_L1, 8)
    planes = np.ascontiguousarray(rows.transpose(0, 2, 1))

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)
    return dict(cols=t(cols), planes=t(planes), rows=t(rows), tris9=t(tris9),
                meta=t(meta), n_tiles=n_tiles)


def call(cfg: TileConfig, inp, counts):
    """cfg's kernel on inp (tile_inputs) with counts, as its lab's
    wrapper returns it (L1: (t, id))."""
    if cfg.name == "k4":
        return lab2(counts, inp["meta"], inp["planes"], inp["tris9"])
    if cfg.name == "k5":
        return lab3(counts, inp["meta"], inp["rows"], inp["tris9"],
                    cfg.group)
    return lab1(counts, inp["meta"], inp["cols"], inp["tris9"], cfg.name)


def call_reference(cfg: TileConfig, inp, counts, stats=None):
    """The plain version of cfg's kernel, as call returns it; `stats` as
    walk_reference takes it (k4, k5)."""
    if cfg.name == "k4":
        return lab2_reference(counts, inp["meta"], inp["planes"],
                              inp["tris9"], stats)
    if cfg.name == "k5":
        return lab3_reference(counts, inp["meta"], inp["rows"], inp["tris9"],
                              stats)
    return lab1_reference(counts, inp["meta"], inp["cols"], inp["tris9"],
                          cfg.name)


def flat(name: str, out):
    """t (R,) f32 and the id (R,) i32 in ray order from what name's
    kernel returns."""
    if name == "k4":
        t, i = out[:, 0], out[:, 1]
    elif name == "k5":
        t, i = out[..., 0], out[..., 1]
    else:
        t, i = out
    if i.dtype == torch.float32:
        i = i.contiguous().view(torch.int32)
    return t.reshape(-1), i.reshape(-1)


def counts_of(n_tiles: int, steps: int, device) -> torch.Tensor:
    """The script's counts: steps * 8 slots for every tile."""
    return torch.full((n_tiles,), steps * KB_L1, dtype=torch.int32,
                      device=device)


def run(device, names: Sequence[str] = NAMES, reps: int = 5, tiles=None):
    """The runs of main for names at the script's size (or its first
    `tiles` tiles), each timed (common.timed_run) and, on the card, back
    to back (common.time_back_to_back): (inputs, [one dict per run: cfg,
    ms, min_ms, max_ms, ms_back_to_back (None on the CPU) with its min and
    max, us_per_tile, gtests_s (k3-k5's tests a second), bound_ms,
    bound_by, staged_bytes, counts, out])."""
    inp = tile_inputs(device, tiles)
    n_tiles = inp["n_tiles"]
    res = []
    for cfg in configs(names):
        counts = counts_of(n_tiles, cfg.steps, device)
        out, t = timed_run(lambda: call(cfg, inp, counts), device, reps)
        t.update(time_back_to_back(lambda: call(cfg, inp, counts), reps)
                 if device.type == "cuda" else dict.fromkeys((
                     "ms_back_to_back", "min_ms_back_to_back",
                     "max_ms_back_to_back")))
        tests = n_tiles * TILE_L1 * cfg.steps * BK \
            if cfg.name not in ("k0", "k1", "k2") else 0
        b_ms, b_by = tile_bound(cfg.name, cfg.steps, n_tiles)
        res.append(dict(
            cfg=cfg, **t, us_per_tile=t["ms"] * 1e3 / n_tiles,
            gtests_s=tests / (t["ms"] * 1e6), bound_ms=b_ms, bound_by=b_by,
            staged_bytes=staged_bytes(cfg.steps, n_tiles)
            if cfg.name not in ("k0", "k1") else 0,
            counts=counts, out=out))
    return inp, res


def step_fit(res, key: str = "ms"):
    """{(kernel, group): (intercept ms, slope ms a step)}: the least-squares
    line of res's key (ms, or ms_back_to_back) over steps of each kernel
    run at two or more step counts (runs without that reading left out)."""
    by = {}
    for r in res:
        c = r["cfg"]
        if r[key] is not None:
            by.setdefault((c.name, c.group), []).append((c.steps, r[key]))
    out = {}
    for key, pts in by.items():
        if len({s for s, _ in pts}) >= 2:
            slope, icpt = np.polyfit(*zip(*pts), 1)
            out[key] = (float(icpt), float(slope))
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    names = [a for a in argv if not a.startswith("-")] or list(NAMES)
    configs(names)                       # an unknown kernel raises here
    dev = parse_args([a for a in argv if a.startswith("-")], __doc__)
    unit = "ms" if dev.type == "cuda" else "host ms (cpu plain)"
    if dev.type == "cuda":
        print(card(), flush=True)
    _, res = run(dev, names)
    for r in res:
        c = r["cfg"]
        staged = f", {r['staged_bytes'] / 1e6:.0f} MB staged" \
            if r["staged_bytes"] else ""
        b2b = f", {r['ms_back_to_back']:.4f} ms back to back" \
            if r["ms_back_to_back"] is not None else ""
        print(f"{c.head}steps={c.steps}: {r['ms']:7.2f} {unit} "
              f"({r['us_per_tile']:5.2f} us/tile, {r['gtests_s']:6.1f} G "
              f"tests/s; bound {r['bound_ms']:.4f} ms, {r['bound_by']}"
              f"{staged}{b2b})", flush=True)
    b2b_fit = step_fit(res, "ms_back_to_back")
    for (name, group), (icpt, slope) in step_fit(res).items():
        if name not in ("k0", "k1"):
            b2b = ""
            if (name, group) in b2b_fit:
                b_icpt, b_slope = b2b_fit[name, group]
                b2b = f"; back to back {b_icpt:.4f} ms + {b_slope:.4f}"
            print(f"{name} G={group}: {icpt:.4f} {unit} + {slope:.4f} a step"
                  f"{b2b}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
