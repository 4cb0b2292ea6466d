"""What L4-L7 share (scripts/kernel_lab2-5.py): the walk's plain torch
version, its wrapper, and the loop that runs and times a script's
configurations.

A tile of 8, 16 or 32 rays walks `steps` steps of KB clusters of 128
triangles. The cluster of the tile's slot k is its meta entry k (of 1,024),
clipped to [0, C) (L7: the entry & 1023, at most C - 1). Each step tests
its KB * 128 triangles against the best t from before the step, and takes
the first smallest candidate when it is strictly closer; the id kept is
the order slot step * KB * 128 + lane (L6 cid: the slot's cluster * 128 +
lane % 128). Per lab and mode:

  lab4 mt      Möller-Trumbore (kernel_lab2.py mt_body);
  lab4 mtfast  the deferred-division body (mtfast_body), kept as written:
               t = t_n / |a|, so a hit with a < 0 gets t < 0; the winner
               is one int32 minimum over the keys (t bits & ~1023) | lane
               of every triangle, hit or not (a miss's t is 3e38); the best
               t kept is the key & ~1023, the id step * BK + (key & 1023),
               which drops lane bit 10 at KB = 16;
  lab5 mt      as lab4 mt (the table read in place, the same function);
  lab6 fixed, slot   as lab5 mt; cid the cluster id; while / while2 stop a
               tile once every ray's best t bits are <= the unclipped meta
               entry min((step + 1) * KB, 1023), tested after every step /
               after odd steps only;
  lab7 mt, bw  Möller-Trumbore over tris9 or Baldwin-Weber over tris12,
               from t = 3e38 and id 0 (t_max is not read); the id column
               holds float(id).

Otherwise t starts at min(t_max, 3e38) and the id at -1. The output is
(n_tiles, tile, 2) f32: t, then the id's int32 bits (L7: float(id)).

On the card L4 takes the unfused bodies and compares bit for bit with the
plain version; L5-L7 take their FMA counterparts (csrc/brick_lab.cu
brick_walk_kernel) and are held by brick_agreement
(common.tie_aware_hold)."""

from __future__ import annotations

import torch

from ..ops.trace_kernel import _bw_test, _mt_test
from .bounds import brick_bound
from .common import (BIG, CLUSTER, ROW, BrickConfig, bw_fp64, card,
                     mt_fp64, parse_args, steps_hold, tie_aware_hold,
                     time_back_to_back, timed_run)
from .lab_kernel import MODES, launch_brick, on_card

# elements of each (tiles, tile, KB * 128) temporary of the plain version:
# 64 MB in f32
_REF_ELEMS = 1 << 24


def brick(lab: str, mode, meta: torch.Tensor, rays: torch.Tensor,
          tris: torch.Tensor, kb: int, steps: int) -> torch.Tensor:
    """lab's walk in mode: csrc/brick_lab.cu for CUDA tensors, the plain
    version for CPU tensors."""
    if not on_card(rays):
        return walk_reference(lab, mode, meta, rays, tris, kb, steps)
    return launch_brick(lab, mode, meta, rays, tris, kb, steps)


def _mtfast_keys(rows, ox, oy, oz, dx, dy, dz, tmin, bt, lane):
    """kernel_lab2.py mtfast_body's keys (t bits & ~1023) | lane: each test
    multiplied through by |a|, t = t_n / |a| on a hit and 3e38 on a miss."""
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = rows
    hx = dy * e2z - dz * e2y
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    a = e1x * hx + e1y * hy + e1z * hz
    sx = ox - v0x
    sy = oy - v0y
    sz = oz - v0z
    u_n = sx * hx + sy * hy + sz * hz
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v_n = dx * qx + dy * qy + dz * qz
    t_n = e2x * qx + e2y * qy + e2z * qz
    sa = torch.where(a < 0, -1.0, 1.0)
    na = a * sa
    nu = u_n * sa
    nv = v_n * sa
    nt = t_n * sa
    hit = (nu >= 0) & (nv >= 0) & (nu + nv <= na) & (nt >= tmin * na) & \
        (nt < bt * na) & (na > 0)
    tt = torch.where(hit, t_n / torch.where(na == 0, 1.0, a * sa), BIG)
    return (tt.view(torch.int32) & ~1023) | lane


def walk_reference(lab: str, mode, meta: torch.Tensor, rays: torch.Tensor,
                   tris: torch.Tensor, kb: int, steps: int,
                   stats=None) -> torch.Tensor:
    """Plain torch version of lab's walk in mode: every tile still walking
    takes step s as one batched block. `stats` (a dict), when given,
    receives the steps the tiles walked."""
    if mode not in MODES[lab]:
        raise ValueError(f"{lab}: no mode {mode}")
    dev = rays.device
    n_tiles, tile = rays.shape[:2]
    C, nf = tris.shape[:2]
    rows = tris.reshape(C, nf, CLUSTER)
    bk = kb * CLUSTER
    m2 = meta.reshape(n_tiles, ROW)
    if lab == "lab7":
        bt = torch.full((n_tiles, tile), BIG, dtype=torch.float32,
                        device=dev)
        bi = torch.zeros((n_tiles, tile), dtype=torch.int32, device=dev)
    else:
        tmax = rays[..., 7]
        bt = torch.where(tmax > BIG, BIG, tmax)     # jnp.minimum keeps NaN
        bi = torch.full((n_tiles, tile), -1, dtype=torch.int32, device=dev)
    vote = {"while": 1, "while2": 2}.get(mode) if lab == "lab6" else None
    walking = torch.ones(n_tiles, dtype=torch.bool, device=dev)
    lane = torch.arange(bk, dtype=torch.int32, device=dev)
    chunk = max(1, _REF_ELEMS // (tile * bk))
    walked = 0
    for s in range(steps):
        active = torch.nonzero(walking).squeeze(1)
        walked += active.numel()
        for sel in active.split(chunk):
            n = sel.numel()
            ent = m2[sel, s * kb:(s + 1) * kb]
            orders = ((ent & 1023).clamp(max=C - 1) if lab == "lab7" else
                      ent.clamp(0, C - 1)).long()
            tri = rows[orders].permute(0, 2, 1, 3).reshape(n, nf, 1, bk)
            cols = [tri[:, i] for i in range(nf)]
            ray = rays[sel]
            o = [ray[..., k, None] for k in range(3)]
            d = [ray[..., 3 + k, None] for k in range(3)]
            tmin = ray[..., 6, None]
            bt_s, bi_s = bt[sel], bi[sel]
            if mode == "mtfast":
                cand = _mtfast_keys(cols, *o, *d, tmin, bt_s[..., None],
                                    lane).min(dim=2).values
                closer = cand < bt_s.view(torch.int32)
                bt[sel] = torch.where(
                    closer, (cand & ~1023).view(torch.float32), bt_s)
                bi[sel] = torch.where(closer, s * bk + (cand & 1023), bi_s)
            else:
                test = _bw_test if mode == "bw" else _mt_test
                a, tt, uu, vv = test(cols, *o, *d)
                hit = (a != 0) & (uu >= 0) & (vv >= 0) & (uu + vv <= 1) & \
                    (tt >= tmin) & (tt < bt_s[..., None])
                cand, arg = torch.where(hit, tt, BIG).min(dim=2)
                closer = cand < bt_s
                if mode == "cid":
                    win = torch.gather(orders, 1, arg // CLUSTER) * \
                        CLUSTER + arg % CLUSTER
                else:
                    win = s * bk + arg
                bt[sel] = torch.where(closer, cand, bt_s)
                bi[sel] = torch.where(closer, win.int(), bi_s)
            if vote and s % vote == vote - 1:
                nxt = m2[sel, min((s + 1) * kb, ROW - 1)]
                done = (bt[sel].view(torch.int32) <= nxt[:, None]).all(dim=1)
                walking[sel] = ~done
    if stats is not None:
        stats["steps"] = walked
    ids = bi.float() if lab == "lab7" else bi.view(torch.float32)
    return torch.stack([bt, ids], -1)


def brick_agreement(lab: str, mode, out: torch.Tensor, ref: torch.Tensor,
                    meta, rays, tris, steps=None, kb: int = 0) -> dict:
    """The tie-aware hold of lab's kernel output in mode against its plain
    version (both raw (n_tiles, tile, 2) blocks) on their inputs:
    common.tie_aware_hold, each ray's winner analysed in FP64
    (common.bw_fp64 or mt_fp64). The id is the int32 bits, -1 on a miss,
    and t starts at min(t_max, 3e38) (a NaN kept); the triangle is lane id
    % 128 of the cluster of meta slot id // 128, clipped to [0, C), but for
    cid, whose id is the cluster x 128 + lane itself. L7's id is float(id)
    and a miss keeps t = 3e38 (its id 0 is then no slot), its cluster the
    entry & 1023, at most C - 1. steps, when given, is (the kernel's, the
    plain version's) walked_steps, held by common.steps_hold; the exit's
    bound after s steps is the meta entry min(kb s, 1,023) read as a
    float."""
    n_tiles, tile = rays.shape[:2]
    C, nf = tris.shape[:2]
    rows = tris.reshape(C, nf, CLUSTER)
    m2 = meta.reshape(n_tiles, ROW)
    r8 = rays.reshape(-1, 8)
    test = bw_fp64 if mode == "bw" else mt_fp64

    def analyse(ray, ids):
        if mode == "cid":
            c = (ids // CLUSTER).clamp(0, C - 1)
        else:
            m = m2[ray // tile, ids // CLUSTER]
            c = (m & 1023).clamp(max=C - 1) if lab == "lab7" else \
                m.clamp(0, C - 1)
        return test(rows[c.long(), :, (ids % CLUSTER).long()], r8[ray, 0:3],
                    r8[ray, 3:6], r8[ray, 6])

    def flat(x):
        t = x[..., 0].reshape(-1)
        if lab == "lab7":
            return t, torch.where(t < BIG, x[..., 1].reshape(-1).int(), -1)
        return t, x[..., 1].contiguous().view(torch.int32).reshape(-1)
    if lab == "lab7":
        t_start = torch.full_like(r8[:, 0], BIG)
    else:
        t_start = torch.where(r8[:, 7] > BIG, BIG, r8[:, 7])  # NaN kept
    (t_k, id_k), (t_p, id_p) = flat(out), flat(ref)
    res = tie_aware_hold(t_k, id_k, t_p, id_p, t_start, analyse)
    if steps is None:
        return res

    def bound(tile_, s):
        return m2[tile_, min(kb * s, ROW - 1)].view(torch.float32).double()
    return steps_hold(res, steps, t_k, id_k, t_p, id_p, tile, bound,
                      analyse)


def walked_steps(fn, steps: int) -> torch.Tensor:
    """Per tile, the fewest steps s whose output, fn(s), equals fn(steps)'s
    bit for bit ((n_tiles,) int64): the steps the walk needed, the exit's
    among them. fn(s) returns a brick lab's raw block for s steps."""
    full = fn(steps).view(torch.int32)
    n = torch.full((full.shape[0],), steps, dtype=torch.long,
                   device=full.device)
    for s in range(steps - 1, -1, -1):
        part = fn(s).view(torch.int32)
        n = torch.where((part == full).flatten(1).all(1), s, n)
    return n


def run_configs(device, tables, draws, reps: int, tiles=None):
    """Each configuration that draws yields, timed (common.timed_run; on
    the card also common.time_back_to_back) on its inputs at the script's
    size (or its first `tiles` tiles): [one dict per configuration: cfg,
    ms, min_ms, max_ms, ms_back_to_back (None on the CPU) with its min and
    max, us_per_tile, gtests_s (the tests the script counts, a second),
    bound_ms, bound_by, out, meta, rays, tris]."""
    tabs = {k: torch.from_numpy(v).to(device) for k, v in tables.items()}
    res = []
    for cfg, meta, rays in draws:
        if tiles is not None:
            cfg = cfg._replace(n_tiles=tiles)
            meta, rays = meta[:tiles * ROW], rays[:tiles]
        meta = torch.from_numpy(meta).to(device)
        rays = torch.from_numpy(rays).to(device)
        tris = tabs["tris12" if cfg.mode == "bw" else "tris9"]

        def call():
            return brick(cfg.lab, cfg.mode, meta, rays, tris, cfg.kb,
                         cfg.steps)
        out, t = timed_run(call, device, reps)
        t.update(time_back_to_back(call, reps) if device.type == "cuda"
                 else dict.fromkeys(("ms_back_to_back", "min_ms_back_to_back",
                                     "max_ms_back_to_back")))
        tests = cfg.n_tiles * cfg.tile * cfg.steps * cfg.kb * CLUSTER
        b_ms, b_by = brick_bound(cfg)
        res.append(dict(cfg=cfg, **t, us_per_tile=t["ms"] * 1e3 / cfg.n_tiles,
                        gtests_s=tests / (t["ms"] * 1e6), bound_ms=b_ms,
                        bound_by=b_by, out=out, meta=meta, rays=rays,
                        tris=tris))
    return res


def hits(out: torch.Tensor, cfg: BrickConfig) -> int:
    """Rays of out that hit: an id other than the start's (-1; L7: 0 with
    t below 3e38)."""
    if cfg.lab == "lab7":
        return int((out[..., 0] < BIG).sum())
    return int((out[..., 1].view(torch.int32) != -1).sum())


def entry_point(argv, doc: str, run, width: int = 0) -> int:
    """A brick lab's main: run(device) on --device (the card; cpu: the
    plain versions), then the script's line per configuration (its label
    padded to width, steps, ms, us a tile, G tests/s) with the bound and,
    on the card, the ms back to back, after the card's name and power
    limit."""
    dev = parse_args(argv, doc)
    unit = "ms" if dev.type == "cuda" else "host ms (cpu plain)"
    if dev.type == "cuda":
        print(card(), flush=True)
    for r in run(dev):
        c = r["cfg"]
        b2b = f", {r['ms_back_to_back']:.4f} ms back to back" \
            if r["ms_back_to_back"] is not None else ""
        print(f"{c.label:{width}s} steps={c.steps}: {r['ms']:7.2f} {unit} "
              f"({r['us_per_tile']:5.2f} us/tile, {r['gtests_s']:6.1f} G "
              f"tests/s; bound {r['bound_ms']:.4f} ms, {r['bound_by']}"
              f"{b2b})", flush=True)
    return 0
