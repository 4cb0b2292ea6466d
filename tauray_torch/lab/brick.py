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

On the card L4-L7 run one walk (csrc/brick_lab.cu brick_walk_kernel) with
the bodies' FMA forms: L4 mt and L5-L7 are held by brick_agreement
(common.tie_aware_hold), L4 mtfast by mtfast_agreement, which holds its
truncated keys to a quantum."""

from __future__ import annotations

import torch

from ..ops.trace_kernel import _bw_test, _mt_test
from .bounds import brick_bound
from .common import (BIG, CLUSTER, ILL_SHARE, ROW, BrickConfig, bw_fp64,
                     card, mt_fp64, parse_args, steps_hold, tie_aware_hold,
                     time_back_to_back, timed_run)
from .lab_kernel import MODES, launch_brick, on_card

# elements of each (tiles, tile, KB * 128) temporary of the plain version:
# 64 MB in f32
_REF_ELEMS = 1 << 24
# mtfast's key keeps t's int32 bits above the low 10, which hold the lane:
# one quantum of t is 1,024 in its bits
QUANTUM = 1024


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


def _fp64_key_t(rows, o, d, tmin):
    """mt_fp64 of each ray against one triangle each, with t as mtfast's
    key takes it, t_n / |a|: negative where a < 0."""
    f = mt_fp64(rows, o, d, tmin)
    e1, e2 = rows[:, 3:6].double(), rows[:, 6:9].double()
    a = (e1 * torch.cross(d.double(), e2, dim=1)).sum(1)
    f["t"] = torch.where(a < 0, -f["t"], f["t"])
    return f


def mtfast_agreement(out: torch.Tensor, ref: torch.Tensor, meta, rays,
                     tris, kb: int, ill_share: float = ILL_SHARE) -> dict:
    """The hold of L4 mtfast's kernel output (the FMA form of the
    deferred-division body) against its plain version (both raw (n_tiles,
    tile, 2) blocks) on their inputs, ray by ray:
      * the sign of t equal on every ray (t < 0 for a hit with a < 0);
      * ids equal: t's int32 bits within one key quantum (QUANTUM), or two
        where both keys carry bit 10: the FMAs move t across a quantum,
        and at KB = 16 a lane >= 1,024 sets bit 10, when a crossing moves
        the key by two (the CPU rule of the script's hold); further apart
        only on an ill-conditioned test, where the two t lie within twice
        its FP64 bound (common.mt_fp64's b_t) and the keys' truncations;
      * ids differ, or t departs on an ill-conditioned test, on at most
        ill_share of the rays together; ids differ each where FP64 puts
        the outcome within rounding of turning: a winner whose test rounding
        decides (common.mt_fp64's margin <= 1), or two winners whose t,
        t_n / |a| in FP64, lie within a quantum and their rounding bounds
        of each other (the keys' minimum then turns on a crossing); each
        side's t must be its winner's FP64 t within its bound and a quantum
        (the key's truncation, bit 10), or, with no id, its start. A slot
        at KB = 16 names lane & 1,023 of its step: its winner is that lane
        or the lane 1,024 on, whichever FP64 puts nearer its t.
    Returns the rays, the ids that differ, the ill-conditioned rays with
    equal ids, the rays so held (held, each with its winners' FP64 t and
    margins or bound), t_bits_differ and max_quanta
    (the largest |bits difference| / QUANTUM) over equal ids, the signs
    that differ, t_negative (the kernel's, the plain version's), the rays
    that break every rule (rays_off) and ok."""
    n_tiles, tile = rays.shape[:2]
    C = tris.shape[0]
    rows = tris.reshape(C, tris.shape[1], CLUSTER)
    m2 = meta.reshape(n_tiles, ROW)
    r8 = rays.reshape(-1, 8)
    bk = kb * CLUSTER
    t_k, t_p = out[..., 0].reshape(-1), ref[..., 0].reshape(-1)
    id_k, id_p = (x[..., 1].contiguous().view(torch.int32).reshape(-1)
                  for x in (out, ref))
    b_k, b_p = (t.view(torch.int32).long() for t in (t_k, t_p))
    n = t_k.numel()
    sign_off = torch.signbit(t_k) != torch.signbit(t_p)
    same = id_k == id_p
    d = (b_k - b_p).abs()
    bit10 = ((b_k & 1024) != 0) & ((b_p & 1024) != 0)
    t_ok = (d <= QUANTUM) | ((d == 2 * QUANTUM) & bit10)
    off = sign_off | (same & ~t_ok)
    t_start = torch.where(r8[:, 7] > BIG, BIG, r8[:, 7])  # NaN kept

    def winner(sel, ids, t):
        """FP64's test of the triangle each id names (the nearer of the
        two a KB = 16 slot can name) for the rays sel, keyed as mtfast
        keys t."""
        ids = ids.clamp(min=0).long()
        step, lane = ids // bk, ids % bk
        best = None
        for extra in ((0, 1024) if bk > 1024 else (0,)):
            ln = (lane + extra).clamp(max=bk - 1)
            m = m2[sel // tile, step * kb + ln // CLUSTER]
            f = _fp64_key_t(rows[m.clamp(0, C - 1).long(), :, ln % CLUSTER],
                            r8[sel, 0:3], r8[sel, 3:6], r8[sel, 6])
            if best is None:
                best = f
                continue
            nearer = (f["t"] - t.double()).abs() < \
                (best["t"] - t.double()).abs()
            best = {k: torch.where(nearer, f[k], best[k]) for k in f}
        return best

    def quantum(x):
        """One quantum of the key at |x| (f64): 1,024 of its ulps."""
        return torch.ldexp(torch.ones_like(x),
                           torch.frexp(x.abs()).exponent - 14)
    held = []
    # ids equal, t further apart than the quantum rule: held only where
    # FP64 bounds the two bodies' t that far apart (an ill-conditioned
    # test: 2 b_t and the keys' truncations, bit 10 included)
    ill = torch.nonzero(same & ~t_ok & ~sign_off & (id_k >= 0)).squeeze(1)
    if ill.numel():
        f = winner(ill, id_k[ill], t_k[ill])
        tk, tp = t_k[ill].double(), t_p[ill].double()
        q = quantum(torch.maximum(tk.abs(), tp.abs()))
        within = (tk - tp).abs() <= 2 * f["b_t"] + q * (1 + bit10[ill])
        off[ill] = ~within
        for i in range(ill.numel()):
            held.append(dict(ray=int(ill[i]), id_k=int(id_k[ill[i]]),
                             id_p=int(id_p[ill[i]]), t_k=float(tk[i]),
                             t_p=float(tp[i]), t64_k=float(f["t"][i]),
                             b_t=float(f["b_t"][i]),
                             quanta=float(d[ill[i]]) / QUANTUM,
                             ok=bool(within[i])))
    sel = torch.nonzero(~same).squeeze(1)
    if sel.numel():
        ik, ip = id_k[sel], id_p[sel]
        tk, tp = t_k[sel], t_p[sel]
        fk, fp = winner(sel, ik, tk), winner(sel, ip, tp)

        def bits(x):    # of |x|: the key truncates t's magnitude
            return x.abs().float().view(torch.int32).long()

        def legit(f, ids, t, start):
            mag = f["t"].abs()
            lo = bits((mag - f["b_t"]).clamp(min=0)) - QUANTUM
            hi = bits(mag + f["b_t"]) + QUANTUM
            inside = (bits(t) >= lo) & (bits(t) <= hi) & (
                (f["t"] == 0) | (torch.signbit(t) == (f["t"] < 0)))
            hit = (ids >= 0) & (f["hit"] | (f["margin"] <= 1)) & inside
            return hit | ((ids < 0) & (t.view(torch.int32) ==
                                       start.view(torch.int32)))
        lk = legit(fk, ik, tk, t_start[sel])
        lp = legit(fp, ip, tp, t_start[sel])
        turn = ((ik >= 0) & (fk["margin"] <= 1)) | \
            ((ip >= 0) & (fp["margin"] <= 1))
        q = quantum(torch.maximum(fk["t"].abs(), fp["t"].abs()))
        key_tie = (ik >= 0) & (ip >= 0) & ((fk["t"] - fp["t"]).abs() <=
                                           q + fk["b_t"] + fp["b_t"])
        ok = lk & lp & (turn | key_tie)
        off[sel] |= ~ok
        for i in range(sel.numel()):
            held.append(dict(ray=int(sel[i]), id_k=int(ik[i]),
                             id_p=int(ip[i]), t_k=float(tk[i]),
                             t_p=float(tp[i]), t64_k=float(fk["t"][i]),
                             t64_p=float(fp["t"][i]),
                             margin_k=float(fk["margin"][i]),
                             margin_p=float(fp["margin"][i]),
                             key_tie=bool(key_tie[i]), ok=bool(ok[i])))
    n_ill = int(sel.numel() + ill.numel())
    return dict(rays=n, ids_differ=int(sel.numel()),
                ill_conditioned=int(ill.numel()), held=held,
                t_bits_differ=int((same & (d != 0)).sum()),
                max_quanta=float((torch.where(same, d, 0).max() / QUANTUM)
                                 if n else 0.0),
                signs_differ=int(sign_off.sum()),
                t_negative=[int((t_k < 0).sum()), int((t_p < 0).sum())],
                rays_off=int(off.sum()),
                ok=not bool(off.any()) and n_ill <= ill_share * n)


def agreement(lab: str, mode, out, ref, meta, rays, tris, kb: int,
              steps=None) -> dict:
    """The card's hold of lab's walk in mode against its plain version:
    mtfast_agreement for L4 mtfast, brick_agreement (steps: see it) for
    every other."""
    if mode == "mtfast":
        return mtfast_agreement(out, ref, meta, rays, tris, kb)
    return brick_agreement(lab, mode, out, ref, meta, rays, tris, steps, kb)


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
