"""L12, the counterpart of scripts/mxu_lab.py: does a ray-triangle test in
Plücker form, as matrix products on the tensor cores, beat FP32
Möller-Trumbore, and at what error? 65,536 random rays in 2,048 tiles of
32 (o in [0, 1), d standard normal, t in [0, 3e38)), a fixed 6 steps of 8
clusters a tile named by order (2,048, 64), over 636 random clusters. Each
step tests its 1,024 triangles against the best t from before it and takes
the first smallest hit when strictly closer; the id is the order slot,
step * 1,024 + the triangle's lane in the step (-1 on a miss, t then
min(t_max, 3e38)). An order outside [0, C) is clamped. Modes:

  mt       Möller-Trumbore over tris9 (C, 9, 1, 128) (mt_body);
  plucker  four products a step over tris24 (C, 24, 1, 128)
           (plucker_body): with the ray's [d | d x o] and [-o | 1], s0, s1
           and s2 over rows 0-5, 6-11 and 12-17, tnum over rows 18-21; a
           hit where s0, s1 and s2 share a sign, den = s0 + s1 + s2 is not
           0 and t = tnum / den lies in [t_min, best).

The plain versions run in FP32 (plucker's products as FP32 matrix
products, no TF32 on the card either). On the card (csrc/mxu_lab.cu) mt
runs the brick walk of L4-L7 (csrc/brick_walk.cuh, its FMA body), so it is
held to its unfused plain version by mt_agreement (common.tie_aware_hold,
each winner analysed in FP64 by common.mt_fp64, as brick.brick_agreement
holds L6). plucker's products are mma.sync in TF32 split in two (as L11;
m16n8k8 for the sides, m16n8k4 for tnum), and its epilogue
(plucker_epilogue) tests the sides' signs by their minimum and maximum and
takes one test of den != 0, which gives the script's verdict
(plucker_verdict); it is held to its
plain version by plucker_agreement, L11's rule: t within TOL x max(1,
|t|), or where the ids agree within its rounding bound of t in FP64; the
ids equal, or where they differ, the plain t of the kernel's triangle
within TOL x max(1, |t|) of the plain best (a tie). One rule more, for a
hit test that rounding decides: where the two sides' verdicts on one
winner's test differ, FP64 puts that test within its rounding bound of
turning, and the kernel's t lies within its bound of the FP64 t of the
kernel's triangle. At most 1e-4 of the rays may take the FP64 rules. On
the script's inputs every ray hits and the smallest t wins: the winning t
is small, so its relative error is large and TOL is, in effect, absolute;
and t_min is 0, so a triangle whose t lies within rounding of 0 may pass
one side's test and fail the other's.

    python -m tauray_torch.lab.mxu_lab [--device=cpu]

prints, after the card's name and power limit, the script's two lines (ms
and G ray-tri/s) with each mode's bound (on the card also the ms back to
back, 20 calls a window), then how mt and plucker agree with their plain
versions (on the CPU: are their plain versions)."""

from __future__ import annotations

import contextlib
import sys

import numpy as np
import torch

from ..ops.trace_kernel import _mt_test
from .bounds import lab12_bound
from .common import (BIG, CLUSTER, KBV, STEPS_L12, TILE, card, lab12_inputs,
                     mt_fp64, parse_args, tie_aware_hold, time_back_to_back,
                     timed_run)
from .kernel_lab11 import GAMMA_3XTF32, ILL_SHARE, TOL
from .lab_kernel import MODES, launch_lab12, on_card

BK = KBV * CLUSTER       # triangles a step
# the script's label of each mode
LABELS = {"mt": "VPU Moller-Trumbore", "plucker": "MXU Plucker"}
# tiles per batched block of the plain version: (tiles, 32, 1,024) f32
# temporaries of 32 MB each
_REF_TILES = 256
# the rounding of a product's value, per unit of its terms' magnitudes:
# the kernel's split in two (GAMMA_3XTF32, L11's) and the plain version's
# FP32 sum of at most 6 products
SIDE_ROUNDING = GAMMA_3XTF32 + 6 * 2.0 ** -24


def lab12(order: torch.Tensor, o3: torch.Tensor, d3: torch.Tensor,
          mm2: torch.Tensor, tris: torch.Tensor, mode: str) -> torch.Tensor:
    """One mode over the tiles: order (n_tiles, 64) i32, o3 and
    d3 (n_tiles, 32, 3) f32, mm2 (n_tiles, 32, 2) f32 [t_min | t_max],
    tris (C, 9, 1, 128) f32 for mt or (C, 24, 1, 128) for plucker. Returns
    (n_tiles, 32, 2) f32: the best t, then the slot's int32 bits."""
    if not on_card(o3):
        return lab12_reference(order, o3, d3, mm2, tris, mode)
    return launch_lab12(mode, order, o3, d3, mm2, tris)


def _plucker_test(blk, o3, d3, tmin, bt):
    """plucker_body's test (mxu_lab.py:169-197) in FP32: blk (n, >= 22, L)
    rows, o3 and d3 (n, R, 3), tmin and bt (n, R, 1). The four products
    are FP32 matrix products, as the script's dot_generals (XLA:CPU's and
    torch's CPU ones agree bit for bit). Returns (hit closer than bt, t),
    (n, R, L)."""
    ox, oy, oz = (o3[..., q, None] for q in range(3))
    dx, dy, dz = (d3[..., q, None] for q in range(3))
    rays6 = torch.cat([dx, dy, dz, dy * oz - dz * oy, dz * ox - dx * oz,
                       dx * oy - dy * ox], -1)
    rays4 = torch.cat([-ox, -oy, -oz, torch.ones_like(ox)], -1)
    with _fp32_matmul():
        s0, s1, s2 = (torch.matmul(rays6, blk[:, 6 * e:6 * e + 6])
                      for e in range(3))
        tnum = torch.matmul(rays4, blk[:, 18:22])
    return plucker_verdict(s0, s1, s2, tnum, tmin, bt)


def plucker_verdict(s0, s1, s2, tnum, tmin, bt):
    """plucker_body's verdict (mxu_lab.py:183-189) on the sides s0, s1, s2
    and the numerator tnum: (hit closer than bt, t)."""
    den = s0 + s1 + s2
    inside = ((s0 >= 0) & (s1 >= 0) & (s2 >= 0)) | \
        ((s0 <= 0) & (s1 <= 0) & (s2 <= 0))
    f = torch.where(den != 0, 1.0 / torch.where(den == 0, 1.0, den), 0.0)
    tt = tnum * f
    return inside & (den != 0) & (tt >= tmin) & (tt < bt), tt


def plucker_epilogue(s0, s1, s2, tnum, tmin, bt):
    """The card's epilogue (csrc/mxu_lab.cu plucker_block) on the CPU, in
    FP32: den = (s0 + s1) + s2; the sides mixed where min(s0, s1, s2) < 0 <
    max(s0, s1, s2) (fminf and fmaxf pass a NaN by, as torch.fmin and fmax
    do); t = tnum times the correctly rounded 1 / den (+-inf at den = 0);
    one test of den != 0: (hit closer than bt, t). Where plucker_verdict's
    six compares and this sign test differ (a NaN side), den is NaN and
    both miss."""
    den = s0 + s1 + s2
    mixed = (torch.fmin(torch.fmin(s0, s1), s2) < 0) & \
        (torch.fmax(torch.fmax(s0, s1), s2) > 0)
    tt = tnum * (1.0 / den)
    return ~mixed & (den != 0) & (tt >= tmin) & (tt < bt), tt


@contextlib.contextmanager
def _fp32_matmul():
    """FP32 matrix products on a CUDA card too (no TF32), restored after."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _orders(order, sel, s, C):
    return order[sel, s * KBV:(s + 1) * KBV].clamp(0, C - 1).long()


def lab12_reference(order, o3, d3, mm2, tris, mode: str) -> torch.Tensor:
    """Plain torch version of lab12 (mxu_lab.py:80-204): step s of every
    tile as batched (tiles, 32, 1,024) blocks."""
    if mode not in MODES["lab12"]:
        raise ValueError(f"lab12: no mode {mode}")
    dev = o3.device
    n_tiles = order.shape[0]
    C, nf = tris.shape[:2]
    rows = tris.reshape(C, nf, CLUSTER)
    bt = torch.where(mm2[..., 1] > BIG, BIG, mm2[..., 1])
    bi = torch.full((n_tiles, TILE), -1, dtype=torch.int32, device=dev)
    for s in range(STEPS_L12):
        for sel in torch.arange(n_tiles, device=dev).split(_REF_TILES):
            n = sel.numel()
            tri = rows[_orders(order, sel, s, C)].permute(0, 2, 1, 3).reshape(
                n, nf, 1, BK)
            tmin = mm2[sel][..., 0, None]
            bt_s = bt[sel]
            if mode == "mt":
                o = [o3[sel][..., q, None] for q in range(3)]
                d = [d3[sel][..., q, None] for q in range(3)]
                a, tt, uu, vv = _mt_test([tri[:, i] for i in range(9)], *o,
                                         *d)
                hit = (a != 0) & (uu >= 0) & (vv >= 0) & (uu + vv <= 1) & \
                    (tt >= tmin) & (tt < bt_s[..., None])
            else:
                hit, tt = _plucker_test(tri[:, :, 0], o3[sel], d3[sel], tmin,
                                        bt_s[..., None])
            cand, arg = torch.where(hit, tt, BIG).min(dim=2)
            closer = cand < bt_s
            bt[sel] = torch.where(closer, cand, bt_s)
            bi[sel] = torch.where(closer, (s * BK + arg).int(), bi[sel])
    return torch.stack([bt, bi.view(torch.float32)], -1)


def triangle_rows(order, tris, tiles, slots) -> torch.Tensor:
    """The rows (m, nf) of the triangle that each slot (m,) names in its
    tile (m,) of the walk."""
    C = tris.shape[0]
    s, pos = slots.long() // BK, slots.long() % BK
    c = order[tiles.long(), s * KBV + pos // CLUSTER].clamp(0, C - 1).long()
    return tris[c, :, 0, pos % CLUSTER]


def plucker_plain_of(inputs, tiles, lanes, slots):
    """The plain FP32 hit test of each ray (tile, lane) against the tris24
    triangle its slot names, with no best to beat: (hit (m,), t (m,))."""
    w = triangle_rows(inputs["order"], inputs["tris24"], tiles, slots)
    o3 = inputs["o3"][tiles, lanes][:, None]
    tmin = inputs["mm2"][tiles, lanes, 0][:, None, None]
    hit, tt = _plucker_test(w[..., None], o3,
                            inputs["d3"][tiles, lanes][:, None], tmin,
                            torch.full_like(tmin, BIG))
    return hit.reshape(-1), tt.reshape(-1)


def plucker_t64(inputs, tiles, lanes, slots) -> dict:
    """Each ray's (tile, lane) hit test against the tris24 triangle its
    slot names, in FP64: t, the test's verdict (hit), b_t, the rounding
    bound of the t that the kernel or the plain version computes, and
    margin, how far the verdict is from being decided by rounding. Each
    value the test reads (s0, s1, s2, den, t - t_min) has the bound
    SIDE_ROUNDING x the sum of its products' magnitudes (v = d x o's own
    FP32 rounding added; den's the sum of the sides', t's (tnum's + |t|
    den's) / |den|); margin is the smallest |value| over its bound. At
    most 1: the kernel's or the plain version's rounding can turn the
    verdict either way."""
    w = triangle_rows(inputs["order"], inputs["tris24"], tiles,
                      slots).double()
    o = inputs["o3"][tiles, lanes].double()
    d = inputs["d3"][tiles, lanes].double()
    tmin = inputs["mm2"][tiles, lanes, 0].double()
    v = torch.cross(d, o, dim=1)
    # |dy oz| + |dz oy| and its like: what v's FP32 rounding scales with
    vmag = (d[:, [1, 2, 0]] * o[:, [2, 0, 1]]).abs() + \
        (d[:, [2, 0, 1]] * o[:, [1, 2, 0]]).abs()
    u6 = torch.cat([d, v], 1)
    sides, bounds = [], []
    for e in range(3):
        r = w[:, 6 * e:6 * e + 6]
        sides.append((u6 * r).sum(1))
        bounds.append(SIDE_ROUNDING * (u6 * r).abs().sum(1) +
                      2.0 ** -23 * (vmag * r[:, 3:6].abs()).sum(1))
    tn_terms = torch.cat([-o, torch.ones_like(o[:, :1])], 1) * w[:, 18:22]
    tnum, b_tnum = tn_terms.sum(1), SIDE_ROUNDING * tn_terms.abs().sum(1)
    den, b_den = sum(sides), sum(bounds)
    t = tnum / den
    b_t = (b_tnum + t.abs() * b_den) / den.abs()
    s = torch.stack(sides)
    hit = (((s >= 0).all(0) | (s <= 0).all(0)) & (den != 0) & (t >= tmin))
    ratios = [x.abs() / b for x, b in zip(sides, bounds)]
    ratios += [den.abs() / b_den, (t - tmin).abs() / b_t]
    return dict(t=t, hit=hit, b_t=b_t,
                margin=torch.stack(ratios).min(0).values)


def mt_agreement(out: torch.Tensor, ref: torch.Tensor, inputs) -> dict:
    """The tie-aware hold of mt's kernel output (the brick walk's FMA body)
    against its unfused plain version (both (n_tiles, 32, 2)) on inputs
    (order, o3, d3, mm2, tris9), ray by ray: common.tie_aware_hold, each
    ray's winner (the tris9 triangle its slot names, order clamped) analysed
    in FP64 by common.mt_fp64; a ray keeps t = min(t_max, 3e38) (a NaN
    kept) on a miss."""
    o = inputs["o3"].reshape(-1, 3)
    d = inputs["d3"].reshape(-1, 3)
    mm = inputs["mm2"].reshape(-1, 2)

    def analyse(ray, ids):
        rows = triangle_rows(inputs["order"], inputs["tris9"], ray // TILE,
                             ids)
        return mt_fp64(rows, o[ray], d[ray], mm[ray, 0])

    def flat(x):
        return (x[..., 0].reshape(-1),
                x[..., 1].contiguous().view(torch.int32).reshape(-1))
    (t_k, id_k), (t_p, id_p) = flat(out), flat(ref)
    t_start = torch.where(mm[:, 1] > BIG, BIG, mm[:, 1])
    return tie_aware_hold(t_k, id_k, t_p, id_p, t_start, analyse)


def plucker_agreement(out: torch.Tensor, ref: torch.Tensor, inputs) -> dict:
    """The tie-aware hold of plucker's kernel output against its plain
    FP32 version (both (n_tiles, 32, 2)) on inputs (o3, d3, mm2, order,
    tris24). L11's rule (kernel_lab11.mxu_agreement) for this test:
      * t within TOL x max(1, |t|) of the plain t, or, where the ids agree,
        within b_t of t in FP64 (plucker_t64);
      * the ids equal, or a tie: the plain t of the kernel's triangle
        within TOL x max(1, |t|) of the plain best.
    One rule more, for a hit test that rounding decides (a winner's t
    within its rounding of t_min = 0, where the smallest t wins): the ids
    differ and the two sides' verdicts on one winner's test differ, that
    is, the plain test rejects the kernel's triangle, or the plain
    winner's FP64 t lies below the kernel's t by more than its b_t, so
    the kernel rejected it; FP64 puts that test within rounding of
    turning (margin <= 1), and so sides with one of the two; and the
    kernel's t lies within b_t of the FP64 t of its triangle. At most
    ILL_SHARE of the rays may take the two FP64 rules. Returns the ids
    that differ, the ties, the rays held by the FP64 rules
    (ill_conditioned; each in `held`: the rule, its winner's margin, whose
    verdict FP64 takes, the kernel's t error against b_t), the largest t
    difference, the rays that break the rule (rays_off), and ok."""
    t_k, t_p = out[..., 0], ref[..., 0]
    id_k = out[..., 1].contiguous().view(torch.int32)
    id_p = ref[..., 1].contiguous().view(torch.int32)
    scale = torch.clamp(t_p.abs(), min=1.0)
    diff_t = (t_k - t_p).abs()
    bad_t = ~(diff_t <= TOL * scale)
    diff = id_k != id_p
    tie = torch.zeros_like(diff)
    ill = torch.zeros_like(diff)
    held = []

    def note(rule, tiles, lanes, ok, t_err, b_t, margin=None, side=None):
        ill[tiles[ok], lanes[ok]] = True
        for i in torch.nonzero(ok).reshape(-1).tolist():
            h = dict(rule=rule, tile=int(tiles[i]), lane=int(lanes[i]),
                     id_k=int(id_k[tiles[i], lanes[i]]),
                     id_p=int(id_p[tiles[i], lanes[i]]),
                     t_err=float(t_err[i]), b_t=float(b_t[i]))
            if margin is not None:
                h.update(margin=float(margin[i]), fp64_sides_with=side[i])
            held.append(h)
    # L11's FP64 rule for t where the ids agree
    sel = torch.nonzero(bad_t & ~diff & (id_k >= 0))
    if sel.numel():
        tiles, lanes = sel[:, 0], sel[:, 1]
        f = plucker_t64(inputs, tiles, lanes, id_k[tiles, lanes])
        err = (t_k[tiles, lanes].double() - f["t"]).abs()
        note("t", tiles, lanes, err <= f["b_t"], err, f["b_t"])
    sel = torch.nonzero(diff)
    if sel.numel():
        tiles, lanes = sel[:, 0], sel[:, 1]
        ik, ip = id_k[tiles, lanes], id_p[tiles, lanes]
        tk = t_k[tiles, lanes]
        hit_pk, t_alt = plucker_plain_of(inputs, tiles, lanes,
                                         ik.clamp(min=0))
        is_tie = (ik >= 0) & ((t_alt - t_p[tiles, lanes]).abs()
                              <= TOL * scale[tiles, lanes])
        tie[tiles, lanes] = is_tie
        fk = plucker_t64(inputs, tiles, lanes, ik.clamp(min=0))
        fp = plucker_t64(inputs, tiles, lanes, ip.clamp(min=0))
        # the plain version rejected the kernel's winner, or the kernel
        # the plain one, and FP64 finds that test within rounding
        turn_k = (ik >= 0) & ~hit_pk & (fk["margin"] <= 1)
        turn_p = (ip >= 0) & (fp["t"] + fp["b_t"] < tk.double()) & \
            (fp["margin"] <= 1)
        err = (tk.double() - fk["t"]).abs()
        ok = ~is_tie & (turn_k | turn_p) & (ik >= 0) & (err <= fk["b_t"])
        margin = torch.where(turn_k, fk["margin"], fp["margin"])
        # a turned verdict: FP64's hit on the kernel's winner, or its miss
        # on the plain one, sides with the kernel
        with_k = torch.where(turn_k, fk["hit"], ~fp["hit"])
        note("turn", tiles, lanes, ok, err, fk["b_t"], margin,
             ["kernel" if x else "plain" for x in with_k.tolist()])
    bad = (bad_t & ~ill) | (diff & ~tie & ~ill)
    n = t_k.numel()
    return dict(ids_differ=int(diff.sum()), ties=int(tie.sum()),
                ill_conditioned=int(ill.sum()),
                max_abs_t=float(diff_t.max()),
                max_rel_t=float((diff_t / scale).max()),
                rays_off=int(bad.sum()), rays=n,
                ok=not bool(bad.any()) and int(ill.sum()) <= ILL_SHARE * n,
                held=held)


def run(device, reps: int = 5, tiles=None):
    """Both modes at the script's size (or its first `tiles` tiles), timed
    (common.timed_run; on the card also common.time_back_to_back):
    (inputs, [one dict per mode: mode, label, ms, min_ms, max_ms,
    ms_back_to_back (None on the CPU) with its min and max, gtests_s (the
    script's G ray-tri/s), bound_ms, bound_by, out])."""
    inp = lab12_inputs()
    if tiles is not None:
        inp = {k: v if k.startswith("tris") else v[:tiles]
               for k, v in inp.items()}
    inp = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
           for k, v in inp.items()}
    n_tiles = inp["order"].shape[0]
    res = []
    for mode in MODES["lab12"]:
        tris = inp["tris9" if mode == "mt" else "tris24"]
        def call():
            return lab12(inp["order"], inp["o3"], inp["d3"], inp["mm2"],
                         tris, mode)
        out, t = timed_run(call, device, reps)
        t.update(time_back_to_back(call, reps) if device.type == "cuda"
                 else dict.fromkeys(("ms_back_to_back", "min_ms_back_to_back",
                                     "max_ms_back_to_back")))
        tests = n_tiles * TILE * STEPS_L12 * BK
        b_ms, b_by = lab12_bound(mode, n_tiles)
        res.append(dict(mode=mode, label=LABELS[mode], **t,
                        gtests_s=tests / (t["ms"] * 1e6), bound_ms=b_ms,
                        bound_by=b_by, out=out))
    return inp, res


def main(argv=None) -> int:
    dev = parse_args(sys.argv[1:] if argv is None else argv, __doc__)
    unit = "ms" if dev.type == "cuda" else "host ms (cpu plain)"
    if dev.type == "cuda":
        print(card(), flush=True)
    inp, res = run(dev)
    for r in res:
        b2b = "" if r["ms_back_to_back"] is None else \
            f", {r['ms_back_to_back']:.4f} ms back to back"
        print(f"{r['label']:28s}: {r['ms']:7.2f} {unit}  "
              f"({r['gtests_s']:6.1f} G ray-tri/s; bound {r['bound_ms']:.4f} "
              f"ms, {r['bound_by']}{b2b})", flush=True)
    for r, hold in zip(res, (mt_agreement, plucker_agreement)):
        tris = inp["tris9" if r["mode"] == "mt" else "tris24"]
        ref = r["out"] if dev.type == "cpu" else lab12_reference(
            inp["order"], inp["o3"], inp["d3"], inp["mm2"], tris, r["mode"])
        agree = hold(r["out"], ref, inp)
        print(f"{r['mode']} against its plain version: " + ", ".join(
            f"{k} {v}" for k, v in agree.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
