"""L11, the counterpart of scripts/kernel_lab11.py: can the Baldwin-Weber
test run as matrix products? A synthetic stream with the whole table
resident: C = 1,024 clusters of random triangles, 4,096 tiles of 32 random
rays, 8 steps a tile, step i of tile g testing clusters (8i + j + g) mod C,
j < 8. Modes:

  vpu  K1's FP32 step over the rows tris12 (C, 12, 1, 128); on the card
       L9's walk and FMA body (csrc/k1_lab.cu lab11_vpu_kernel), held
       tie-aware to the plain version (vpu_agreement);
  mxu  the same test as six products a step over the table (C, 3, 4, 128)
       [type (n, r1, r2), row (x, y, z, -v.v0), triangle]: o4 = [o | 1]
       times each type (n.o - n.v0, r1.o - r1.v0, r2.o - r2.v0) and d times
       each type's x, y, z rows (n.d, r1.d, r2.d), then t = -(n.o - n.v0) /
       n.d, u = (r1.o - r1.v0) + t r1.d, v likewise. On the card the
       products are mma.sync m16n8k4 in TF32, each operand split in two
       (hi + lo, three products) to come near FP32, and the epilogue takes
       FMAs; the plain version takes them in FP32, so the two agree by a
       tolerance, not bit for bit (mxu_agreement).

    python -m tauray_torch.lab.kernel_lab11 [--device=cpu]

prints, per mode, ms (CUDA events), us per step and Gtests/s, then how the
two modes agree, as the script does."""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops.trace_kernel import _check
from .common import (BIG, CLUSTER, FLOPS_BW, ILL_SHARE, KBV, PEAK_FP32,
                     PEAK_TF32, TILE, bound, bw_fp64, card, lab11_inputs,
                     parse_args, tie_aware_hold, timed_run)
from .kernel_lab9 import _hit
from .lab_kernel import MODES, check_tiles, launch, on_card

# tiles per batched block of the plain version: (tiles, 32, 1024) f32
# temporaries of 32 MB each
_REF_TILES = 256
# TF32 operations of the six products of one test (3 with K = 4, 3 with
# K = 3, a multiply and an add each), and FP32 ones of the epilogue: the
# reciprocal, t, u, v, u + v and the six comparisons of the hit test
TF32_OPS = 3 * 8 + 3 * 6
FLOPS_EPILOGUE = 15
# the split in two takes three products for one
SPLIT = 3
# mxu against the plain FP32 version: t within TOL * max(1, |t|)
TOL = 1e-5
# A product in TF32 split in two errs by up to about 2^-21 of the sum of
# its terms' magnitudes (the dropped lo.lo and the TF32 rounding of each
# lo, 2^-22 each), eight times FP32's rounding; where t = -on / den is
# ill-conditioned (a grazing ray, an origin near the plane), that exceeds
# TOL. Such a ray is held instead to t in FP64 within its forward error
# bound, 2^-21 (sum |o n| + |n.v0| + |t| sum |d n|) / |den|, and at most
# ILL_SHARE of the rays may take that rule (measured on the H100: 2 of
# 131,072, condition 115 and 470, at 0.41 of the bound; PERF.md).
GAMMA_3XTF32 = 2.0 ** -21


def lab11(steps: torch.Tensor, rays: torch.Tensor, tris: torch.Tensor,
          mode: str) -> torch.Tensor:
    """One mode of the stream. steps (n_tiles,) i32; rays (n_tiles, 32, 8)
    f32 [o | d | t_min | unused]; tris (C, 12, 1, 128) f32 for vpu or
    (C, 3, 4, 128) f32 for mxu. Returns (n_tiles, 32, 2) f32: the best t
    (3e38 on a miss), then the id's int32 bits (-1 on a miss)."""
    if not on_card(rays):
        return lab11_reference(steps, rays, tris, mode)
    check_tiles(steps, rays, 8, "lab11", group=False)
    _check(tris, "tris", torch.float32, 4, rays.device)
    want = (12, 1, CLUSTER) if mode == "vpu" else (3, 4, CLUSTER)
    if tuple(tris.shape[1:]) != want or tris.shape[0] < 1:
        raise ValueError(f"lab11 {mode}: tris {tuple(tris.shape)}")
    return launch("lab11", mode, steps, None, rays, tris=tris)


def _mxu_test(tri, o, d, tmin, bt):
    """The six products in FP32 and the epilogue of kernel_lab11.py:87-112:
    tri (n, 1, 12, L) rows [n | -n.v0 | r1 | -r1.v0 | r2 | -r2.v0], rays
    (n, 32, 1). Returns (hit closer than bt, t)."""
    ox, oy, oz = (o[..., k, None] for k in range(3))
    dx, dy, dz = (d[..., k, None] for k in range(3))

    def odot(v):
        return (ox * tri[:, :, 4 * v] + oy * tri[:, :, 4 * v + 1] +
                oz * tri[:, :, 4 * v + 2] + tri[:, :, 4 * v + 3])

    def ddot(v):
        return (dx * tri[:, :, 4 * v] + dy * tri[:, :, 4 * v + 1] +
                dz * tri[:, :, 4 * v + 2])
    den = ddot(0)
    f = torch.where(den != 0, 1.0 / torch.where(den == 0, 1.0, den), 0.0)
    tt = -odot(0) * f
    uu = odot(1) + tt * ddot(1)
    vv = odot(2) + tt * ddot(2)
    hit = (den != 0) & (uu >= 0) & (vv >= 0) & (uu + vv <= 1) & \
        (tt >= tmin[..., None]) & (tt < bt[..., None])
    return hit, tt


def lab11_reference(steps, rays, tris, mode: str) -> torch.Tensor:
    """Plain torch version of lab11 (kernel_lab11.py:64-123): step i of
    every tile with steps > i as one batched (tiles, 32, 1024) block."""
    if mode not in MODES["lab11"]:
        raise ValueError(f"lab11: no mode {mode}")
    dev = rays.device
    n_tiles = steps.shape[0]
    C = tris.shape[0]
    rows = tris.reshape(C, 12, CLUSTER)
    bt = torch.full((n_tiles, TILE), BIG, dtype=torch.float32, device=dev)
    bi = torch.full((n_tiles, TILE), -1, dtype=torch.int32, device=dev)
    steps_l = steps.long()
    j = torch.arange(KBV, device=dev)
    for i in range(int(steps_l.max()) if n_tiles else 0):
        for sel in torch.nonzero(steps_l > i).squeeze(1).split(_REF_TILES):
            n = sel.numel()
            orders = (i * KBV + j[None] + sel[:, None]) % C        # (n, 8)
            tri = rows[orders].permute(0, 2, 1, 3).reshape(
                n, 1, 12, KBV * CLUSTER)
            r = rays[sel]
            bt_s = bt[sel]
            if mode == "vpu":
                hit, tt = _hit([tri[:, :, k] for k in range(12)], r[..., 0:3],
                               r[..., 3:6], r[..., 6], bt_s)
            else:
                hit, tt = _mxu_test(tri, r[..., 0:3], r[..., 3:6], r[..., 6],
                                    bt_s)
            cand, arg = torch.where(hit, tt, BIG).min(dim=2)
            closer = cand < bt_s
            win = torch.gather(orders, 1, arg // CLUSTER)
            bt[sel] = torch.where(closer, cand, bt_s)
            bi[sel] = torch.where(
                closer, (win * CLUSTER + arg % CLUSTER).int(), bi[sel])
    return torch.stack([bt, bi.view(torch.float32)], -1)


def vpu_agreement(out: torch.Tensor, ref: torch.Tensor, rays: torch.Tensor,
                  tris12: torch.Tensor) -> dict:
    """The tie-aware hold of vpu's kernel output (the FMA body) against its
    plain version (both (n_tiles, 32, 2)) on their inputs:
    common.tie_aware_hold, each ray's winner analysed in FP64 by
    common.bw_fp64, as kernel_lab9.lab9_agreement holds L9; the id is the
    cluster x 128 + lane, and a ray that hits nothing keeps t = 3e38."""
    C = tris12.shape[0]
    rows = tris12.reshape(C, 12, CLUSTER)
    r8 = rays.reshape(-1, 8)

    def analyse(ray, ids):
        return bw_fp64(rows[(ids // CLUSTER).long(), :,
                            (ids % CLUSTER).long()], r8[ray, 0:3],
                       r8[ray, 3:6], r8[ray, 6])

    def flat(x):
        return (x[..., 0].reshape(-1),
                x[..., 1].contiguous().view(torch.int32).reshape(-1))
    return tie_aware_hold(*flat(out), *flat(ref),
                          torch.full_like(r8[:, 0], BIG), analyse)


def mxu_t_of(rays: torch.Tensor, m: torch.Tensor,
             ids: torch.Tensor) -> torch.Tensor:
    """The plain FP32 t of each ray (R, 8) against the triangle its id
    (R,) names in the matrix table m (C, 3, 4, 128), hit or not (ids >=
    0)."""
    c, lane = ids.long() // CLUSTER, ids.long() % CLUSTER
    tri = m.reshape(m.shape[0], 12, CLUSTER)[c, :, lane]      # (R, 12)
    tt = _mxu_test(tri[:, None, :, None], rays[:, None, 0:3],
                   rays[:, None, 3:6], rays[:, None, 6],
                   torch.full_like(rays[:, None, 6], BIG))[1]
    return tt.reshape(-1)


def mxu_t64(rays: torch.Tensor, m: torch.Tensor, ids: torch.Tensor):
    """(t, bound) in FP64 of each ray (R, 8) against the triangle its id
    (R,) names in m (C, 3, 4, 128): the exact t of the matrix form and the
    forward error bound of the kernel's t (GAMMA_3XTF32)."""
    c, lane = ids.long() // CLUSTER, ids.long() % CLUSTER
    tri = m.reshape(m.shape[0], 12, CLUSTER)[c, :, lane].double()
    o, d = rays[:, 0:3].double(), rays[:, 3:6].double()
    n, nd = tri[:, 0:3], tri[:, 3]
    den = (d * n).sum(1)
    t = -((o * n).sum(1) + nd) / den
    bound = GAMMA_3XTF32 * ((o * n).abs().sum(1) + nd.abs() +
                            t.abs() * (d * n).abs().sum(1)) / den.abs()
    return t, bound


def mxu_agreement(out: torch.Tensor, ref: torch.Tensor, rays: torch.Tensor,
                  m: torch.Tensor) -> dict:
    """The tie-aware hold of mxu's kernel output against its plain FP32
    version (both (n_tiles, 32, 2)): t within TOL * max(1, |t|) of the
    plain t, or, on an ill-conditioned ray with the plain version's id,
    within GAMMA_3XTF32's bound of t in FP64 (mxu_t64); the ids equal, or
    where they differ the plain t of the kernel's triangle within TOL of
    the plain best (a tie). Returns the share of ids equal, the largest
    relative t difference, the rays held by the FP64 rule
    (ill_conditioned), the rays that break every rule (rays_off), and ok:
    none does and at most ILL_SHARE of the rays needed the FP64 rule."""
    t_k, t_p = out[..., 0].reshape(-1), ref[..., 0].reshape(-1)
    id_k = out[..., 1].reshape(-1).view(torch.int32)
    id_p = ref[..., 1].reshape(-1).view(torch.int32)
    r8 = rays.reshape(-1, 8)
    scale = torch.clamp(t_p.abs(), min=1.0)
    rel = (t_k - t_p).abs() / scale
    bad_t = ~(rel <= TOL)
    diff = id_k != id_p
    ill = torch.zeros_like(diff)
    sel = torch.nonzero(bad_t & ~diff & (id_k >= 0)).squeeze(1)
    if sel.numel():
        t64, bound = mxu_t64(r8[sel], m, id_k[sel])
        ill[sel] = (t_k[sel].double() - t64).abs() <= bound
    tie_ok = torch.ones_like(diff)
    if bool(diff.any()):
        sel = torch.nonzero(diff & (id_k >= 0)).squeeze(1)
        t_alt = mxu_t_of(r8[sel], m, id_k[sel])
        tie_ok[sel] = (t_alt - t_p[sel]).abs() <= TOL * scale[sel]
        tie_ok[diff & (id_k < 0)] = False
    bad = (bad_t & ~ill) | (diff & ~tie_ok)
    n = t_k.numel()
    return dict(id_match=float((~diff).float().mean()),
                ids_differ=int(diff.sum()), ties=int((diff & tie_ok).sum()),
                max_rel_t=float(rel.max()),
                ill_conditioned=int(ill.sum()), rays_off=int(bad.sum()),
                rays=n, ok=not bool(bad.any()) and
                int(ill.sum()) <= ILL_SHARE * n)


def lab11_bound(n_tiles: int, n_steps: int, n_clusters: int, mode: str):
    """(ms, what sets it): vpu 32 FP32 operations a test; mxu the larger
    of its TF32 products (x 3 for the split) on the tensor cores and its
    FP32 epilogue on the CUDA cores, which can run at once. Bytes: the
    rays, the output and the table once."""
    tests = n_tiles * n_steps * KBV * CLUSTER * TILE
    nbytes = n_tiles * TILE * (32 + 8) + n_clusters * 12 * CLUSTER * 4
    if mode == "vpu":
        return bound(tests * FLOPS_BW, nbytes)
    ops_ms = max(tests * TF32_OPS * SPLIT / PEAK_TF32,
                 tests * FLOPS_EPILOGUE / PEAK_FP32) * 1e3
    b_ms, b_by = bound(0, nbytes)
    return (ops_ms, "operations") if ops_ms >= b_ms else (b_ms, b_by)


def run(device, reps: int = 5, seed: int = 0, **sizes):
    """Both modes over the script's stream (sizes: C, n_tiles, n_steps of
    common.lab11_inputs): (inputs, [one dict per mode: mode, ms, min_ms,
    us_per_step, gtests_s, bound_ms, bound_by, out])."""
    steps, rays, tris12, m = (torch.from_numpy(x).to(device)
                              for x in lab11_inputs(seed=seed, **sizes))
    n_tiles, n_steps = steps.shape[0], int(steps[0]) if len(steps) else 0
    res = []
    for mode, tris in (("vpu", tris12), ("mxu", m)):
        out, t = timed_run(lambda: lab11(steps, rays, tris, mode), device,
                           reps)
        total = n_tiles * n_steps
        b_ms, b_by = lab11_bound(n_tiles, n_steps, tris.shape[0], mode)
        res.append(dict(mode=mode, **t, us_per_step=t["ms"] * 1e3 / total,
                        gtests_s=total * TILE * KBV * CLUSTER /
                        (t["ms"] * 1e6), bound_ms=b_ms, bound_by=b_by,
                        out=out))
    return dict(steps=steps, rays=rays, tris12=tris12, m=m), res


def main(argv=None) -> int:
    dev = parse_args(sys.argv[1:] if argv is None else argv, __doc__)
    unit = "ms" if dev.type == "cuda" else "host ms (cpu plain)"
    if dev.type == "cuda":
        print(card(), flush=True)
    _, res = run(dev)
    for r in res:
        print(f"{r['mode']}: {r['ms']:7.3f} {unit}  {r['us_per_step']:6.4f} "
              f"us/step {r['gtests_s']:7.1f} Gtests/s (bound "
              f"{r['bound_ms']:.3f} ms, {r['bound_by']})", flush=True)
    a, b = (r["out"].cpu().numpy() for r in res)
    ids_a, ids_b = a[:, :, 1].view(np.int32), b[:, :, 1].view(np.int32)
    print("t allclose:", np.allclose(a[:, :, 0], b[:, :, 0], rtol=1e-4,
                                     atol=1e-5),
          " id match:", float((ids_a == ids_b).mean()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
