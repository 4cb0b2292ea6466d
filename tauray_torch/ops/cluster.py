"""Cluster tracers: the torch counterparts of tauray_tpu.ops.cluster's
ClusterTracer (flat) and InstancedClusterTracer (the TLAS path of
--as-strategy=per-model / per-material).

  * the host builds (numpy SAH splits into CLUSTER-triangle clusters,
    cluster alignment, alpha segregation, per-mesh object clusters and
    the cluster-instance list) are the JAX package's, unchanged;
  * every trace runs phase 1: a slab cull of every ray against every
    cluster (or cluster-instance) AABB, reduced per 32-ray tile into a row
    of keys. On the card the id-key path (flat scenes of at most
    VM_FITS_CLUSTERS clusters, the default kernel) takes one hand-written
    kernel, trace_kernel.phase1_ids, which writes each row ascending and
    sorts nothing; the entry-t keys, and every phase 1 on the CPU, are
    torch passes, each row then sorted;
  * phase 2 is a traversal kernel (ops/trace_kernel.py), chosen as the
    JAX package chooses its Pallas kernel: flat scenes of at most
    VM_FITS_CLUSTERS clusters take id-only keys and trace_tiles_vm3
    (_kernel_vm3), or, when TAURAY_VM_KERNEL is set to anything but v3,
    entry-t keys and the front-to-back trace_tiles_vm2 (_kernel_vm2) over
    the same Baldwin-Weber rows; larger flat scenes take entry-t keys and
    trace_tiles (_kernel); the instanced tracer takes entry-t keys and
    trace_tiles_inst (_kernel_inst);
  * flat bounce and shadow waves are first sorted by their active-set
    signature (_sig_sort_perm) and un-permuted by an int32 inverse
    permutation gather; the instanced tracer traces waves as given.

The torch phase 1 and the signature pass are dense (rays x clusters)
slab tests. Eager torch materialises them, so both run over chunks of ray
blocks sized to PHASE1_BUDGET_BYTES of temporaries.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, replace
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .. import tracing
from .bvh import morton_3d
from .intersect import Hit
from .sampling import cross
from ..scene.device import resolve_device
from .trace_kernel import (KB, TILE as PT, phase1_ids, trace_tiles,
                           trace_tiles_inst, trace_tiles_vm2,
                           trace_tiles_vm3)

CLUSTER = 128       # triangles per cluster (tauray_tpu.ops.cluster.CLUSTER)
TILE = 128          # rays per slab-test block; PT-ray kernel tiles divide it
KEY_SENTINEL = 0x7FFFFFFF
BIG = 3e38
# Largest flat scene traced over the Baldwin-Weber rows (trace_tiles_vm3,
# or trace_tiles_vm2 under TAURAY_VM_KERNEL). The JAX package keeps that
# path for tables that fit its TPU kernels' 13.5 MB VMEM budget
# (pallas_trace.vm_fits: C * 12 * 128 * 4 B <= 13.5e6, so C <= 2,197) and
# traces larger scenes front to back with _kernel; the port draws the same
# line so that both packages compute the same thing.
VM_FITS_CLUSTERS = 2197

# Budget for the (blocks, clusters, TILE) float temporaries of the torch
# slab passes: the signature pass, the entry-t phase 1 (_phase1_entry) and
# phase 1 on the CPU (the id-key phase 1 on the card is one kernel and
# makes none). About eight such tensors are alive at once, so each chunk
# of ray blocks is sized to an eighth of this. Unchunked, one such tensor
# of a 2^20-ray wave on a 2,116-cluster scene is 8.9 GB; with this budget a
# whole 1080p Sponza-class frame peaked at 2.34 GiB of device memory
# (NVIDIA H100 80GB HBM3, chip_smoke.py, before phase 1 had its kernel).
PHASE1_BUDGET_BYTES = 2 << 30
_LIVE_TEMPS = 8

# every wave handed to a tracer (trace and trace_flagged) and its rays,
# summed since the last reset_traced(); app/bench.py reads them per frame
TRACED: Dict[str, int] = {"waves": 0, "rays": 0}


def reset_traced() -> None:
    TRACED.update(waves=0, rays=0)


def _count_wave(rays: int) -> None:
    TRACED["waves"] += 1
    TRACED["rays"] += rays


@dataclass
class ClusterTracer:
    v0: torch.Tensor          # (C, CLUSTER, 3) triangle blocks, slot order
    e1: torch.Tensor
    e2: torch.Tensor
    tri_valid: torch.Tensor   # (C, CLUSTER) bool
    to_orig: torch.Tensor     # (C*CLUSTER,) i32 slot -> original triangle
    cmin: Optional[torch.Tensor]   # (C, 3) cluster AABBs
    cmax: Optional[torch.Tensor]
    n_clusters: int
    # (C*CLUSTER, 9) [v0|e1|e2] rows for the barycentric post-pass
    tris_flat: Optional[torch.Tensor] = None
    # first slot of the alpha-capable tail clusters (build_cluster_tracer
    # segregates them), so "might be transparent" is slot >= alpha_base
    alpha_base: Optional[int] = None
    # (C, 12, 1, CLUSTER) Baldwin-Weber rows [n | n.v0 | r1 | r1.v0 |
    # r2 | r2.v0], the triangle table of trace_tiles_vm3 / _vm2
    tris12: Optional[torch.Tensor] = None
    # slot_ids=True: trace() returns raw slot ids (no to_orig remap), for
    # callers whose scene tables are permuted into slot order
    slot_ids: bool = False
    # (C, 9, 1, CLUSTER) v0/e1/e2 components by lane, trace_tiles' table
    tris9: Optional[torch.Tensor] = None
    # (C,) i32: 1 when every valid triangle of the cluster is opaque, so
    # an any-hit trace can stop at the first hit there
    opaque: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.alpha_base is None:
            self.alpha_base = self.n_clusters * CLUSTER
        if self.opaque is None:
            self.opaque = torch.ones(self.n_clusters, dtype=torch.int32,
                                     device=self.device)

    @property
    def device(self) -> torch.device:
        return self.v0.device

    def with_kernel_layout(self) -> "ClusterTracer":
        """tris12, tris9 and tris_flat tables (tauray_tpu's
        with_pallas_layout). Baldwin-Weber rows: n = e1 x e2;
        r1 = (e2 x n)/|n|^2 and r2 = (n x e1)/|n|^2, so a hit point p gives
        u = r1.p - r1.v0, v = r2.p - r2.v0 and t = (n.v0 - n.o)/(n.d).
        Degenerate triangles get n = r = 0 and fail the den != 0 test."""
        tris_flat = torch.cat([self.v0, self.e1, self.e2],
                              dim=-1).reshape(-1, 9)
        n = cross(self.e1, self.e2)
        det = (n * n).sum(-1, keepdim=True)
        inv_det = torch.where(
            det > 0, 1.0 / torch.where(det == 0, 1.0, det), 0.0)
        r1 = cross(self.e2, n) * inv_det
        r2 = cross(n, self.e1) * inv_det

        def dotv0(x):
            return (x * self.v0).sum(-1, keepdim=True)
        bw = torch.cat([n, dotv0(n), r1, dotv0(r1), r2, dotv0(r2)], dim=-1)
        tris12 = bw.transpose(1, 2)[:, :, None, :].contiguous()
        return replace(self, tris_flat=tris_flat, tris12=tris12,
                       tris9=_tris9(self.v0, self.e1, self.e2))

    # ------------------------------------------------------------------
    def trace(self, origins, dirs, t_min, t_max, any_hit: bool = False,
              sort_rays: bool = False, need_uv: bool = True) -> Hit:
        return self.trace_flagged(origins, dirs, t_min, t_max,
                                  any_hit=any_hit, sort_rays=sort_rays,
                                  need_uv=need_uv)[0]

    def trace_flagged(self, origins, dirs, t_min, t_max,
                      any_hit: bool = False, sort_rays: bool = False,
                      need_uv: bool = True
                      ) -> Tuple[Hit, torch.Tensor]:
        """Closest hit per ray, plus (R,) bool marking hits on
        alpha-capable triangles (slot id >= alpha_base). On the id-only
        key path (C <= VM_FITS_CLUSTERS, the default) the kernel has no
        early exit, so any_hit traces are closest-hit traces; the
        front-to-back kernels (larger scenes, or TAURAY_VM_KERNEL=v2)
        stop an any_hit ray at its first hit in an all-opaque cluster.

        sort_rays: reorder the wave by its active-set signature before
        tiling (bounce and shadow waves); camera waves keep pixel-block
        order."""
        with tracing.span("trace_wave"):
            R = origins.shape[0]
            _count_wave(R)
            rays8 = _pack_rays(origins, dirs, t_min, t_max)
            if sort_rays:
                with tracing.span("sig_sort"):
                    perm = _sig_sort_perm(self, rays8)
                    rays8 = rays8[perm]
                hit = _trace_padded(self, rays8, any_hit, need_uv)
                # un-permute by an inverse-permutation GATHER; ids stay
                # int32
                inv = torch.empty_like(perm)
                inv[perm] = torch.arange(perm.shape[0], device=perm.device)
                hit = Hit(*(x[inv] for x in hit))
            else:
                hit = _trace_padded(self, rays8, any_hit, need_uv)
            t, tid, u, v = (x[:R] for x in hit)
            alpha_flag = tid >= self.alpha_base
            if not self.slot_ids:
                tid = torch.where(
                    tid >= 0, self.to_orig[tid.clamp(min=0).long()], -1)
        return Hit(t, tid, u, v), alpha_flag


def _pack_rays(origins, dirs, t_min, t_max) -> torch.Tensor:
    """(R', 8) [o|d|t_min|t_max] rows, R' the ray count rounded up to a
    TILE multiple with dead filler rays (t_max = 0)."""
    o = origins.to(torch.float32)
    d = dirs.to(torch.float32)
    R = o.shape[0]
    t_min = torch.as_tensor(t_min, dtype=torch.float32,
                            device=o.device).expand(R)
    t_max = torch.as_tensor(t_max, dtype=torch.float32,
                            device=o.device).expand(R)
    rays8 = torch.cat([o, d, t_min[:, None], t_max[:, None]], dim=1)
    pad = (-R) % TILE
    if pad:
        filler = torch.zeros((pad, 8), dtype=torch.float32, device=o.device)
        filler[:, 3:7] = 1.0              # d = 1, t_min = 1, t_max = 0
        rays8 = torch.cat([rays8, filler])
    return rays8


def _tris9(v0, e1, e2) -> torch.Tensor:
    """(C, 9, 1, CLUSTER) v0/e1/e2 components by lane (tauray_tpu
    with_pallas_layout's tris9)."""
    comps = torch.cat([v0.transpose(1, 2), e1.transpose(1, 2),
                       e2.transpose(1, 2)], dim=1)
    return comps[:, :, None, :].contiguous()


def _sah_order(tri_pos, ids) -> np.ndarray:
    """Top-down splits with axis and cut chosen by surface-area cost over
    CLUSTER-aligned cuts: cost(k) = SA(prefix AABB)*k + SA(suffix
    AABB)*(n-k) on the coordinate-sorted list."""
    centroids = tri_pos.mean(axis=1)
    tlo = tri_pos.min(axis=1)
    thi = tri_pos.max(axis=1)
    out = []
    stack = [np.asarray(ids)]
    while stack:
        cur = stack.pop()
        n = len(cur)
        if n <= CLUSTER:
            out.append(cur)
            continue
        best = None
        for ax in range(3):
            o = cur[np.argsort(centroids[cur, ax], kind="stable")]
            lo = tlo[o]
            hi = thi[o]
            pre_lo = np.minimum.accumulate(lo)
            pre_hi = np.maximum.accumulate(hi)
            suf_lo = np.minimum.accumulate(lo[::-1])[::-1]
            suf_hi = np.maximum.accumulate(hi[::-1])[::-1]

            def sa(lo_, hi_):
                dd = np.maximum(hi_ - lo_, 0)
                return dd[:, 0] * dd[:, 1] + dd[:, 1] * dd[:, 2] + \
                    dd[:, 2] * dd[:, 0]
            ks = np.arange(CLUSTER, n, CLUSTER)
            if not len(ks):
                ks = np.array([n // 2])
            cost = sa(pre_lo[ks - 1], pre_hi[ks - 1]) * ks + \
                sa(suf_lo[ks], suf_hi[ks]) * (n - ks)
            j = int(np.argmin(cost))
            if best is None or cost[j] < best[0]:
                best = (cost[j], o, int(ks[j]))
        _, o, k = best
        stack.append(o[k:])
        stack.append(o[:k])
    return np.concatenate(out)


def tri_opacity(tri_instance, inst_has_alpha) -> np.ndarray:
    """(T,) bool — triangle's instance has no alpha-capable material."""
    inst = np.maximum(np.asarray(tri_instance), 0)
    return ~np.asarray(inst_has_alpha)[inst]


def build_cluster_tracer(tri_pos, tri_instance, tri_opaque=None,
                         strategy: str = "all-merged-static",
                         inst_dynamic=None, inst_entity=None, device=None
                         ) -> Tuple[ClusterTracer, np.ndarray]:
    """Host-side build, as tauray_tpu.ops.cluster.build_cluster_tracer with
    its default SAH builder. Returns (tracer on `device`, perm).

    strategy mirrors --as-strategy's grouping: clusters never span group
    boundaries (all-merged-static: one group; per-material: one group per
    instance; per-model: one per entity; static-merged-dynamic-per-model:
    static instances share one group, each dynamic entity gets its own).
    Alpha-capable triangles go to the tail clusters. device=None means
    the CUDA card (raises without one)."""
    device = resolve_device(device)
    tri_pos = np.asarray(tri_pos)
    tri_instance = np.asarray(tri_instance)
    valid = tri_instance >= 0
    T = tri_pos.shape[0]
    centroids = tri_pos.mean(axis=1)
    sel = valid if valid.any() else np.ones(T, bool)
    lo = centroids[sel].min(axis=0)
    hi = centroids[sel].max(axis=0)
    ext = np.maximum(hi - lo, 1e-12)

    inst = np.maximum(tri_instance, 0)
    ent = (np.asarray(inst_entity) if inst_entity is not None
           else np.arange(int(inst.max()) + 1 if len(inst) else 1))
    if strategy == "per-material":
        group = inst
    elif strategy == "per-model":
        group = ent[inst]
    elif strategy == "static-merged-dynamic-per-model" and \
            inst_dynamic is not None and np.asarray(inst_dynamic).any():
        dyn = np.asarray(inst_dynamic, bool)
        group = np.where(dyn[inst], ent[inst] + 1, 0)
    else:
        group = np.zeros(T, np.int64)

    if tri_opaque is not None:
        tri_alpha = (~np.asarray(tri_opaque, bool)) & valid
    else:
        tri_alpha = np.zeros(T, bool)
    any_alpha = bool(tri_alpha.any())

    order = None
    parts = []
    for a_val in (False, True):
        sel = valid & (tri_alpha == a_val)
        for g in np.unique(group[sel]) if sel.any() else []:
            ids = np.flatnonzero(sel & (group == g))
            if len(ids):
                parts.append(_sah_order(tri_pos, ids))
    if parts:
        inval = np.flatnonzero(~valid)
        order = np.concatenate(parts + ([inval] if len(inval) else []))
    else:
        grid = np.clip(((centroids - lo) / ext) * 1023.0,
                       0, 1023).astype(np.uint32)
        codes = morton_3d(grid).astype(np.uint64)
        gkey = np.asarray(group, np.uint64) * (np.uint64(1) << 34) + \
            tri_alpha.astype(np.uint64) * (np.uint64(1) << 49) + \
            (~valid).astype(np.uint64) * (np.uint64(1) << 50)
        order = np.lexsort((np.arange(T), codes + gkey))

    # cluster-align each (alpha, group) segment
    seg = np.asarray(group) * 2 + tri_alpha
    gsorted = seg[order]
    n_valid = int(valid.sum())
    if n_valid and (strategy != "all-merged-static" or any_alpha):
        pieces = []
        vmask = []
        gs = gsorted[:n_valid]
        bounds = np.flatnonzero(np.diff(gs)) + 1
        start = 0
        for end in list(bounds) + [n_valid]:
            seg = order[start:end]
            pad = (-len(seg)) % CLUSTER
            pieces.append(seg)
            vmask.append(np.ones(len(seg), bool))
            if pad:
                pieces.append(np.full(pad, seg[-1], np.int32))
                vmask.append(np.zeros(pad, bool))
            start = end
        perm = np.concatenate(pieces).astype(np.int32)
        valid_perm = np.concatenate(vmask)
        C = len(perm) // CLUSTER
        total = C * CLUSTER
    else:
        C = max((n_valid + CLUSTER - 1) // CLUSTER, 1)
        total = C * CLUSTER
        perm = np.full(total, order[0] if T else 0, dtype=np.int32)
        n_copy = min(T, total)
        perm[:n_copy] = order[:n_copy]
        valid_perm = np.zeros(total, dtype=bool)
        valid_perm[:n_valid] = True

    if tri_opaque is not None:
        op = np.asarray(tri_opaque, bool)[perm] | ~valid_perm
    else:
        op = np.ones(total, bool)
    cluster_opaque = op.reshape(C, CLUSTER).all(axis=1).astype(np.int32)
    slot_alpha = tri_alpha[perm] & valid_perm
    if slot_alpha.any():
        alpha_base = int(np.flatnonzero(slot_alpha)[0]) // CLUSTER * CLUSTER
    else:
        alpha_base = total

    def dev(x):
        return torch.from_numpy(np.require(x, requirements=["C", "W"])
                                ).to(device)
    empty = torch.zeros((C, CLUSTER, 3), dtype=torch.float32, device=device)
    tracer = ClusterTracer(
        v0=empty, e1=empty, e2=empty,
        tri_valid=dev(valid_perm.reshape(C, CLUSTER)), to_orig=dev(perm),
        cmin=None, cmax=None, n_clusters=C, alpha_base=alpha_base,
        opaque=dev(cluster_opaque))
    return refit_cluster_tracer(tracer, tri_pos, perm), perm


def refit_cluster_tracer(tracer: ClusterTracer, tri_pos, perm
                         ) -> ClusterTracer:
    """Per-frame refit: triangle blocks, cluster AABBs, kernel tables."""
    C = tracer.n_clusters
    dev = tracer.device
    tri_pos = torch.as_tensor(tri_pos, dtype=torch.float32, device=dev)
    perm = torch.as_tensor(perm, device=dev).long()
    pos = tri_pos[perm]
    v0 = pos[:, 0].reshape(C, CLUSTER, 3)
    e1 = (pos[:, 1] - pos[:, 0]).reshape(C, CLUSTER, 3)
    e2 = (pos[:, 2] - pos[:, 0]).reshape(C, CLUSTER, 3)
    corners = pos.reshape(C, CLUSTER * 3, 3)
    valid = tracer.tri_valid.repeat_interleave(3, dim=1)[..., None]
    cmin = torch.where(valid, corners, BIG).amin(dim=1)
    cmax = torch.where(valid, corners, -BIG).amax(dim=1)
    return replace(tracer, v0=v0, e1=e1, e2=e2, cmin=cmin,
                   cmax=cmax).with_kernel_layout()


def _from_numpy(fields: Dict[str, Any], device):
    """name -> tensor on `device` (None for an absent field)."""
    def dev(name):
        x = fields.get(name)
        return None if x is None else \
            torch.from_numpy(np.require(x, requirements=["C", "W"])).to(device)
    return dev


def tracer_from_numpy(fields: Dict[str, Any], device) -> ClusterTracer:
    """ClusterTracer from a {field: numpy array or int} dict carrying
    tauray_tpu ClusterTracer fields (v0, e1, e2, tri_valid, to_orig, cmin,
    cmax, n_clusters, and optionally opaque, alpha_base, slot_ids). The
    kernel tables are rebuilt here, so tris12/tris9/tris_flat may be
    absent; without opaque every cluster counts as opaque, as in
    tauray_tpu's any-hit trace of a tracer without the table."""
    dev = _from_numpy(fields, device)
    opaque = dev("opaque")
    tracer = ClusterTracer(
        v0=dev("v0"), e1=dev("e1"), e2=dev("e2"),
        tri_valid=dev("tri_valid"), to_orig=dev("to_orig"),
        cmin=dev("cmin"), cmax=dev("cmax"),
        n_clusters=int(fields["n_clusters"]),
        alpha_base=(None if fields.get("alpha_base") is None
                    else int(fields["alpha_base"])),
        slot_ids=bool(fields.get("slot_ids", False)),
        opaque=None if opaque is None else opaque.to(torch.int32))
    return tracer.with_kernel_layout()


# ---------------------------------------------------------------------------
# Phase 1 and the signature key: dense slab tests over ray-block chunks
# ---------------------------------------------------------------------------

def _slab_t_soa(ox, oy, oz, ix, iy, iz, bmin, bmax):
    """Slab test returning (t_near, t_far), each (G, C, TILE); o*/i* are
    (G, 1, TILE) and bmin/bmax (C, 3). Same operation order as
    tauray_tpu's _slab_t_soa, so the activity masks agree exactly."""
    res_tn = None
    res_tf = None
    for oc, ic, k in ((ox, ix, 0), (oy, iy, 1), (oz, iz, 2)):
        t0 = (bmin[None, :, k, None] - oc).mul_(ic)
        t1 = (bmax[None, :, k, None] - oc).mul_(ic)
        tn = torch.minimum(t0, t1)
        tf = torch.maximum(t0, t1, out=t1)
        del t0
        if res_tn is None:
            res_tn, res_tf = tn, tf
        else:
            torch.maximum(res_tn, tn, out=res_tn)
            torch.minimum(res_tf, tf, out=res_tf)
        del tn, tf
    return res_tn, res_tf


def _block_chunks(n_blocks: int, n_boxes: int):
    per_block = max(n_boxes, 1) * TILE * 4
    step = max(PHASE1_BUDGET_BYTES // (_LIVE_TEMPS * per_block), 1)
    for b0 in range(0, n_blocks, step):
        yield b0, min(b0 + step, n_blocks)


def _slab_blocks(rays8, b0, b1, bmin, bmax):
    """Entry t (clamped up to t_min) and activity of ray blocks b0..b1
    against every box, each (b1-b0, boxes, TILE): the ray hits the box
    AABB within [t_min, t_max]."""
    with tracing.span("slab"):
        blk = rays8[b0 * TILE:b1 * TILE].reshape(b1 - b0, TILE, 8)
        ro = blk[..., 0:3]
        rd = blk[..., 3:6]
        inv_d = torch.where(rd == 0, BIG,
                            1.0 / torch.where(rd == 0, 1.0, rd))
        tn, tf = _slab_t_soa(
            ro[:, None, :, 0], ro[:, None, :, 1], ro[:, None, :, 2],
            inv_d[:, None, :, 0], inv_d[:, None, :, 1], inv_d[:, None, :, 2],
            bmin, bmax)
        torch.maximum(tn, blk[:, None, :, 6], out=tn)
        return tn, (tf >= tn) & (tn <= blk[:, None, :, 7])


def _phase1(tracer: ClusterTracer, rays8):
    """Per 32-ray kernel tile: count of active clusters (n_tiles,) i32 and
    the ascending active cluster ids, KEY_SENTINEL-padded (n_tiles, C)
    i32 (tauray_tpu _trace_padded_pallas, v3 branch): trace_kernel.
    phase1_ids, one kernel launch on the card, straight inside the
    caller's phase1 span, and on the CPU the torch passes of
    phase1_ids_reference, whose slab tests open their own slab spans."""
    return phase1_ids(rays8, tracer.cmin, tracer.cmax)


def phase1_ids_reference(rays8, cmin, cmax):
    """Plain torch version of trace_kernel.phase1_ids over the boxes
    cmin/cmax (C, 3): the slab test of every ray block against every box
    (_slab_blocks), reduced per tile, then each row of ids sorted."""
    R = rays8.shape[0]
    C = cmin.shape[0]
    n_blocks = R // TILE
    sub = TILE // PT
    cid = torch.arange(C, dtype=torch.int32, device=rays8.device)
    counts, keys = [], []
    for b0, b1 in _block_chunks(n_blocks, C):
        act = _slab_blocks(rays8, b0, b1, cmin, cmax)[1]
        tile_act = act.reshape(b1 - b0, C, sub, PT).any(dim=3)
        del act
        tile_act = tile_act.permute(0, 2, 1).reshape(-1, C)
        counts.append(tile_act.sum(dim=1, dtype=torch.int32))
        key = torch.where(tile_act, cid, KEY_SENTINEL)
        keys.append(torch.sort(key, dim=1).values)
    return torch.cat(counts), torch.cat(keys)


def key_idmask(n_ids: int) -> int:
    """Low-bit mask holding any of n_ids key ids: 2^ceil(log2 n) - 1."""
    return (1 << max((max(n_ids, 2) - 1).bit_length(), 1)) - 1


def _phase1_entry(bmin, bmax, rays8):
    """Entry-t keyed phase 1 over the boxes bmin/bmax (C, 3) (tauray_tpu
    _trace_padded_pallas, cluster.py:993-1016, and
    _trace_padded_pallas_inst). Per 32-ray kernel tile and box, the
    minimum slab entry t of its active rays; the key is
    (bits(t) & ~idmask) | box id, inactive boxes KEY_SENTINEL, rows sorted
    ascending, so the active boxes come front to back and each key is a
    lower bound of its entry t (t >= 0 orders like its bits). Rows are
    C + KB wide: the kernels read the key one step past the last active
    one, which must be a sentinel. Returns counts (n_tiles,) i32, keys
    (n_tiles, C + KB) i32 and idmask."""
    R = rays8.shape[0]
    C = bmin.shape[0]
    n_blocks = R // TILE
    sub = TILE // PT
    idmask = key_idmask(C)
    cid = torch.arange(C, dtype=torch.int32, device=rays8.device)
    counts, keys = [], []
    for b0, b1 in _block_chunks(n_blocks, C):
        tn, act = _slab_blocks(rays8, b0, b1, bmin, bmax)
        tn = torch.where(act, tn, float("inf"))
        del act
        tnear = tn.reshape(b1 - b0, C, sub, PT).amin(dim=3)
        del tn
        tnear = tnear.permute(0, 2, 1).reshape(-1, C)
        counts.append((tnear < float("inf")).sum(dim=1, dtype=torch.int32))
        key = (tnear.view(torch.int32) & ~idmask) | cid
        key = torch.where(torch.isfinite(tnear), key, KEY_SENTINEL)
        keys.append(torch.sort(key, dim=1).values)
    keys = torch.cat(keys)
    tail = torch.full((keys.shape[0], KB), KEY_SENTINEL, dtype=torch.int32,
                      device=keys.device)
    return torch.cat(counts), torch.cat([keys, tail], dim=1), idmask


def _sig_sort_key(tracer: ClusterTracer, rays8):
    """Active-set signature key per ray (int64 holding a uint32): the
    smallest active cluster id of each residue class packed together, dead
    rays (t_max <= 0) last. Scenes of <= 1023 clusters pack three 10-bit
    class minima (classes mod 3), larger ones two 16-bit minima (even,
    odd), as tauray_tpu's _sig_sort_key with supercluster size 1."""
    R = rays8.shape[0]
    C = tracer.n_clusters
    n_blocks = R // TILE
    cid = torch.arange(C, dtype=torch.int32, device=rays8.device)
    small = C <= 1023
    big = 1023 if small else 65535
    cid = torch.clamp(cid, max=big)[None, :, None]
    parts = []
    for b0, b1 in _block_chunks(n_blocks, C):
        act = _slab_blocks(rays8, b0, b1, tracer.cmin, tracer.cmax)[1]
        vals = torch.where(act, cid, big)
        del act
        n_cls = 3 if small else 2
        m = [vals[:, r::n_cls].amin(dim=1).long() if r < C else
             torch.full_like(vals[:, 0], big).long() for r in range(n_cls)]
        if small:
            k = (m[0] << 20) | (m[1] << 10) | m[2]
        else:
            k = (m[0] << 16) | m[1]
        parts.append(k.reshape(-1))
    k = torch.cat(parts)
    return torch.where(rays8[:, 7] <= 0, 0xFFFFFFFF, k)


def _sig_sort_perm(tracer: ClusterTracer, rays8):
    return torch.argsort(_sig_sort_key(tracer, rays8), stable=True)


def _trace_padded(tracer: ClusterTracer, rays8, any_hit: bool,
                  need_uv: bool) -> Hit:
    """Phase 1, the traversal kernel, and the optional barycentric
    post-pass. rays8: (R, 8) [o|d|t_min|t_max], R a multiple of TILE.
    The kernel is chosen as tauray_tpu's _trace_padded_pallas chooses it
    (cluster.py:963-1052), reading TAURAY_VM_KERNEL at every trace:
      * C <= VM_FITS_CLUSTERS and the variable empty or v3: id-only keys
        and trace_tiles_vm3 (K1);
      * C <= VM_FITS_CLUSTERS and any other value: entry-t keys and
        trace_tiles_vm2 (K4) over tris12, with the opacity exit;
      * larger scenes: entry-t keys and trace_tiles (K2) over tris9."""
    R = rays8.shape[0]
    rays8 = rays8.contiguous()
    tiles = rays8.reshape(R // PT, PT, 8)
    fits = tracer.n_clusters <= VM_FITS_CLUSTERS
    if fits and (os.environ.get("TAURAY_VM_KERNEL") or "v3") == "v3":
        with tracing.span("phase1"):
            counts, keys = _phase1(tracer, rays8)
        with tracing.span("traverse"):
            t, tid = trace_tiles_vm3(counts, keys, tiles, tracer.tris12)
    else:
        with tracing.span("phase1"):
            counts, keys, idmask = _phase1_entry(tracer.cmin, tracer.cmax,
                                                 rays8)
        with tracing.span("traverse"):
            if fits:
                t, tid = trace_tiles_vm2(counts, keys, tiles, tracer.tris12,
                                         tracer.opaque, idmask, any_hit)
            else:
                t, tid = trace_tiles(counts, keys, tiles, tracer.tris9,
                                     tracer.opaque, idmask, any_hit)
    if not need_uv:
        z = torch.zeros_like(t)
        return Hit(t, tid, z, z)
    # barycentrics for the single best triangle from its [v0|e1|e2] row
    row = tracer.tris_flat[tid.clamp(min=0).long()]
    return _bary_hit(t, tid, rays8[:, 0:3], rays8[:, 3:6], row)


def _bary_hit(t, tid, o, d, row) -> Hit:
    """Hit with the barycentrics of ray (o, d) on its hit triangle's
    [v0|e1|e2] row (zero on a miss)."""
    miss = tid < 0
    v0, e1, e2 = row[:, 0:3], row[:, 3:6], row[:, 6:9]
    h = cross(d, e2)
    a = (e1 * h).sum(-1)
    f = torch.where(a != 0, 1.0 / torch.where(a == 0, 1.0, a), 0.0)
    s = o - v0
    u = f * (s * h).sum(-1)
    v = f * (d * cross(s, e1)).sum(-1)
    return Hit(t, tid, torch.where(miss, 0.0, u), torch.where(miss, 0.0, v))


# ---------------------------------------------------------------------------
# Object-space instancing: the TLAS path
# ---------------------------------------------------------------------------

@dataclass
class InstancedClusterTracer:
    """Two-level tracer over shared object-space geometry (tauray_tpu
    InstancedClusterTracer): one set of SAH clusters per unique mesh, and
    K cluster-instances, each an (object cluster, instance) pair with a
    world AABB. Phase 1 runs over the K world AABBs; the kernel moves each
    key's rays into its instance's space. Slot ids are k * CLUSTER + lane;
    alpha-capable instances come last, so "might be transparent" is
    slot >= alpha_base."""
    v0: torch.Tensor            # (Cu, CLUSTER, 3) object-space blocks
    e1: torch.Tensor
    e2: torch.Tensor
    tri_valid: torch.Tensor     # (Cu, CLUSTER) bool
    to_orig: torch.Tensor       # (K*CLUSTER,) i32 slot -> world triangle
    cmin: Optional[torch.Tensor]    # (K, 3) world AABB per cluster-instance
    cmax: Optional[torch.Tensor]
    n_clusters: int             # K
    k_cluster: torch.Tensor     # (K,) i32 -> object cluster
    k_inst: torch.Tensor        # (K,) i32 -> instance
    inv: Optional[torch.Tensor]     # (I, 3, 4) world -> object
    obj_min: torch.Tensor       # (Cu, 3) object AABBs
    obj_max: torch.Tensor
    tris9: torch.Tensor         # (Cu, 9, 1, CLUSTER)
    opaque: torch.Tensor        # (K,) i32
    tris_flat: torch.Tensor     # (Cu*CLUSTER, 9) object [v0|e1|e2] rows
    alpha_base: int

    @property
    def device(self) -> torch.device:
        return self.v0.device

    def trace(self, origins, dirs, t_min, t_max, any_hit: bool = False,
              sort_rays: bool = False, need_uv: bool = True) -> Hit:
        return self.trace_flagged(origins, dirs, t_min, t_max,
                                  any_hit=any_hit, sort_rays=sort_rays,
                                  need_uv=need_uv)[0]

    def trace_flagged(self, origins, dirs, t_min, t_max,
                      any_hit: bool = False, sort_rays: bool = False,
                      need_uv: bool = True) -> Tuple[Hit, torch.Tensor]:
        """Closest hit per ray (any_hit: stops at the first hit in an
        all-opaque cluster-instance) with world-triangle ids, plus the
        alpha flag. sort_rays is ignored: waves trace as given, as in
        tauray_tpu."""
        with tracing.span("trace_wave"):
            R = origins.shape[0]
            _count_wave(R)
            rays8 = _pack_rays(origins, dirs, t_min, t_max)
            t, tid, u, v = (x[:R] for x in
                            _trace_padded_inst(self, rays8, any_hit, need_uv))
            alpha_flag = tid >= self.alpha_base
            tid = torch.where(tid >= 0,
                              self.to_orig[tid.clamp(min=0).long()], -1)
        return Hit(t, tid, u, v), alpha_flag


def _trace_padded_inst(tracer: InstancedClusterTracer, rays8,
                       any_hit: bool, need_uv: bool) -> Hit:
    """tauray_tpu _trace_padded_pallas_inst: entry-t phase 1 over the K
    world AABBs, trace_tiles_inst, and the barycentric post-pass in object
    space (barycentrics are affine-invariant)."""
    R = rays8.shape[0]
    rays8 = rays8.contiguous()
    with tracing.span("phase1"):
        counts, keys, idmask = _phase1_entry(tracer.cmin, tracer.cmax, rays8)
    with tracing.span("traverse"):
        t, tid = trace_tiles_inst(
            counts, keys, rays8.reshape(R // PT, PT, 8), tracer.tris9,
            tracer.opaque, tracer.k_cluster, tracer.k_inst,
            tracer.inv.reshape(-1, 12), idmask, any_hit)
    if not need_uv:
        z = torch.zeros_like(t)
        return Hit(t, tid, z, z)
    safe = tid.clamp(min=0).long()
    kidx = safe // CLUSTER
    row = tracer.tris_flat[tracer.k_cluster[kidx].long() * CLUSTER +
                           safe % CLUSTER]
    inv = tracer.inv[tracer.k_inst[kidx].long()]                # (R, 3, 4)
    o = rays8[:, None, 0:3]
    d = rays8[:, None, 3:6]
    oo = (inv[..., :3] * o).sum(-1) + inv[..., 3]
    dd = (inv[..., :3] * d).sum(-1)
    return _bary_hit(t, tid, oo, dd, row)


def build_instanced_tracer(mesh_tris, mesh_of_inst, inst_model, inst_opaque,
                           tri_starts, device=None) -> InstancedClusterTracer:
    """Host build, as tauray_tpu.ops.cluster.build_instanced_tracer.

    mesh_tris: list of (Tm, 3, 3) OBJECT-space triangle arrays, one per
    unique mesh; mesh_of_inst: (I,) mesh index per instance; inst_model:
    (I, 4, 4) object -> world transforms; inst_opaque: (I,) bool (False =
    alpha-capable material); tri_starts: (I,) world-soup triangle offset
    per instance (the to_orig mapping). device=None means the CUDA card
    (raises without one)."""
    device = resolve_device(device)
    mesh_builds = []
    for tris in mesh_tris:
        tris = np.asarray(tris, np.float32)
        T = tris.shape[0]
        order = _sah_order(tris, np.arange(T))
        C = max((T + CLUSTER - 1) // CLUSTER, 1)
        total = C * CLUSTER
        perm = np.full(total, order[0] if T else 0, np.int64)
        perm[:min(T, total)] = order[:total]
        vmask = np.zeros(total, bool)
        vmask[:T] = True
        pos = tris[perm]
        mesh_builds.append(dict(
            v0=pos[:, 0].reshape(C, CLUSTER, 3),
            e1=(pos[:, 1] - pos[:, 0]).reshape(C, CLUSTER, 3),
            e2=(pos[:, 2] - pos[:, 0]).reshape(C, CLUSTER, 3),
            valid=vmask.reshape(C, CLUSTER), perm=perm, C=C))

    cluster_base = np.cumsum([0] + [b["C"] for b in mesh_builds])
    # cluster-instance list: alpha-capable instances LAST
    mesh_of_inst = np.asarray(mesh_of_inst)
    inst_opaque = np.asarray(inst_opaque, bool)
    order_i = np.argsort(~inst_opaque, kind="stable")
    k_cluster, k_inst, to_orig, opaque = [], [], [], []
    alpha_base = None
    for i in order_i:
        mi = mesh_of_inst[i]
        b = mesh_builds[mi]
        if not inst_opaque[i] and alpha_base is None:
            alpha_base = len(k_cluster) * CLUSTER
        for c in range(b["C"]):
            k_cluster.append(cluster_base[mi] + c)
            k_inst.append(i)
            opaque.append(1 if inst_opaque[i] else 0)
            sl = b["perm"][c * CLUSTER:(c + 1) * CLUSTER]
            to_orig.append(tri_starts[i] + sl)
    if alpha_base is None:
        alpha_base = len(k_cluster) * CLUSTER


    def dev(x, dtype=None):
        t = torch.from_numpy(np.require(x, requirements=["C", "W"]))
        return t.to(device=device, dtype=dtype)
    v0, e1, e2 = (dev(np.concatenate([b[k] for b in mesh_builds]))
                  for k in ("v0", "e1", "e2"))
    tri_valid = dev(np.concatenate([b["valid"] for b in mesh_builds]))
    # object AABBs (static): corners v0, v0 + e1, v0 + e2 of valid slots
    valid = tri_valid[..., None]
    obj_min = torch.where(valid, torch.minimum(torch.minimum(
        v0, v0 + e1), v0 + e2), BIG).amin(dim=1)
    obj_max = torch.where(valid, torch.maximum(torch.maximum(
        v0, v0 + e1), v0 + e2), -BIG).amax(dim=1)
    tracer = InstancedClusterTracer(
        v0=v0, e1=e1, e2=e2, tri_valid=tri_valid,
        to_orig=dev(np.concatenate(to_orig).astype(np.int32)),
        cmin=None, cmax=None, n_clusters=len(k_cluster),
        k_cluster=dev(np.asarray(k_cluster, np.int32)),
        k_inst=dev(np.asarray(k_inst, np.int32)), inv=None,
        obj_min=obj_min, obj_max=obj_max, tris9=_tris9(v0, e1, e2),
        opaque=dev(np.asarray(opaque, np.int32)),
        tris_flat=torch.cat([v0, e1, e2], dim=-1).reshape(-1, 9),
        alpha_base=int(alpha_base))
    return refit_instanced_tracer(tracer, inst_model)


def refit_instanced_tracer(tracer: InstancedClusterTracer, inst_model
                           ) -> InstancedClusterTracer:
    """Per-frame refit: only transforms move (tauray_tpu
    refit_instanced_tracer). The inverses are float32 LU inverses taken on
    the host (I 4x4 matrices), then every cluster-instance's world AABB
    is that of its 8 transformed object-AABB corners. Triangle tables are
    untouched."""
    dev = tracer.device
    model = torch.as_tensor(np.asarray(inst_model, np.float32))  # (I, 4, 4)
    inv = torch.linalg.inv(model)[:, :3, :].contiguous().to(dev)
    model = model.to(dev)
    kc = tracer.k_cluster.long()
    omin = tracer.obj_min[kc]                                    # (K, 3)
    omax = tracer.obj_max[kc]
    M = model[tracer.k_inst.long()]                              # (K, 4, 4)
    corners = torch.stack([
        torch.stack([omax[:, 0] if m & 1 else omin[:, 0],
                     omax[:, 1] if m & 2 else omin[:, 1],
                     omax[:, 2] if m & 4 else omin[:, 2]], dim=-1)
        for m in range(8)], dim=1)                               # (K, 8, 3)
    wc = (M[:, None, :3, :3] * corners[:, :, None, :]).sum(-1) + \
        M[:, None, :3, 3]                                        # (K, 8, 3)
    return replace(tracer, cmin=wc.amin(dim=1), cmax=wc.amax(dim=1),
                   inv=inv)


def instanced_tracer_from_numpy(fields: Dict[str, Any], device
                                ) -> InstancedClusterTracer:
    """InstancedClusterTracer from a {field: numpy array or int} dict
    carrying tauray_tpu InstancedClusterTracer fields (v0, e1, e2,
    tri_valid, to_orig, cmin, cmax, n_clusters, k_cluster, k_inst, inv,
    obj_min, obj_max, opaque, alpha_base). tris9 and tris_flat are rebuilt
    here."""
    dev = _from_numpy(fields, device)
    v0, e1, e2 = dev("v0"), dev("e1"), dev("e2")
    return InstancedClusterTracer(
        v0=v0, e1=e1, e2=e2, tri_valid=dev("tri_valid"),
        to_orig=dev("to_orig"), cmin=dev("cmin"), cmax=dev("cmax"),
        n_clusters=int(fields["n_clusters"]), k_cluster=dev("k_cluster"),
        k_inst=dev("k_inst"), inv=dev("inv"), obj_min=dev("obj_min"),
        obj_max=dev("obj_max"), tris9=_tris9(v0, e1, e2),
        opaque=dev("opaque").to(torch.int32),
        tris_flat=torch.cat([v0, e1, e2], dim=-1).reshape(-1, 9),
        alpha_base=int(fields["alpha_base"]))


def build_instanced_from_arrays(arrays, device=None
                                ) -> Optional[InstancedClusterTracer]:
    """Instanced build from SceneArrays (tauray_tpu
    build_instanced_from_arrays): instances sharing a mesh (the same
    position and index arrays) share its object clusters. None when no
    mesh is shared or an instance is skinned (its object geometry deforms
    per frame); the caller then builds the flat tracer."""
    device = resolve_device(device)
    insts = arrays.instances
    if not insts or any(arrays._skinned):
        return None
    mesh_ids = {}
    mesh_of_inst = []
    for ig in insts:
        key = (id(ig.positions), id(ig.indices))
        if key not in mesh_ids:
            mesh_ids[key] = len(mesh_ids)
        mesh_of_inst.append(mesh_ids[key])
    if len(mesh_ids) == len(insts):
        return None
    tri_inst = np.asarray(arrays.tri_instance)
    obj = np.asarray(arrays.obj_pos)
    mesh_tris = [None] * len(mesh_ids)
    tri_starts = np.zeros(len(insts), np.int64)
    for i in range(len(insts)):
        idx = np.flatnonzero(tri_inst == i)
        tri_starts[i] = idx[0] if len(idx) else 0
        mi = mesh_of_inst[i]
        if mesh_tris[mi] is None:
            mesh_tris[mi] = obj[idx]
    return build_instanced_tracer(
        mesh_tris, mesh_of_inst, arrays.inst_model,
        ~np.asarray(arrays.inst_has_alpha), tri_starts, device=device)
