"""The cluster tracers' kernels: phase 2, the traversal kernels, and the
flat tracer's phase 1 on the id-key path.

  * trace_tiles_vm3 is the counterpart of tauray_tpu's
    pallas_trace_tiles_vm3 (_kernel_vm3): closest hit over Baldwin-Weber
    rows, id-only keys, no early exit (K1);
  * trace_tiles is the counterpart of pallas_trace_tiles (_kernel):
    Möller-Trumbore over tris9, entry-t keys walked front to back in
    steps of KB clusters with a tile-level early exit, and in any-hit
    mode an exit on opaque hits (K2);
  * trace_tiles_inst is the counterpart of pallas_trace_tiles_inst
    (_kernel_inst): trace_tiles over cluster-instances, each key's rays
    moved into its instance's object space (K3);
  * trace_tiles_vm2 and trace_tiles_vm are the counterparts of
    pallas_trace_tiles_vm2 (_kernel_vm2) and pallas_trace_tiles_vm
    (_kernel_vm), which compute one function: trace_tiles' walk and exit
    over the Baldwin-Weber rows of trace_tiles_vm3 (K4/K5). Both launch
    the same kernel; trace_tiles_vm can also return the steps each tile
    walked (the TPU kernel's debug_steps).

All five are instances of one kernel, csrc/trace_tiles.cu: one block per
tile, its W warps sharing the tile's clusters; bw_warps picks W from the
wave's size and the kernel's kind.

phase1_ids is phase 1 of trace_tiles_vm3's key rows (P1, csrc/phase1.cu):
the slab cull of every ray against every cluster box and each 32-ray
tile's count and ascending active cluster ids, in one pass, equal bit for
bit to the torch passes of ops/cluster.phase1_ids_reference. No TPU kernel
of the JAX package computes it (XLA fuses it there).

build_all also builds csrc/k1_lab.cu, csrc/brick_lab.cu, csrc/tile_lab.cu
and csrc/mxu_lab.cu, the TPU labs' kernels (tauray_torch/lab/).

For CUDA tensors each wrapper launches the hand-written kernel; for CPU
tensors it runs the plain torch version beside it (the *_reference
functions; phase1_ids' is in ops/cluster.py, beside the slab test it
shares), which computes the same contract. A build or launch failure
raises: there is no fallback from the card to the plain version.

The source is compiled with nvcc for sm_90a into a shared library with a
plain C interface on first use (from this package's sources, into
tauray_torch/_build/, one nvcc process per source, all started together)
and loaded with ctypes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict

import torch

from .. import tracing

TILE = 32            # rays per tile (one warp)
CLUSTER = 128        # triangles per cluster
KB = 8               # clusters per step of the front-to-back kernels
BIG = 3.0e38
KEY_SENTINEL = 0x7FFFFFFF

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# library name -> its CUDA source
SOURCES = {name: os.path.join(_PKG, "csrc", f"{name}.cu")
           for name in ("trace_tiles", "phase1", "k1_lab", "brick_lab",
                        "tile_lab", "mxu_lab")}
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-fmad=false", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_libs: Dict[str, ctypes.CDLL] = {}
# wrapper launches of each kernel, counted where the kernel is launched
LAUNCHES: Dict[str, int] = {"trace_vm3": 0, "trace_mt": 0,
                            "trace_mt_inst": 0, "trace_vm2": 0,
                            "trace_vm": 0, "phase1_ids": 0}
# K1's work since the last reset, counted at its wrapper on both paths: the
# tiles handed in, always, and while tracing.counting() their cluster
# visits (the sum of the counts), added on the device into one int64
# scalar a device and read by k1_work()
K1_WORK: Dict[str, int] = {"tiles": 0}
_K1_VISITS: Dict[torch.device, torch.Tensor] = {}
# what the build did, per library: seconds, library path, compiler output
BUILD_INFO: Dict[str, Dict[str, object]] = {}

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "trace_tiles_launch": [_P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                           _I, _I, _I, _P, _P, _P, _P],
    "phase1_launch": [_P, _P, _P, _I, _I, _P, _P, _P],
    "k1_lab_launch": [_I, _I, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I,
                      _P, _P, _P],
    "brick_lab_launch": [_I, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P],
    "tile_lab_launch": [_I, _P, _P, _P, _P, _I, _I, _I, _P, _P],
    "mxu_lab_launch": [_I, _P, _P, _P, _P, _P, _I, _I, _P, _P],
}
# the kernel kind trace_tiles_launch takes for each wrapper
_KIND = {"trace_vm3": 0, "trace_vm2": 1, "trace_vm": 1, "trace_mt": 2,
         "trace_mt_inst": 3}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    K1_WORK["tiles"] = 0
    _K1_VISITS.clear()


def _count_k1(counts: torch.Tensor) -> None:
    K1_WORK["tiles"] += counts.shape[0]
    if tracing.counting():
        visits = _K1_VISITS.get(counts.device)
        if visits is None:
            visits = _K1_VISITS[counts.device] = torch.zeros(
                (), dtype=torch.int64, device=counts.device)
        visits.add_(counts.sum(dtype=torch.int64))


def k1_work() -> Dict[str, int]:
    """K1's tiles since the last reset_launch_counts() and, where they were
    counted, its cluster visits (one read of each device's counter)."""
    out = {"k1_tiles": K1_WORK["tiles"]}
    if _K1_VISITS:
        out["k1_visits"] = sum(int(v) for v in _K1_VISITS.values())
    return out


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the traversal kernels are built "
                       "from tauray_torch/csrc/*.cu with the CUDA toolkit")


def _digest() -> str:
    """One hash over the flags and every file of csrc/ (the sources and
    any header they include): a change to any of them rebuilds every
    library."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    csrc = os.path.join(_PKG, "csrc")
    for name in sorted(os.listdir(csrc)):
        with open(os.path.join(csrc, name), "rb") as f:
            h.update(name.encode() + f.read())
    return h.hexdigest()[:16]


def build_all() -> Dict[str, ctypes.CDLL]:
    """Build (once per source version) and load every kernel library; the
    missing ones compile in parallel, one nvcc process per source."""
    if len(_libs) == len(SOURCES):
        return _libs
    digest = _digest()
    paths = {n: os.path.join(BUILD_DIR, f"lib{n}_{digest}.so")
             for n in SOURCES}
    t0 = time.perf_counter()
    procs = {}
    for name, path in paths.items():
        if name not in _libs and not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            procs[name] = (subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCES[name]],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                tmp)
    logs = {}
    for name, (proc, tmp) in procs.items():
        logs[name] = proc.communicate()[0]
        BUILD_INFO[name] = dict(seconds=time.perf_counter() - t0,
                                path=paths[name], log=logs[name])
    for name, (proc, tmp) in procs.items():
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {SOURCES[name]}:\n"
                               f"{logs[name]}")
        os.replace(tmp, paths[name])
    for name, path in paths.items():
        if name in _libs:
            continue
        lib = ctypes.CDLL(path)
        fn = getattr(lib, f"{name}_launch")
        fn.restype = ctypes.c_int
        fn.argtypes = _ARGTYPES[f"{name}_launch"]
        BUILD_INFO.setdefault(name, dict(seconds=0.0, path=path, log=""))
        _libs[name] = lib
    return _libs


def _check(x: torch.Tensor, name: str, dtype, ndim: int, device):
    if x.dtype != dtype or x.dim() != ndim or x.device != device:
        raise ValueError(f"{name}: want {dtype} {ndim}-d on {device}, got "
                         f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _check_tiles(counts, keys, rays8, dev, kernel: str):
    _check(counts, "counts", torch.int32, 1, dev)
    _check(keys, "keys", torch.int32, 2, dev)
    _check(rays8, "rays8", torch.float32, 3, dev)
    n_tiles = counts.shape[0]
    if (keys.shape[0] != n_tiles or keys.shape[1] < 1 or
            tuple(rays8.shape) != (n_tiles, TILE, 8)):
        raise ValueError(f"{kernel}: inconsistent shapes "
                         f"{tuple(counts.shape)} {tuple(keys.shape)} "
                         f"{tuple(rays8.shape)}")


def _on_card(rays8: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU tensors (the plain version);
    any other device raises."""
    if rays8.device.type == "cpu":
        return False
    if rays8.device.type != "cuda":
        raise ValueError(f"no traversal kernel for {rays8.device}")
    return True


# ---------------------------------------------------------------------------
# K1: id-only keys, Baldwin-Weber, no exit
# ---------------------------------------------------------------------------

def trace_tiles_vm3(counts: torch.Tensor, keys: torch.Tensor,
                    rays8: torch.Tensor, tris12: torch.Tensor):
    """Closest hit per ray.

    counts (n_tiles,) i32 active clusters per tile; keys (n_tiles, W) i32
    with each row's first counts[tile] entries the ascending active cluster
    ids; rays8 (n_tiles, 32, 8) f32 [o|d|tmin|tmax]; tris12 (C, 12, 1, 128)
    f32 Baldwin-Weber rows. Returns t (R,) f32 (+inf on miss) and the slot
    id (R,) i32 (-1 on miss)."""
    _count_k1(counts)
    if not _on_card(rays8):
        return trace_tiles_vm3_reference(counts, keys, rays8, tris12)
    return _launch_bw(counts, keys, rays8, tris12, None, 0, False,
                      "trace_vm3")[:2]


def trace_tiles_vm3_reference(counts, keys, rays8, tris12):
    """Plain torch version of trace_tiles_vm3. Walks key column j for every
    tile with count > j, testing the tile's rays against that cluster's
    128 triangles as a batched (tiles, 32, 128) block; the running best
    updates on strictly closer hits only, and min() picks the lowest lane
    on ties, so ties go to the lowest slot id as in the kernel."""
    n_tiles = counts.shape[0]
    C = tris12.shape[0]
    rows = tris12.reshape(C, 12, CLUSTER)
    o = rays8[..., 0:3]
    d = rays8[..., 3:6]
    tmin = rays8[..., 6]
    bt = torch.where(rays8[..., 7] > BIG, BIG, rays8[..., 7])
    bi = torch.full((n_tiles, TILE), -1, dtype=torch.int32,
                    device=rays8.device)
    counts_l = counts.long()
    max_count = int(counts_l.max()) if n_tiles else 0
    for j in range(max_count):
        sel = torch.nonzero(counts_l > j).squeeze(1)
        c = keys[sel, j].long().clamp(0, C - 1)
        tri = rows[c][:, None]                           # (n, 1, 12, 128)
        # rays (n, 32, 1) against rows (n, 1, 128)
        den, tt, uu, vv = _bw_test(
            [tri[:, :, i] for i in range(12)],
            *(x[sel, :, k, None] for x in (o, d) for k in range(3)))
        bt_s = bt[sel]
        hit = (den != 0) & (uu >= 0) & (vv >= 0) & (uu + vv <= 1) & \
            (tt >= tmin[sel, :, None]) & (tt < bt_s[..., None])
        cand, arg = torch.where(hit, tt, BIG).min(dim=2)
        closer = cand < bt_s
        bt[sel] = torch.where(closer, cand, bt_s)
        bi[sel] = torch.where(closer, (c[:, None] * CLUSTER + arg).int(),
                              bi[sel])
    tid = bi.reshape(-1)
    t = torch.where(tid < 0, float("inf"), bt.reshape(-1))
    return t, tid


# ---------------------------------------------------------------------------
# P1: phase 1 of K1's key rows, the slab cull and the ascending ids
# ---------------------------------------------------------------------------

def phase1_ids(rays8: torch.Tensor, cmin: torch.Tensor, cmax: torch.Tensor):
    """Phase 1 of trace_tiles_vm3's keys. Per 32-ray tile: counts
    (n_tiles,) i32, the cluster boxes that any of its rays hits within
    [t_min, t_max], and keys (n_tiles, C) i32, those box ids ascending,
    then KEY_SENTINEL to the end of the row.

    rays8 (R, 8) f32 [o|d|t_min|t_max], R a positive multiple of 128 (the
    tracer's padded wave); cmin, cmax (C, 3) f32 with 1 <= C <=
    VM_FITS_CLUSTERS. CUDA tensors take one launch of csrc/phase1.cu, CPU
    tensors the torch passes of ops/cluster.phase1_ids_reference; both give
    the same bits."""
    from .cluster import VM_FITS_CLUSTERS, phase1_ids_reference
    dev = rays8.device
    _check(rays8, "rays8", torch.float32, 2, dev)
    _check(cmin, "cmin", torch.float32, 2, dev)
    _check(cmax, "cmax", torch.float32, 2, dev)
    R, C = rays8.shape[0], cmin.shape[0]
    if rays8.shape[1] != 8 or R == 0 or R % 128:
        raise ValueError(f"phase1_ids: rays8 {tuple(rays8.shape)} is not "
                         f"(R, 8) with R a positive multiple of 128")
    if tuple(cmin.shape) != (C, 3) or tuple(cmax.shape) != (C, 3) or \
            not 1 <= C <= VM_FITS_CLUSTERS:
        raise ValueError(f"phase1_ids: boxes {tuple(cmin.shape)} "
                         f"{tuple(cmax.shape)} are not (C, 3) with 1 <= C "
                         f"<= {VM_FITS_CLUSTERS}")
    if not _on_card(rays8):
        return phase1_ids_reference(rays8, cmin, cmax)
    lib = build_all()["phase1"]
    counts = torch.empty(R // TILE, dtype=torch.int32, device=dev)
    keys = torch.empty((R // TILE, C), dtype=torch.int32, device=dev)
    err = lib.phase1_launch(
        rays8.data_ptr(), cmin.data_ptr(), cmax.data_ptr(), R, C,
        counts.data_ptr(), keys.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"phase1_ids launch failed: CUDA error {err}")
    LAUNCHES["phase1_ids"] += 1
    return counts, keys


# ---------------------------------------------------------------------------
# K2 / K3: entry-t keys, Möller-Trumbore, front-to-back exit
# ---------------------------------------------------------------------------

def trace_tiles(counts: torch.Tensor, keys: torch.Tensor,
                rays8: torch.Tensor, tris9: torch.Tensor,
                opaque: torch.Tensor, idmask: int, any_hit: bool = False):
    """Closest hit (or, with any_hit, a hit that ends the search once it
    lies in an all-opaque cluster) per ray, walking each tile's clusters
    front to back.

    counts (n_tiles,) i32; keys (n_tiles, W) i32, each row the ascending
    keys (entry-t bits & ~idmask) | cluster id of the tile's active
    clusters, then KEY_SENTINEL, with W >= C + KB; rays8 (n_tiles, 32, 8)
    f32 [o|d|tmin|tmax]; tris9 (C, 9, 1, 128) f32 v0/e1/e2 components by
    lane; opaque (C,) i32, read only with any_hit. Returns t (R,) f32
    (+inf on miss) and the slot id (R,) i32 (-1 on miss)."""
    if not _on_card(rays8):
        return trace_tiles_reference(counts, keys, rays8, tris9, opaque,
                                     idmask, any_hit)
    return _launch_mt(counts, keys, rays8, tris9, opaque, None, idmask,
                      any_hit)[:2]


def trace_tiles_inst(counts: torch.Tensor, keys: torch.Tensor,
                     rays8: torch.Tensor, tris9: torch.Tensor,
                     opaque: torch.Tensor, k_cluster: torch.Tensor,
                     k_inst: torch.Tensor, inv12: torch.Tensor, idmask: int,
                     any_hit: bool = False):
    """trace_tiles over K cluster-instances: key ids index k_cluster /
    k_inst (K,) i32, opaque is (K,) i32, and inv12 (I, 12) f32 holds each
    instance's world -> object 3x4 rows. Each key's rays are moved into
    its instance's space with the direction left unnormalized, so t is in
    world units; the id is key * 128 + lane."""
    if not _on_card(rays8):
        return trace_tiles_inst_reference(counts, keys, rays8, tris9,
                                          opaque, k_cluster, k_inst, inv12,
                                          idmask, any_hit)
    return _launch_mt(counts, keys, rays8, tris9, opaque,
                      (k_cluster, k_inst, inv12), idmask, any_hit)[:2]


def trace_tiles_vm2(counts: torch.Tensor, keys: torch.Tensor,
                    rays8: torch.Tensor, tris12: torch.Tensor,
                    opaque: torch.Tensor, idmask: int,
                    any_hit: bool = False):
    """trace_tiles over the Baldwin-Weber rows tris12 (C, 12, 1, 128) f32
    (the counterpart of pallas_trace_tiles_vm2, the flat tracer's kernel
    under TAURAY_VM_KERNEL=v2): the same keys, opacity exit and outputs,
    the hit test of trace_tiles_vm3. Returns t (R,) f32 and the slot id
    (R,) i32."""
    if not _on_card(rays8):
        return trace_tiles_vm2_reference(counts, keys, rays8, tris12,
                                         opaque, idmask, any_hit)[:2]
    return _launch_bw(counts, keys, rays8, tris12, opaque, idmask, any_hit,
                      "trace_vm2")[:2]


def trace_tiles_vm(counts: torch.Tensor, keys: torch.Tensor,
                   rays8: torch.Tensor, tris12: torch.Tensor,
                   opaque: torch.Tensor, idmask: int, any_hit: bool = False,
                   debug_steps: bool = False):
    """trace_tiles_vm2 under its other TPU entry (pallas_trace_tiles_vm,
    which the wave-statistics tool calls). With debug_steps it also
    returns the steps each tile walked, (n_tiles,) i32: the trip count of
    the TPU kernel's loop, the step that ended it included, 0 for a tile
    with no active cluster. (The TPU kernel writes those steps in place of
    t and the id; here they go to their own array.)"""
    if not _on_card(rays8):
        t, tid, steps = trace_tiles_vm2_reference(counts, keys, rays8,
                                                  tris12, opaque, idmask,
                                                  any_hit)
    else:
        t, tid, steps = _launch_bw(counts, keys, rays8, tris12, opaque,
                                   idmask, any_hit, "trace_vm", debug_steps)
    return (t, tid, steps) if debug_steps else (t, tid)


# W, the warps that share one tile, is 8 for waves of up to
# TILES_PER_SM[kernel] tiles per SM, else 4: for K1 up to 64 (a 2^18-ray
# wave is 62 tiles per SM on 132 SMs, a 2^20-ray wave 248), for K4/K5 up
# to 16 (an alpha re-trace of 32,768 rays is 8), since they also
# synchronise the block once per step of 8 keys. These were the fastest
# of 1, 2, 4 and 8 on each wave size, and only 4 and 8 are built
# (PERF.md; app/bw_bench.py times both). K2/K3 take 16 too: W = 8 won
# their 32,768-ray slices and W = 4 their 2^18 and 2^20 waves.
TILES_PER_SM = {"trace_vm3": 64, "trace_vm2": 16, "trace_vm": 16,
                "trace_mt": 16, "trace_mt_inst": 16}
BW_WARPS = (4, 8)


def bw_warps(n_tiles: int, n_sm: int, kernel: str) -> int:
    """W for a launch of n_tiles tiles on n_sm SMs of kernel (a LAUNCHES
    key)."""
    return 8 if n_tiles <= TILES_PER_SM[kernel] * n_sm else 4


def _launch_bw(counts, keys, rays8, tris12, opaque, idmask, any_hit,
               kernel, debug_steps=False, warps=None):
    """Launch K1 (kernel trace_vm3; opaque None) or K4/K5 (trace_vm2 /
    trace_vm) over tris12. warps (W, one of BW_WARPS) defaults to
    bw_warps' choice; the timing tool and the tests set it. Returns (t,
    tid, steps or None)."""
    dev = rays8.device
    _check_tiles(counts, keys, rays8, dev, kernel)
    _check(tris12, "tris12", torch.float32, 4, dev)
    C = tris12.shape[0]
    if tuple(tris12.shape) != (C, 12, 1, CLUSTER) or C < 1:
        raise ValueError(f"{kernel}: bad tris12 shape "
                         f"{tuple(tris12.shape)}")
    if kernel != "trace_vm3":
        _check_exit(keys, opaque, idmask, C, dev, kernel)
    return _launch(kernel, counts, keys, rays8, tris12, opaque, None, C,
                   idmask, any_hit, debug_steps, warps)


def _check_exit(keys, opaque, idmask, n_keys, dev, kernel):
    """The checks of the front-to-back kernels: per-key opacity, key rows
    with a sentinel past the last id, a valid id mask."""
    _check(opaque, "opaque", torch.int32, 1, dev)
    if opaque.shape[0] != n_keys:
        raise ValueError(f"{kernel}: opaque has {opaque.shape[0]} entries "
                         f"for {n_keys} key ids")
    if keys.shape[1] < n_keys + KB:
        raise ValueError(f"{kernel}: key rows of {keys.shape[1]} hold no "
                         f"sentinel past {n_keys} ids (need {n_keys + KB})")
    if not 0 < idmask < (1 << 30) or idmask & (idmask + 1) or \
            idmask < n_keys - 1:
        raise ValueError(f"{kernel}: bad idmask {idmask} for {n_keys} ids")


def _launch_mt(counts, keys, rays8, tris, opaque, inst, idmask, any_hit,
               debug_steps=False, warps=None):
    """Launch K2 over tris9, or K3 with inst = (k_cluster, k_inst,
    inv12). warps as in _launch_bw. Returns (t, tid, steps or None)."""
    kernel = "trace_mt" if inst is None else "trace_mt_inst"
    dev = rays8.device
    _check_tiles(counts, keys, rays8, dev, kernel)
    _check(tris, "tris9", torch.float32, 4, dev)
    C = tris.shape[0]
    n_keys = C
    if tuple(tris.shape) != (C, 9, 1, CLUSTER) or C < 1:
        raise ValueError(f"{kernel}: bad tris9 shape {tuple(tris.shape)}")
    if inst is not None:
        k_cluster, k_inst, inv12 = inst
        _check(k_cluster, "k_cluster", torch.int32, 1, dev)
        _check(k_inst, "k_inst", torch.int32, 1, dev)
        _check(inv12, "inv12", torch.float32, 2, dev)
        n_keys = k_cluster.shape[0]
        if (k_inst.shape[0] != n_keys or n_keys < 1 or
                inv12.shape[1] != 12 or inv12.shape[0] < 1):
            raise ValueError(f"{kernel}: inconsistent instance tables "
                             f"{tuple(k_cluster.shape)} "
                             f"{tuple(k_inst.shape)} {tuple(inv12.shape)}")
    _check_exit(keys, opaque, idmask, n_keys, dev, kernel)
    return _launch(kernel, counts, keys, rays8, tris, opaque, inst, n_keys,
                   idmask, any_hit, debug_steps, warps)


def _launch(kernel, counts, keys, rays8, tris, opaque, inst, n_keys,
            idmask, any_hit, debug_steps, warps):
    """Launch csrc/trace_tiles.cu's instance for kernel on checked
    arguments and count the launch. Returns (t, tid, steps or None)."""
    dev = rays8.device
    n_tiles = counts.shape[0]
    if warps is None:
        warps = bw_warps(n_tiles, torch.cuda.get_device_properties(
            dev).multi_processor_count, kernel)
    lib = build_all()["trace_tiles"]
    t = torch.empty(n_tiles * TILE, dtype=torch.float32, device=dev)
    tid = torch.empty(n_tiles * TILE, dtype=torch.int32, device=dev)
    steps = (torch.empty(n_tiles, dtype=torch.int32, device=dev)
             if debug_steps else None)
    ptrs = (0, 0, 0) if inst is None else tuple(x.data_ptr() for x in inst)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.trace_tiles_launch(
        counts.data_ptr(), keys.data_ptr(), keys.shape[1], rays8.data_ptr(),
        tris.data_ptr(), 0 if opaque is None else opaque.data_ptr(), *ptrs,
        n_tiles, n_keys, idmask, int(any_hit), _KIND[kernel], warps,
        t.data_ptr(), tid.data_ptr(),
        0 if steps is None else steps.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err}")
    LAUNCHES[kernel] += 1
    return t, tid, steps


def trace_tiles_reference(counts, keys, rays8, tris9, opaque, idmask,
                          any_hit=False, stats=None):
    """Plain torch version of trace_tiles; `stats` (a dict), when given,
    receives the steps walked and skipped (see _mt_reference)."""
    return _mt_reference(counts, keys, rays8, tris9, opaque, None, idmask,
                         any_hit, stats)


def trace_tiles_inst_reference(counts, keys, rays8, tris9, opaque,
                               k_cluster, k_inst, inv12, idmask,
                               any_hit=False, stats=None):
    """Plain torch version of trace_tiles_inst."""
    return _mt_reference(counts, keys, rays8, tris9, opaque,
                         (k_cluster, k_inst, inv12), idmask, any_hit, stats)


def trace_tiles_vm2_reference(counts, keys, rays8, tris12, opaque, idmask,
                              any_hit=False, stats=None):
    """Plain torch version of trace_tiles_vm2 / trace_tiles_vm: returns t,
    the slot id and the steps each tile walked (n_tiles,) i32; `stats`
    receives the totals, as in trace_tiles_reference."""
    stats = {} if stats is None else stats
    t, tid = _mt_reference(counts, keys, rays8, tris12, opaque, None,
                           idmask, any_hit, stats)
    return t, tid, stats["tile_steps"]


# tiles per batched block of the plain version: (tiles, 32, KB*128) f32
# temporaries of 32 MB each
_REF_TILES = 256


def _mt_reference(counts, keys, rays8, tris, opaque, inst, idmask, any_hit,
                  stats):
    """The contract of _kernel / _kernel_inst / _kernel_vm2 / _kernel_vm
    (tauray_tpu pallas_trace.py :64-240, :297-484, :745-897, :565-728) as
    batched torch ops. Every tile that is still walking takes step s: the
    KB clusters of key slots s*KB.. are tested as one (tiles, 32, KB*128)
    block, slots past the tile's count masked: Möller-Trumbore in the
    order of pallas_trace.py:170-189 for tris9 (C, 9, 1, 128), or
    Baldwin-Weber in the order of :841-855 for tris12 (C, 12, 1, 128). A
    hit needs t < the best from before the step, and the step's minimum
    goes to its first lane in key order. Then the whole tile stops when
    every ray's best t bits are <= the next step's key & ~idmask (or, under
    any_hit, its best hit lies in an opaque cluster).

    stats: steps (walked), steps_total (ceil(count / KB) summed), clusters
    (real slots tested), tiles, and tile_steps (n_tiles,) i32, the steps
    each tile walked (the step that stopped it included)."""
    dev = rays8.device
    n_tiles = counts.shape[0]
    W = keys.shape[1]
    n_rows = tris.shape[1]
    bw = n_rows == 12
    comps = tris.reshape(tris.shape[0], n_rows, CLUSTER)
    n_keys = comps.shape[0] if inst is None else inst[0].shape[0]
    if inst is not None:
        k_cluster = inst[0].long()
        k_inst = inst[1].long()
        inv = inst[2].reshape(-1, 12)
    bt = torch.where(rays8[..., 7] > BIG, BIG, rays8[..., 7])
    bi = torch.full((n_tiles, TILE), -1, dtype=torch.int32, device=dev)
    bopq = torch.zeros((n_tiles, TILE), dtype=torch.int32, device=dev)
    counts_l = counts.long()
    steps = (counts_l + KB - 1) // KB
    walking = steps > 0
    tile_steps = torch.zeros(n_tiles, dtype=torch.int32, device=dev)
    lane_slot = torch.arange(KB * CLUSTER, device=dev) // CLUSTER
    walked = clusters = 0
    step = 0
    while True:
        active = torch.nonzero(walking & (steps > step)).squeeze(1)
        if active.numel() == 0:
            break
        walked += active.numel()
        tile_steps[active] += 1
        clusters += int((counts_l[active] - step * KB).clamp(max=KB).sum())
        slots = step * KB + torch.arange(KB, device=dev)
        nxt = min((step + 1) * KB, W - 1)
        for sel in active.split(_REF_TILES):
            kk = keys[sel][:, slots.clamp(max=W - 1)]           # (n, KB)
            order = torch.clamp(kk & idmask, max=n_keys - 1).long()
            cl = order if inst is None else k_cluster[order]
            tri = comps[cl].permute(0, 2, 1, 3).reshape(-1, n_rows,
                                                        KB * CLUSTER)
            rows_l = [tri[:, None, i] for i in range(n_rows)]    # (n, 1, L)
            r = rays8[sel]                                       # (n, 32, 8)
            if inst is None:
                ox, oy, oz, dx, dy, dz = (r[..., i, None] for i in range(6))
            else:
                # world rays (n, 32, 1) into each key's instance space:
                # iv0*x + iv1*y + iv2*z (+ iv3), left to right, per
                # (tile, ray, key) and then spread over the key's 128 lanes
                wo = [r[..., i, None] for i in range(3)]
                wd = [r[..., i, None] for i in range(3, 6)]
                iv = inv[k_inst[order]][:, None]             # (n, 1, KB, 12)
                rows = [iv[..., 4 * m:4 * m + 4] for m in range(3)]
                ox, oy, oz = (
                    (a[..., 0] * wo[0] + a[..., 1] * wo[1] + a[..., 2] * wo[2]
                     + a[..., 3]).repeat_interleave(CLUSTER, dim=2)
                    for a in rows)
                dx, dy, dz = (
                    (a[..., 0] * wd[0] + a[..., 1] * wd[1] + a[..., 2] * wd[2]
                     ).repeat_interleave(CLUSTER, dim=2) for a in rows)
            tmin = r[..., 6, None]
            bt_s = bt[sel]
            if bw:
                a, tt, uu, vv = _bw_test(rows_l, ox, oy, oz, dx, dy, dz)
            else:
                a, tt, uu, vv = _mt_test(rows_l, ox, oy, oz, dx, dy, dz)
            slot_ok = (step * KB + lane_slot) < counts_l[sel][:, None, None]
            hit = (a != 0) & (uu >= 0) & (vv >= 0) & (uu + vv <= 1) & \
                (tt >= tmin) & (tt < bt_s[..., None]) & slot_ok
            cand, arg = torch.where(hit, tt, BIG).min(dim=2)     # (n, 32)
            closer = cand < bt_s
            win = torch.gather(order, 1, arg // CLUSTER)
            bt_n = torch.where(closer, cand, bt_s)
            bi_n = torch.where(closer, (win * CLUSTER + arg % CLUSTER).int(),
                               bi[sel])
            bt[sel] = bt_n
            bi[sel] = bi_n
            nk = keys[sel, nxt] & ~idmask
            done = bt_n.view(torch.int32) <= nk[:, None]
            if any_hit:
                bo_n = torch.where(closer, opaque.long()[win].int(),
                                   bopq[sel])
                bopq[sel] = bo_n
                done = done | ((bi_n >= 0) & (bo_n > 0))
            walking[sel] = ~done.all(dim=1)
        step += 1
    if stats is not None:
        stats.update(steps=walked, steps_total=int(steps.sum()),
                     clusters=clusters, tiles=n_tiles, tile_steps=tile_steps)
    tid = bi.reshape(-1)
    t = torch.where(tid < 0, float("inf"), bt.reshape(-1))
    return t, tid


def _mt_test(rows, ox, oy, oz, dx, dy, dz):
    """Möller-Trumbore over [v0 | e1 | e2] component rows, h = cross(d,
    e2). Returns (the determinant a, t, u, v)."""
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = rows
    hx = dy * e2z - dz * e2y
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    a = e1x * hx + e1y * hy + e1z * hz
    f = torch.where(a != 0, 1.0 / torch.where(a == 0, 1.0, a), 0.0)
    sx = ox - v0x
    sy = oy - v0y
    sz = oz - v0z
    uu = f * (sx * hx + sy * hy + sz * hz)
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    vv = f * (dx * qx + dy * qy + dz * qz)
    tt = f * (e2x * qx + e2y * qy + e2z * qz)
    return a, tt, uu, vv


def _bw_test(rows, ox, oy, oz, dx, dy, dz):
    """Baldwin-Weber over [n | n.v0 | r1 | r1.v0 | r2 | r2.v0] rows, in the
    order of trace_tiles_vm3_reference. Returns (the denominator n.d, t,
    u, v)."""
    nx, ny, nz, ndot, r1x, r1y, r1z, r1d, r2x, r2y, r2z, r2d = rows
    den = nx * dx + ny * dy + nz * dz
    num = ndot - (nx * ox + ny * oy + nz * oz)
    f = torch.where(den != 0, 1.0 / torch.where(den == 0, 1.0, den), 0.0)
    tt = num * f
    px = ox + tt * dx
    py = oy + tt * dy
    pz = oz + tt * dz
    uu = r1x * px + r1y * py + r1z * pz - r1d
    vv = r2x * px + r2y * py + r2z * pz - r2d
    return den, tt, uu, vv
