"""The binding of the hand-written Hopper kernels of the TPU labs:
csrc/k1_lab.cu (the four K1 labs, L8-L11) and csrc/brick_lab.cu (the brick
and resident-table labs, L4-L7). ops/trace_kernel.build_all compiles each
with nvcc for sm_90a beside csrc/trace_tiles.cu, with the same flags
(-fmad=false among them), into tauray_torch/_build/ on first use; they are
loaded with ctypes. A failed build or launch raises: no lab falls back from
the card to its plain version."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..ops import trace_kernel
from ..ops.trace_kernel import _check
from .common import CLUSTER, G, ROW, TILE

# each lab's modes, in the order k1_lab_launch and brick_lab_launch number
# them
MODES = {"lab4": ("mt", "mtfast"),
         "lab5": ("mt",),
         "lab6": ("fixed", "slot", "cid", "while", "while2"),
         "lab7": ("mt", "bw"),
         "lab8": (0, 1, 2, 3),
         "lab9": ("full", "exit", "loads", "math", "nocat"),
         "lab10": ("full", "noray", "fixord", "nowrite"),
         "lab11": ("vpu", "mxu")}
# wrapper launches of each lab's kernel, counted where it is launched
LAUNCHES: Dict[str, int] = {lab: 0 for lab in MODES}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def on_card(x: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU tensors (the plain version);
    any other device raises."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"no lab kernel for {x.device}")
    return True


def check_tiles(counts: torch.Tensor, rays: torch.Tensor, ray_width: int,
                name: str, group: bool = True) -> int:
    """counts (n_tiles,) i32 and the ray block (n_tiles, 32, ray_width)
    f32 on one device, contiguous and aligned; with group, n_tiles a
    multiple of the group of 32 tiles. Returns n_tiles."""
    dev = rays.device
    _check(counts, "counts", torch.int32, 1, dev)
    _check(rays, "rays", torch.float32, 3, dev)
    n_tiles = counts.shape[0]
    if tuple(rays.shape) != (n_tiles, TILE, ray_width):
        raise ValueError(f"{name}: rays {tuple(rays.shape)} for "
                         f"{n_tiles} tiles of {TILE} x {ray_width}")
    if group and n_tiles % G:
        raise ValueError(f"{name}: {n_tiles} tiles, not groups of {G}")
    return n_tiles


def launch(lab: str, mode, counts: torch.Tensor,
           keys: Optional[torch.Tensor], rays: torch.Tensor,
           d3: Optional[torch.Tensor] = None,
           mm2: Optional[torch.Tensor] = None,
           tris: Optional[torch.Tensor] = None, idmask: int = 0,
           warps: int = 0) -> torch.Tensor:
    """Launches lab's kernel in mode on checked CUDA tensors (see
    k1_lab_launch for what each lab reads) and counts the launch. Returns
    out (n_tiles, 32, 2) f32: t, then the id's int32 bits."""
    dev = rays.device
    lib = trace_kernel.build_all()["k1_lab"]
    n_tiles = counts.shape[0]
    out = torch.empty((n_tiles, TILE, 2), dtype=torch.float32, device=dev)

    def ptr(x):
        return 0 if x is None else x.data_ptr()
    err = lib.k1_lab_launch(
        int(lab[3:]), MODES[lab].index(mode), ptr(counts), ptr(keys),
        0 if keys is None else keys.shape[1], ptr(rays), ptr(d3), ptr(mm2),
        ptr(tris), n_tiles, 0 if tris is None else tris.shape[0], idmask,
        warps, out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{lab} {mode} launch failed: CUDA error {err}")
    LAUNCHES[lab] += 1
    return out


def check_brick(lab: str, mode, meta: torch.Tensor, rays: torch.Tensor,
                tris: torch.Tensor, kb: int, steps: int) -> None:
    """An L4-L7 walk's arguments: meta (n_tiles x 1,024,) i32, rays
    (n_tiles, 8 | 16 | 32, 8) f32 and tris (C, 9 | 12, 1, 128) f32 (12 for
    L7 bw) on one device, contiguous and aligned; 1 <= kb <= 16 and the
    steps' meta entries within a tile's row."""
    if mode not in MODES[lab]:
        raise ValueError(f"{lab}: no mode {mode}")
    dev = rays.device
    _check(meta, "meta", torch.int32, 1, dev)
    _check(rays, "rays", torch.float32, 3, dev)
    _check(tris, "tris", torch.float32, 4, dev)
    n_tiles, tile, width = rays.shape
    nf = 12 if mode == "bw" else 9
    if tile not in (8, 16, 32) or width != 8:
        raise ValueError(f"{lab}: rays {tuple(rays.shape)}, not tiles of "
                         f"8, 16 or 32 x 8")
    if meta.shape[0] != n_tiles * ROW:
        raise ValueError(f"{lab}: {meta.shape[0]} meta entries for "
                         f"{n_tiles} tiles of {ROW}")
    if tuple(tris.shape[1:]) != (nf, 1, CLUSTER) or tris.shape[0] < 1:
        raise ValueError(f"{lab} {mode}: tris {tuple(tris.shape)}, not "
                         f"(C, {nf}, 1, {CLUSTER})")
    if not 1 <= kb <= 16 or steps < 0 or steps * kb > ROW:
        raise ValueError(f"{lab}: KB {kb}, {steps} steps")


def launch_brick(lab: str, mode, meta: torch.Tensor, rays: torch.Tensor,
                 tris: torch.Tensor, kb: int, steps: int) -> torch.Tensor:
    """Launches lab's walk (csrc/brick_lab.cu) in mode on checked CUDA
    tensors and counts the launch. Returns out (n_tiles, tile, 2) f32: t,
    then the id (its int32 bits; L7: float(id))."""
    check_brick(lab, mode, meta, rays, tris, kb, steps)
    dev = rays.device
    lib = trace_kernel.build_all()["brick_lab"]
    n_tiles, tile = rays.shape[:2]
    out = torch.empty((n_tiles, tile, 2), dtype=torch.float32, device=dev)
    err = lib.brick_lab_launch(
        int(lab[3:]), MODES[lab].index(mode), meta.data_ptr(),
        rays.data_ptr(), tris.data_ptr(), n_tiles, tile, tris.shape[0], kb,
        steps, out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{lab} {mode} launch failed: CUDA error {err}")
    LAUNCHES[lab] += 1
    return out
