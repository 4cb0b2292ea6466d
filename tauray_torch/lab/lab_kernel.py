"""The binding of the hand-written Hopper kernels of the TPU labs:
csrc/k1_lab.cu (the four K1 labs, L8-L11), csrc/brick_lab.cu (the brick
and resident-table labs, L4-L7), csrc/tile_lab.cu (the 128-ray tile walks,
L1-L3) and csrc/mxu_lab.cu (the Plücker test as matrix products against
Möller-Trumbore, L12). ops/trace_kernel.build_all compiles each
with nvcc for sm_90a beside csrc/trace_tiles.cu, with the same flags
(-fmad=false among them), into tauray_torch/_build/ on first use; they are
loaded with ctypes. A failed build or launch raises: no lab falls back from
the card to its plain version."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..ops import trace_kernel
from ..ops.trace_kernel import _check
from .common import CLUSTER, G, ORDER_L12, ROW, ROW_L1, TILE, TILE_L1

# each lab's modes, in the order k1_lab_launch, brick_lab_launch,
# tile_lab_launch (lab1-lab3: kernels 0-5) and mxu_lab_launch number them
MODES = {"lab1": ("k0", "k1", "k2", "k3"),
         "lab2": ("k4",),
         "lab3": ("k5",),
         "lab4": ("mt", "mtfast"),
         "lab5": ("mt",),
         "lab6": ("fixed", "slot", "cid", "while", "while2"),
         "lab7": ("mt", "bw"),
         "lab8": (0, 1, 2, 3),
         "lab9": ("full", "exit", "loads", "math", "nocat"),
         "lab10": ("full", "noray", "fixord", "nowrite"),
         "lab11": ("vpu", "mxu"),
         "lab12": ("mt", "plucker")}
# tile_lab_launch's kernel of each L1-L3 mode
_TILE_KERNEL = {("lab1", "k0"): 0, ("lab1", "k1"): 1, ("lab1", "k2"): 2,
                ("lab1", "k3"): 3, ("lab2", "k4"): 4, ("lab3", "k5"): 5}
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
           warps: int = 0,
           order: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launches lab's kernel in mode on checked CUDA tensors (see
    k1_lab_launch for what each lab reads; warps is an older L10's W, and
    an older library reads no order) and counts the launch. Returns out
    (n_tiles, 32, 2) f32: t, then the id's int32 bits."""
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
        warps, out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        ptr(order))
    if err != 0:
        raise RuntimeError(f"{lab} {mode} launch failed: CUDA error {err}")
    LAUNCHES[lab] += 1
    return out


def check_brick(lab: str, mode, meta: torch.Tensor, rays: torch.Tensor,
                tris: torch.Tensor, kb: int, steps: int) -> None:
    """An L4-L7 walk's arguments: meta (n_tiles x 1,024,) i32, rays
    (n_tiles, 8 | 16 | 32, 8) f32 (L7: 32) and tris (C, 9 | 12, 1, 128) f32
    (12 for L7 bw) on one device, contiguous and aligned; 1 <= kb <= 16 and the
    steps' meta entries within a tile's row."""
    if mode not in MODES[lab]:
        raise ValueError(f"{lab}: no mode {mode}")
    dev = rays.device
    _check(meta, "meta", torch.int32, 1, dev)
    _check(rays, "rays", torch.float32, 3, dev)
    _check(tris, "tris", torch.float32, 4, dev)
    n_tiles, tile, width = rays.shape
    nf = 12 if mode == "bw" else 9
    if tile not in ((32,) if lab == "lab7" else (8, 16, 32)) or width != 8:
        raise ValueError(f"{lab}: rays {tuple(rays.shape)}, not tiles of "
                         f"{'32' if lab == 'lab7' else '8, 16 or 32'} x 8")
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


def check_tile(lab: str, mode: str, counts: torch.Tensor,
               meta: torch.Tensor, rays: torch.Tensor, tris: torch.Tensor,
               group: int) -> int:
    """An L1-L3 walk's arguments (scripts/kernel_lab.py): counts (n_tiles,)
    i32, meta (n_tiles x 3,072,) i32, tris (C, 9, 1, 128) f32 and
    rays f32 in the lab's layout, L1 (8, n_tiles * 128) columns, L2
    (n_tiles, 8, 128) planes, L3 (n_tiles, 128, 8) rows, on one device,
    contiguous and aligned; group (the script's tiles a TPU grid step;
    the card walks one tile a block whatever it is) dividing n_tiles, 1
    for L1. Returns n_tiles."""
    if (lab, mode) not in _TILE_KERNEL:
        raise ValueError(f"{lab}: no mode {mode}")
    dev = rays.device
    _check(counts, "counts", torch.int32, 1, dev)
    _check(meta, "meta", torch.int32, 1, dev)
    _check(tris, "tris", torch.float32, 4, dev)
    n_tiles = counts.shape[0]
    want = {"lab1": (8, n_tiles * TILE_L1), "lab2": (n_tiles, 8, TILE_L1),
            "lab3": (n_tiles, TILE_L1, 8)}[lab]
    _check(rays, "rays", torch.float32, len(want), dev)
    if tuple(rays.shape) != want:
        raise ValueError(f"{lab}: rays {tuple(rays.shape)} for {n_tiles} "
                         f"tiles, not {want}")
    if meta.shape[0] != n_tiles * ROW_L1:
        raise ValueError(f"{lab}: {meta.shape[0]} meta entries for "
                         f"{n_tiles} tiles of {ROW_L1}")
    if tuple(tris.shape[1:]) != (9, 1, CLUSTER) or tris.shape[0] < 1:
        raise ValueError(f"{lab}: tris {tuple(tris.shape)}, not (C, 9, 1, "
                         f"{CLUSTER})")
    if group < 1 or n_tiles % group or (lab == "lab1" and group != 1):
        raise ValueError(f"{lab}: {n_tiles} tiles in groups of {group}")
    return n_tiles


def launch_tile(lab: str, mode: str, counts: torch.Tensor,
                meta: torch.Tensor, rays: torch.Tensor, tris: torch.Tensor,
                group: int = 1) -> torch.Tensor:
    """Launches an L1-L3 walk (csrc/tile_lab.cu) on checked CUDA tensors
    and counts the launch. Returns out f32 with t and the id's int32 bits:
    L1 (2, n_tiles * 128), L2 (n_tiles, 2, 128), L3 (n_tiles, 128, 2)."""
    n_tiles = check_tile(lab, mode, counts, meta, rays, tris, group)
    dev = rays.device
    lib = trace_kernel.build_all()["tile_lab"]
    shape = {"lab1": (2, n_tiles * TILE_L1), "lab2": (n_tiles, 2, TILE_L1),
             "lab3": (n_tiles, TILE_L1, 2)}[lab]
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    err = lib.tile_lab_launch(
        _TILE_KERNEL[lab, mode], counts.data_ptr(), meta.data_ptr(),
        rays.data_ptr(), tris.data_ptr(), n_tiles, tris.shape[0], group,
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{lab} {mode} launch failed: CUDA error {err}")
    LAUNCHES[lab] += 1
    return out


def check_lab12(mode: str, order: torch.Tensor, o3: torch.Tensor,
                d3: torch.Tensor, mm2: torch.Tensor, tris: torch.Tensor) -> int:
    """L12's arguments (scripts/mxu_lab.py): order (n_tiles, 64) i32, o3 and d3 (n_tiles, 32, 3) f32, mm2 (n_tiles, 32, 2) f32, tris
    (C, 9, 1, 128) f32 for mt or (C, 24, 1, 128) for plucker, on one
    device, contiguous and aligned. Returns n_tiles."""
    if mode not in MODES["lab12"]:
        raise ValueError(f"lab12: no mode {mode}")
    dev = o3.device
    _check(order, "order", torch.int32, 2, dev)
    _check(tris, "tris", torch.float32, 4, dev)
    n_tiles = order.shape[0]
    for x, name, w in ((o3, "o3", 3), (d3, "d3", 3), (mm2, "mm2", 2)):
        _check(x, name, torch.float32, 3, dev)
        if tuple(x.shape) != (n_tiles, TILE, w):
            raise ValueError(f"lab12: {name} {tuple(x.shape)} for {n_tiles} "
                             f"tiles of {TILE} x {w}")
    nf = 9 if mode == "mt" else 24
    if tuple(tris.shape[1:]) != (nf, 1, CLUSTER) or tris.shape[0] < 1:
        raise ValueError(f"lab12 {mode}: tris {tuple(tris.shape)}, not (C, "
                         f"{nf}, 1, {CLUSTER})")
    if order.shape[1] != ORDER_L12:
        raise ValueError(f"lab12: order rows of {order.shape[1]}, not "
                         f"{ORDER_L12}")
    return n_tiles


def launch_lab12(mode: str, order: torch.Tensor, o3: torch.Tensor,
                 d3: torch.Tensor, mm2: torch.Tensor,
                 tris: torch.Tensor) -> torch.Tensor:
    """Launches L12's mode (csrc/mxu_lab.cu) on checked CUDA tensors and
    counts the launch. Returns out (n_tiles, 32, 2) f32: t, then the order
    slot's int32 bits."""
    n_tiles = check_lab12(mode, order, o3, d3, mm2, tris)
    dev = o3.device
    lib = trace_kernel.build_all()["mxu_lab"]
    out = torch.empty((n_tiles, TILE, 2), dtype=torch.float32, device=dev)
    err = lib.mxu_lab_launch(
        MODES["lab12"].index(mode), order.data_ptr(), o3.data_ptr(),
        d3.data_ptr(), mm2.data_ptr(), tris.data_ptr(), n_tiles,
        tris.shape[0], out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lab12 {mode} launch failed: CUDA error {err}")
    LAUNCHES["lab12"] += 1
    return out
