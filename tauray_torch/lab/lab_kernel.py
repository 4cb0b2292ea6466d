"""The binding of csrc/k1_lab.cu, the hand-written Hopper kernels of the four
K1 labs. ops/trace_kernel.build_all compiles it with nvcc for sm_90a
beside csrc/trace_tiles.cu, with the same flags (-fmad=false among them),
into tauray_torch/_build/ on first use; it is loaded with ctypes. A failed
build or launch raises: no lab falls back from the card to its plain
version."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..ops import trace_kernel
from ..ops.trace_kernel import _check
from .common import G, TILE

# each lab's modes, in the order k1_lab_launch numbers them
MODES = {"lab8": (0, 1, 2, 3),
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
