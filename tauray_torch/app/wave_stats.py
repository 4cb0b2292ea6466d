"""Per-wave traversal statistics of real path-tracer waves on one CUDA card
(the counterpart of tauray_tpu's scripts/wave_stats.py).

    python -m tauray_torch.app.wave_stats

TAURAY_BENCH_SCENE (default proc://sponza?tris=262144) and
TAURAY_BENCH_SPP (default 16) choose the scene and the samples per pixel of
a 256x256, depth-4 frame, all samples in one pass. The tool captures the
trace waves of the frame's first call (PathTracerRenderer.capture_waves)
and traces each again on the flat tracer, bounce and shadow
waves signature-sorted as the path tracer sorts them. Per wave it prints
the live fraction; the active clusters per 32-ray tile (mean, p95) and
per ray (the per-ray need); the steps each tile walked through the
front-to-back kernel (trace_tiles_vm with debug_steps; mean, p95); the
triangle tests per lane-ray, steps x 8 x 128; and the kernel's ms and the
full trace's ms (phase 1 + the path's kernel), both CUDA events. The last
line holds the totals.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, List

import torch

from ..ops.cluster import (TILE, ClusterTracer, _block_chunks, _pack_rays,
                           _phase1_entry, _sig_sort_perm, _slab_blocks,
                           _trace_padded)
from ..ops.trace_kernel import CLUSTER, KB, trace_tiles_vm
from ..options import parse_command_line_options
from .main import create_renderer, load_scenes

DEFAULT_SCENE = "proc://sponza?tris=262144"


def _ms(fn, reps: int = 1) -> float:
    """Mean ms of fn over reps calls after one warm-up call (CUDA
    events)."""
    fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _per_ray_need(tracer: ClusterTracer, rays8) -> torch.Tensor:
    """(R,) count of cluster AABBs each ray enters within [t_min, t_max]."""
    need = []
    for b0, b1 in _block_chunks(rays8.shape[0] // TILE, tracer.n_clusters):
        act = _slab_blocks(rays8, b0, b1, tracer.cmin, tracer.cmax)[1]
        need.append(act.sum(dim=1).reshape(-1))
    return torch.cat(need)


def _p95(x: torch.Tensor) -> float:
    return float(torch.quantile(x.float(), 0.95))


def wave_stats(tracer: ClusterTracer, waves) -> List[Dict[str, float]]:
    """Statistics of each captured wave (kind, o, d, t_min, t_max); the
    first bounce wave (t_min 0) is reported as the camera wave."""
    out = []
    for kind, o, d, t_min, t_max in waves:
        rays8 = _pack_rays(o, d, t_min, t_max)
        if kind == "bounce" and t_min == 0.0:
            kind = "camera"
        else:                                     # the path tracer's sort
            rays8 = rays8[_sig_sort_perm(tracer, rays8)]
        rays8 = rays8.contiguous()
        any_hit = kind == "shadow"
        full_ms = _ms(lambda: _trace_padded(tracer, rays8, any_hit, False))
        counts, keys, idmask = _phase1_entry(tracer.cmin, tracer.cmax, rays8)
        args = (counts, keys, rays8.reshape(-1, 32, 8), tracer.tris12,
                tracer.opaque, idmask, any_hit)
        steps = trace_tiles_vm(*args, debug_steps=True)[2].float()
        kernel_ms = _ms(lambda: trace_tiles_vm(*args))
        live = rays8[:, 7] > 0
        out.append(dict(
            kind=kind, rays=rays8.shape[0],
            live=float(live.float().mean()),
            tile_clusters_mean=float(counts.float().mean()),
            tile_clusters_p95=_p95(counts),
            per_ray_need=float(_per_ray_need(tracer, rays8).float().mean()),
            steps_mean=float(steps.mean()), steps_p95=_p95(steps),
            tests_per_lane_ray=float(steps.mean()) * KB * CLUSTER,
            live_rays=int(live.sum()), kernel_ms=kernel_ms,
            full_ms=full_ms))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("the wave statistics run on a CUDA device and "
                           "none is available")
    scene_path = os.environ.get("TAURAY_BENCH_SCENE", DEFAULT_SCENE)
    spp = int(os.environ.get("TAURAY_BENCH_SPP", "16"))
    opt = parse_command_line_options([
        "--renderer=path-tracer", "--width=256", "--height=256",
        "--max-ray-depth=4", f"--samples-per-pixel={spp}",
        f"--samples-per-pass={spp}", "--headless=unused",
        "--filetype=none", scene_path])
    scene = load_scenes(opt)
    rr = create_renderer(opt, scene, torch.device("cuda"))
    rr.set_scene(scene)
    if not isinstance(rr.bvh, ClusterTracer):
        raise ValueError("the wave statistics need the flat tracer")
    waves = rr.capture_waves()
    tracer = rr.bvh
    print(f"scene {scene_path}: C={tracer.n_clusters} clusters, kernel "
          f"TILE=32 KB={KB}, {torch.cuda.get_device_name(0)}", flush=True)
    tests = rays = full = 0.0
    for i, w in enumerate(wave_stats(tracer, waves)):
        tests += w["tests_per_lane_ray"] * w["rays"]
        rays += max(w["live_rays"], 1)
        full += w["full_ms"]
        print(f"{i}:{w['kind']:6s} R={w['rays']} live={w['live']:4.2f} "
              f"activations/tile mean={w['tile_clusters_mean']:6.1f} "
              f"p95={w['tile_clusters_p95']:6.0f} "
              f"per-ray-need={w['per_ray_need']:5.1f} "
              f"steps mean={w['steps_mean']:5.2f} "
              f"p95={w['steps_p95']:4.0f} "
              f"tests/lane-ray={w['tests_per_lane_ray']:7.0f} "
              f"kern={w['kernel_ms']:6.1f}ms full={w['full_ms']:6.1f}ms",
              flush=True)
    print(f"TOTAL trace {full:.0f} ms  tests/lane-ray avg="
          f"{tests / max(rays, 1):.0f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
