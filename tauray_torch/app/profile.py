"""Device-time breakdown of path-traced frames on one CUDA card.

    python -m tauray_torch.app.profile [--width=256 --height=256
        --samples-per-pixel=16 --samples-per-pass=16 --max-ray-depth=4]
        [scene]

Renders one warm-up frame, then profiles the next with torch.profiler and
prints one JSON line: frame wall ms, device busy ms and idle share, the
span on the device timeline of each range of tracing.SPANS (frame, the
renderer's render_device; trace_wave, each wave handed to a tracer;
sig_sort, phase1, traverse, slab (the slab test, inside phase1 and
sig_sort), alpha (the re-trace rounds' compaction and alpha tests), shade;
for
--renderer=restir / restir-hybrid gbuffer, restir_di, restir_gi and
sh_bake, which contain their waves' phase1 and traverse; for
--renderer=raster / dshgi shadow_maps, raster_draw and pcf; for
--fake-devices / --mesh-shape path tracing (each device's slice) and
stitch (the gather of the partial frames
onto the first device and the scatter into the accumulation); the profiled
frame then starting with update_frame, which rebuilds the maps, as the
CLI's frames after the first do; a span includes gaps between its
kernels), device ms of the top kernels by name, and the peak device
memory.
"""

from __future__ import annotations

import json
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from ..options import parse_command_line_options
from ..tracing import SPANS
from .main import create_renderer, load_scenes


def _self_device_ms(evt) -> float:
    return float(getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0))) / 1e3


def profile_frame(rr, update: bool = False) -> dict:
    """Profile one frame of a renderer that has rendered at least once
    (with update, from its update_frame): frame wall ms, device busy ms
    and idle share, the device-timeline span of each range, device ms of
    the top kernels by name, and the peak device memory (GiB) since the
    last reset of the peak."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        if update:
            rr.update_frame()
        rr.reset_accumulation()
        rr.render_device().sum().item()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events: kernels and memcpys, plus one annotation per
    # record_function range whose self time is the range's span on the
    # device timeline
    device = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA")]
    ranges = {name: 0.0 for name in SPANS}
    kernels = []
    for e in device:
        if e.key in ranges:
            ranges[e.key] += _self_device_ms(e)
        else:
            kernels.append(e)
    busy = sum(_self_device_ms(e) for e in kernels)
    by_name = {}
    for e in kernels:            # template instances share a short name
        key = e.key[:60]
        by_name[key] = by_name.get(key, 0.0) + _self_device_ms(e)
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:12])
    return dict(
        device=torch.cuda.get_device_name(0), wall_ms=wall_ms,
        device_busy_ms=busy, idle_share=max(0.0, 1 - busy / wall_ms),
        range_span_ms=ranges, top_kernels_ms=top,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not any(not a.startswith("-") for a in argv):
        argv = argv + ["proc://sponza?tris=262144"]
    if not torch.cuda.is_available():
        raise RuntimeError("profiling needs a CUDA device")
    opt = parse_command_line_options(argv)
    scene = load_scenes(opt)
    rr = create_renderer(opt, scene, torch.device("cuda"))
    rr.set_scene(scene)
    rr.render_device().sum().item()           # warm-up frame
    print(json.dumps(profile_frame(
        rr, update=opt.renderer in ("raster", "dshgi"))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
