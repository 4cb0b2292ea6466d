"""Path-tracing throughput of the torch port on one CUDA card; the
counterpart of the root bench.py (the JAX package's harness) with its
keys. Prints ONE JSON line.

    python -m tauray_torch.app.bench [--cells=headline,sponza_1080p,
        sponza_1080p_plain,hires,restir_1080p,raster_1080p,
        raster_foliage_1080p,dshgi_1080p,distributed_1080p,quilt_5x9]

Cells, all at depth 4 with next-event estimation:
  * headline: proc://sponza?tris=262144 at 256x256, 16 samples per pixel
    in one pass. Its numbers are the top-level keys,
    with the triangle tests per ray of each wave kind (`tests_per_ray`)
    and the device-time split (`device_ms`);
  * sponza_1080p: proc://sponza?tris=262144&foliage=1 (alpha-tested
    foliage) at 1920x1080, 1 spp;
  * sponza_1080p_plain: proc://sponza?tris=262144 at 1920x1080, 1 spp;
  * hires: proc://sponza?tris=262144 at 1024x1024, 4 spp;
  * restir_1080p: proc://sponza?tris=262144 at 1920x1080 through
    --renderer=restir (ReSTIR DI and GI, the reconnection shift, the other
    restir.* options at their defaults); it has no useful-ray count;
  * raster_1080p: proc://sponza?tris=262144 at 1920x1080 through
    --renderer=raster at its defaults (2048^2 shadow maps, 4 cascades,
    --pcf=64, --pcss=32, 1 sample per pixel);
  * raster_foliage_1080p: raster_1080p's options on
    proc://sponza?tris=262144&foliage=1: every map and camera wave
    through trace_alpha, never the path tracer's alpha rounds;
  * dshgi_1080p: the same scene with an 8x8x8 SH grid over its bounds
    (grid_over) through --preset=ddish-gi (renderer dshgi, depth 4, 512
    samples a probe, 8 samples per pixel: one shaded pass and 8 coverage
    waves; its 4096^2 maps clamp to 2048^2);
  * distributed_1080p: sponza_1080p_plain through the CLI's renderer
    choice with --fake-devices=4 and shuffled strips: four workloads on
    the card, stitched on it (renderer/distributed.py);
  * quilt_5x9: the 45-view light field of scripts/bench_extra.py (44
    cameras added in a row beside the scene's, quilt_cameras) on
    proc://sponza?tris=262144 at 256x256, 1 spp, depth 2, timed twice in
    one run: through the CLI's renderer on one card (`cli`), and
    view-sharded over [cuda:0] * 4 (`view_sharded`), each with ms per
    view.

Each cell renders one warm-up frame, then 5 timed frames, each from
render_device to torch.cuda.synchronize on the host clock (the raster
cells' frames from update_frame, which rebuilds the shadow maps, as the
CLI's frames after the first), and reports their median, min, max and
spread (max - min), the peak device memory of the timed frames, and:
  * lane Mrays/s: the rays the frame hands to the tracer over the median
    frame, counted in the tracer (ops/cluster.TRACED; the lanes of padded
    pixels x spp x (2 x depth - 1) waves on the path tracer, depth bounce
    waves and depth - 1 shadow waves, plus the foliage cell's alpha
    re-trace sub-waves), with the waves per frame and each kernel's
    launches per frame;
  * useful Mrays/s and the useful fraction: the lanes that traced (alive
    bounce lanes, shadow lanes of nonzero length), counted on the device
    (PTConfig.count_rays);
  * tests_per_ray (headline): one frame's waves (capture_waves), each
    traced again through the wave-statistics tool's K5 accounting, steps
    x 8 x 128 triangle tests per lane; per_lane over every lane of the
    wave kind, per_live_ray over the lanes with t_max > 0;
  * device_ms (headline): app/profile.py's range spans of one profiled
    frame (phase1, sig_sort, alpha, shade, traverse), with that frame's
    wall ms, device busy ms and idle share;
  * split_ms (raster cells): the median ms of the frame's parts, each
    timed from a device synchronize to the next (raster_split): the
    device scene update, the shadow maps, the probe bake and the draw,
    and the maps' and the draw's shares of the frame.
The line also names the card and its power limit (nvidia-smi)."""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import statistics
import subprocess
import sys
import time

import torch

from ..ops import cluster, trace_kernel
from ..options import parse_command_line_options
from .main import create_renderer, load_scenes

SCENE = "proc://sponza?tris=262144"
SCENE_FOLIAGE = "proc://sponza?tris=262144&foliage=1"
DEPTH = 4
FRAMES = 5
# cell -> (scene, width, height, spp, renderer, further options)
CELLS = {"headline": (SCENE, 256, 256, 16, "path-tracer", ()),
         "sponza_1080p": (SCENE_FOLIAGE, 1920, 1080, 1, "path-tracer", ()),
         "sponza_1080p_plain": (SCENE, 1920, 1080, 1, "path-tracer", ()),
         "hires": (SCENE, 1024, 1024, 4, "path-tracer", ()),
         "restir_1080p": (SCENE, 1920, 1080, 1, "restir", ()),
         "raster_1080p": (SCENE, 1920, 1080, 1, "raster", ()),
         "raster_foliage_1080p": (SCENE_FOLIAGE, 1920, 1080, 1, "raster",
                                  ()),
         "dshgi_1080p": (SCENE, 1920, 1080, 8, "ddish-gi", ()),
         "distributed_1080p": (SCENE, 1920, 1080, 1, "path-tracer", (
             "--fake-devices=4", "--distribution-strategy=shuffled-strips")),
         "quilt_5x9": (SCENE, 256, 256, 1, "path-tracer", (
             "--max-ray-depth=2",))}
QUILT_VIEWS = 45
RASTER = ("raster", "ddish-gi")


def card() -> dict:
    name, limit = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0].split(", ")
    return {"name": name, "power_limit": limit}


def grid_over(scene, res=8):
    """An SH grid entity of res^3 probes over the scene's bounds (no
    procedural scene carries one)."""
    import numpy as np
    from ..scene.sh_grid import SHGrid
    from ..scene.transformable import Transformable
    pts = []
    for e in scene.entities:
        if e.model is None:
            continue
        M = np.asarray(e.transform.get_global_transform())
        for g in e.model.groups:
            pts.append(g.mesh.positions @ M[:3, :3].T + M[:3, 3])
    pts = np.concatenate(pts)
    lo, hi = pts.min(0), pts.max(0)
    ge = scene.add("probes")
    ge.transform = Transformable(position=(lo + hi) / 2,
                                 scaling=(hi - lo) / 2)
    ge.sh_grid = SHGrid(resolution=(res, res, res), order=2)
    return ge


def _synced_ms(out: list, fn):
    """fn wrapped to append its ms, device synchronize to synchronize,
    to out."""
    def timed(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(*args, **kw)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
        return res
    return timed


@contextlib.contextmanager
def raster_split():
    """Times the parts of raster and DSHGI frames: yields {"update": ms of
    each device scene update, "maps": of each shadow-map build, "bake": of
    each probe bake, "draw": of each render_device less its bake}, every
    part from a device synchronize to the next."""
    from ..renderer.base import Renderer
    from ..renderer.raster_renderer import RasterRenderer
    from ..renderer.sh_renderer import SHRenderer
    rec = {"update": [], "maps": [], "bake": [], "frame": []}
    orig = (Renderer.device_update_frame, RasterRenderer._build_shadow_maps,
            SHRenderer.step, RasterRenderer.render_device)
    Renderer.device_update_frame = _synced_ms(rec["update"], orig[0])
    RasterRenderer._build_shadow_maps = _synced_ms(rec["maps"], orig[1])
    SHRenderer.step = _synced_ms(rec["bake"], orig[2])
    RasterRenderer.render_device = _synced_ms(rec["frame"], orig[3])
    try:
        yield rec
    finally:
        (Renderer.device_update_frame, RasterRenderer._build_shadow_maps,
         SHRenderer.step, RasterRenderer.render_device) = orig
        bake = list(rec["bake"])
        if len(bake) < len(rec["frame"]):
            bake = [0.0] * (len(rec["frame"]) - len(bake)) + bake
        rec["draw"] = [f - b for f, b in zip(rec["frame"], bake)]


def quilt_cameras(scene, n: int = QUILT_VIEWS):
    """n - 1 perspective cameras in a row beside the scene's camera, 0.05
    apart at z = 6 (scripts/bench_extra.py bench_quilt's 5x9 grid)."""
    from ..scene.camera import Camera
    from ..scene.transformable import Transformable
    for k in range(n - 1):
        ce = scene.add(f"quiltcam{k}")
        ce.transform = Transformable(position=(0.05 * (k - 22), 0, 6))
        ce.camera = Camera()
        ce.camera.perspective(45, 1.0, 0.1, 100.0)
        ce.camera_enabled = True


def make_renderer(scene: str, W: int, H: int, spp: int,
                  renderer: str = "path-tracer", extra=(), devices=None,
                  views: int = 1):
    """A renderer on the card; the path tracer with useful-ray counting
    on. renderer "ddish-gi" is --preset=ddish-gi on the scene with an
    8x8x8 SH grid over its bounds. extra: further options (the last
    --max-ray-depth wins); views > 1: the scene gets quilt_cameras; with
    devices the path tracer is the distributed one over them."""
    flag = (f"--preset={renderer}" if renderer == "ddish-gi" else
            f"--renderer={renderer}")
    opt = parse_command_line_options([
        flag, f"--width={W}", f"--height={H}"] + (
        [] if renderer == "ddish-gi" else [
            f"--max-ray-depth={DEPTH}", f"--samples-per-pixel={spp}",
            f"--samples-per-pass={spp}"]) + list(extra) + [
        "--headless=unused", "--filetype=none", scene])
    s = load_scenes(opt)
    if renderer == "ddish-gi":
        grid_over(s)
    if views > 1:
        quilt_cameras(s, views)
    if devices is not None:
        from ..renderer.distributed import DistributedPathTracerRenderer
        rr = DistributedPathTracerRenderer(opt, devices[0],
                                           devices=devices)
    else:
        rr = create_renderer(opt, s, torch.device("cuda"))
    rr.set_scene(s)
    if renderer == "path-tracer":
        rr.cfg = dataclasses.replace(rr.cfg, count_rays=True)
    return rr


def time_frames(rr, update: bool = False):
    """One warm-up frame, then FRAMES timed ones (host ms from
    render_device, or with update from update_frame, to synchronize).
    Returns (ms per frame, useful rays of the last frame or None, peak
    GiB, waves and rays traced per frame, launches per frame of each
    kernel launched), all of the timed frames."""
    rr.reset_accumulation()
    rr.render_device()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cluster.reset_traced()
    trace_kernel.reset_launch_counts()
    ms = []
    for _ in range(FRAMES):
        rr.reset_accumulation()
        t0 = time.perf_counter()
        if update:
            rr.update_frame()
        rr.render_device()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    useful = getattr(rr, "last_useful_rays", None)
    traced = {k: v // FRAMES for k, v in cluster.TRACED.items()}
    launches = {k: v // FRAMES for k, v in trace_kernel.LAUNCHES.items()
                if v}
    return ms, None if useful is None else int(useful), \
        torch.cuda.max_memory_allocated() / 2**30, traced, launches


def run_cell(scene: str, W: int, H: int, spp: int, renderer: str,
             extra=(), devices=None, views: int = 1):
    rr = make_renderer(scene, W, H, spp, renderer, extra, devices, views)
    raster = renderer in RASTER
    with (raster_split() if raster else contextlib.nullcontext()) as split:
        ms, useful, peak, traced, launches = time_frames(rr, update=raster)
    lanes = traced["rays"]
    med = statistics.median(ms)
    cell = dict(
        scene=scene, size=f"{W}x{H}", renderer=renderer, spp=spp,
        depth=rr.opt.max_ray_depth, tris=int(rr.arrays.num_triangles),
        frames=FRAMES,
        ms_per_frame=med, ms_min=min(ms), ms_max=max(ms),
        spread_ms=max(ms) - min(ms), ms_frames=ms,
        waves_per_frame=traced["waves"], launches_per_frame=launches,
        mrays_s=lanes / med / 1e3, lanes=lanes, peak_mem_gb=peak,
        views=len(rr.viewports()))
    if hasattr(rr, "n_devices"):
        cell.update(devices=len(rr.devices), workloads=rr.n_devices,
                    strategy=rr.strategy, view_sharded=rr.view_sharded,
                    ms_per_view=med / rr.cfg.n_views)
    if renderer == "restir":
        cell["shift"] = rr.opt.restir.shift_mapping_type
    if raster:
        # the timed frames' parts (the warm-up frame's come first)
        part = {k: statistics.median(v[-FRAMES:]) if v else 0.0
                for k, v in split.items() if k != "frame"}
        cell.update(split_ms=part, maps_share=part["maps"] / med,
                    draw_share=part["draw"] / med,
                    shadow_maps=int(rr.shadow_maps.depth.shape[0]),
                    map_resolution=rr.shadow_maps.resolution)
    if useful is not None:
        cell.update(useful_mrays_s=useful / med / 1e3,
                    useful_fraction=useful / lanes)
    return cell, rr


def tests_per_ray(rr) -> dict:
    """Triangle tests per ray by wave kind, from one frame's waves."""
    from .wave_stats import wave_stats
    agg = {}
    for w in wave_stats(rr.bvh, rr.capture_waves()):
        a = agg.setdefault(w["kind"], dict(tests=0.0, lanes=0, live=0,
                                           waves=0))
        a["tests"] += w["tests_per_lane_ray"] * w["rays"]
        a["lanes"] += w["rays"]
        a["live"] += w["live_rays"]
        a["waves"] += 1
    return {k: {"per_lane": a["tests"] / max(a["lanes"], 1),
                "per_live_ray": a["tests"] / max(a["live"], 1),
                "waves": a["waves"]} for k, a in agg.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", default=",".join(CELLS))
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the bench runs on a CUDA device and none is "
                           "available")
    cells = args.cells.split(",")
    unknown = set(cells) - set(CELLS)
    if unknown:
        raise ValueError(f"unknown cells {sorted(unknown)}")
    result = {"metric": "pt_throughput", "unit": "Mrays/s",
              "device": card()}
    for name in cells:
        if name == "quilt_5x9":
            # the CLI's renderer (one card: the single-device path
            # tracer), then view-sharded over the card named four times
            cell, rr = run_cell(*CELLS[name], views=QUILT_VIEWS)
            cell["ms_per_view"] = cell["ms_per_frame"] / cell["views"]
            del rr
            torch.cuda.empty_cache()
            cell = {"cli": cell, "view_sharded": run_cell(
                *CELLS[name], devices=[torch.device("cuda", 0)] * 4,
                views=QUILT_VIEWS)[0]}
            result[name] = cell
            continue
        cell, rr = run_cell(*CELLS[name])
        if name == "headline":
            from .profile import profile_frame
            prof = profile_frame(rr)
            result.update(
                value=cell["mrays_s"], ms_per_frame=cell["ms_per_frame"],
                spp=cell["spp"], useful_mrays_s=cell["useful_mrays_s"],
                useful_fraction=cell["useful_fraction"],
                tests_per_ray=tests_per_ray(rr),
                device_ms=dict(prof["range_span_ms"],
                               wall=prof["wall_ms"],
                               busy=prof["device_busy_ms"],
                               idle_share=prof["idle_share"]))
        result[name] = cell
        # the next cell's peak memory counts only its own renderer
        del rr
        torch.cuda.empty_cache()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
