"""The benchmark of tauray_torch, the PyTorch and CUDA port, on NVIDIA GPUs.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Runs one cell of BENCHMARK.json from the root of a checkout. The cell's
file (benchmark/workloads/<cell>.json) names its configuration
(benchmark/configs/<config>.json) and holds its traffic, its wave
schedule, its sample size and its limits; each metric's reader is
benchmark/metrics/<metric>.py. A run builds the cell's scene
(benchmark/scene.py), hands it to the port as a glTF file, builds the
renderer on the card as the command line does, renders its warm-up
frames, then renders whole frames back to back through the renderer's
render_device() until --seconds have passed (the frame in flight then
finishes and counts). The seed sets the sample streams; the scene, camera
and work per frame are the same for every seed.

Every run keeps the size and kind of every wave handed to the tracer and
a sample of its rays and answers, drawn from the seed, and after the
window holds them to the cell's schedule and to the plain reference
(benchmark/judge.py): `correct` and each number beside its limit.
--trace 1 profiles the window (torch.profiler) and reports the per-layer
metrics instead of the end-to-end ones.

Prints, as its last line on standard output, one JSON object: correct,
attempted and failed frames, metrics, device and, traced, breakdown, with
the compared numbers last under "checks"; the same numbers are the last
lines on standard error. Exits with 2, printing no result, without the
CUDA cards the cell asks for, and with 3 if JAX or the JAX package was
loaded."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# top-level module names no run may load (compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "tauray_tpu")
WINDOW_RANGE = "bench_window"


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]


@dataclass
class Run:
    """What a run measured, as the metric readers see it."""
    frames: int = 0
    elapsed_s: float = 0.0
    setup_s: float = 0.0
    peak_bytes: int = 0
    counts: Dict[str, int] = field(default_factory=dict)
    k1_launches: List[tuple] = field(default_factory=list)
    trace: Optional[object] = None
    setup_parts: Dict[str, float] = field(default_factory=dict)
    frame_s: List[float] = field(default_factory=list)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell `name` of BENCHMARK.json with its cell file, configuration
    and the metrics it reports."""
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"unknown workload {name!r}")
    traffic = _json(os.path.join(HERE, "workloads", f"{name}.json"))
    config = _json(os.path.join(HERE, "configs", f"{entry['config']}.json"))

    def mine(ms):
        return [m for m in ms if name in m.get("workloads", [name])]
    return Cell(name, int(entry["chips"]), config, traffic,
                mine(bench["end_to_end"]), mine(bench["per_layer"]))


def reader(metric: str):
    return importlib.import_module(f"benchmark.metrics.{metric}")


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} &
                  set(FORBIDDEN))


def power_limit() -> Optional[str]:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0].split(", ")[1]
    except (OSError, IndexError, subprocess.SubprocessError):
        return None


def window(frame, seconds: float, clock=time.perf_counter):
    """Calls frame() back to back until `seconds` have passed since the
    first call began; the frame in flight then finishes. Returns (whole
    frames, elapsed seconds to the end of the last)."""
    t0 = clock()
    frames = 0
    while True:
        frame()
        frames += 1
        elapsed = clock() - t0
        if elapsed >= seconds:
            return frames, elapsed


def measure(cell: Cell, seed: int, seconds: float, trace: bool, device,
            t_start: float = T_START, fault=None):
    """Set-up, warm-up and the window of one run of `cell` on `device`.
    Returns (Run, the captured frames on the host, the plain scene), with
    the program's state freed. fault(renderer), when given, runs after the
    warm-up, before the window, and returns what mends it once the window
    has closed: the tests and the control break the timed path with it
    (benchmark/faults.py)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark import profiling, program
    traffic = cell.traffic
    run = Run()
    mark = time.perf_counter()
    run.setup_parts["imports"] = mark - t_start

    def lap(part):
        nonlocal mark
        now = time.perf_counter()
        run.setup_parts[part] = now - mark
        mark = now
    if device.type == "cuda":
        torch.zeros(1, device=device)
        torch.cuda.synchronize(device)
        lap("cuda_init")
    plain = program.plain_scene(cell.config)
    lap("scene")
    if device.type == "cuda":
        program.load_kernels()
        lap("kernel_libraries")
    capture = program.WaveCapture(int(traffic["sample_rays_per_wave"]),
                                  seed, device)
    k1 = program.K1Counter() if trace else None
    mend = None
    capture.install()
    try:
        rr = program.make_renderer(cell.config, traffic, seed, plain,
                                   device)
        lap("renderer")
        capture.on = True
        for _ in range(int(traffic.get("warmup_frames", 1))):
            capture.begin_frame()
            program.reset_frame(rr, traffic)
            program.frame_done(rr.render_device(), device)
        capture.frames = []
        lap("warmup_frames")
        if fault is not None:
            mend = fault(rr)
        if k1 is not None:
            k1.install()
        program.reset_counts()
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) \
            if trace and device.type == "cuda" else None
        run.setup_s = time.perf_counter() - t_start
        with prof if prof is not None else contextlib.nullcontext():
            with record_function(WINDOW_RANGE):
                def frame():
                    t = time.perf_counter()
                    capture.begin_frame()
                    program.reset_frame(rr, traffic)
                    program.frame_done(rr.render_device(), device)
                    run.frame_s.append(time.perf_counter() - t)
                run.frames, run.elapsed_s = window(frame, seconds)
        capture.on = False
        run.counts = program.traced_counts()
        if device.type == "cuda":
            run.peak_bytes = int(torch.cuda.max_memory_allocated(device))
        if k1 is not None:
            run.k1_launches = k1.read()
    finally:
        if mend is not None:
            mend()
        capture.uninstall()
        if k1 is not None:
            k1.uninstall()
    frames = capture.to_host()
    del rr, capture
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if prof is not None:
        run.trace = profiling.from_profiler(prof, run.frames, WINDOW_RANGE)
    elif trace:
        run.trace = profiling.Trace(frames=run.frames)
    return run, frames, plain


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float = T_START, fault=None) -> dict:
    """One run of `cell` on `device` (see `measure`); returns the result's
    fields, the compared numbers last under "checks"."""
    import torch

    from benchmark import judge, profiling, reference
    traffic = cell.traffic
    run, frames, plain = measure(cell, seed, seconds, trace, device,
                                 t_start, fault)
    t_ref = time.perf_counter()
    tris = torch.from_numpy(reference.world_triangles(plain)).to(device)
    shown = []
    nums = judge.numbers(frames, tris, judge.schedule(traffic),
                         shown=shown)
    compared = nums.pop("rays_compared")
    reference_s = time.perf_counter() - t_ref
    correct, checks = judge.verdict(nums, traffic["limits"])

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = reader(m["name"]).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": run.peak_bytes}
    out = {"correct": bool(correct), "attempted": run.frames, "failed": 0,
           "metrics": metrics, "device": dev}
    if trace and run.trace is not None:
        tr = run.trace
        dev["busy_s"] = profiling.busy_s(tr)
        dev["window_s"] = tr.window[1] - tr.window[0]
        out["breakdown"] = {"device_ops": profiling.top_ops(tr),
                            "idle_gaps": profiling.idle_gaps(tr)}
    out["counts"] = run.counts
    out["setup_parts"] = run.setup_parts
    out["frame_s"] = run.frame_s
    out["rays_compared"] = compared
    out["reference_s"] = reference_s
    out["rays_off"] = shown
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    cell = load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"the cell {cell.name} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0))
    limit = power_limit()
    if limit is not None:
        out["device"]["power_limit"] = limit
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {', '.join(bad)}; it may load none of "
              f"{', '.join(FORBIDDEN)}", file=sys.stderr)
        return 3
    checks = out.pop("checks")
    out["checks"] = checks
    for ray in out.pop("rays_off"):
        print("ray off:", json.dumps(ray), file=sys.stderr)
    for name, c in checks.items():
        lim = f" (limit {c['limit']})" if "limit" in c else ""
        print(f"check {name} = {c['value']}{lim}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
