"""The port's tracing (tauray_torch/tracing.py) on the CPU: spans that cost
nothing while the record is off, the record behind get_timing(), --timing
and the trace-event exporter, the distributed renderer's per-device
"path tracing" times that the load balancer reads, and K1's work counted
at its wrapper."""

import io
import json
import os
import re

import numpy as np
import pytest
import torch

from tauray_torch import tracing
from tauray_torch.log import logger
from tauray_torch.ops import cluster as tcl
from tauray_torch.ops import trace_kernel
from tauray_torch.options import Options
from tauray_torch.renderer.rt_renderer import PathTracerRenderer

from test_torch_scene import floor_scene

# the tests run in several worker processes at once: keep torch's
# intra-op pool small so they do not oversubscribe the cores
torch.set_num_threads(2)

CPU = torch.device("cpu")
PKG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tauray_torch")
# the stages of one path-traced frame of the floor scene: its camera wave
# and its sorted bounce and shadow waves through phase 1 and K1
PT_STAGES = ("frame", "trace_wave", "sig_sort", "slab", "phase1", "traverse",
             "shade")


def _opt(**kw):
    opt = Options()
    opt.width = opt.height = 8
    opt.samples_per_pixel = 1
    opt.max_ray_depth = 3
    opt.tonemap = "linear"
    for k, v in kw.items():
        setattr(opt, k, v)
    return opt


@pytest.fixture
def record():
    """A record on the CPU, on for the test and off after it."""
    rec = tracing.TracingRecord(device=CPU).start()
    try:
        yield rec
    finally:
        rec.stop()


def _soup_tracer(seed: int):
    rng = np.random.default_rng(seed)
    T = 4 * 128 - 11
    v0 = rng.uniform(-4, 4, (T, 3)).astype(np.float32)
    tri = (v0[:, None] + rng.normal(0, 0.7, (T, 3, 3))).astype(np.float32)
    tt, _ = tcl.build_cluster_tracer(tri, np.zeros(T, np.int32),
                                     strategy="per-material", device=CPU)
    R = 1000
    o = torch.from_numpy(rng.uniform(-6, 6, (R, 3)).astype(np.float32))
    d = torch.from_numpy(rng.standard_normal((R, 3)).astype(np.float32))
    return tt, o, d / d.norm(dim=1, keepdim=True)


def test_span_with_the_record_off_makes_no_event(monkeypatch):
    """With no record on, a span is its profiler range alone: no CUDA
    event is made (torch.cuda.Event counted), a record that was never
    started receives nothing, and K1's visits are not counted; a whole
    frame and a traced wave alike."""
    made = []

    class Event:
        def __init__(self, *a, **k):
            made.append(1)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    assert not tracing.counting()
    idle = tracing.TracingRecord(device=CPU)
    with tracing.span("frame", CPU, 0):
        with tracing.span("phase1"):
            pass
    rr = PathTracerRenderer(_opt(), CPU)
    rr.set_scene(floor_scene("tauray_torch"))
    trace_kernel.reset_launch_counts()
    rr.render_device()
    tt, o, d = _soup_tracer(1)
    tt.trace(o, d, 0.0, float("inf"), sort_rays=True)
    assert made == []
    assert idle.frame_counter == 0 and idle.timing() == {}
    assert rr.get_timing() == {} and tracing.timing() == {}
    work = trace_kernel.k1_work()
    assert work["k1_tiles"] > 0 and "k1_visits" not in work


def test_record_fills_get_timing(record):
    """A small path-traced render with the record on: every stage of the
    frame before last in get_timing(), each > 0, nested stages inside
    their parents."""
    rr = PathTracerRenderer(_opt(), CPU)
    rr.set_scene(floor_scene("tauray_torch"))
    rr.render_device()
    assert rr.get_timing() == {}          # read one frame late
    rr.render_device()
    got = rr.get_timing()
    for stage in PT_STAGES:
        assert got[(0, stage)] > 0, stage
    assert {d for d, _ in got} == {0}
    assert got[(0, "frame")] >= got[(0, "trace_wave")] >= \
        got[(0, "sig_sort")] + got[(0, "phase1")] + got[(0, "traverse")]
    assert record.frame_counter == 2
    record.finish()
    assert record.timing() != got         # the second frame, read


def _run_loop(opt, tmp_text):
    from tauray_torch.app.main import replay_viewer
    stream = logger.timing.stream
    logger.timing.stream = tmp_text
    try:
        replay_viewer(opt, floor_scene("tauray_torch"), CPU)
    finally:
        logger.timing.stream = stream
    assert not tracing.counting()         # the loop switched it off
    return tmp_text.getvalue()


def test_timing_prints_device_lines():
    """--timing: a FRAME block a frame with a [device 0] line for every
    stage and the HOST line."""
    out = _run_loop(_opt(timing=True, frames=3), io.StringIO())
    blocks = re.split(r"^FRAME (\d+):\n", out, flags=re.M)[1:]
    assert [int(i) for i in blocks[::2]] == [0, 1, 2]
    for body in blocks[1::2]:
        stages = re.findall(r"^  \[device 0\] (.+) (\d+\.\d\d)ms$", body,
                            flags=re.M)
        assert {n for n, _ in stages} >= set(PT_STAGES)
        assert all(float(ms) >= 0 for _, ms in stages)
        assert re.search(r"^  HOST: \d+\.\d\dms$", body, flags=re.M)


def test_trace_event_format_has_device_tracks():
    """--trace=trace-event-format: valid JSON; the host's frames on track
    0, each stage on the device's track, on the host's clock (each
    device frame inside its host frame)."""
    out = _run_loop(_opt(trace="trace-event-format", frames=2),
                    io.StringIO())
    events = json.loads(out)["traceEvents"]
    names = {(e["tid"], e["args"]["name"]) for e in events
             if e["ph"] == "M"}
    assert names == {(0, "host"), (1, "device 0")}
    spans = [e for e in events if e["ph"] == "X"]
    host = [e for e in spans if e["tid"] == 0]
    dev = [e for e in spans if e["tid"] == 1]
    assert len(host) == 2 and {e["name"] for e in dev} >= set(PT_STAGES)
    frames = [e for e in dev if e["name"] == "frame"]
    assert len(frames) == 2
    for h, f in zip(host, frames):
        assert h["ts"] <= f["ts"] and \
            f["ts"] + f["dur"] <= h["ts"] + h["dur"]


def test_fake_devices_feed_the_load_balancer(record):
    """--fake-devices=2: each device's "path tracing" time > 0, its waves
    under its own index, and LoadBalancer.update takes those times from
    the renderer."""
    from tauray_torch.parallel.load_balancer import LoadBalancer
    from tauray_torch.renderer.distributed import \
        DistributedPathTracerRenderer
    rr = DistributedPathTracerRenderer(_opt(fake_devices=2), CPU)
    rr.set_scene(floor_scene("tauray_torch"))
    for _ in range(2):
        rr.render_device()
    got = rr.get_timing()
    times = [got[(i, "path tracing")] for i in range(2)]
    assert all(t > 0 for t in times)
    assert got[(0, "trace_wave")] > 0 and got[(1, "trace_wave")] > 0
    assert LoadBalancer(2).update(rr) == LoadBalancer(2).update(rr, times)
    assert LoadBalancer(2).update(rr) != [0.5, 0.5]


@pytest.mark.parametrize("mode", ["off", "record", "profiler"])
def test_k1_work_counts_the_handed_counts(monkeypatch, mode):
    """K1's wrapper counts the tiles and, while counting (the record on,
    or the record off under a torch.profiler session), the cluster visits
    of the counts handed to it: a seeded sorted wave and a camera wave
    through the plain path."""
    handed = []
    plain = trace_kernel.trace_tiles_vm3_reference

    def keep(counts, *a):
        handed.append(counts.clone())
        return plain(counts, *a)
    monkeypatch.setattr(trace_kernel, "trace_tiles_vm3_reference", keep)
    tt, o, d = _soup_tracer(7)
    rec = tracing.TracingRecord(device=CPU)
    if mode == "record":
        rec.start()
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    try:
        if mode == "profiler":
            prof.__enter__()
        assert tracing.counting() == (mode != "off")
        trace_kernel.reset_launch_counts()
        tt.trace(o, d, 0.0, float("inf"), sort_rays=True)
        tt.trace(o[:300], d[:300], 0.0, 3.0)
    finally:
        if mode == "profiler":
            prof.__exit__(None, None, None)
        rec.stop()
    assert not tracing.counting()
    assert tracing.timing() == {}         # the profiler fed no record
    want = {"k1_tiles": sum(c.shape[0] for c in handed)}
    if mode != "off":
        want["k1_visits"] = int(sum(c.sum() for c in handed))
        assert want["k1_visits"] > want["k1_tiles"]
    assert len(handed) == 2 and trace_kernel.k1_work() == want
    trace_kernel.reset_launch_counts()
    assert trace_kernel.k1_work() == {"k1_tiles": 0}


def test_counting_without_torchs_profiler_flag(monkeypatch):
    """A torch release without the profiler's module flag reads as no
    profiler session: counting() follows the record alone and a wave
    still traces."""
    monkeypatch.delattr(torch.autograd.profiler, "_is_profiler_enabled")
    assert not tracing.counting()
    tt, o, d = _soup_tracer(3)
    trace_kernel.reset_launch_counts()
    tt.trace(o, d, 0.0, float("inf"), sort_rays=True)
    assert "k1_visits" not in trace_kernel.k1_work()
    rec = tracing.TracingRecord(device=CPU).start()
    try:
        assert tracing.counting()
    finally:
        rec.stop()


def test_frames_end_at_the_outermost_frame_span(record):
    """A frame ends where the outermost `frame` span closes, with or
    without begin_frame and end_frame around it; a nested renderer's
    `frame` span ends none, and end_frame gives the host's time to the
    frame that ended inside it."""
    record.print_frames = True
    with tracing.span("frame", CPU):
        with tracing.span("frame"):
            pass
    assert record.frame_counter == 1
    record.begin_frame()
    with tracing.span("frame", CPU):
        pass
    record.end_frame()
    assert record.frame_counter == 2 and list(record._host) == [1]


def test_span_names_live_in_one_tuple():
    """Every span the port opens is named in tracing.SPANS; no module but
    tracing.py opens a profiler range or makes a CUDA event on the frame's
    path (the labs and the kernel-timing tools time kernels alone)."""
    used = set()
    for root, _, files in os.walk(PKG):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(root, f)
            src = open(path).read()
            used |= set(re.findall(r"tracing\.span\(\s*\"([^\"]+)\"", src))
            rel = os.path.relpath(path, PKG)
            if rel == "tracing.py":
                continue
            assert "record_function(" not in src, rel
            if not rel.startswith("lab") and \
                    rel not in ("app/wave_stats.py",):
                assert "cuda.Event" not in src, rel
    assert used == set(tracing.SPANS)
    from tauray_torch.app import profile
    assert profile.SPANS is tracing.SPANS
