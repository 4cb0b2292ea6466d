"""CPU tests of the benchmark harness (benchmark/): cells, configurations
and metrics found by name, the window and self-time arithmetic, the frozen
roofline bound, the import rules, and a run of each cell at a tiny size
on the CPU through the port's plain versions: held to the reference, the
control failing its limit, and the timed path broken underneath.

    python -m pytest -q benchmark/
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from benchmark import faults, judge, profiling, reference, roofline
from benchmark import run as brun
from benchmark import scene as bscene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in BENCH["workloads"]]
CPU = torch.device("cpu")


def tiny(name: str) -> brun.Cell:
    """The cell at a size the CPU holds: the scene at its smallest
    tessellation (tris=8192, ~41k triangles), 32x16 pixels, a camera grid
    of 3 views where the cell has one, 64 sampled rays a wave, its
    schedule and limits as they stand."""
    cell = brun.load_cell(name)
    cell.config = dict(cell.config,
                       scene=dict(cell.config["scene"], tris=8192))
    opts = [o if not o.startswith("--camera-grid=") else
            "--camera-grid=3,1,0.05,0"
            for o in cell.traffic.get("options", [])]
    cell.traffic = dict(cell.traffic, width=32, height=16,
                        sample_rays_per_wave=64, options=opts)
    return cell


def tiny_run(name: str, fault=None, seed: int = 2**31 + 12345):
    return brun.run_cell(tiny(name), seed, 0.0, False, CPU,
                         t_start=time.perf_counter(), fault=fault)


# -- found by name ---------------------------------------------------------

@pytest.mark.parametrize("name", CELLS)
def test_cell_found_by_name(name):
    cell = brun.load_cell(name)
    entry = next(w for w in BENCH["workloads"] if w["name"] == name)
    assert cell.traffic["name"] == name
    assert cell.traffic["config"] == entry["config"] == cell.config["name"]
    assert cell.traffic["traffic"] == entry["traffic"]
    assert cell.traffic["why"] == entry["why"]
    assert cell.chips == entry["chips"] == 1
    assert set(cell.traffic["limits"]) == {"waves_short", "rays_short",
                                           "hits_off_ppm"}
    assert cell.traffic["limits"]["waves_short"] == 0
    assert cell.traffic["limits"]["rays_short"] == 0
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "frame_ms"}
    assert cell.per_layer


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_found_by_name(conf):
    path = os.path.join(ROOT, conf["file"])
    assert path == os.path.join(ROOT, "benchmark", "configs",
                                conf["name"] + ".json")
    data = json.load(open(path))
    assert data["name"] == conf["name"]
    assert sorted(data["reduced"]) == sorted(conf["reduced"])
    assert any(w["config"] == conf["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize(
    "metric", BENCH["end_to_end"] + BENCH["per_layer"],
    ids=lambda m: m["name"])
def test_metric_reader_found_by_name(metric):
    mod = brun.reader(metric["name"])
    assert callable(mod.read)
    # a run with nothing to read gives nothing for the per-layer metrics
    if metric in BENCH["per_layer"]:
        assert mod.read(brun.Run()) is None


# -- arithmetic ------------------------------------------------------------

def test_window_counts_whole_frames_and_the_one_in_flight():
    now = [0.0]

    def clock():
        return now[0]

    def frame():
        now[0] += 6.0
    frames, elapsed = brun.window(frame, 20.0, clock)
    assert (frames, elapsed) == (4, 24.0)     # the 4th began at 18 s
    run = brun.Run(frames=frames, elapsed_s=elapsed)
    assert brun.reader("frame_ms").read(run) == 6000.0
    now[0] = 0.0
    assert brun.window(frame, 0.0, clock) == (1, 6.0)


def test_self_time_on_a_hand_built_nest():
    # shade [0, 10) holds phase1 [2, 5) and traverse [5, 6); kernels run
    # [0, 1), [2, 4), [5, 5.5), [7, 8), with a gap at [8, 10)
    tr = profiling.Trace(
        kernels=[("a", 0, 1), ("p", 2, 4), ("k1", 5, 5.5), ("s", 7, 8)],
        ranges={"shade": [(0, 10)], "phase1": [(2, 5)],
                "traverse": [(5, 6)]},
        window=(0, 10), frames=2)
    assert profiling.self_s(tr, ["shade"]) == 4.5
    assert profiling.self_s(tr, ["shade"], ["phase1", "traverse"]) == 2.0
    assert profiling.self_s(tr, ["phase1"]) == 2.0
    assert profiling.self_ms_a_frame(tr, ["phase1"]) == 1000.0
    assert profiling.self_ms_a_frame(tr, ["sig_sort"]) is None
    assert profiling.busy_s(tr) == 4.5
    assert profiling.idle_share(tr) == 0.55
    assert profiling.subtract([(0, 10)], [(1, 2), (3, 4)]) == [
        (0, 1), (2, 3), (4, 10)]
    assert profiling.intersect([(0, 3), (5, 9)], [(2, 6)]) == [(2, 3),
                                                              (5, 6)]


def test_idle_gaps_named_by_the_innermost_host_operation():
    tr = profiling.Trace(kernels=[("k", 0, 1), ("k", 3, 4)],
                         host=[("frame", 0, 4), ("aten::nonzero", 1, 2.5)],
                         window=(0, 6), frames=1)
    assert profiling.idle_gaps(tr) == [["aten::nonzero", 2.0],
                                       ["host", 2.0]]
    assert profiling.top_ops(tr) == [["k", 2]]


def test_frozen_bound_of_the_recorded_bounce_wave():
    # chip_smoke.py's bounce wave: 1,590,484,992 tests -> 0.7596 ms
    ms, by = roofline.bound(1_590_484_992 * roofline.FLOPS_BW, 0)
    assert by == "operations" and abs(ms - 0.7596) < 5e-5
    visits = 1_590_484_992 // (roofline.CLUSTER * roofline.TILE)
    ms2, by2 = roofline.k1_bound(8192, 2116, visits)
    assert by2 == "operations" and ms2 == ms


def test_k1_reader_names_only_k1():
    from benchmark.metrics.traverse_ms import is_k1
    assert is_k1("void trace_tiles_kernel<8, false, 12, false>(int const*)")
    assert not is_k1("void trace_tiles_kernel<4, true, 9, false>(int*)")
    assert not is_k1("void at::native::elementwise_kernel<128, 2>()")


def test_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-11, 1.0 + 3 * 2**-11, 3.0, -1.0 - 2**-12])
    assert reference.tf32(x).tolist() == [1.0, 1.0 + 2**-9, 3.0, -1.0]


def test_reference_hits_a_known_triangle():
    tris = torch.tensor([[[0.0, 0, 0], [1, 0, 0], [0, 1, 0]]],
                        dtype=torch.float64)
    o = torch.tensor([[0.25, 0.25, 1.0], [2.0, 2.0, 1.0], [0.25, 0.25, 1.0]])
    d = torch.tensor([[0.0, 0, -1], [0, 0, -1], [0, 0, -1]])
    t = reference.closest_hits(o, d, torch.zeros(3),
                               torch.tensor([9.0, 9.0, 0.5]), tris)["t"]
    assert torch.isfinite(t).tolist() == [True, False, False]
    assert float(t[0]) == 1.0


def test_world_triangles_match_the_port_scene():
    plain = bscene.sponza(8192)
    ref = reference.world_triangles(plain)
    from tauray_torch.io.procedural import build_sponza
    from tauray_torch.scene.scene import Scene
    port = build_sponza(Scene(), 8192)
    n = sum(g.mesh.indices.shape[0] for e in port.entities if e.model
            for g in e.model.groups)
    assert ref.shape == (n, 3, 3)


# -- imports ---------------------------------------------------------------

def _modules_after(code: str):
    out = subprocess.run([sys.executable, "-c", code + (
        "\nimport sys\nprint(sorted({m.split('.')[0] for m in "
        "sys.modules}))")], cwd=ROOT, capture_output=True, text=True,
        check=True, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_nothing_of_the_program():
    mods = _modules_after("import benchmark.reference, benchmark.judge, "
                          "benchmark.scene, benchmark.roofline, "
                          "benchmark.profiling")
    assert not mods & {"tauray_torch", "tauray_tpu", "jax", "jaxlib",
                       "flax"}


def test_a_run_loads_neither_jax_nor_the_jax_package():
    mods = _modules_after(
        "from benchmark import test_bench_harness as t\n"
        "t.tiny_run('sponza-pt.1080p-1spp')")
    assert "tauray_torch" in mods
    assert not mods & set(brun.FORBIDDEN)


def test_forbidden_names_compare_whole(monkeypatch):
    import types
    for name in ("tauray_tpux", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert brun.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy",
                        types.ModuleType("jax.numpy"))
    monkeypatch.setitem(sys.modules, "tauray_tpu",
                        types.ModuleType("tauray_tpu"))
    assert brun.forbidden_modules() == ["jax", "tauray_tpu"]


# -- correctness at a tiny size ----------------------------------------------

@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_the_port(name):
    out = tiny_run(name)
    assert out["correct"], out["checks"]
    assert out["checks"]["hits_off_ppm"]["value"] == 0.0
    assert out["rays_compared"] > 100
    assert set(out["metrics"]) == {m["name"]
                                   for m in brun.load_cell(name).end_to_end}


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_limit(name):
    cell = tiny(name)
    run, frames, plain = brun.measure(cell, 77, 0.0, False, CPU,
                                      time.perf_counter())
    tris = torch.from_numpy(reference.world_triangles(plain))
    ctrl = judge.numbers(frames, tris, judge.schedule(cell.traffic),
                         answer="control")
    ok, _ = judge.verdict(ctrl, cell.traffic["limits"])
    assert not ok and ctrl["hits_off_ppm"] > \
        cell.traffic["limits"]["hits_off_ppm"]


FAULT_CASES = [(name, f) for name in CELLS for f in faults.for_renderer(
    brun.load_cell(name).config["renderer"])]


@pytest.mark.parametrize("name,fault", FAULT_CASES,
                         ids=[f"{n}-{f}" for n, f in FAULT_CASES])
def test_broken_timed_path_is_not_correct(name, fault):
    out = tiny_run(name, fault=faults.FAULTS[fault][0])
    assert not out["correct"], out["checks"]


def test_faults_are_mended_after_the_window():
    from tauray_torch.ops import cluster
    from tauray_torch.renderer import rt_renderer
    before = (cluster._trace_padded, cluster.trace_tiles_vm3,
              rt_renderer.pt_trace_pass)
    for f in ("half_left_out", "answer_altered", "pixels_halved"):
        tiny_run("sponza-pt.1080p-1spp", fault=faults.FAULTS[f][0])
    assert (cluster._trace_padded, cluster.trace_tiles_vm3,
            rt_renderer.pt_trace_pass) == before


def test_schedule_shortfall_counts_waves_and_rays():
    sched = judge.schedule(dict(width=4, height=2, samples_per_pixel=2,
                                options=["--camera-grid=3,1,0.05,0"],
                                rays_per_sample=dict(closest=2, any_hit=1)))
    assert sched == dict(samples=48, closest=2, any_hit=1)

    def wave(n, any_hit=False):
        return dict(n=n, any_hit=any_hit)
    whole = [wave(64), wave(64), wave(64, True)]
    assert judge.shortfall([whole, whole], sched) == (0, 0)
    # a shadow wave dropped; half the pixels; a frame that traced nothing
    assert judge.shortfall([whole[:2]], sched) == (1, 48)
    assert judge.shortfall([[wave(24), wave(24), wave(24, True)]],
                           sched) == (0, 72)
    assert judge.shortfall([whole, []], sched) == (3, 144)
    # padding above the schedule counts for nothing
    assert judge.shortfall([[wave(100)] * 2 + [wave(100, True)]],
                           sched) == (0, 0)


def test_the_port_gets_the_reference_triangles_through_gltf(tmp_path):
    from tauray_torch.app.main import load_scenes
    from benchmark.gltf_writer import write_gltf
    from benchmark.program import options
    cell = tiny("sponza-pt.1080p-1spp")
    plain = bscene.sponza(8192)
    s = load_scenes(options(cell.config, cell.traffic, 5,
                            write_gltf(plain, str(tmp_path))))
    ref = reference.world_triangles(plain)
    tris = []
    for e in s.entities:
        if e.model is None:
            continue
        m = e.transform.get_global_transform().astype(np.float64)
        for g in e.model.groups:
            p = g.mesh.positions.astype(np.float64) @ m[:3, :3].T + m[:3, 3]
            tris.append(p[g.mesh.indices])
    port = np.concatenate(tris)
    assert port.shape == ref.shape
    assert np.abs(port - ref).max() < 1e-5 * np.abs(ref).max()
    cams = [e for e in s.entities if e.camera is not None]
    assert [e.camera_enabled for e in cams] == [True]
    assert len(s.textures) == 4 and (s.textures[0] ==
                                     plain.textures[0]).all()
