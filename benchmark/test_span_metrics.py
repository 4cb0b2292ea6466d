"""CPU tests of the readers of the program's spans and counters
(benchmark/metrics/slab_ms, tile_keys_ms, tracer_idle_ms,
renderer_idle_ms, k1_visits_per_tile): exact values on a hand-built
trace, the accepted readers unmoved by the nested spans, the new spans
kept out of the device's operations, and K1's work read from the program.

    python -m pytest -q benchmark/
"""

from __future__ import annotations

import time

import pytest
import torch

from benchmark import profiling
from benchmark import run as brun

CPU = torch.device("cpu")
NEW = ("slab_ms", "tile_keys_ms", "tracer_idle_ms", "renderer_idle_ms")
ACCEPTED = ("waves_per_frame", "sig_sort_ms", "phase1_ms", "traverse_ms",
            "k1_roofline_pct", "idle_pct")
K1 = "void trace_tiles_kernel<8, false, 0>(...)"

# Two frames in a 20 s window, each a frame span holding one wave
# (trace_wave): the first sorted (sig_sort holding a slab), both with
# phase1 holding a slab, then traverse. Kernels, with gaps between them:
KERNELS = [
    ("shade_k", 0.0, 0.5), ("slab_k", 1.0, 1.5), ("sort_k", 1.5, 1.75),
    ("slab_k", 2.0, 3.0), ("keys_k", 3.0, 3.5), (K1, 4.0, 4.5),
    ("shade_k", 6.0, 8.0), ("reset", 9.5, 9.75),
    ("slab_k", 11.0, 12.0), ("keys_k", 12.0, 12.5), (K1, 13.0, 13.5),
    ("unperm", 14.5, 15.0), ("shade_k", 16.0, 18.0)]
RANGES = {"sig_sort": [(1.0, 2.0)], "phase1": [(2.0, 4.0), (11.0, 13.0)],
          "traverse": [(4.0, 5.0), (13.0, 14.0)]}
NESTED = {"slab": [(1.0, 1.5), (2.0, 3.0), (11.0, 12.0)],
          "trace_wave": [(1.0, 5.0), (11.0, 15.0)],
          "frame": [(0.0, 9.0), (10.0, 19.0)]}


def _run(nested: bool) -> brun.Run:
    ranges = dict(RANGES, **(NESTED if nested else {}))
    tr = profiling.Trace(kernels=list(KERNELS), ranges=ranges,
                         window=(0.0, 20.0), frames=2)
    return brun.Run(frames=2, trace=tr, counts={"traced_waves": 3},
                    k1_launches=[(32768, 2116, 800000)] * 2)


def test_new_readers_on_a_hand_built_nest():
    run = _run(nested=True)
    # slab: [1, 1.5) in sig_sort, [2, 3) and [11, 12) in phase1: 2.5 s
    assert brun.reader("slab_ms").read(run) == 1250.0
    # phase1 less slab: [3, 3.5) and [12, 12.5) busy
    assert brun.reader("tile_keys_ms").read(run) == 500.0
    # waves [1, 5) busy 2.75 and [11, 15) busy 2.5: 1.25 + 1.5 idle
    assert brun.reader("tracer_idle_ms").read(run) == 1375.0
    # frames less waves: [0, 1) + [5, 9) busy 2.5 of 5, [10, 11) +
    # [15, 19) busy 2 of 5
    assert brun.reader("renderer_idle_ms").read(run) == 2750.0
    # the window's idle: 10 of 20 s; between frames [9, 10) less the
    # reset and [19, 20): 1.75 s
    assert brun.reader("idle_pct").read(run) == 50.0
    idle_ms = 0.5 * 20.0 * 1e3 / 2
    assert idle_ms - 1375.0 - 2750.0 == 1.75 * 1e3 / 2


def test_accepted_readers_read_the_same_with_the_nested_spans():
    with_, without = _run(nested=True), _run(nested=False)
    for name in ACCEPTED:
        v = brun.reader(name).read(with_)
        assert v is not None and v == brun.reader(name).read(without), name
    assert brun.reader("phase1_ms").read(with_) == 1500.0
    assert brun.reader("sig_sort_ms").read(with_) == 375.0


def test_new_readers_read_nothing_without_their_spans():
    # a program without the new spans (the parent's) reads nothing new
    run = _run(nested=False)
    for name in NEW:
        assert brun.reader(name).read(run) is None, name


class _Event:
    def __init__(self, name, dev, s, e, ua):
        self._v = (name, dev, s, e, ua)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return int(self._v[2] * 1e9)

    def end_ns(self):
        return int(self._v[3] * 1e9)

    def is_user_annotation(self):
        return self._v[4]


class _Prof:
    def __init__(self, events):
        class R:
            def events(self_):
                return events

        class P:
            kineto_results = R()
        self.profiler = P()


def test_new_spans_are_ranges_not_operations():
    """The program's new ranges, marked as user annotations on the host
    as torch.profiler marks record_function, are read as ranges on the
    device too: none is an operation of breakdown.device_ops."""
    ev = [_Event("bench_window", "DeviceType.CPU", 0.0, 20.0, True)]
    for name, ivs in NESTED.items():
        for s, e in ivs:
            ev.append(_Event(name, "DeviceType.CPU", s - 0.01, e, True))
            ev.append(_Event(name, "DeviceType.CUDA", s, e, True))
    for name, s, e in KERNELS:
        ev.append(_Event(name, "DeviceType.CUDA", s, e, False))
    tr = profiling.from_profiler(_Prof(ev), 2, "bench_window")
    assert {n for n, _ in profiling.top_ops(tr, 100)} == \
        {n for n, _, _ in KERNELS}
    assert set(tr.ranges) == set(NESTED)


@pytest.fixture
def program_counts():
    from tauray_torch.ops import trace_kernel
    trace_kernel.reset_launch_counts()
    yield trace_kernel
    trace_kernel.reset_launch_counts()


def test_k1_visits_per_tile_reads_the_program(program_counts):
    """The reader divides the program's K1 visits by its tiles; with the
    visits not counted (no profiler, no record) it reads nothing."""
    from tauray_torch import tracing
    counts = torch.tensor([3, 0, 5, 1], dtype=torch.int32)
    program_counts._count_k1(counts)
    run = _run(nested=True)
    assert brun.reader("k1_visits_per_tile").read(run) is None
    rec = tracing.TracingRecord(device=CPU).start()
    try:
        program_counts.reset_launch_counts()
        program_counts._count_k1(counts)
        program_counts._count_k1(counts[:2])
    finally:
        rec.stop()
    assert brun.reader("k1_visits_per_tile").read(run) == 12 / 6


def test_a_traced_cpu_run_reads_no_new_metric():
    """A tiny traced run on the CPU: the profiler runs only on the card,
    so the span readers read nothing there; the visits are not counted
    without a profiler."""
    from benchmark.test_bench_harness import tiny
    out = brun.run_cell(tiny("sponza-pt.1080p-1spp"), 2**31 + 5, 0.0, True,
                        CPU, t_start=time.perf_counter())
    assert out["correct"]
    for name in NEW + ("k1_visits_per_tile",):
        assert name not in out["metrics"]
