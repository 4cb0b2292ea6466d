"""Reduction of a torch.profiler trace of the window to what the per-layer
readers need: the device's kernels, the device-side spans of the
program's record_function ranges, the host's operations, and the
arithmetic over them (busy time, self time, idle gaps).

The busy and idle arithmetic is tauray_torch/app/profile.py's
`profile_frame` (commit ccf5a6c): device busy time over the frame's wall
time, idle share = 1 - busy / wall. Here busy time is the union of the
kernels' intervals rather than the sum of their durations, which is the
same on one stream and never counts an overlap twice. A range's span on
the device timeline includes the gaps between its kernels and any nested
range; `self_s` counts only device busy time inside the range and outside
the nested ranges named."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Sequence, Tuple

Interval = Tuple[float, float]

# the program's record_function ranges (tauray_torch/app/profile.py's
# RANGES, commit ccf5a6c) and the harness's own: device events of these
# names are ranges even where the profiler does not mark user annotations
RANGES = ("sig_sort", "phase1", "traverse", "alpha", "shade", "gbuffer",
          "restir_di", "restir_gi", "sh_bake", "shadow_maps", "raster_draw",
          "pcf", "stitch", "bench_window")


@dataclass
class Trace:
    """Times in seconds on one clock. kernels: (name, start, end) of every
    device operation; ranges: name -> device-side spans of that range;
    host: (name, start, end) of host operations; window: (start, end) of
    the traced window; frames: whole frames in it."""
    kernels: List[Tuple[str, float, float]] = field(default_factory=list)
    ranges: Dict[str, List[Interval]] = field(default_factory=dict)
    host: List[Tuple[str, float, float]] = field(default_factory=list)
    window: Interval = (0.0, 0.0)
    frames: int = 0


def union(iv: Iterable[Interval]) -> List[Interval]:
    """Sorted disjoint intervals covering the same points."""
    out: List[Interval] = []
    for a, b in sorted(iv):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def length(iv: Sequence[Interval]) -> float:
    return sum(b - a for a, b in iv)


def intersect(x: Sequence[Interval], y: Sequence[Interval]) -> List[Interval]:
    """Intersection of two sorted disjoint interval lists."""
    out, i, j = [], 0, 0
    while i < len(x) and j < len(y):
        a, b = max(x[i][0], y[j][0]), min(x[i][1], y[j][1])
        if a < b:
            out.append((a, b))
        if x[i][1] < y[j][1]:
            i += 1
        else:
            j += 1
    return out


def subtract(x: Sequence[Interval], y: Sequence[Interval]) -> List[Interval]:
    """x less y, both sorted and disjoint."""
    out = []
    j = 0
    for a, b in x:
        cur = a
        while j < len(y) and y[j][1] <= cur:
            j += 1
        k = j
        while k < len(y) and y[k][0] < b:
            if y[k][0] > cur:
                out.append((cur, y[k][0]))
            cur = max(cur, y[k][1])
            k += 1
        if cur < b:
            out.append((cur, b))
    return out


def busy(tr: Trace) -> List[Interval]:
    """The union of the device's operations, clipped to the window."""
    return intersect(union((s, e) for _, s, e in tr.kernels),
                     [tr.window])


def busy_s(tr: Trace) -> float:
    return length(busy(tr))


def idle_share(tr: Trace) -> float:
    """1 - busy / window (app/profile.py's idle share)."""
    w = tr.window[1] - tr.window[0]
    return max(0.0, 1.0 - busy_s(tr) / w) if w > 0 else 0.0


def self_s(tr: Trace, names: Sequence[str],
           inner: Sequence[str] = ()) -> float:
    """Device busy seconds inside the spans of the ranges `names` and
    outside those of the ranges `inner` nested in them."""
    region = union(iv for n in names for iv in tr.ranges.get(n, ()))
    region = subtract(region, union(iv for n in inner
                                    for iv in tr.ranges.get(n, ())))
    return length(intersect(busy(tr), region))


def self_ms_a_frame(tr: Trace, names: Sequence[str],
                    inner: Sequence[str] = ()):
    """self_s in ms a frame, or None where the trace has no such range or
    no whole frame."""
    if not tr.frames or not any(tr.ranges.get(n) for n in names):
        return None
    return self_s(tr, names, inner) * 1e3 / tr.frames


def kernel_s(tr: Trace, match) -> float:
    """Device seconds of the operations whose name `match` accepts."""
    return sum(e - s for n, s, e in tr.kernels if match(n))


def top_ops(tr: Trace, n: int = 10) -> List[List]:
    """[name, seconds] of the n device operations that took most time,
    template instances by their full name."""
    tot: Dict[str, float] = {}
    for name, s, e in tr.kernels:
        tot[name] = tot.get(name, 0.0) + (e - s)
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(tr: Trace, n: int = 10) -> List[List]:
    """[what the host was doing, seconds] of the device's idle time in the
    window, each gap named by the innermost host operation under its
    midpoint (the latest begun of those that cover it; "host" where none
    does) and summed by name; the n largest. One sweep over the host's
    operations in order of their start."""
    host = sorted(tr.host, key=lambda h: h[1])
    stack: List[Tuple[str, float, float]] = []
    tot: Dict[str, float] = {}
    i = 0
    for a, b in subtract([tr.window], busy(tr)):
        mid = 0.5 * (a + b)
        while i < len(host) and host[i][1] <= mid:
            while stack and stack[-1][2] < host[i][1]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][2] < mid:
            stack.pop()
        name = stack[-1][0] if stack else "host"
        tot[name] = tot.get(name, 0.0) + (b - a)
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def _events(prof):
    """(name, device type, start s, end s, user annotation) of every event
    of a finished torch.profiler.profile, read from the profiler's raw
    results (far faster than building prof.events())."""
    res = prof.profiler.kineto_results
    for e in res.events():
        yield (e.name(), str(e.device_type()), e.start_ns() * 1e-9,
               e.end_ns() * 1e-9, bool(e.is_user_annotation()))


def from_profiler(prof, frames: int, window_range: str) -> Trace:
    """A Trace of a torch.profiler.profile run over CPU and CUDA. Device
    events named as a host-side record_function range are that range's
    device-side spans; every other device event is an operation. The
    window is the host-side span of the range `window_range`."""
    events = list(_events(prof))
    annotations = set(RANGES) | {n for n, dev, _, _, ua in events
                                 if ua and not dev.endswith("CUDA")}
    kernels, ranges, host = [], {}, []
    window = (0.0, 0.0)
    for name, dev, s, t, _ in events:
        if dev.endswith("CUDA"):
            if name in annotations:
                ranges.setdefault(name, []).append((s, t))
            else:
                kernels.append((name, s, t))
        elif name == window_range:
            window = (s, t)
        elif name not in annotations:
            host.append((name, s, t))
    return Trace(kernels=kernels, ranges=ranges, host=host, window=window,
                 frames=frames)
