"""Frame timing and profiling (reference: src/tracing.cc,
src/tracing.hh:22-86).

Every stage of a frame is marked once, with `span(name)`:

    with tracing.span("phase1"):
        ...

A span always opens a torch.profiler range of its name, so a profiler
sees every stage. While the process's TracingRecord is on, the span is
also timed on its device: a pair of CUDA events recorded on the current
stream, from a pool of events made once and reused (Tauray's timer on its
timestamp query pool), or time.perf_counter on a CPU device. While the
record is off, a span is its profiler range and one check of a module
variable: no event, no allocation, no launch, no synchronisation.

The record is on under --timing and --trace=trace-event-format
(`for_options`), and for any caller that starts it (TracingRecord.start);
it is off otherwise. A frame ends where the outermost `frame` span (a
renderer's render_device) closes; begin_frame and end_frame add the host's
time around it, its trace event and the --timing print. A frame's events are read after the frame that
follows it has ended, once they are complete, as Tauray reads its query
pools after the frame's fence: recording adds no synchronisation. Only a
backlog of more than IN_FLIGHT frames waits for the oldest, and finish()
reads the rest.

What reads the record:
  * Renderer.get_timing() returns the newest read frame as
    {(device, name): seconds}, each stage summed over its spans; the load
    balancer reads (i, "path tracing") from it (src/load_balancer.cc:17);
  * --timing prints each read frame in the SIMPLE format
    (docs/MANUAL.md:371-411), its device lines one frame behind the
    frame being rendered:

        FRAME 42:
          [device 0] path tracing 1.55ms
          HOST: 3.64ms

  * --trace=trace-event-format prints Chrome Trace Event Format JSON at the
    end, the host's frames on track 0 and each device's spans on track
    device + 1, all on the host's perf_counter clock: each device span is
    placed by its distance from an anchor event, the first event of its
    frame on that device. --timing-output redirects either.
"""

from __future__ import annotations

import json
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import torch
from torch.profiler import record_function

from .log import TR_TIME

# every span's name: the stages of a frame, outermost first
SPANS = ("frame", "path tracing", "trace_wave", "sig_sort", "slab", "phase1",
         "traverse", "alpha", "shade", "gbuffer", "restir_di", "restir_gi",
         "sh_bake", "shadow_maps", "raster_draw", "pcf", "stitch")

# frames recorded but not read before the oldest is waited for
IN_FLIGHT = 3

Stages = Dict[Tuple[int, str], float]

# the process's record while it is on
_record: Optional["TracingRecord"] = None


def counting() -> bool:
    """Whether counters that cost device work count (K1's cluster visits,
    ops/trace_kernel.k1_work): while the record is on, or while a
    torch.profiler session records the process (torch's own flag, read
    as off where a torch release lacks it)."""
    return _record is not None or \
        getattr(torch.autograd.profiler, "_is_profiler_enabled", False)


def timing() -> Stages:
    """The newest read frame of the process's record ({} while off)."""
    return {} if _record is None else _record.timing()


class span:
    """A stage of a frame: a torch.profiler range and, while the process's
    record is on, a timed span on the torch.device `device` (default: the
    enclosing span's, else the record's) under the device index `index`
    (default: the enclosing span's, else 0)."""

    __slots__ = ("name", "device", "index", "_range", "_rec", "_open")

    def __init__(self, name: str, device=None, index: Optional[int] = None):
        self.name = name
        self.device = device
        self.index = index

    def __enter__(self):
        self._range = record_function(self.name)
        self._range.__enter__()
        self._rec = _record
        if self._rec is not None:
            self._open = self._rec._open(self.name, self.device, self.index)
        return self

    def __exit__(self, *exc):
        if self._rec is not None:
            self._rec._close(self._open)
        self._range.__exit__(*exc)
        return False


class _Frame:
    """One frame's spans: (index, name, device, start, end), each stamp an
    event or a perf_counter reading; per device its anchor (the first
    stamp, the host's clock when it was taken) and its events in the order
    recorded, on the device's one stream (the last completes last)."""

    def __init__(self, index: int):
        self.index = index
        self.spans: List[tuple] = []
        self.anchors: Dict[torch.device, tuple] = {}
        self.events: Dict[torch.device, List[torch.cuda.Event]] = {}

    def done(self) -> bool:
        return all(evs[-1].query() for evs in self.events.values())


class TracingRecord:
    """Stage times of frames on every device, once started. A span that
    names no device and sits in no span that does is timed on `device`;
    opt gives --trace and --timing."""

    def __init__(self, device, opt=None):
        self.format = opt.trace if opt is not None else "simple"
        self.print_frames = bool(opt is not None and opt.timing)
        self.device = torch.device(device)
        self.frame_counter = 0
        self._frame: Optional[_Frame] = None
        self._host_t0 = 0.0
        self._stack: List[tuple] = []
        self._pending: Deque[_Frame] = deque()
        self._pool: Dict[torch.device, List[torch.cuda.Event]] = {}
        self._timing: Stages = {}
        self._host: Dict[int, float] = {}
        self._unprinted: List[Tuple[int, Stages]] = []
        self._trace_events: List[Dict] = []
        self._tracks = set()

    @classmethod
    def for_options(cls, opt, device) -> "TracingRecord":
        """The record of a render loop, on under --timing and
        --trace=trace-event-format."""
        rec = cls(device, opt)
        if opt.timing or rec.format == "trace-event-format":
            rec.start()
        return rec

    # -- on and off ------------------------------------------------------
    def start(self) -> "TracingRecord":
        """Makes this the process's record: spans are timed into it."""
        global _record
        _record = self
        return self

    def stop(self):
        global _record
        if _record is self:
            _record = None

    # -- frames ------------------------------------------------------------
    def begin_frame(self):
        self._host_t0 = time.perf_counter()

    def end_frame(self):
        """The host's time since begin_frame, given to the frame that
        ended inside it, and under --timing the SIMPLE lines of the frames
        read since the last print."""
        host = time.perf_counter() - self._host_t0
        if self.print_frames:
            self._host[self.frame_counter - 1] = host
        if self.format == "trace-event-format":
            self._trace_events.append(dict(
                name="frame", ph="X", pid=0, tid=0,
                ts=self._host_t0 * 1e6, dur=host * 1e6))
        if self.print_frames:
            self.print_last_trace()

    def _end(self):
        f, self._frame = self._frame, None
        self.frame_counter += 1
        self._pending.append(f)
        while len(self._pending) > 1 and (
                len(self._pending) > IN_FLIGHT or self._pending[0].done()):
            self._read(self._pending.popleft())

    def timing(self) -> Stages:
        """{(device, name): seconds} of the newest read frame."""
        return dict(self._timing)

    # -- spans -------------------------------------------------------------
    def _stamp(self, dev: torch.device):
        f = self._frame
        if dev.type != "cuda":
            t = time.perf_counter()
            f.anchors.setdefault(dev, (t, t))
            return t
        free = self._pool.setdefault(dev, [])
        ev = free.pop() if free else torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(dev))
        f.events.setdefault(dev, []).append(ev)
        if dev not in f.anchors:
            f.anchors[dev] = (ev, time.perf_counter())
        return ev

    def _open(self, name, device, index):
        top = self._stack[-1] if self._stack else None
        idx = index if index is not None else (top[0] if top else 0)
        dev = device if device is not None else \
            (top[2] if top else self.device)
        if self._frame is None:
            self._frame = _Frame(self.frame_counter)
        tok = (idx, name, dev, self._stamp(dev))
        self._stack.append(tok)
        return tok

    def _close(self, tok):
        self._stack.pop()
        idx, name, dev, start = tok
        self._frame.spans.append((idx, name, dev, start, self._stamp(dev)))
        if name == "frame" and not self._stack:
            self._end()

    def _read(self, f: _Frame):
        """The frame's stage times (waiting for its events where they are
        not complete), its trace events, and its events back to the
        pool."""
        for evs in f.events.values():
            evs[-1].synchronize()
        export = self.format == "trace-event-format"
        stages: Stages = {}
        for idx, name, dev, a, b in f.spans:
            on_host = isinstance(a, float)
            dur = b - a if on_host else a.elapsed_time(b) * 1e-3
            stages[(idx, name)] = stages.get((idx, name), 0.0) + dur
            if export:
                anchor, host = f.anchors[dev]
                ts = a if on_host else \
                    host + anchor.elapsed_time(a) * 1e-3
                self._tracks.add(idx)
                self._trace_events.append(dict(
                    name=name, ph="X", pid=0, tid=idx + 1, ts=ts * 1e6,
                    dur=dur * 1e6))
        for dev, evs in f.events.items():
            self._pool[dev].extend(evs)
        self._timing = stages
        if self.print_frames:
            self._unprinted.append((f.index, stages))

    # -- output ------------------------------------------------------------
    def print_last_trace(self):
        """The SIMPLE lines of every frame read since the last print."""
        frames, self._unprinted = self._unprinted, []
        if self.format != "simple":
            return
        for index, stages in frames:
            TR_TIME(f"FRAME {index}:")
            for (dev, name), dur in sorted(stages.items()):
                TR_TIME(f"  [device {dev}] {name} {dur * 1000:.2f}ms")
            host = self._host.pop(index, None)
            if host is not None:
                TR_TIME(f"  HOST: {host * 1000:.2f}ms")

    def finish(self):
        """Reads the frames still in flight (waiting for them), prints
        them under --timing and the trace under
        --trace=trace-event-format."""
        while self._pending:
            self._read(self._pending.popleft())
        if self.print_frames:
            self.print_last_trace()
        if self.format == "trace-event-format" and self._trace_events:
            tracks = [dict(name="thread_name", ph="M", pid=0, tid=0,
                           args=dict(name="host"))]
            tracks += [dict(name="thread_name", ph="M", pid=0, tid=i + 1,
                            args=dict(name=f"device {i}"))
                       for i in sorted(self._tracks)]
            TR_TIME(json.dumps({"traceEvents": tracks +
                                self._trace_events}))
