"""tracer_idle_ms: device idle ms a frame inside the device-side spans of
the program's `trace_wave` range (the flat and instanced tracers'
trace_flagged, one a wave): each span's length less the busy time in it,
within the window."""

from ..profiling import busy, intersect, length, subtract, union


def idle_ms_a_frame(tr, names, outside=()):
    """Device idle ms a frame inside the device-side spans of the ranges
    `names` and outside those of the ranges `outside`, within the window;
    None where the trace has no such range or no whole frame."""
    if not tr.frames or not any(tr.ranges.get(n) for n in names):
        return None
    region = intersect(union(iv for n in names
                             for iv in tr.ranges.get(n, ())), [tr.window])
    region = subtract(region, union(iv for n in outside
                                    for iv in tr.ranges.get(n, ())))
    return length(subtract(region, busy(tr))) * 1e3 / tr.frames


def read(run):
    return None if run.trace is None else \
        idle_ms_a_frame(run.trace, ["trace_wave"])
