"""phase1_ms: device busy ms a frame inside the program's `phase1` range
(ops/cluster._phase1: the slab cull and per-tile key rows)."""

from ..profiling import self_ms_a_frame


def read(run):
    return None if run.trace is None else \
        self_ms_a_frame(run.trace, ["phase1"])
