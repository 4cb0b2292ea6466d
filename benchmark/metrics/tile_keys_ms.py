"""tile_keys_ms: device busy ms a frame inside the program's `phase1` range
and outside its `slab` ranges: phase 1's reduction of the slab test to
32-ray tiles, its counts and the sort of each tile's key row. None where
the program has no `slab` range, as phase1_ms then reads the same."""

from ..profiling import self_ms_a_frame


def read(run):
    if run.trace is None or not run.trace.ranges.get("slab"):
        return None
    return self_ms_a_frame(run.trace, ["phase1"], ["slab"])
