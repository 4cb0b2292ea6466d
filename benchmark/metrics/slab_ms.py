"""slab_ms: device busy ms a frame inside the program's `slab` range
(ops/cluster._slab_blocks: the slab test of every ray against every
cluster box), wherever it is called: inside `phase1` and inside the
signature sort's key (`sig_sort`)."""

from ..profiling import self_ms_a_frame


def read(run):
    return None if run.trace is None else \
        self_ms_a_frame(run.trace, ["slab"])
