"""sig_sort_ms: device busy ms a frame inside the program's `sig_sort` range
(ops/cluster._sig_sort_perm and the gather of the sorted wave), outside
any nested tracer range."""

from ..profiling import self_ms_a_frame


def read(run):
    return None if run.trace is None else \
        self_ms_a_frame(run.trace, ["sig_sort"], ["phase1", "traverse"])
