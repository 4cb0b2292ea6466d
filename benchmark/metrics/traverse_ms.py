"""traverse_ms: device ms a frame of the traversal kernel K1
(csrc/trace_tiles.cu, the instance trace_tiles_kernel<W, false, ...>,
the only one without the front-to-back exit), by kernel name."""

import re

from ..profiling import kernel_s

K1_NAME = re.compile(r"trace_tiles_kernel<\s*\d+\s*,\s*false\s*,")


def is_k1(name: str) -> bool:
    return K1_NAME.search(name) is not None


def read(run):
    if run.trace is None or not run.trace.frames:
        return None
    s = kernel_s(run.trace, is_k1)
    return s * 1e3 / run.trace.frames if s > 0 else None
