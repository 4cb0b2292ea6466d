"""idle_pct: the share of the traced window in which no operation ran on the
device, 1 - busy / window, in %."""

from ..profiling import idle_share


def read(run):
    if run.trace is None or run.trace.window[1] <= run.trace.window[0]:
        return None
    return 100.0 * idle_share(run.trace)
