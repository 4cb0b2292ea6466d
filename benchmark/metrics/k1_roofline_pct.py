"""k1_roofline_pct: the least time the card could take for the traced
window's K1 launches, the sum over them of the roofline bound from each
launch's own tiles and cluster visits (benchmark/roofline.k1_bound), over
K1's device time by kernel name, in %."""

from ..profiling import kernel_s
from ..roofline import k1_bound
from .traverse_ms import is_k1


def read(run):
    if run.trace is None or not run.k1_launches:
        return None
    t = kernel_s(run.trace, is_k1)
    if t <= 0:
        return None
    least_ms = sum(k1_bound(*launch)[0] for launch in run.k1_launches)
    return 100.0 * least_ms * 1e-3 / t
