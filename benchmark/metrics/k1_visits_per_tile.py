"""k1_visits_per_tile: K1's cluster visits over its tiles in the traced
window, as the program counts them at K1's wrapper
(ops/trace_kernel.k1_work: the sum of the counts handed to
trace_tiles_vm3 over their tiles, reset with the launch counters before
the window). The visits are K1's work: a tile of 32 rays tests 128
triangles a visit. None for a program without the counter."""


def read(run):
    if run.trace is None or not run.trace.frames:
        return None
    from tauray_torch.ops import trace_kernel
    if not hasattr(trace_kernel, "k1_work"):
        return None
    work = trace_kernel.k1_work()
    if not work["k1_tiles"] or "k1_visits" not in work:
        return None
    return work["k1_visits"] / work["k1_tiles"]
