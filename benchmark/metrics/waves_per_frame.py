"""waves_per_frame: waves handed to the flat tracer in the traced window
(ops/cluster.TRACED["waves"]), over its frames."""


def read(run):
    if run.trace is None or not run.trace.frames:
        return None
    waves = run.counts.get("traced_waves", 0)
    return waves / run.trace.frames if waves else None
