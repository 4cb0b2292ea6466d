"""frame_ms: the window's elapsed host seconds over the whole frames it
completed, x 1000 (the frame in flight when the time ran out is finished
and counted)."""


def read(run):
    if not run.frames:
        return None
    return run.elapsed_s / run.frames * 1e3
