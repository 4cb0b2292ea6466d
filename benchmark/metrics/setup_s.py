"""setup_s: host seconds from the start of the process to the first timed
frame: imports, the scene, the renderer's set-up (scene tables, cluster
build), the kernels' build or load, and the warm-up frames."""


def read(run):
    return run.setup_s
