"""peak_mem_gib: torch.cuda.max_memory_allocated() over the whole run, set-up
included, in GiB."""


def read(run):
    return run.peak_bytes / 2**30
