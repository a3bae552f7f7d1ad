"""peak_mem_gib: torch.cuda.max_memory_allocated over the window, reset
when it opens: the memory that bounds how many lanes a user can batch."""


def read(run):
    if run.device.type != "cuda":
        return None
    return run.peak_window_bytes / 2**30
