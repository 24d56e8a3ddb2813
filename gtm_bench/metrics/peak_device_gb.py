"""peak_device_gb (GB; layer device): torch.cuda.max_memory_allocated over
the window, in 1e9 bytes."""


def read(run):
    return run.peak_bytes / 1e9 if run.peak_bytes else None
