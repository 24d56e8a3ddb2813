"""elementwise_ms (ms an encode; layer ops: ops/, utils/): device time in
PyTorch's own elementwise and reduction kernels, by the names the profiler
gives them, over the traced window's encodes."""

NAMES = ("elementwise_kernel", "reduce_kernel")


def read(run):
    if run.trace is None or not run.encodes:
        return None
    s = sum(run.trace.seconds_matching(name)[0] for name in NAMES)
    return 1e3 * s / len(run.encodes) if s > 0 else None
