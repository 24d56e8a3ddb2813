"""setup_s (s, end to end, host clock): process start to the window's
start: imports, the kernels' build in a fresh checkout, the clip from the
seed and one warm-up encode of the cell's shape."""


def read(run):
    return run.setup_s
