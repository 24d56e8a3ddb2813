"""Hand-written CUDA kernels for the H100 (sources in ``../csrc``), each
beside its plain PyTorch version. Each wrapper counts the launches of its
kernel in its ``launches`` attribute."""
from .blockify import blockify_field
from .knn_topk import knn_bucket_top2, knn_bucket_top2_v1
from .tk_dither import tk_select, tk_select_wide

WRAPPERS = (tk_select, tk_select_wide, knn_bucket_top2, knn_bucket_top2_v1, blockify_field)


def reset_launch_counts():
    for w in WRAPPERS:
        w.launches = 0


def launch_counts() -> dict:
    return {w.__name__: w.launches for w in WRAPPERS}
