"""The yardstick for kernel roofline shares: NVIDIA's published H100 SXM
peaks (dense, no sparsity, at the full 700 W) and the least time of each
hand-written kernel from the operations and bytes its inputs need.

Copied from ``chip_smoke.py`` (``bound_ms``, ``_tk_bound``, ``_knn_bound``)
so that later changes to the program cannot move it. A share is stated
against these peaks whatever the card's power limit; ``power_limit_w``
reads the limit to print beside it.
"""
from __future__ import annotations

import subprocess

HBM_BPS = 3.35e12
BF16_OPS = 989e12  # dense tensor cores
FP32_OPS = 67e12  # outside the tensor cores; the sheet has no int32 rate, so
# Thomas Knoll's integer operations are counted against this one
TK_STEPS = 64
TK_OPS_PER_TRIPLE = 14.0  # integer operations a (pixel, step, candidate colour)
KNN_DIMS = 192  # the features of a squared distance; 2 operations each


def bound_s(n_bytes: float, n_ops: float, peak_ops: float) -> tuple[float, str]:
    """(least seconds, "bytes" or "operations")."""
    tb, to = n_bytes / HBM_BPS, n_ops / peak_ops
    return max(tb, to), ("bytes" if tb >= to else "operations")


def tk_bound(pix, mirror, pal_idx, table) -> tuple[float, str]:
    """One ``tk_select`` launch: each input read once (the palette table
    whole), the slots written once, or ~14 integer operations per pixel,
    step and candidate colour (the valid slots of the tile's palette, at
    least one) at the fp32 rate, whichever is longer."""
    T = pix.shape[0]
    n_bytes = pix.numel() + mirror.numel() + 4 * pal_idx.numel() + 4 * table.numel() + T * 64
    colors = float((table[:, :, 4] > 0).sum(dim=1).clamp_min(1)[pal_idx.long()].sum())
    return bound_s(n_bytes, TK_OPS_PER_TRIPLE * colors * 64 * TK_STEPS, FP32_OPS)


def knn_bound(cells: int, tiles: int, depth: int, tiles_padded: int) -> tuple[float, str]:
    """One B2 launch over ``cells`` real cells and ``tiles`` real tiles:
    2 * 192 operations a pair on bf16 inputs; bytes: both bf16 operands,
    the f32 norms, two int32 keys a cell and bucket out."""
    nb = tiles_padded // 512
    n_bytes = 2 * depth * (cells + tiles) + 4 * tiles + 2 * 4 * nb * cells
    return bound_s(n_bytes, 2.0 * cells * tiles * KNN_DIMS, BF16_OPS)


def power_limit_w() -> float | None:
    """The card's power limit in watts from nvidia-smi, or None."""
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30, check=True)
        return float(res.stdout.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None
