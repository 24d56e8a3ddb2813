"""PSNR-HVS from a weighted-DCT squared error, and Pearson correlation.

Counterpart of ``tiler_tpu/ops/metrics.py``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .ordered import fold_lanes, log32, row_sum, seq_sum

TILE_DCT_SIZE = 192
PSNR_MAX = 10 * math.log10(255 * 255 / 0.5)
_INV_DCT_SIZE = float(np.float32(1 / TILE_DCT_SIZE))
_TEN_INV_LN10 = float.fromhex("0x1.15f2dp+2")  # f32(10 * f32(1 / ln 10)), XLA's folded log10


def euclidean_to_psnr(err: torch.Tensor) -> torch.Tensor:
    """Squared-L2 error over a 192-dim weighted-DCT vector -> dB. On the
    CPU in XLA's CPU order, bit for bit: the product by f32(1/192), the
    division, XLA's log (``ops/ordered.log32``) times f32(10 / ln 10)."""
    if err.device.type == "cpu":
        mse = err.float() * _INV_DCT_SIZE
        x = torch.full_like(mse, 65025.0) / torch.clamp_min(mse, 0.5)  # scalar / tensor would round twice
        return log32(x) * _TEN_INV_LN10
    mse = err * (1.0 / TILE_DCT_SIZE)
    return 10.0 * torch.log10(255.0 * 255.0 / torch.clamp_min(mse, 0.5))


def pearson(x: torch.Tensor, y: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Pearson correlation along ``axis``; 1.0 where it is degenerate."""
    xc = x - x.mean(dim=axis, keepdim=True)
    yc = y - y.mean(dim=axis, keepdim=True)
    num = (xc * yc).sum(dim=axis)
    den = torch.sqrt((xc * xc).sum(dim=axis)) * torch.sqrt((yc * yc).sum(dim=axis))
    return torch.where(den != 0.0, num / torch.where(den == 0, 1.0, den), 1.0)


def _cell_window_sums(v: torch.Tensor) -> torch.Tensor:
    """Row sums of v [R, cells * 3] (three LAB values a tile) as XLA's CPU
    build sums the load's first Pearson operand: windows of 32 cells of
    three values each, then the window sums in XLA's windows
    (``ops/ordered.row_sum``). With the cells a multiple of 32 a window is
    summed in eight lanes, a lane the cells i mod 8 with the three values
    of a cell added in turn, the lanes then folded
    (``ops/ordered.fold_lanes``); otherwise the cells are zero-padded (the
    padding split between both ends) and each window summed in order."""
    R, cells = v.shape[0], v.shape[1] // 3
    pad = -cells % 32
    if pad:
        w = torch.nn.functional.pad(v, (3 * (pad // 2), 3 * (pad - pad // 2)))
        return row_sum(seq_sum(w.reshape(R, -1, 32 * 3)))
    w = v.reshape(R, -1, 4, 8, 3)  # [rows, window, step, lane, value]
    acc = torch.zeros(w.shape[:2] + (8,), dtype=v.dtype, device=v.device)
    for step in range(4):
        for c in range(3):
            acc = acc + w[:, :, step, :, c]
    return row_sum(fold_lanes(acc))


def pearson_ordered(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """:func:`pearson` of the rows of x and y [R, cells * 3] (the load's
    mean LAB of consecutive frames) as the JAX package's compiled load
    computes it on the CPU: x's sum by :func:`_cell_window_sums`, y's
    and the three sums of products in XLA's windows, each mean a product
    by float32 1/n, the square roots correctly rounded (torch's float32
    sqrt on the CPU is not always). The same bits on the CPU and on
    CUDA."""
    inv = float(np.float32(1 / x.shape[-1]))
    xc = x - (_cell_window_sums(x) * inv)[:, None]
    yc = y - (row_sum(y) * inv)[:, None]
    num = row_sum(xc * yc)
    sx, sy = (torch.sqrt(row_sum(v * v).double()).float() for v in (xc, yc))
    den = sx * sy
    return torch.where(den != 0.0, num / torch.where(den == 0, 1.0, den), 1.0)
