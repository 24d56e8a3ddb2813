"""Planar -> blocked relayout of the motion search's window field: the
CUDA kernel and its plain PyTorch version.

Replaces the Pallas TPU kernel ``tiler_tpu/kernels/blockify.py::
blockify_field`` (the call at :46). The CUDA source is
``csrc/blockify.cu``; its header says what bounds it on the card (bytes)
and how the design answers that.

:func:`blockify_field` dispatches on the device of its input: a CPU
tensor goes to :func:`blockify_field_plain`, a CUDA tensor to the
kernel. There is no fallback from one to the other.
"""
from __future__ import annotations

import torch

from . import _build


def blockify_field_plain(F: torch.Tensor) -> torch.Tensor:
    """F [HP, WP, K] -> [mh, mw, 64, K] with HP = 8 mh, WP = 8 mw: output
    row (m, n, 8 sy + sx) is input row (8 m + sy, 8 n + sx)."""
    HP, WP, K = F.shape
    mh, mw = HP // 8, WP // 8
    return (F.view(mh, 8, mw, 8, K).permute(0, 2, 1, 3, 4)
            .reshape(mh, mw, 64, K).contiguous())


def _check(F: torch.Tensor):
    if F.device.type not in ("cpu", "cuda"):
        raise ValueError(f"blockify_field: no kernel for device {F.device}")
    if F.dtype != torch.bfloat16:
        raise ValueError(f"blockify_field: F must be bfloat16, got {F.dtype}")
    if F.dim() != 3 or not F.is_contiguous():
        raise ValueError("blockify_field: F must be a contiguous [HP, WP, K] tensor")
    HP, WP, K = F.shape
    if HP % 8 or WP % 8:
        raise ValueError(f"blockify_field: HP={HP} and WP={WP} must be multiples of 8")
    if K < 1:
        raise ValueError(f"blockify_field: K={K}: the field needs a depth of at least 1")


def blockify_field(F: torch.Tensor) -> torch.Tensor:
    """[HP, WP, K] bf16 -> [mh, mw, 64, K] bf16 at any depth K >= 1; see
    :func:`blockify_field_plain`. CPU tensors run the plain version, CUDA
    tensors the kernel (runs of eight rows, K 16-byte vectors each)."""
    _check(F)
    if F.device.type == "cpu":
        return blockify_field_plain(F)
    if F.data_ptr() % 16:
        raise ValueError("blockify_field: F must start on a 16-byte boundary")
    HP, WP, K = F.shape
    out = torch.empty(HP // 8, WP // 8, 64, K, dtype=F.dtype, device=F.device)
    code = _build.lib().blockify_launch(
        F.data_ptr(), out.data_ptr(), HP // 8, WP // 8, K, _build.stream_ptr(F.device))
    _build.check(code, "blockify_launch")
    blockify_field.launches += 1
    return out


blockify_field.launches = 0
