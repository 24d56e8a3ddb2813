"""The reference for the bucket top-2 kernel (B2) on the timed encode's own
operands.

The kernel multiplies cell rows fa [Np, depth] by corpus columns dsTa
[depth, Tp] (both bfloat16; the product is each cell's squared distance to
each tile, folded into one product), clamps at 0, and returns for every
cell and bucket of 512 tiles the smallest and second-smallest key: the
float32 bits of the distance with the low 9 bits holding the tile's lane.
Here the same products are summed in float64 (products of bfloat16 values
are exact, so only the kernel's float32 summation and its 14-bit key
mantissa separate the two), and each of the kernel's picks is measured
against the true best of its bucket:

    gap = max over cells and buckets of
          (d[pick1] - d_min1) / s1,  (d[pick2] - d_min2) / s2,
          |key1 - d[pick1]| / a1,    |key2 - d[pick2]| / a2

where d is the clamped distance, d_min1 <= d_min2 the two smallest in the
bucket, a the sum of absolute products of a pick (the scale of its
rounding) and s the sum of a at the pick and at the true one. A repeated
lane reads 1.
"""
from __future__ import annotations

import torch

TB = 512
LANE = 0x1FF


def _key_value(keys: torch.Tensor) -> torch.Tensor:
    return (keys & ~LANE).view(torch.float32).double()


def gap(fa: torch.Tensor, dsTa: torch.Tensor, k1: torch.Tensor, k2: torch.Tensor,
        cells_at_once: int = 512) -> float:
    """The widest normalized gap of the kernel's keys k1, k2 [nb, Np]."""
    Np, Tp = fa.shape[0], dsTa.shape[1]
    nb = Tp // TB
    ds = dsTa.double()
    ads = ds.abs()
    worst = 0.0
    for c0 in range(0, Np, cells_at_once):
        f = fa[c0:c0 + cells_at_once].double()
        n = f.shape[0]
        d = torch.clamp_min(f @ ds, 0.0).reshape(n, nb, TB)
        a = (f.abs() @ ads).reshape(n, nb, TB)
        low = torch.topk(d, 2, dim=-1, largest=False).values  # [n, nb, 2]
        best_a = a.gather(-1, torch.topk(d, 1, dim=-1, largest=False).indices)[..., 0]
        terms = []
        for j, keys in enumerate((k1, k2)):
            kk = keys[:, c0:c0 + n].T  # [n, nb]
            lane = (kk & LANE).long()[..., None]
            dp = d.gather(-1, lane)[..., 0]
            ap = a.gather(-1, lane)[..., 0]
            s = ap + best_a
            terms.append(torch.where(s > 0, (dp - low[..., j]) / s, 0.0))
            terms.append(torch.where(ap > 0, (_key_value(kk) - dp).abs() / ap, 0.0))
        same = (k1[:, c0:c0 + n] == k2[:, c0:c0 + n]).T
        terms.append(same.double())
        worst = max(worst, float(torch.stack(terms).max()))
    return worst


def _quantized(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x through ``dtype`` with one scale for the tensor (its largest
    magnitude to the format's largest), back in float64."""
    x = x.double()
    scale = float(x.abs().max()) / float(torch.finfo(dtype).max) or 1.0
    return (x / scale).to(dtype).double() * scale


def keys_in(fa: torch.Tensor, dsTa: torch.Tensor, dtype: torch.dtype = torch.float8_e4m3fn,
            cells_at_once: int = 512) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's keys (k1, k2) [nb, Np] int32 from the operands taken
    through ``dtype`` (the control: fp8, below the kernel's bfloat16)."""
    Np, Tp = fa.shape[0], dsTa.shape[1]
    nb = Tp // TB
    ds = _quantized(dsTa, dtype)
    fq = _quantized(fa, dtype)
    lane = torch.arange(TB, dtype=torch.int32, device=fa.device)
    k1 = torch.empty(nb, Np, dtype=torch.int32, device=fa.device)
    k2 = torch.empty_like(k1)
    for c0 in range(0, Np, cells_at_once):
        d = torch.clamp_min(fq[c0:c0 + cells_at_once] @ ds, 0.0).float()
        key = (d.view(torch.int32).reshape(-1, nb, TB) & ~LANE) | lane
        two = torch.topk(key, 2, dim=-1, largest=False).values
        k1[:, c0:c0 + cells_at_once] = two[..., 0].T
        k2[:, c0:c0 + cells_at_once] = two[..., 1].T
    return k1, k2
