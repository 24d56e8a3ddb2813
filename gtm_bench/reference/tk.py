"""Thomas Knoll dithering's slot choice, in plain PyTorch: the reference
that the dither kernels (``tk_select``, ``tk_select_wide``) are held to on
the timed encode's own inputs.

For every pixel of a tile: 64 steps, each adding 9/100 of the error so far
(truncated) to the pixel, picking the valid palette slot of least penalty
13 |rgb - c|^2 + 32 ((luma(rgb) - luma(c)) / 1000)^2 (luma 299/587/114,
the quotient truncated; the first such slot on ties; slot 0 if none is
valid) and adding the pixel less that colour to the error. The picks are
ranked by (luma of the colour, step), and the pixel takes the pick whose
rank is its Bayer 8x8 value, mirrored as the tile is on screen. This is
the Thomas Knoll pattern dither of gligli/tiler (tilingencoder.pas,
DitherTileThomasKnoll), in the integer arithmetic the kernels state.

``dtype`` torch.int64 computes exactly; a floating dtype computes every
step in it (the control: bfloat16, the precision below the kernels'
float32 with exact integer values).
"""
from __future__ import annotations

import numpy as np
import torch

STEPS = 64
BAYER8 = np.array([
    0, 48, 12, 60, 3, 51, 15, 63, 32, 16, 44, 28, 35, 19, 47, 31,
    8, 56, 4, 52, 11, 59, 7, 55, 40, 24, 36, 20, 43, 27, 39, 23,
    2, 50, 14, 62, 1, 49, 13, 61, 34, 18, 46, 30, 33, 17, 45, 29,
    10, 58, 6, 54, 9, 57, 5, 53, 42, 26, 38, 22, 41, 25, 37, 21,
]).reshape(8, 8)
LUMA = (299, 587, 114)


def _div_trunc(a: torch.Tensor, d: int) -> torch.Tensor:
    if a.is_floating_point():
        return torch.trunc(a / d)
    return torch.div(a, d, rounding_mode="trunc")


def select(pix, mirror, pal_idx, table, dtype=torch.int64, tiles_at_once: int = 0):
    """pix uint8 [T, 64, 3], mirror uint8 [T] (h | v << 1), pal_idx [T],
    table int32 [P, S, 8] rows (r, g, b, luma, valid, ...) -> uint8 [T, 64]
    palette slots."""
    T, S = pix.shape[0], table.shape[1]
    chunk = tiles_at_once or max(1, (1 << 25) // (64 * S))
    if T > chunk:
        return torch.cat([select(pix[i:i + chunk], mirror[i:i + chunk], pal_idx[i:i + chunk],
                                 table, dtype, chunk) for i in range(0, T, chunk)])
    pal = table[pal_idx.long()].to(dtype)  # [T, S, 8]
    cr, cg, cb = (pal[:, None, :, i] for i in range(3))  # [T, 1, S]
    cl = cr * LUMA[0] + cg * LUMA[1] + cb * LUMA[2]
    valid = table[pal_idx.long()][:, None, :, 4] > 0
    src = pix.to(dtype)
    err = torch.zeros_like(src)
    big = torch.tensor(float("inf") if dtype.is_floating_point else 1 << 62,
                       dtype=dtype, device=pix.device)
    picks, keys = [], []
    for step in range(STEPS):
        t = src + _div_trunc(err * 9, 100)  # [T, 64, 3]
        tl = t[..., 0] * LUMA[0] + t[..., 1] * LUMA[1] + t[..., 2] * LUMA[2]
        dr, dg, db = (t[..., i, None] - c for i, c in enumerate((cr, cg, cb)))
        ld = _div_trunc(tl[..., None] - cl, 1000)
        pen = torch.where(valid, (dr * dr + dg * dg + db * db) * 13 + ld * ld * 32, big)
        best = pen.argmin(dim=-1)  # the first least penalty
        best = torch.where(valid.any(dim=-1).expand_as(best), best, 0)
        chosen = torch.stack([c.expand_as(pen).gather(-1, best[..., None])[..., 0]
                              for c in (cr, cg, cb)], -1)  # [T, 64, 3]
        chosen = torch.where(valid.any(dim=-1)[..., None].expand_as(chosen), chosen, 0)
        lum = (chosen[..., 0] * LUMA[0] + chosen[..., 1] * LUMA[1] + chosen[..., 2] * LUMA[2])
        keys.append(lum.double() * STEPS + step)
        picks.append(best)
        err = err + src - chosen
    keys = torch.stack(keys, -1)  # [T, 64, steps]
    picks = torch.stack(picks, -1)
    bay = torch.as_tensor(BAYER8, device=pix.device).expand(T, 8, 8)
    m = mirror.to(torch.int64)[:, None, None]
    bay = torch.where((m & 1) != 0, bay.flip(-1), bay)
    bay = torch.where((m & 2) != 0, bay.flip(-2), bay).reshape(T, 64, 1)
    order = torch.sort(keys, dim=-1, stable=True).indices
    return picks.gather(-1, order.gather(-1, bay)).squeeze(-1).to(torch.uint8)
