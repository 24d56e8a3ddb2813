"""Yliluoma2 dithering's slot choice, in plain PyTorch: the reference that
the Yliluoma2 kernel (``yl2_select``) is held to on the timed encode's own
inputs.

A transcription of gligli/tiler's DeviseBestMixingPlanYliluoma
(tilingencoder.pas:2339-2504, the x64 assembly path the reference runs)
and of DitherTile's pick (:2688-2715), after J. Yliluoma's "Arbitrary-
palette positional dithering algorithm", algorithm 2. For each pixel,
with colors as four lanes (r, g, b, luma div 1000), luma 299 r + 587 g +
114 b:

- the plan starts empty; while it holds fewer than ``mixed`` entries, with
  ``count`` entries so far summing to ``so_far`` and ``max_test`` = max(1,
  count), each valid palette color in slot order is tried ``max_test``
  times: the p-th try adds the color's lanes, then one, to a running sum
  started at ``so_far`` (so after p tries it is so_far + p * color +
  p (p - 1) / 2), and scores the mix (sum * (65536 div t)) >> 16, t =
  count + p, against the pixel by 13 (dr^2 + dg^2 + db^2) + 32 dl^2;
- the first try of least score (strictly less replaces) adds its color p
  times to the plan, entry by entry, and p times its lanes to so_far (an
  invalid palette offers nothing: slot 0 once);
- the plan is sorted by the colors' luma, stably, and the pixel takes the
  entry at (bayer * count) >> 6, its Bayer 8x8 value mirrored as the tile
  is on screen.

``dtype`` torch.int64 computes exactly; a floating dtype computes the
sums, the mix and the score in it (the control: a precision below the
kernel's exact int32). Imports nothing of the program.
"""
from __future__ import annotations

import torch

from .tk import BAYER8, LUMA

WEIGHTS = (13, 13, 13, 32)


def _mix(total, inv, dtype):
    if dtype.is_floating_point:
        return torch.floor(total * inv / 65536)
    return (total * inv) >> 16


def plans(target4, pal4, valid, mixed: int, dtype=torch.int64):
    """target4 [B, 4], pal4 [B, S, 4], valid [B, S] bool -> (plan [B, 2 *
    mixed] int64 slots in the order they were added, count [B])."""
    dev = target4.device
    B, S = pal4.shape[:2]
    rows = torch.arange(B, device=dev)
    tgt = target4.to(dtype)
    pal = pal4.to(dtype)
    w = torch.tensor(WEIGHTS, device=dev).to(dtype)
    count = torch.zeros(B, dtype=torch.int64, device=dev)
    so_far = torch.zeros(B, 4, dtype=dtype, device=dev)
    plan = torch.zeros(B, 2 * mixed, dtype=torch.int64, device=dev)
    huge = torch.tensor(float("inf") if dtype.is_floating_point else 1 << 62, dtype=dtype,
                        device=dev)
    while bool((count < mixed).any()):
        live = count < mixed
        max_test = count.clamp_min(1)
        tries = int(max_test[live].max())
        least = huge.expand(B).clone()
        chosen = torch.zeros(B, dtype=torch.int64, device=dev)
        amount = torch.ones(B, dtype=torch.int64, device=dev)
        for index in range(S):
            ok = live & valid[:, index]
            total = so_far.clone()
            add = pal[:, index].clone()
            for p in range(1, tries + 1):
                total = total + add
                add = add + 1
                inv = (65536 // (count + p)).to(dtype)
                d = _mix(total, inv[:, None], dtype) - tgt
                score = (d * d * w).sum(dim=1)
                better = ok & (p <= max_test) & (score < least)
                least = torch.where(better, score, least)
                chosen = torch.where(better, index, chosen)
                amount = torch.where(better, p, amount)
        for j in range(int(amount[live].max())):
            put = live & (j < amount)
            plan[rows[put], count[put] + j] = chosen[put]
        so_far = torch.where(live[:, None], so_far + pal[rows, chosen] * amount[:, None].to(dtype),
                             so_far)
        count = torch.where(live, count + amount, count)
    return plan, count


def select(pix, mirror, pal_idx, pal_rgb, valid, mixed: int, dtype=torch.int64,
           pixels_at_once: int = 1 << 20):
    """pix uint8 [T, 64, 3], mirror uint8 [T] (h | v << 1), pal_idx [T],
    pal_rgb integer [P, S, 3], valid bool [P, S] -> uint8 [T, 64] palette
    slots; the pixels in blocks of about ``pixels_at_once``."""
    T = pix.shape[0]
    tiles = max(1, pixels_at_once // 64)
    if T > tiles:
        return torch.cat([select(pix[i:i + tiles], mirror[i:i + tiles], pal_idx[i:i + tiles],
                                 pal_rgb, valid, mixed, dtype, pixels_at_once)
                          for i in range(0, T, tiles)])
    dev = pix.device
    rgb = pal_rgb.to(torch.int64)
    lum_pal = rgb[..., 0] * LUMA[0] + rgb[..., 1] * LUMA[1] + rgb[..., 2] * LUMA[2]
    pal4 = torch.cat([rgb, (lum_pal // 1000)[..., None]], dim=-1)  # [P, S, 4]
    src = pix.reshape(T * 64, 3).to(torch.int64)
    lum = src[:, 0] * LUMA[0] + src[:, 1] * LUMA[1] + src[:, 2] * LUMA[2]
    target4 = torch.cat([src, (lum // 1000)[:, None]], dim=1)
    pidx = pal_idx.long().repeat_interleave(64)
    plan, count = plans(target4, pal4[pidx], valid[pidx], mixed, dtype)
    # DitherTile: the plan in luma order (stable), unused entries last
    key = lum_pal[pidx[:, None], plan]
    key = torch.where(torch.arange(plan.shape[1], device=dev)[None, :] < count[:, None], key,
                      1 << 40)
    plan = plan.gather(1, torch.sort(key, dim=1, stable=True).indices)
    bay = torch.as_tensor(BAYER8, device=dev).expand(T, 8, 8)
    m = mirror.to(torch.int64)[:, None, None]
    bay = torch.where((m & 1) != 0, bay.flip(-1), bay)
    bay = torch.where((m & 2) != 0, bay.flip(-2), bay).reshape(T * 64)
    return plan.gather(1, ((bay * count) >> 6)[:, None]).reshape(T, 64).to(torch.uint8)
