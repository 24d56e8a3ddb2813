"""Yliluoma2 dithering of corpus tiles: the CUDA kernel and its plain
PyTorch version.

The JAX package computes Yliluoma2's mixing plans as plain XLA passes
(``tiler_tpu/pipeline/dither.py::yliluoma2_lists``, :102-181) and has no
kernel for them; ``csrc/yl2_dither.cu`` is the port's own, and its header
says what bounds it on the card and how the design answers that.
:func:`yl2_select` dispatches on the device of its inputs: CPU tensors go
to :func:`yl2_select_plain`, CUDA tensors to the kernel (one launch for the
whole corpus, counted in ``yl2_select.launches``). There is no fallback
from one to the other.
"""
from __future__ import annotations

import torch

from . import _build
from .tk_dither import (BIG, BLUE_MUL, GREEN_MUL, LUMA_DIV, MAX_S, RED_MUL, RGB_W,
                        _trunc_div, check_pal_idx, mirrored_bayer)

MAX_MIXED = 16
# Bytes of the plain passes' [pixels, S, 2 * mixed, 4] int32 candidate
# table a chunk of tiles: 8,192 tiles at S = 16, mixed = 4 (a round holds
# about five tensors of that size; the JAX package's 16,384 tiles would
# double both), 512 tiles at S = 256.
YLILUOMA_TABLE = 1 << 30


def yliluoma2_chunk(S: int, mixed: int) -> int:
    """Tiles per chunk of the plain passes: the candidate table near
    YLILUOMA_TABLE."""
    return max(1, YLILUOMA_TABLE // (64 * S * 2 * mixed * 4 * 4))


def pal4_table(pal_rgb: torch.Tensor) -> torch.Tensor:
    """[P, S, 3] ints -> [P, S, 4] int32 rows (r, g, b, luma div 1000),
    the kernel's palette layout."""
    rgb = pal_rgb.to(torch.int32)
    lum = rgb[..., 0] * RED_MUL + rgb[..., 1] * GREEN_MUL + rgb[..., 2] * BLUE_MUL
    return torch.cat([rgb, torch.div(lum, LUMA_DIV, rounding_mode="floor")[..., None]],
                     dim=-1).contiguous()


def yliluoma2_lists(pix_rgb, pal_rgb, pal_valid, S: int, mixed: int, *, trials=None):
    """Yliluoma2 mixing plans, after ``tiler_tpu.pipeline.dither.
    yliluoma2_lists``: a 4-component (r, g, b, luma) distance with weights
    (13, 13, 13, 32) and the reciprocal rounding
    ``mixed = (sum * (65536 div t)) >> 16``.

    pix_rgb [B, 3], pal_rgb [B, S, 3] (the palette of each pixel) integer
    tensors, pal_valid [B, S] bool. Returns (lists [B, 2 * mixed] int32 of
    palette slots, luma-sorted, unused entries last; count [B] int32).
    The rounds end when every pixel's plan holds ``mixed`` entries, which
    the host reads once a round (at most ``mixed`` rounds). ``trials``: an
    int64 tensor to which the (valid color, admitted total) trials of the
    rounds are added in place."""
    dev = pix_rgb.device
    B = pix_rgb.shape[0]
    cap = 2 * mixed
    pix = pix_rgb.to(torch.int32)
    pal = pal_rgb.to(torch.int32)
    if pal.shape[1] != S:
        raise ValueError(f"yliluoma2_lists: pal_rgb holds {pal.shape[1]} slots, S={S}")
    lum_pal = pal[..., 0] * RED_MUL + pal[..., 1] * GREEN_MUL + pal[..., 2] * BLUE_MUL
    lum_pix = pix[:, 0] * RED_MUL + pix[:, 1] * GREEN_MUL + pix[:, 2] * BLUE_MUL
    target4 = torch.cat([pix, _trunc_div(lum_pix, LUMA_DIV)[:, None]], dim=1)  # [B, 4]
    pal4 = torch.cat([pal, torch.div(lum_pal, LUMA_DIV, rounding_mode="floor")[..., None]],
                     dim=2)  # [B, S, 4]
    inval = ~pal_valid
    n_valid = pal_valid.sum(dim=1)
    tt = torch.arange(1, cap + 1, dtype=torch.int32, device=dev)  # candidate totals t
    inv_t = (1 << 16) // tt  # the reference's FVecInv
    w4 = torch.tensor([RGB_W, RGB_W, RGB_W, 32], dtype=torch.int32, device=dev)
    pos = torch.arange(cap, dtype=torch.int32, device=dev)[None, :]

    plan_count = torch.zeros(B, dtype=torch.int32, device=dev)
    so_far = torch.zeros(B, 4, dtype=torch.int32, device=dev)
    lists = torch.zeros(B, cap, dtype=torch.int32, device=dev)
    while B and int(plan_count.min()) < mixed:
        max_test = plan_count.clamp_min(1)
        # after k = t - plan_count repeats: sum = so_far + k * color +
        # k (k - 1) / 2 (the reference adds on all four lanes each repeat)
        k = tt[None, :] - plan_count[:, None]  # [B, cap]
        tmask = (k >= 1) & (k <= max_test[:, None])
        bias = (k * (k - 1)) >> 1  # a product of neighbours: even, >= 0
        sums = (so_far[:, None, None, :] + k[:, None, :, None] * pal4[:, :, None, :]
                + bias[:, None, :, None])  # [B, S, cap, 4]
        d = ((sums * inv_t[None, None, :, None]) >> 16) - target4[:, None, None, :]
        pen = (d * d * w4).sum(dim=-1, dtype=torch.int32)  # [B, S, cap]
        pen = torch.where(inval[:, :, None] | ~tmask[:, None, :], BIG, pen)
        best = pen.reshape(B, -1).argmin(dim=1)  # the first minimum
        chosen = torch.div(best, cap, rounding_mode="floor").to(torch.int32)
        amount = ((best % cap + 1).to(torch.int32) - plan_count).clamp_min(1)
        # `chosen` fills lists[plan_count : plan_count + amount]
        wmask = (pos >= plan_count[:, None]) & (pos < (plan_count + amount)[:, None])
        ch4 = pal4.gather(1, chosen.long()[:, None, None].expand(B, 1, 4))[:, 0]
        done = plan_count >= mixed  # complete plans stay as they are
        if trials is not None:
            trials += torch.where(done, 0, n_valid * max_test).sum()
        lists = torch.where(wmask & ~done[:, None], chosen[:, None], lists)
        so_far = torch.where(done[:, None], so_far, so_far + ch4 * amount[:, None])
        plan_count = torch.where(done, plan_count, plan_count + amount)

    lum = lum_pal.gather(1, lists.long())
    lum = torch.where(pos < plan_count[:, None], lum, BIG)
    order = torch.sort(lum, dim=1, stable=True).indices
    return lists.gather(1, order), plan_count


def yl2_select_plain(pix, mirror, pal_idx, pal4, valid, mixed: int, chunk: int | None = None):
    """Plain PyTorch version of the kernel, same arguments and result:
    :func:`yliluoma2_lists` on tiles in chunks of ``chunk`` (by default
    :func:`yliluoma2_chunk`), each pixel taking the plan entry at
    ``(bayer * count) >> 6`` of its mirrored Bayer value. Runs on the
    device of its inputs and launches no kernel.

    pix uint8 [T, 64, 3] canonical tile pixels; mirror uint8 [T] (hmirror
    | vmirror << 1); pal_idx integer [T]; pal4 int32 [P, S, 4] from
    :func:`pal4_table`; valid bool [P, S]. Returns (uint8 [T, 64] palette
    slots, int64 0-d tensor of the (color, total) trials made)."""
    T, S = pix.shape[0], pal4.shape[1]
    chunk = chunk or yliluoma2_chunk(S, mixed)
    trials = torch.zeros((), dtype=torch.int64, device=pix.device)
    out = torch.empty(T, 64, dtype=torch.uint8, device=pix.device)
    for i in range(0, T, chunk):
        n = min(chunk, T - i)
        pidx = pal_idx[i:i + n].long()
        lists, count = yliluoma2_lists(
            pix[i:i + n].reshape(n * 64, 3), pal4[pidx, :, :3].repeat_interleave(64, dim=0),
            valid[pidx].repeat_interleave(64, dim=0), S, mixed, trials=trials)
        mapv = mirrored_bayer(mirror[i:i + n]).reshape(n * 64).long()
        sel = lists.gather(1, ((mapv * count) >> 6)[:, None])[:, 0]
        out[i:i + n] = sel.reshape(n, 64).to(torch.uint8)
    return out, trials


def _check(pix, mirror, pal_idx, pal4, valid, mixed):
    dev = pix.device
    T = pix.shape[0]
    for name, t, dtype, shape in (
        ("pix", pix, torch.uint8, (T, 64, 3)),
        ("mirror", mirror, torch.uint8, (T,)),
        ("pal_idx", pal_idx, torch.int32, (T,)),
        ("pal4", pal4, torch.int32, None),
        ("valid", valid, torch.bool, tuple(pal4.shape[:2])),
    ):
        if t.device != dev:
            raise ValueError(f"yl2_select: {name} is on {t.device}, pix on {dev}")
        if t.dtype != dtype:
            raise ValueError(f"yl2_select: {name} must be {dtype}, got {t.dtype}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"yl2_select: {name} shape {tuple(t.shape)} != {shape}")
        if not t.is_contiguous():
            raise ValueError(f"yl2_select: {name} must be contiguous")
    if pal4.dim() != 3 or pal4.shape[2] != 4:
        raise ValueError(f"yl2_select: pal4 must be [P, S, 4], got {tuple(pal4.shape)}")
    if not 1 <= pal4.shape[1] <= MAX_S:
        raise ValueError(f"yl2_select: palette size {pal4.shape[1]} outside 1..{MAX_S}")
    if not 1 <= mixed <= MAX_MIXED:
        raise ValueError(f"yl2_select: mixed {mixed} outside 1..{MAX_MIXED}")
    if T and dev.type == "cpu":
        # on the card the caller checks the range while pal_idx is still a
        # host array (check_pal_idx, pipeline/dither.py)
        check_pal_idx(pal_idx.numpy(), pal4.shape[0])


def yl2_select(pix, mirror, pal_idx, pal4, valid, mixed: int):
    """Yliluoma2 palette slot per pixel and the trials the plan search
    made; see :func:`yl2_select_plain`. CPU tensors run the plain version,
    CUDA tensors the kernel (one launch, counted here; the trials are
    summed on the device and stay there). The kernel's integer ranges
    assume colors in 0..255 with the luma of :func:`pal4_table`; on the
    card the caller answers for pal_idx in [0, P)."""
    if pix.device.type not in ("cpu", "cuda"):
        raise ValueError(f"yl2_select: no kernel for device {pix.device}")
    _check(pix, mirror, pal_idx, pal4, valid, mixed)
    if pix.device.type == "cpu":
        return yl2_select_plain(pix, mirror, pal_idx, pal4, valid, mixed)
    T, P, S = pix.shape[0], pal4.shape[0], pal4.shape[1]
    out = torch.empty((T, 64), dtype=torch.uint8, device=pix.device)
    trials = torch.zeros((), dtype=torch.int64, device=pix.device)
    code = _build.lib().yl2_select_launch(
        pix.data_ptr(), mirror.data_ptr(), pal_idx.data_ptr(), pal4.data_ptr(),
        valid.data_ptr(), out.data_ptr(), trials.data_ptr(), T, P, S, mixed,
        _build.stream_ptr(pix.device))
    _build.check(code, "yl2_select_launch")
    yl2_select.launches += 1
    return out, trials


yl2_select.launches = 0


def range_case(S: int, seed: int = 0):
    """Tiles and palettes that drive the kernel's integer values to the
    ends of csrc/yl2_dither.cu's point 1, as numpy arrays (pix uint8 [T,
    64, 3], mirror uint8 [T], pal_idx int32 [T], pal_rgb int32 [P, S, 3],
    valid bool [P, S]): a white palette, a black one and one of black and
    white, every slot valid, against tiles of black, of white and of
    random colors (at mixed = 16 a black pixel's plan through the white
    palette reaches mix = 258 on every lane)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    bw = np.where((np.arange(S) % 2 == 0)[:, None], 255, 0) * np.ones((1, 3), int)
    pal = np.stack([np.full((S, 3), 255), np.zeros((S, 3), int), bw]).astype(np.int32)
    tiles = [np.zeros((64, 3), int), np.full((64, 3), 255), rng.integers(0, 256, (64, 3))]
    pix = np.stack([t for t in tiles for _ in range(3)]).astype(np.uint8)
    pidx = np.tile(np.arange(3, dtype=np.int32), 3)
    mirror = rng.integers(0, 4, len(pix)).astype(np.uint8)
    return pix, mirror, pidx, pal, np.ones((3, S), bool)
