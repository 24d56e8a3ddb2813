"""esDither: ordered dithering of every corpus tile through its palette.

Counterpart of ``tiler_tpu/pipeline/dither.py``. The canonical pixels are
dithered against a per-tile MIRRORED Bayer map (the reference un-mirrors
each tile to its screen orientation first). Two ditherers, chosen by
``settings.dithering_use_thomas_knoll``:

- Thomas Knoll, with ``use_pallas_tk`` (the default): the per-pixel work
  is the ``tk_select`` kernel (``kernels/tk_dither.py``), one launch for
  the whole corpus, at every palette size 1..256.
- Thomas Knoll without it (:func:`thomas_knoll_select`): the JAX
  package's XLA path (``thomas_knoll_lists``,
  ``tiler_tpu/pipeline/dither.py:67-99``) as plain tensor passes, tiles in
  chunks sized from S. It runs on a CUDA tensor too, because the settings
  ask for it, and launches no kernel.
- Yliluoma2 (:func:`yliluoma2_lists`): the mixing-plan construction of
  ``tiler_tpu/pipeline/dither.py:102-181`` as plain integer tensor passes
  on the encoder's device, tiles in chunks sized from S. The JAX package
  has no kernel here either.

All are int32 and bit-identical to the JAX package's (and the two Thomas
Knoll paths to each other). Reindex's palette-pixel hashes are taken
here, as the JAX package's prefetch does.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import EncoderSettings
from ..kernels.tk_dither import (BLUE_MUL, GREEN_MUL, LUMA_DIV, RED_MUL, RGB_W,
                                 check_pal_idx, mirrored_bayer, pal_table, tk_select)
from ..models.state import EncodeState
from .reindex import pal_hashes

BIG = 1 << 30
# Bytes of Yliluoma2's [pixels, S, 2 * mixed, 4] int32 candidate table a
# chunk of tiles: 8,192 tiles at S = 16, mixed = 4 (a round holds about
# five tensors of that size; the JAX package's 16,384 tiles would double
# both), 512 tiles at S = 256.
YLILUOMA_TABLE = 1 << 30
# Elements of the plain Thomas Knoll path's [pixels, S] int32 step tensors
# a chunk of tiles: 32,768 tiles at S = 16, 2,048 at S = 256.
TK_PLAIN_ELEMS = 1 << 25


def yliluoma2_chunk(S: int, mixed: int) -> int:
    """Tiles per Yliluoma2 chunk: the candidate table near YLILUOMA_TABLE."""
    return max(1, YLILUOMA_TABLE // (64 * S * 2 * mixed * 4 * 4))


def _trunc_div(a: torch.Tensor, b: int) -> torch.Tensor:
    """Pascal ``div``: integer division truncating toward zero."""
    return torch.div(a, b, rounding_mode="trunc")


def color_compare(r1, g1, b1, r2, g2, b2):
    """ColorCompare (the reference's tilingencoder.pas:2323-2337); int32
    tensors in, int32 out."""
    luma1 = r1 * RED_MUL + g1 * GREEN_MUL + b1 * BLUE_MUL
    luma2 = r2 * RED_MUL + g2 * GREEN_MUL + b2 * BLUE_MUL
    lumadiff = _trunc_div(luma1 - luma2, LUMA_DIV)
    dr, dg, db = r1 - r2, g1 - g2, b1 - b2
    return (dr * dr + dg * dg + db * db) * RGB_W + (lumadiff * lumadiff) * 32


def thomas_knoll_lists(pix_rgb, pal_rgb, pal_valid, S: int):
    """Thomas Knoll 64-entry mixing lists, luma-sorted, after
    ``tiler_tpu.pipeline.dither.thomas_knoll_lists``: 64 error-feedback
    steps, each the first minimum of ColorCompare over the valid colors.

    pix_rgb [B, 3], pal_rgb [B, S, 3] (the palette of each pixel) integer
    tensors, pal_valid [B, S] bool. Returns [B, 64] int32 palette slots,
    stable-sorted by luma (equal lumas keep their step order)."""
    src = pix_rgb.to(torch.int32)
    pal = pal_rgb.to(torch.int32)
    if pal.shape[1] != S:
        raise ValueError(f"thomas_knoll_lists: pal_rgb holds {pal.shape[1]} slots, S={S}")
    pr, pg, pb = pal[..., 0], pal[..., 1], pal[..., 2]
    lum_pal = pr * RED_MUL + pg * GREEN_MUL + pb * BLUE_MUL
    inval = ~pal_valid
    err = torch.zeros_like(src)
    picks = []
    for _ in range(64):
        t = src + _trunc_div(err * 9, 100)
        pen = color_compare(t[:, None, 0], t[:, None, 1], t[:, None, 2], pr, pg, pb)
        chosen = torch.where(inval, BIG, pen).argmin(dim=1)  # the first minimum
        err = err + src - pal.gather(1, chosen[:, None, None].expand(-1, 1, 3))[:, 0]
        picks.append(chosen)
    lists = torch.stack(picks, dim=1)
    order = torch.sort(lum_pal.gather(1, lists), dim=1, stable=True).indices
    return lists.gather(1, order).to(torch.int32)


def _select_in_chunks(tiles_u8, mirror, pal_idx, pal_rgb, pal_valid, chunk: int, pick):
    """Tiles in chunks of ``chunk``: each chunk's pixels with their
    palettes go to ``pick(pix [B, 3], pal [B, S, 3], valid [B, S], mapv
    [B])``, which returns each pixel's palette slot. Returns [T, 8, 8]
    uint8."""
    T = tiles_u8.shape[0]
    out = torch.empty(T, 8, 8, dtype=torch.uint8, device=tiles_u8.device)
    for i in range(0, T, chunk):
        n = min(chunk, T - i)
        pidx = pal_idx[i:i + n].long()
        sel = pick(tiles_u8[i:i + n].reshape(n * 64, 3),
                   pal_rgb[pidx].repeat_interleave(64, dim=0),
                   pal_valid[pidx].repeat_interleave(64, dim=0),
                   mirrored_bayer(mirror[i:i + n]).reshape(n * 64).long())
        out[i:i + n] = sel.reshape(n, 8, 8).to(torch.uint8)
    return out


def thomas_knoll_select(tiles_u8, mirror, pal_idx, pal_rgb, pal_valid,
                        chunk: int | None = None) -> torch.Tensor:
    """Thomas Knoll palette slot per pixel by plain tensor passes
    (``use_pallas_tk=False``), tiles in chunks of ``chunk`` (by default
    sized from S, ``TK_PLAIN_ELEMS``): the list entry at the pixel's
    mirrored Bayer value. Runs on the device of its inputs, a CUDA one
    included, and launches no kernel; its slots equal ``tk_select``'s.

    tiles_u8 [T, 8, 8, 3] uint8, mirror [T] uint8, pal_idx [T] integer,
    pal_rgb [P, S, 3] integer, pal_valid [P, S] bool. Returns [T, 8, 8]
    uint8."""
    S = pal_rgb.shape[1]

    def pick(pix, pal, valid, mapv):
        return thomas_knoll_lists(pix, pal, valid, S).gather(1, mapv[:, None])[:, 0]

    return _select_in_chunks(tiles_u8, mirror, pal_idx, pal_rgb, pal_valid,
                             chunk or max(1, TK_PLAIN_ELEMS // (64 * S)), pick)


def yliluoma2_lists(pix_rgb, pal_rgb, pal_valid, S: int, mixed: int):
    """Yliluoma2 mixing plans, after ``tiler_tpu.pipeline.dither.
    yliluoma2_lists``: a 4-component (r, g, b, luma) distance with weights
    (13, 13, 13, 32) and the reciprocal rounding
    ``mixed = (sum * (65536 div t)) >> 16``.

    pix_rgb [B, 3], pal_rgb [B, S, 3] (the palette of each pixel) integer
    tensors, pal_valid [B, S] bool. Returns (lists [B, 2 * mixed] int32 of
    palette slots, luma-sorted, unused entries last; count [B] int32).
    The rounds end when every pixel's plan holds ``mixed`` entries, which
    the host reads once a round (at most ``mixed`` rounds)."""
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
        lists = torch.where(wmask & ~done[:, None], chosen[:, None], lists)
        so_far = torch.where(done[:, None], so_far, so_far + ch4 * amount[:, None])
        plan_count = torch.where(done, plan_count, plan_count + amount)

    lum = lum_pal.gather(1, lists.long())
    lum = torch.where(pos < plan_count[:, None], lum, BIG)
    order = torch.sort(lum, dim=1, stable=True).indices
    return lists.gather(1, order), plan_count


def yliluoma2_select(tiles_u8, mirror, pal_idx, pal_rgb, pal_valid, mixed: int,
                     chunk: int | None = None) -> torch.Tensor:
    """Yliluoma2 palette slot per pixel, tiles in chunks of ``chunk`` (by
    default :func:`yliluoma2_chunk`).

    tiles_u8 [T, 8, 8, 3] uint8, mirror [T] uint8, pal_idx [T] integer,
    pal_rgb [P, S, 3] integer, pal_valid [P, S] bool, all on one device.
    Returns [T, 8, 8] uint8."""
    S = pal_rgb.shape[1]

    def pick(pix, pal, valid, mapv):
        lists, count = yliluoma2_lists(pix, pal, valid, S, mixed)
        return lists.gather(1, ((mapv * count) >> 6)[:, None])[:, 0]

    return _select_in_chunks(tiles_u8, mirror, pal_idx, pal_rgb.to(torch.int32), pal_valid,
                             chunk or yliluoma2_chunk(S, mixed), pick)


def _corpus_initial_mirrors(state: EncodeState):
    """Mirror flags of each corpus tile, taken from the last tilemap
    instance that maps to it (the canonical content alone cannot say
    which mirror made it canonical)."""
    T = len(state.corpus_rgb)
    hm = np.zeros(T, bool)
    vm = np.zeros(T, bool)
    tidx = state.tilemap.tile_idx.reshape(-1)
    sel = tidx >= 0
    first = np.full(T, -1, np.int64)
    first[tidx[sel]] = np.flatnonzero(sel)
    ok = first >= 0
    hm[ok] = state.tilemap.hmirror.reshape(-1)[first[ok]]
    vm[ok] = state.tilemap.vmirror.reshape(-1)[first[ok]]
    return hm, vm


def dither(state: EncodeState, settings: EncoderSettings) -> EncodeState:
    corpus = state.corpus_rgb
    dev = corpus.device
    T = len(corpus)
    hm, vm = _corpus_initial_mirrors(state)
    mirror = torch.as_tensor((hm | (vm.astype(np.uint8) << 1)).astype(np.uint8), device=dev)
    pal_rgb = torch.as_tensor(state.palettes_rgb, device=dev)
    pal_valid = torch.as_tensor(state.palettes_valid, device=dev)
    pal_initial = state.corpus_pal_initial
    if isinstance(pal_initial, np.ndarray):
        # a resumed state; prepare_palettes itself leaves a device tensor
        # drawn from a permutation of arange(P), in range by construction
        check_pal_idx(pal_initial, pal_rgb.shape[0])
    pidx = torch.as_tensor(pal_initial, device=dev).to(torch.int32).contiguous()
    if settings.dithering_use_thomas_knoll and settings.use_pallas_tk:
        sel = tk_select(corpus.reshape(T, 64, 3).contiguous(), mirror, pidx,
                        pal_table(pal_rgb, pal_valid))
    elif settings.dithering_use_thomas_knoll:
        sel = thomas_knoll_select(corpus, mirror, pidx, pal_rgb, pal_valid)
    else:
        sel = yliluoma2_select(corpus, mirror, pidx, pal_rgb, pal_valid,
                               settings.dithering_yliluoma2_mixed_colors)
    state.corpus_pal_pixels = sel.reshape(T, 8, 8)
    state._pal_hashes_prefetch = pal_hashes(state.corpus_pal_pixels)
    return state
