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
- Yliluoma2: ``yl2_select`` (``kernels/yl2_dither.py``), which follows
  the device of its inputs. On a card it is the port's own kernel (the
  JAX package has none here), one launch for the whole corpus; on the
  CPU the plain passes (``yliluoma2_lists`` there, the mixing-plan
  construction of ``tiler_tpu/pipeline/dither.py:102-181``), tiles in
  chunks sized from S, as the JAX package's CPU encode runs them.

All are int32 and bit-identical to the JAX package's (the two Thomas
Knoll paths to each other, the Yliluoma2 kernel to the plain passes).
Reindex's palette-pixel hashes are taken here, as the JAX package's
prefetch does. With Yliluoma2 the step counts into ``stats``:
``dither_colors``, the valid colors of each pixel's palette summed over
the corpus's pixels, and ``yl2_candidates``, the (color, total) trials of
the plan search; both are device tensors on a card, which the encoder
reads once the step has ended.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import EncoderSettings
from ..kernels.tk_dither import (BLUE_MUL, GREEN_MUL, LUMA_DIV, RED_MUL, RGB_W,
                                 check_pal_idx, mirrored_bayer, pal_table, tk_select)
from ..kernels.yl2_dither import pal4_table, yl2_select, yl2_select_plain
from ..models.state import EncodeState
from .reindex import pal_hashes

BIG = 1 << 30
# Elements of the plain Thomas Knoll path's [pixels, S] int32 step tensors
# a chunk of tiles: 32,768 tiles at S = 16, 2,048 at S = 256.
TK_PLAIN_ELEMS = 1 << 25


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


def yliluoma2_select(tiles_u8, mirror, pal_idx, pal_rgb, pal_valid, mixed: int,
                     chunk: int | None = None) -> torch.Tensor:
    """Yliluoma2 palette slot per pixel by the plain passes
    (``kernels/yl2_dither.py::yliluoma2_lists``), tiles in chunks of
    ``chunk`` (by default sized from S), on the device of the inputs; the
    slots equal ``yl2_select``'s.

    tiles_u8 [T, 8, 8, 3] uint8, mirror [T] uint8, pal_idx [T] integer,
    pal_rgb [P, S, 3] integer, pal_valid [P, S] bool, all on one device.
    Returns [T, 8, 8] uint8."""
    T = tiles_u8.shape[0]
    sel, _ = yl2_select_plain(tiles_u8.reshape(T, 64, 3), mirror, pal_idx,
                              pal4_table(pal_rgb), pal_valid, mixed, chunk)
    return sel.reshape(T, 8, 8)


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


def dither(state: EncodeState, settings: EncoderSettings, chunk: int = 16384, *,
           stats: dict | None = None) -> EncodeState:
    """Every corpus tile through its palette. The kernel paths are one
    launch; the plain Thomas Knoll path takes the corpus ``chunk`` tiles
    at a time, as the JAX package's XLA path does, and Yliluoma2 on the
    CPU chunks inside ``yl2_select`` (each tile on its own, so the result
    does not depend on either). ``stats``: where the step's counts go
    (module docstring)."""
    stats = {} if stats is None else stats
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
    elif not settings.dithering_use_thomas_knoll:
        stats["dither_colors"] = 64 * pal_valid.sum(dim=1)[pidx.long()].sum()
        sel, stats["yl2_candidates"] = yl2_select(
            corpus.reshape(T, 64, 3).contiguous(), mirror, pidx, pal4_table(pal_rgb),
            pal_valid.contiguous(), settings.dithering_yliluoma2_mixed_colors)
    else:
        sel = torch.cat([thomas_knoll_select(corpus[i:i + chunk], mirror[i:i + chunk],
                                             pidx[i:i + chunk], pal_rgb, pal_valid)
                         for i in range(0, max(T, 1), chunk)])
    state.corpus_pal_pixels = sel.reshape(T, 8, 8)
    state._pal_hashes_prefetch = pal_hashes(state.corpus_pal_pixels)
    return state
