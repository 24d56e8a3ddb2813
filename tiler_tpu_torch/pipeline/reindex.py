"""esReindex: dedup the corpus on palette pixels, recount usage from the
tilemaps, drop unused tiles, sort by use count (desc, ties on content),
and remap the tilemap indexes.

Counterpart of ``tiler_tpu/pipeline/reindex.py``: the same device-side
pair of int32 polynomial hashes (multipliers rebuilt with the same numpy
draws) and the same host bookkeeping, so the result is bit-identical.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import EncoderSettings
from ..models.state import EncodeState
from .reduce import poly_hashes

_RNG = np.random.RandomState(0x1DE7)
_C1 = (_RNG.randint(0, 1 << 31, 64) * 2 + 1).astype(np.int32)
_C2 = (_RNG.randint(0, 1 << 31, 64) * 2 + 1).astype(np.int32)


def pal_hashes(pp_u8: torch.Tensor) -> torch.Tensor:
    """[T, 8, 8] uint8 palette pixels -> [2, T] int32 hashes."""
    return poly_hashes(pp_u8.reshape(-1, 64), _C1, _C2)


def reindex(state: EncodeState, settings: EncoderSettings) -> EncodeState:
    tm = state.tilemap
    pp = state.corpus_pal_pixels
    hh = state._pal_hashes_prefetch
    state._pal_hashes_prefetch = None
    if hh is None:
        hh = pal_hashes(pp)
    hh = hh.cpu().numpy()
    key = (hh[0].astype(np.int64) << 32) ^ (hh[1].astype(np.int64) & 0xFFFFFFFF)
    uniq_keys, first_idx, inverse = np.unique(key, return_index=True, return_inverse=True)

    # count only emitted cells by default; count_predicted_tiles also
    # counts prediction-overridden cells (the reference's accounting)
    tid = tm.tile_idx.reshape(-1)
    if settings.count_predicted_tiles:
        emitted = tid >= 0
    else:
        emitted = (tid >= 0) & ~tm.predicted.reshape(-1)
    uidx = inverse[tid[emitted]]
    counts = np.bincount(uidx, minlength=len(first_idx)).astype(np.int64)

    kept = np.flatnonzero(counts > 0)
    kcounts = counts[kept]
    order = np.lexsort((uniq_keys[kept], -kcounts))
    rank_of_kept = np.empty(len(order), np.int64)
    rank_of_kept[order] = np.arange(len(order))
    final_of_unique = np.full(len(first_idx), -1, np.int64)
    final_of_unique[kept] = rank_of_kept

    new_tid = np.full_like(tid, -1)
    new_tid[emitted] = final_of_unique[uidx]
    tm.tile_idx = new_tid.reshape(tm.tile_idx.shape)

    sel = first_idx[kept][order]
    sel_dev = torch.as_tensor(sel, device=pp.device)
    state.corpus_pal_pixels = pp[sel_dev]
    state.corpus_use = kcounts[order]
    if state.corpus_rgb is not None:
        state.corpus_rgb = torch.as_tensor(state.corpus_rgb, device=pp.device)[sel_dev]
    if state.corpus_pal_initial is not None:
        pal_init = state.corpus_pal_initial
        if isinstance(pal_init, torch.Tensor):
            pal_init = pal_init.cpu().numpy()
        state.corpus_pal_initial = np.asarray(pal_init)[sel]
    return state
