"""esDither: Thomas Knoll ordered dithering of every corpus tile through
its palette.

Counterpart of the TK path of ``tiler_tpu/pipeline/dither.py:210-320``.
The canonical pixels are dithered against a per-tile MIRRORED Bayer map
(the reference un-mirrors each tile to its screen orientation first);
the per-pixel work is kernel B1 (``kernels/tk_dither.py``). Reindex's
palette-pixel hashes are taken here, as the JAX package's prefetch does.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import EncoderSettings
from ..kernels.tk_dither import pal_table, tk_select
from ..models.state import EncodeState
from .reindex import pal_hashes


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
    table = pal_table(torch.as_tensor(state.palettes_rgb, device=dev),
                      torch.as_tensor(state.palettes_valid, device=dev))
    pidx = torch.as_tensor(state.corpus_pal_initial, device=dev).to(torch.int32).contiguous()
    sel = tk_select(corpus.reshape(T, 64, 3).contiguous(), mirror, pidx, table)
    state.corpus_pal_pixels = sel.reshape(T, 8, 8)
    state._pal_hashes_prefetch = pal_hashes(state.corpus_pal_pixels)
    return state
