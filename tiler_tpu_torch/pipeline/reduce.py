"""esReduce: global tile budget via a PSNR threshold + corpus dedup.

Counterpart of ``tiler_tpu/pipeline/reduce.py``. Tile identity is the
same pair of int32 wrapping polynomial hashes of the canonical RGB bytes,
computed on the device (the multipliers are rebuilt here with the same
numpy draws; a test holds them equal to the JAX package's). The host
logic is the JAX package's line for line, so given the same motion PSNRs
the corpus and its order are bit-identical: use count descending, ties
on the content hash. Host-resident tiles (``pipeline/load.py``) are
hashed on the device in slices of ``HASH_CHUNK`` tiles, and the corpus is
gathered on the host, then uploaded.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import EncoderSettings
from ..models.state import EncodeState
from .load import to_device

_RNG = np.random.RandomState(0x5EED)
_C1 = (_RNG.randint(0, 1 << 31, 192) * 2 + 1).astype(np.int32)
_C2 = (_RNG.randint(0, 1 << 31, 192) * 2 + 1).astype(np.int32)

HASH_CHUNK = 1 << 18  # tiles per hash pass (bounds the int64 transient)


def wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """Two's-complement wrap of int64 values to int32 (int32 overflow
    semantics of the JAX sums)."""
    return (((x + 2**31) & 0xFFFFFFFF) - 2**31).to(torch.int32)


def poly_hashes(flat_u8: torch.Tensor, c1: np.ndarray, c2: np.ndarray):
    """[n, L] uint8 -> [2, n] int32 wrapping sums of bytes * c1 / c2."""
    dev = flat_u8.device
    m1 = torch.as_tensor(c1.astype(np.int64), device=dev)
    m2 = torch.as_tensor(c2.astype(np.int64), device=dev)
    out = torch.empty(2, flat_u8.shape[0], dtype=torch.int32, device=dev)
    for i in range(0, flat_u8.shape[0], HASH_CHUNK):
        x = flat_u8[i:i + HASH_CHUNK].long()
        # exact in int64 (< 2^47), wrapped once: equal to the int32 sum
        out[0, i:i + HASH_CHUNK] = wrap_int32((x * m1).sum(dim=1))
        out[1, i:i + HASH_CHUNK] = wrap_int32((x * m2).sum(dim=1))
    return out


def tile_hashes(tiles_u8: torch.Tensor) -> torch.Tensor:
    """[..., 8, 8, 3] uint8 -> [2, n] int32 tile hashes."""
    return poly_hashes(tiles_u8.reshape(-1, 192), _C1, _C2)


def reduce_tiles(state: EncodeState, settings: EncoderSettings,
                 device=None) -> EncodeState:
    """``device``: where the hashes run and the corpus lives (default: the
    tiles' device)."""
    F, N = state.n_frames, state.tilemap_size
    tiles_flat = state.tiles_canon.reshape(F * N, 8, 8, 3)
    host = isinstance(tiles_flat, np.ndarray)
    dev = torch.device(device) if device is not None else tiles_flat.device
    tm = state.tilemap
    psnr = tm.psnr.astype(np.float64)
    kf_start = np.zeros(F, bool)
    for kf in state.keyframes:
        kf_start[kf.start_frame] = True
    eff = np.where(kf_start[:, None], psnr / 10.0, psnr)
    eff_flat = eff.reshape(-1)

    hh = state._hashes_prefetch
    state._hashes_prefetch = None
    if hh is None and host:
        hh = torch.cat([tile_hashes(to_device(tiles_flat[i:i + HASH_CHUNK], dev)).cpu()
                        for i in range(0, F * N, HASH_CHUNK)], dim=1)
    elif hh is None:
        hh = tile_hashes(tiles_flat)
    hh = hh.cpu().numpy()
    key = (hh[0].astype(np.int64) << 32) ^ (hh[1].astype(np.int64) & 0xFFFFFFFF)
    uniq_keys, first_idx, inverse = np.unique(key, return_index=True, return_inverse=True)
    n_unique = len(first_idx)

    if settings.global_tiling_use_target_psnr:
        x = float(settings.global_tiling_target_psnr)
    else:
        target = settings.derived_tile_count(F * N)
        min_eff = np.full(n_unique, np.inf)
        np.minimum.at(min_eff, inverse, eff_flat)
        order = np.sort(min_eff)
        target = min(target, n_unique)
        x = float(order[target - 1]) if target >= 1 else -np.inf
        # the count step nearest the target: a tie block of equal values
        # spanning the target can only end (threshold = tie value) or
        # start (threshold = previous distinct value); ties -> smaller
        cnt_hi = int(np.searchsorted(order, x, side="right"))
        cnt_lo = int(np.searchsorted(order, x, side="left"))
        if cnt_lo >= 1 and abs(cnt_lo - target) <= abs(cnt_hi - target):
            x = float(order[cnt_lo - 1])

    unpred_flat = eff_flat <= x
    tm.predicted = (~unpred_flat).reshape(F, N)

    sel = np.flatnonzero(unpred_flat)
    sel_u = inverse[sel]
    used_unique, sel_to_corpus = np.unique(sel_u, return_inverse=True)
    counts = np.bincount(sel_to_corpus, minlength=len(used_unique)).astype(np.int64)

    # use count desc, ties by content hash
    order = np.lexsort((uniq_keys[used_unique], -counts))
    rank = np.empty(len(order), np.int64)
    rank[order] = np.arange(len(order))

    rep_flat = first_idx[used_unique][order]
    if host:
        state.corpus_rgb = to_device(tiles_flat[rep_flat], dev)
    else:
        state.corpus_rgb = tiles_flat[torch.as_tensor(rep_flat, device=dev)]
    state.corpus_use = counts[order]
    tile_idx = np.full(F * N, -1, np.int64)
    tile_idx[sel] = rank[sel_to_corpus]
    tm.tile_idx = tile_idx.reshape(F, N)
    return state
