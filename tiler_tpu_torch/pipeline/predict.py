"""esPredictMotion: motion vectors and their PSNR for every frame.

Counterpart of ``tiler_tpu/pipeline/predict.py:24-150``. Frame t
searches frame t-1's original pixels; frame 0 searches frame 1. The frame
pairs are independent; the port runs them as a frame loop on the device
and pulls the vectors once. Host-resident frames (``pipeline/load.py``)
go up in chunks sized to the device's free memory. On the device-resident
path Reduce's tile hashes are computed here, after the motion work is
queued, as in the JAX package's prefetch; in host mode Reduce hashes the
host tiles itself.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import EncoderSettings
from ..models.state import EncodeState
from ..ops.metrics import euclidean_to_psnr
from .load import to_device
from .motion import motion_search
from .reduce import tile_hashes

CPU_CHUNK_BUDGET = 4e9  # bytes of staged frames a chunk on the CPU


def _frame_chunk(H: int, W: int, device: torch.device) -> int:
    """Frames a chunk of host frames: the chunk stages its frames and
    the reference of its first (one uint8 copy; the JAX package stages
    the current and the reference frames apart, twice the bytes) within
    half the card's free memory (1..20 GB), or a fixed budget on the
    CPU."""
    budget = CPU_CHUNK_BUDGET
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        budget = max(1e9, min(0.5 * free, 2e10))
    return max(1, int(budget / (H * W * 3)))


def predict_motion(state: EncodeState, settings: EncoderSettings,
                   device=None) -> EncodeState:
    """``device``: where the search runs (default: the frames' device)."""
    R = settings.motion_predict_radius
    F = state.n_frames
    if F < 2 or R <= 0:
        return state
    frames = state.frames_rgb
    host = isinstance(frames, np.ndarray)
    dev = torch.device(device) if device is not None else frames.device
    refs = np.concatenate([[1], np.arange(F - 1)])  # frame 0 predicts from frame 1
    chunk = _frame_chunk(state.height, state.width, dev) if host else F
    oy, ox, psnr = [], [], []
    for i in range(0, F, chunk):
        j = min(F, i + chunk)
        # frames [lo, hi) hold the chunk and every reference it searches
        lo, hi = (max(0, i - 1), max(j, 2)) if host else (0, F)
        src = to_device(frames[lo:hi], dev) if host else frames
        for f in range(i, j):
            y, x, err = motion_search(src[f - lo], src[refs[f] - lo], R, settings.motion_field,
                                      int16=settings.int16_features,
                                      rank_dims=settings.motion_rank_dims)
            oy.append(y.reshape(-1))
            ox.append(x.reshape(-1))
            psnr.append(euclidean_to_psnr(err).reshape(-1))
    state._hashes_prefetch = None if host else tile_hashes(state.tiles_canon)
    tm = state.tilemap
    tm.pred_y[:] = torch.stack(oy).cpu().numpy()
    tm.pred_x[:] = torch.stack(ox).cpu().numpy()
    tm.psnr[:] = torch.stack(psnr).cpu().numpy()
    return state
