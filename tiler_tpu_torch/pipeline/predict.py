"""esPredictMotion: motion vectors and their PSNR for every frame.

Counterpart of ``tiler_tpu/pipeline/predict.py:24-150``. Frame t
searches frame t-1's original pixels; frame 0 searches frame 1. The frame
pairs are independent; the port runs them as a frame loop on the device
and pulls the vectors once. Reduce's tile hashes are computed here, after
the motion work is queued, as in the JAX package's prefetch.
"""
from __future__ import annotations

import torch

from ..config import EncoderSettings
from ..models.state import EncodeState
from ..ops.metrics import euclidean_to_psnr
from .motion import motion_search
from .reduce import tile_hashes


def predict_motion(state: EncodeState, settings: EncoderSettings) -> EncodeState:
    R = settings.motion_predict_radius
    F = state.n_frames
    if F < 2 or R <= 0:
        return state
    frames = state.frames_rgb
    refs = [1] + list(range(F - 1))  # frame 0 predicts from frame 1
    oy, ox, psnr = [], [], []
    for f in range(F):
        y, x, err = motion_search(frames[f], frames[refs[f]], R, settings.motion_field)
        oy.append(y.reshape(-1))
        ox.append(x.reshape(-1))
        psnr.append(euclidean_to_psnr(err).reshape(-1))
    state._hashes_prefetch = tile_hashes(state.tiles_canon)
    tm = state.tilemap
    tm.pred_y[:] = torch.stack(oy).cpu().numpy()
    tm.pred_x[:] = torch.stack(ox).cpu().numpy()
    tm.psnr[:] = torch.stack(psnr).cpu().numpy()
    return state
