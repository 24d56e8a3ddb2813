"""esPredictMotion: motion vectors and their PSNR for every frame.

Counterpart of ``tiler_tpu/pipeline/predict.py``. Frame t searches frame
t-1's original pixels; frame 0 searches frame 1. The frame pairs are
independent; the port runs them as a frame loop on the device and pulls
the vectors once. Host-resident frames (``pipeline/load.py``) go up in
chunks sized to the device's free memory. On a mesh with a "data" axis
of more than one rank, each rank searches its share of the frames and
the results are gathered (``_predict_motion_dp``). On the device-resident
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
from ..parallel.collectives import all_gather_stack, axis_index
from ..parallel.mesh import mesh_shape
from .load import to_device
from .motion import motion_search
from .reduce import tile_hashes

CPU_CHUNK_BUDGET = 4e9  # bytes of staged frames a chunk on the CPU


def _frame_chunk(H: int, W: int, device: torch.device) -> int:
    """Frames a chunk of host frames: the chunk stages its frames and
    their references (one uint8 copy; the JAX package stages the current
    and the reference frames apart, twice the bytes) within half the
    card's free memory (1..20 GB), or a fixed budget on the CPU."""
    budget = CPU_CHUNK_BUDGET
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        budget = max(1e9, min(0.5 * free, 2e10))
    return max(1, int(budget / (H * W * 3)))


def _search(state: EncodeState, settings: EncoderSettings, fids: np.ndarray, dev):
    """The motion search of frames ``fids`` (ascending) against their
    references: int32 [3, len(fids), N], the vectors' y and x and the
    PSNR's float32 bits. Host frames go up a chunk of frames (with the
    references they search) at a time."""
    frames = state.frames_rgb
    host = isinstance(frames, np.ndarray)
    F = state.n_frames
    refs = np.concatenate([[1], np.arange(F - 1)])  # frame 0 predicts from frame 1
    chunk = _frame_chunk(state.height, state.width, dev) if host else len(fids)
    out = []
    for i in range(0, len(fids), chunk):
        ids = fids[i:i + chunk]
        need = np.unique(np.concatenate([ids, refs[ids]]))
        if host:  # the chunk's frames and references, at slots 0, 1, ...
            src, slot = to_device(frames[need], dev), {f: j for j, f in enumerate(need.tolist())}
        else:
            src, slot = frames, {f: f for f in need.tolist()}
        for f in ids.tolist():
            y, x, err = motion_search(src[slot[f]], src[slot[int(refs[f])]],
                                      settings.motion_predict_radius, settings.motion_field,
                                      int16=settings.int16_features,
                                      rank_dims=settings.motion_rank_dims)
            out.append(torch.stack([y.reshape(-1).int(), x.reshape(-1).int(),
                                    euclidean_to_psnr(err).reshape(-1).view(torch.int32)]))
    return torch.stack(out, dim=1)


def predict_motion(state: EncodeState, settings: EncoderSettings, device=None,
                   mesh=None) -> EncodeState:
    """``device``: where the search runs (default: the frames' device).
    ``mesh``: a DeviceMesh; with a "data" axis of more than one rank the
    frames are searched data-parallel."""
    F = state.n_frames
    if F < 2 or settings.motion_predict_radius <= 0:
        return state
    frames = state.frames_rgb
    host = isinstance(frames, np.ndarray)
    dev = torch.device(device) if device is not None else frames.device
    if mesh is not None and mesh_shape(mesh).get("data", 1) > 1:
        packed = _predict_motion_dp(state, settings, mesh, dev)
    else:
        packed = _search(state, settings, np.arange(F), dev)
    state._hashes_prefetch = None if host else tile_hashes(state.tiles_canon)
    packed = packed.cpu().numpy()
    tm = state.tilemap
    tm.pred_y[:] = packed[0]
    tm.pred_x[:] = packed[1]
    tm.psnr[:] = packed[2].view(np.float32)
    return state


def _predict_motion_dp(state: EncodeState, settings: EncoderSettings, mesh, dev):
    """Data-parallel motion (``tiler_tpu/pipeline/predict.py:153-177``):
    the frames, padded to Fp, a multiple of the "data" axis's size dd, by
    repeating the last, are split into dd runs; the rank at data
    coordinate i searches run i (a host clip stages only that run's
    frames and references) and the runs are gathered in coordinate order.
    The same per-frame search as the single-device path, so the same
    bits. Returns int32 [3, F, N] as :func:`_search`."""
    F = state.n_frames
    dd = mesh_shape(mesh)["data"]
    per = -(-F // dd)
    idxs = np.minimum(np.arange(per * dd), F - 1)
    i = axis_index(mesh, "data")
    mine = _search(state, settings, idxs[i * per:(i + 1) * per], dev)
    runs = all_gather_stack(mine, mesh, "data")  # [dd, 3, per, N]
    return runs.transpose(0, 1).reshape(3, per * dd, -1)[:, :F]
