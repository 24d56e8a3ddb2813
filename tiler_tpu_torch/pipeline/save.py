"""esSave: assemble the GTM bitstream from encoder state
(SaveStream parity, tilingencoder.pas:5177-5482).

The port's own copy of ``tiler_tpu/pipeline/save.py``; it reads a numpy
copy of the state (``models/convert.py::state_to_numpy``)."""
from __future__ import annotations

import numpy as np

from ..bitstream.gtm import FrameCommands, GTMWriter, GTMStats
from ..config import EncoderSettings
from ..models.state import EncodeState


def save(state: EncodeState, settings: EncoderSettings, path) -> GTMStats:
    tm = state.tilemap
    F = state.n_frames
    frames = []
    for f in range(F):
        frames.append(
            FrameCommands(
                tile_idx=tm.tile_idx[f],
                pal_idx=tm.pal_idx[f],
                predicted=tm.predicted[f],
                pred_x=tm.pred_x[f],
                pred_y=tm.pred_y[f],
                hmirror=tm.hmirror[f],
                vmirror=tm.vmirror[f],
            )
        )
    kf_end = np.zeros(F, bool)
    for kf in state.keyframes:
        kf_end[kf.end_frame] = True

    writer = GTMWriter(
        state.tilemap_w,
        state.tilemap_h,
        state.fps,
        settings.palette_size,
        settings_text=settings.to_ini(),
        lzma_mode=settings.lzma_mode,
    )
    return writer.write(
        path,
        np.asarray(state.corpus_pal_pixels),
        state.corpus_use,
        np.asarray(state.palettes_rgb),
        frames,
        kf_end.tolist(),
        palettes_valid=(None if state.palettes_valid is None
                        else np.asarray(state.palettes_valid)),
    )
