"""Encoder state: explicit, serializable artifacts between stages.

The reference keeps everything live in a TTilingEncoder instance (frames
zlib-compressed in RAM, tilemaps mutated in place). Here each stage reads
and writes plain arrays on a state object, so any stage's output can be
checkpointed to disk and resumed — the rebuild's answer to the GUI's
step-range re-runs (SURVEY.md section 5, checkpoint/resume).

Tilemap layout is struct-of-arrays [F, N] (N = tilemap_h * tilemap_w,
raster order), replacing TTileMapItem records (tilingencoder.pas:178-206).

The port's own copy of ``tiler_tpu/models/state.py``, without the JAX
package's pipelined-ingest hooks. The port keeps the large arrays as
torch tensors on its device (``models/convert.py``); checkpoints hold
numpy arrays, as the JAX package's do.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


@dataclass
class KeyFrameInfo:
    index: int
    start_frame: int
    end_frame: int
    reason: str = "manual"  # TKeyFrameReason (tilingencoder.pas:19)

    @property
    def frame_count(self):
        return self.end_frame - self.start_frame + 1


@dataclass
class TileMapSoA:
    """[F, N] arrays; defaults match InitFrames (tilingencoder.pas:2661-2687)."""

    tile_idx: np.ndarray  # int64, -1 = none
    pal_idx: np.ndarray  # int32, -1 = none
    pred_x: np.ndarray  # int16
    pred_y: np.ndarray  # int16
    predicted: np.ndarray  # bool
    hmirror: np.ndarray  # bool  (from load heuristics)
    vmirror: np.ndarray  # bool
    psnr: np.ndarray  # float32

    @classmethod
    def zeros(cls, f: int, n: int) -> "TileMapSoA":
        return cls(
            tile_idx=np.full((f, n), -1, np.int64),
            pal_idx=np.full((f, n), -1, np.int32),
            pred_x=np.zeros((f, n), np.int16),
            pred_y=np.zeros((f, n), np.int16),
            predicted=np.zeros((f, n), bool),
            hmirror=np.zeros((f, n), bool),
            vmirror=np.zeros((f, n), bool),
            psnr=np.zeros((f, n), np.float32),
        )


@dataclass
class EncodeState:
    """Pipeline state (host arrays; stages move slices to device)."""

    # load
    fps: float = 24.0
    tilemap_w: int = 0
    tilemap_h: int = 0
    frames_rgb: Optional[np.ndarray] = None  # [F, H, W, 3] uint8 (original)
    tiles_canon: Optional[np.ndarray] = None  # [F, N, 8, 8, 3] uint8 canonical spin
    correlations: Optional[np.ndarray] = None  # [F] float (with previous frame)
    keyframes: List[KeyFrameInfo] = field(default_factory=list)
    frame_kf: Optional[np.ndarray] = None  # [F] int32: keyframe index per frame
    tilemap: Optional[TileMapSoA] = None

    # reduce (global corpus; canonical orientation)
    corpus_rgb: Optional[np.ndarray] = None  # [T, 8, 8, 3] uint8
    corpus_use: Optional[np.ndarray] = None  # [T] int64
    corpus_pal_initial: Optional[np.ndarray] = None  # [T] int32

    # palettes
    palettes_rgb: Optional[np.ndarray] = None  # [P, S, 3] uint8
    palettes_valid: Optional[np.ndarray] = None  # [P, S] bool (False = null color)

    # dither
    corpus_pal_pixels: Optional[np.ndarray] = None  # [T, 8, 8] uint8

    # reconstruct
    kf_psnr: Optional[np.ndarray] = None  # per keyframe mean tile PSNR-HVS
    total_psnr: float = 0.0

    # prefetched per-cell tile hashes [2, F*N] (device array with its host
    # copy already streaming): dispatched by predict_motion so Reduce's
    # pull hides behind the motion programs
    _hashes_prefetch: Optional[object] = field(default=None, repr=False)

    # prefetched per-corpus-tile palette-pixel hashes [2, T]: dispatched
    # by dither so Reindex's pull hides behind reconstruct
    _pal_hashes_prefetch: Optional[object] = field(default=None, repr=False)

    @property
    def n_frames(self) -> int:
        # loaded source frames; 0 means "no video loaded" (run_all's
        # auto-load)
        if self.frames_rgb is None:
            return 0
        return len(self.frames_rgb)

    @property
    def tilemap_size(self) -> int:
        return self.tilemap_w * self.tilemap_h

    @property
    def width(self) -> int:
        return self.tilemap_w * 8

    @property
    def height(self) -> int:
        return self.tilemap_h * 8
