"""Preview rendering: the GUI's four render pages as numpy images.

The Lazarus GUI renders input / output (with motion-predicted tiles from
the back buffer) / global-tiles sheet / palette sheet bitmaps plus a
per-frame PSNR readout (TTilingEncoder.Render, tilingencoder.pas:
3455-3736; page enum :20). Headless equivalents return RGB arrays for
notebooks, PNG export, or quick inspection."""
from __future__ import annotations

from typing import Optional

import numpy as np

from .models.state import EncodeState

TILE_W = 8


def render_input(state: EncodeState, frame_idx: int) -> np.ndarray:
    """The loaded input frame (rpInput)."""
    return np.asarray(state.frames_rgb[frame_idx])


def render_output(state: EncodeState, frame_idx: int) -> np.ndarray:
    """Decode the tilemap state up to frame_idx (rpOutput): tile commands
    through palettes, motion-predicted cells copied from the previous
    reconstruction. Fully vectorized: <10 ms per 720p frame (the naive
    per-cell loop took minutes)."""
    tm = state.tilemap
    th, tw = state.tilemap_h, state.tilemap_w
    pal = np.asarray(state.palettes_rgb)
    pp = np.asarray(state.corpus_pal_pixels)
    prev = np.zeros((state.height, state.width, 3), np.uint8)
    cell_y = (np.arange(th) * TILE_W)[:, None]  # [th, 1]
    cell_x = (np.arange(tw) * TILE_W)[None, :]  # [1, tw]
    dy = np.arange(TILE_W)
    for f in range(frame_idx + 1):
        tid = np.maximum(tm.tile_idx[f], 0)
        pid = np.maximum(tm.pal_idx[f], 0)
        t = pp[tid]  # [N, 8, 8]
        t = np.where(tm.hmirror[f][:, None, None], t[:, :, ::-1], t)
        t = np.where(tm.vmirror[f][:, None, None], t[:, ::-1, :], t)
        rgb = pal[pid[:, None, None], t]  # [N, 8, 8, 3]
        # predicted cells: window gather from the previous reconstruction
        sy = cell_y + tm.pred_y[f].reshape(th, tw).astype(np.int64)
        sx = cell_x + tm.pred_x[f].reshape(th, tw).astype(np.int64)
        wy = np.clip(sy[:, :, None, None] + dy[None, None, :, None], 0, state.height - 1)
        wx = np.clip(sx[:, :, None, None] + dy[None, None, None, :], 0, state.width - 1)
        pred_rgb = prev[wy, wx]  # [th, tw, 8, 8, 3]
        chosen = np.where(
            tm.predicted[f].reshape(th, tw, 1, 1, 1),
            pred_rgb,
            rgb.reshape(th, tw, TILE_W, TILE_W, 3),
        )
        prev = chosen.transpose(0, 2, 1, 3, 4).reshape(state.height, state.width, 3).astype(np.uint8)
    return prev


def render_tiles(state: EncodeState, page_w_tiles: int = 64,
                 palette_idx: Optional[int] = None) -> np.ndarray:
    """Global tile sheet (rpTilesPalette), tiles rendered through a palette
    (default: each tile's initial palette). Vectorized."""
    pp = np.asarray(state.corpus_pal_pixels)
    pal = np.asarray(state.palettes_rgb)
    T = len(pp)
    if palette_idx is None:
        pidx = np.asarray(state.corpus_pal_initial)[:T] if state.corpus_pal_initial is not None else np.zeros(T, int)
    else:
        pidx = np.full(T, palette_idx)
    rows = -(-T // page_w_tiles)
    rgb = pal[np.asarray(pidx)[:, None, None], pp]  # [T, 8, 8, 3]
    padded = np.zeros((rows * page_w_tiles, TILE_W, TILE_W, 3), np.uint8)
    padded[:T] = rgb
    return (
        padded.reshape(rows, page_w_tiles, TILE_W, TILE_W, 3)
        .transpose(0, 2, 1, 3, 4)
        .reshape(rows * TILE_W, page_w_tiles * TILE_W, 3)
    )


def render_palettes(state: EncodeState, scale: int = 8) -> np.ndarray:
    """Palette sheet: one row per palette, one column per color."""
    pal = np.asarray(state.palettes_rgb)  # [P, S, 3]
    img = pal.repeat(scale, axis=0).repeat(scale, axis=1)
    return img


def frame_psnr(state: EncodeState, frame_idx: int) -> float:
    """Mean per-tile PSNR-HVS of a frame (GUI readout, :3713-3731)."""
    return float(state.tilemap.psnr[frame_idx].mean())
