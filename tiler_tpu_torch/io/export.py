"""Exports: PNG-per-frame + palette dump, Y4M (C444), parity with
GeneratePNGs / GenerateY4M (tilingencoder.pas:2075-2199).

The port's own copy of ``tiler_tpu/io/export.py``, byte for byte."""
from __future__ import annotations

import os
from typing import Iterable, Optional

import numpy as np


def write_y4m(path: str, frames: Iterable[np.ndarray], fps: float):
    """C444 Y4M of RGB frames; header/frame layout parity with
    GenerateY4M (tilingencoder.pas:2126-2199): y plain, u/v offset +128."""
    frames = list(frames)
    H, W = frames[0].shape[:2]
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{W} H{H} F{round(fps*1000000)}:1000000 Ip C444\n".encode())
        for fr in frames:
            f.write(b"FRAME \n")
            rgb = fr[..., :3].astype(np.float32)
            y = rgb[..., 0] * 0.299 + rgb[..., 1] * 0.587 + rgb[..., 2] * 0.114
            u = (rgb[..., 2] - y) * 0.492
            v = (rgb[..., 0] - y) * 0.877
            f.write(np.clip(np.round(y), 0, 255).astype(np.uint8).tobytes())
            f.write(np.clip(np.round(u) + 128, 0, 255).astype(np.uint8).tobytes())
            f.write(np.clip(np.round(v) + 128, 0, 255).astype(np.uint8).tobytes())


def write_pngs(out_base: str, frames: Iterable[np.ndarray],
               palettes_rgb: Optional[np.ndarray] = None):
    """frame PNGs named <base>_%04d.png + palette text dump <base>.txt
    (GeneratePNGs, tilingencoder.pas:2075-2124)."""
    from PIL import Image

    base = os.path.splitext(out_base)[0]
    if palettes_rgb is not None:
        with open(base + ".txt", "w") as f:
            for pal in palettes_rgb:
                for c in pal:
                    col = 0xFF000000 | (int(c[2]) << 16) | (int(c[1]) << 8) | int(c[0])
                    f.write(f"{col:08X}\n")
    for i, fr in enumerate(frames):
        Image.fromarray(fr[..., :3]).save(f"{base}_{i:04d}.png")
