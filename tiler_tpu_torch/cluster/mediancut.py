"""Median-cut color quantizer — the optional alternative to k-means.

The port's own copy of ``tiler_tpu/cluster/mediancut.py`` (pure numpy, on
the host; ``tests/test_torch_quantizers.py`` holds its palettes equal to
the original's). The reference declares the Dennis Lee DL1/DL3 quantizers
as an optional palette path (dlquant/quantizer.c, bindings
extern.pas:195-196); this is that capability, selected by
``EncoderSettings(color_quantizer="mediancut")`` in place of the
per-palette k-means (``pipeline/palettes.py::quantization``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def median_cut(colors: np.ndarray, weights: Optional[np.ndarray], k: int
               ) -> np.ndarray:
    """colors [N, 3] (0..255), weights [N] -> palette [k, 3] uint8.

    Boxes split along their widest (weighted-extent) channel at the
    weighted median until k boxes exist; each box yields its weighted
    mean color.
    """
    colors = np.asarray(colors, np.float64)
    n = len(colors)
    if n == 0:
        return np.zeros((k, 3), np.uint8)
    w = np.ones(n) if weights is None else np.asarray(weights, np.float64)
    boxes = [np.arange(n)]
    while len(boxes) < k:
        # split the box with the largest weighted spread
        spreads = []
        for idx in boxes:
            if len(idx) < 2:
                spreads.append(-1.0)
                continue
            c = colors[idx]
            spreads.append(float((c.max(0) - c.min(0)).max()))
        bi = int(np.argmax(spreads))
        if spreads[bi] <= 0:
            break
        idx = boxes[bi]
        c = colors[idx]
        ch = int(np.argmax(c.max(0) - c.min(0)))
        order = np.argsort(c[:, ch], kind="stable")
        cum = np.cumsum(w[idx][order])
        split = int(np.searchsorted(cum, cum[-1] / 2.0)) + 1
        split = max(1, min(split, len(idx) - 1))
        boxes[bi] = idx[order[:split]]
        boxes.append(idx[order[split:]])
    pal = np.zeros((k, 3))
    for i, idx in enumerate(boxes):
        ww = w[idx]
        pal[i] = (colors[idx] * ww[:, None]).sum(0) / max(ww.sum(), 1e-9)
    return np.clip(np.round(pal), 0, 255).astype(np.uint8)
