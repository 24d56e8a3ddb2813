"""Synthetic test clips.

:func:`synthetic_clip` is the port's copy of ``bench.synthetic_clip``:
the same seeded frames, byte for byte, so a clip encoded by the port and
by the JAX package's benchmark is the same input.
"""
from __future__ import annotations

import numpy as np


def synthetic_clip(F: int, H: int, W: int, seed: int = 0) -> np.ndarray:
    """[F, H, W, 3] uint8: a colour gradient with fixed noise, scrolled
    by (3, 5) pixels a frame, and a 64x64 red square moving over it."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    base = np.stack(
        [(yy * 255 // H), (xx * 255 // W), ((yy + xx) * 255 // (H + W))], -1
    ).astype(np.uint8)
    noise = rng.randint(0, 30, (H, W, 3)).astype(np.uint8)
    frames = []
    for f in range(F):
        img = np.roll(base + noise, (3 * f, 5 * f), (0, 1))
        # max(1, ...): keeps tiny shapes (W or H below 64) from a zero
        # modulo; the square then pins at 0, 0
        x0 = (40 + 11 * f) % max(1, W - 64)
        y0 = (30 + 7 * f) % max(1, H - 64)
        img[y0:y0 + 64, x0:x0 + 64] = [220, 40, 40]
        frames.append(img)
    return np.stack(frames)
