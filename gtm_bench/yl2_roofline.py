"""The least time of the Yliluoma2 plan search (the ``yl2_select`` kernel)
from the timed encode's shapes alone, at the peaks of ``roofline.py``.

A plan of ``mixed`` entries grows in rounds: a round at ``count`` entries
tries every valid color of the pixel's palette with each total count + k,
k = 1..max(count, 1), and adds k entries. The least number of trials a
color that any pixel's plan needs is :func:`least_trials` (4 at mixed =
4: rounds at 0, 1 and 2 entries, the last adding 2). A trial is about 7
integer operations on each of the 4 lanes (r, g, b, luma): the mix's
multiply-add and shift, the difference, its square and weighted sum, and
the key's min, counted against the float32 rate as ``roofline.tk_bound``
counts Thomas Knoll's. Bytes: each pixel's 3 bytes in and its slot out,
and each tile's mirror and palette index (4 bytes); the palettes, at most
16 x 256 x 17 bytes, are left out. No count that the kernel reports is
used, so that any implementation is held to the same work.
"""
from __future__ import annotations

import re
from functools import lru_cache

from . import roofline
from .reference import gtm_decode, lzma

OPS_PER_TRIAL = 28.0  # 7 integer operations on each of 4 lanes
MIXED_KEY = re.compile(rb"DitheringUseThomasKnoll=0\s+DitheringYliluoma2MixedColors=(\d+)")


@lru_cache(maxsize=None)
def least_trials(mixed: int, count: int = 0) -> int:
    """The fewest (color, total) trials a color that a plan of ``mixed``
    entries needs from ``count`` entries on."""
    if count >= mixed:
        return 0
    tries = max(count, 1)
    return tries + min(least_trials(mixed, count + k) for k in range(1, tries + 1))


def bound_s(pixels: int, colors: int, mixed: int) -> tuple[float, str]:
    """(least seconds, "bytes" or "operations") of one encode's plan
    search over ``pixels`` pixels whose palettes hold ``colors`` valid
    colors in all (summed over the pixels)."""
    n_bytes = 4 * pixels + 5 * (pixels // 64)
    return roofline.bound_s(n_bytes, OPS_PER_TRIAL * least_trials(mixed) * colors,
                            roofline.FP32_OPS)


def stream_mixed(raw: bytes) -> int | None:
    """``DitheringYliluoma2MixedColors`` of a stream whose settings text
    (the extended command of its first payload) selects Yliluoma2, else
    None."""
    _, off = gtm_decode.parse_header(raw)
    m = MIXED_KEY.search(lzma.decode_stream(raw, off)[0])
    return int(m.group(1)) if m else None
