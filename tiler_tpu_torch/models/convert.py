"""Carry an ``EncodeState`` across the two packages.

The state is this system's weights: a ``tiler_tpu`` checkpoint holds it
as numpy arrays (``tiler_tpu/pipeline/encoder.py:262-305``), the port
keeps its large arrays as torch tensors on its device, except a
host-resident clip's frames and canonical tiles (``pipeline/load.py``),
which stay numpy arrays or disk memmaps. The tilemap, the keyframe list
and the use counts stay numpy on both sides.
"""
from __future__ import annotations

import copy
import hashlib

import numpy as np
import torch

from .state import EncodeState

# state fields the port keeps on its device, with their dtypes
DEVICE_FIELDS = {
    "frames_rgb": torch.uint8,
    "tiles_canon": torch.uint8,
    "corpus_rgb": torch.uint8,
    "corpus_pal_initial": torch.int32,
    "palettes_rgb": torch.uint8,
    "palettes_valid": torch.bool,
    "corpus_pal_pixels": torch.uint8,
}


def _copy(state: EncodeState) -> EncodeState:
    out = copy.copy(state)
    out.tilemap = copy.deepcopy(state.tilemap)  # stages update it in place
    out.keyframes = copy.deepcopy(state.keyframes)
    out._hashes_prefetch = None
    out._pal_hashes_prefetch = None
    return out


# the fields that a host-resident clip keeps on the host
HOST_FIELDS = ("frames_rgb", "tiles_canon")


def state_from_numpy(state: EncodeState, device, host_resident: bool = False) -> EncodeState:
    """A copy of a numpy ``EncodeState`` with its large arrays as tensors
    on ``device``; with ``host_resident`` the frames and canonical tiles
    stay as they are (a memmap is not read). Transient caches are
    dropped."""
    out = _copy(state)
    for name, dtype in DEVICE_FIELDS.items():
        v = getattr(state, name)
        if v is not None and not (host_resident and name in HOST_FIELDS):
            setattr(out, name, torch.as_tensor(np.array(v), device=device).to(dtype))
    return out


def state_to_numpy(state: EncodeState) -> EncodeState:
    """A copy of an ``EncodeState`` with every device array (a torch
    tensor, or any array with ``__array__``) as a numpy array: what
    ``tiler_tpu`` checkpoints and ``pipeline/save.py`` read. A numpy array
    (a memmap, say) is kept as it is."""
    out = _copy(state)
    for name in DEVICE_FIELDS:
        v = getattr(state, name)
        if isinstance(v, torch.Tensor):
            setattr(out, name, v.cpu().numpy())
        elif v is not None and not isinstance(v, np.ndarray):
            setattr(out, name, np.asarray(v))
    return out


def state_digest(state: EncodeState) -> str:
    """sha256 of what a stream is written from: the tilemap, the palettes
    and the corpus. The ranks of a mesh encode must end with the same."""
    st = state_to_numpy(state)
    tm = st.tilemap
    h = hashlib.sha256()
    for a in (tm.tile_idx, tm.pal_idx, tm.predicted, tm.pred_x, tm.pred_y, tm.hmirror,
              tm.vmirror, tm.psnr, st.palettes_rgb, st.corpus_pal_pixels,
              st.corpus_pal_initial, st.corpus_use):
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def state_array_digests(state: EncodeState) -> dict:
    """sha256 (16 hex digits) of every array of ``state_to_numpy(state)``,
    the tilemap's and the keyframes' included, by field name: two encodes
    that should agree are compared field by field after each step."""
    st = state_to_numpy(state)
    out = {}

    def visit(name, v):
        if isinstance(v, np.ndarray):
            out[name] = hashlib.sha256(np.ascontiguousarray(v).tobytes()).hexdigest()[:16]
        elif hasattr(v, "__dataclass_fields__"):
            for f in v.__dataclass_fields__:
                visit(f"{name}.{f}", getattr(v, f))
        elif isinstance(v, (list, tuple)):
            for i, item in enumerate(v):
                visit(f"{name}[{i}]", item)
        elif isinstance(v, (int, float, str, bool)):
            out[name] = repr(v)

    for f in st.__dataclass_fields__:
        if not f.startswith("_"):
            visit(f, getattr(st, f))
    return out
