"""Disk-spill backing for beyond-host-RAM arrays.

The port's own copy of ``tiler_tpu/utils/spill.py``. A clip beyond
``EncoderSettings.host_ram_budget`` spills its two big host arrays (raw
frames and canonical tiles, each 192 B/tile) to UNLINKED temp-file
memmaps: the OS pages them in on the pipeline's bounded slice and gather
accesses and reclaims pages under pressure, so resident memory stays at
the working set while capacity is disk-bound. Every stage branches on
``isinstance(x, np.ndarray)`` and slices in bounded chunks, which a
memmap satisfies.
"""
from __future__ import annotations

import os
import tempfile

import numpy as np


def spill_memmap(shape, dtype=np.uint8) -> np.memmap:
    """Allocate a writable memmap over an anonymous (already-unlinked)
    temp file sized for `shape` — nothing to clean up; the mapping keeps
    the inode alive and the space frees when the array dies.

    TILER_TPU_SPILL_DIR overrides the directory (a fast local SSD beats
    the default tmpdir when /tmp is small or tmpfs-backed); the JAX
    package reads the same variable, so one setting serves both."""
    d = os.environ.get("TILER_TPU_SPILL_DIR") or None
    f = tempfile.TemporaryFile(dir=d)
    nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
    f.truncate(max(1, nbytes))
    mm = np.memmap(f, dtype=dtype, mode="r+", shape=tuple(shape))
    mm._spill_file = f  # pin the fd for the array's lifetime
    return mm
