"""ctypes loader for the native C++ helpers (builds on first use).

The reference ships native DLLs for its hot host-side loops (ANN, yakmo,
BICO, LZMA — SURVEY.md section 2.2). The TPU-native rebuild puts the math
libraries on-device; what remains host-side and native here is the LZMA
codec (lc=8 parity with the reference bitstreams, extern.pas:420-458).

The port's own copy of ``tiler_tpu/native.py``: it builds ``lzma.cpp``
beside this file (a copy of ``native/lzma.cpp`` whose two-thread optimal
parse waits on condition variables instead of spinning) with ``g++`` at
first use into ``build/libgtmlzma_torch.so`` of the checkout.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(os.path.dirname(_HERE))
_SRC = os.path.join(_HERE, "lzma.cpp")
_SO = os.path.join(_ROOT, "build", "libgtmlzma_torch.so")
_lock = threading.Lock()
_lib = None
_failed = False


def _build() -> bool:
    """Compile into a file of this process and rename it into place, so
    processes that build at once never load a half-written library."""
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    for flags in (["-march=native", "-funroll-loops"],
                  []):  # portable fallback (e.g. cross-built images)
        try:
            subprocess.run(
                ["g++", "-O3", *flags, "-shared", "-fPIC", "-std=c++17",
                 "-pthread", "-o", tmp, _SRC],
                check=True,
                capture_output=True,
            )
        except Exception:
            continue
        os.replace(tmp, _SO)
        return True
    return False


def get_lib():
    """Returns the loaded library or None (callers must degrade gracefully)."""
    global _lib, _failed
    with _lock:
        if _lib is not None or _failed:
            return _lib
        if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
            if not _build():
                _failed = True
                return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            _failed = True
            return None
        lib.gtm_lzma_compress.restype = ctypes.c_size_t
        lib.gtm_lzma_compress.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint32,
            ctypes.c_int, ctypes.c_int,
        ]
        lib.gtm_lzma_decompress.restype = ctypes.c_size_t
        lib.gtm_lzma_decompress.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_size_t),
        ]
        _lib = lib
        return _lib


def lzma_compress(data: bytes, lc: int = 8, lp: int = 0, pb: int = 2,
                  dict_size: int = 1 << 25, depth: int = -2,
                  threads: int = 0) -> bytes:
    """depth > 0: greedy/lazy; depth < 0: optimal parse, chain |depth|.

    Default -2: on GTM payloads, chain depth 2 under the optimal parse
    measures SMALLER than depth 8 (44.81% vs 44.87%) and ~2x faster —
    the DP dominates, extra chain candidates add almost nothing.

    threads: 0 = auto (optimal parse runs its match finder on a second
    core when one exists); bytes are identical at every thread count."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native lzma unavailable")
    cap = len(data) + len(data) // 2 + 4096
    out = ctypes.create_string_buffer(cap)
    n = lib.gtm_lzma_compress(data, len(data), out, cap, lc, lp, pb, dict_size,
                              depth, threads)
    if n == 0:
        raise RuntimeError("native lzma compress failed")
    return out.raw[:n]


def lzma_decompress_stream(buf: bytes, offset: int = 0,
                           max_out: int = 1 << 31) -> tuple:
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native lzma unavailable")
    src = bytes(buf[offset:])
    corrupt = ctypes.c_size_t(-1).value
    need_space = ctypes.c_size_t(-2).value
    # grow output until it fits; ONLY on the retryable "out_cap too
    # small" code. A corrupt stream fails immediately — growing on it
    # turned bit-flipped inputs into multi-GB allocation storms. No
    # relative expansion heuristic: valid LZMA ratios are unbounded
    # (measured 7000x+ on constant payloads), so the only ceiling is
    # the caller's absolute max_out.
    cap = max(4 * len(src), 1 << 16)
    while True:
        out = ctypes.create_string_buffer(cap)
        used = ctypes.c_size_t(0)
        n = lib.gtm_lzma_decompress(src, len(src), out, cap, ctypes.byref(used))
        if n == corrupt:
            raise ValueError("corrupt LZMA stream")
        if n != need_space:
            return out.raw[:n], used.value
        if cap > max_out:
            raise ValueError("LZMA stream larger than max_out")
        cap *= 4


def available() -> bool:
    return get_lib() is not None
