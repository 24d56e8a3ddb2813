"""Loads ``lzma_dec.c`` (built once per checkout with the host's C compiler
into ``build/gtm_bench/``, named by a hash of the source) and splits a
.gtm's concatenated LZMA streams into their payloads."""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_SRC = Path(__file__).resolve().parent / "lzma_dec.c"
BUILD_DIR = _SRC.parents[2] / "build" / "gtm_bench"
_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"liblzma_dec_{digest}.so"


def _compile(so: Path):
    cc = shutil.which("gcc") or shutil.which("cc")
    cmd = ([cc] if cc else [shutil.which("g++") or "g++", "-x", "c"])
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run([*cmd, "-O2", "-shared", "-fPIC", "-o", str(tmp), str(_SRC)],
                   check=True, capture_output=True)
    os.replace(tmp, so)


def lib():
    global _lib
    with _lock:
        if _lib is None:
            so = library_path()
            if not so.exists():
                _compile(so)
            handle = ctypes.CDLL(str(so))
            handle.lzma_alone_decode.restype = ctypes.c_longlong
            handle.lzma_alone_decode.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_size_t)]
            _lib = handle
        return _lib


def decode_stream(buf: bytes, offset: int = 0, max_out: int = 1 << 31) -> tuple[bytes, int]:
    """(payload, bytes consumed) of the stream at ``offset``; ValueError on
    a corrupt stream."""
    src = bytes(buf[offset:])
    cap = max(8 * len(src), 1 << 16)
    while True:
        out = ctypes.create_string_buffer(cap)
        used = ctypes.c_size_t(0)
        n = lib().lzma_alone_decode(src, len(src), out, cap, ctypes.byref(used))
        if n == -1:
            raise ValueError("corrupt LZMA stream")
        if n >= 0:
            return out.raw[:n], used.value
        if cap > max_out:
            raise ValueError("LZMA payload larger than max_out")
        cap *= 4


def split_streams(buf: bytes) -> list[bytes]:
    out, off = [], 0
    while off < len(buf):
        payload, used = decode_stream(buf, off)
        if used == 0:
            raise ValueError("LZMA stream consumed no input")
        out.append(payload)
        off += used
    return out
