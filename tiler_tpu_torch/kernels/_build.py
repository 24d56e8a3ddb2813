"""Build and load the hand-written CUDA kernels of ``tiler_tpu_torch/csrc``.

The sources are compiled on first use with ``nvcc`` into one shared
library with a plain C interface, loaded with ctypes. The library lands
in ``build/torch_kernels/`` of the checkout, named by a hash of every
file the build reads (the ``*.cu`` it compiles and the ``*.cuh``/``*.h``
they include) and of the flags, so an edited source or header rebuilds
and an unchanged tree is reused. Nothing here runs at import: the CPU tests import every module on
machines with neither ``nvcc`` nor a card.

Each C entry point launches on the stream it is given, allocates
nothing, and returns ``cudaGetLastError()`` after the launch;
:func:`check` turns a nonzero code into an exception.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_OUT = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

_lock = threading.Lock()
_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures: (name, argtypes); every entry returns the cudaError_t int
_SIGNATURES = (
    ("tk_select_launch", (_P, _P, _P, _P, _P, _I, _I, _I, _P)),
    ("knn_bucket_top2_launch", (_P, _P, _P, _P, _I, _I, _P)),
    ("knn_bucket_top2_v1_launch", (_P, _P, _P, _P, _P, _I, _I, _P)),
    ("blockify_launch", (_P, _P, _I, _I, _I, _P)),
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _sources():
    """The translation units nvcc compiles."""
    return sorted(_CSRC.glob("*.cu"))


def _inputs():
    """Every file the build reads: the sources and the headers they include."""
    return sorted(p for pat in ("*.cu", "*.cuh", "*.h") for p in _CSRC.glob(pat))


def library_path() -> Path:
    h = hashlib.sha256()
    for src in _inputs():
        data = src.read_bytes()
        h.update(f"{src.name}:{len(data)}:".encode())
        h.update(data)
    h.update(" ".join(NVCC_FLAGS).encode())
    return _OUT / f"libtiler_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile every csrc/*.cu into the shared library (if not built)."""
    so = library_path()
    if so.exists():
        return so
    _OUT.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), *map(str, _sources())]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    if verbose and res.stderr:
        print(res.stderr)
    os.replace(tmp, so)
    return so


def lib():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES:
                fn = getattr(handle, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = handle
        return _lib


def check(code: int, what: str):
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
