"""Build and load the hand-written CUDA kernels of ``tiler_tpu_torch/csrc``.

The sources are compiled on first use with ``nvcc`` into one shared
library with a plain C interface, loaded with ctypes. The library lands
in ``build/torch_kernels/`` of the checkout, named by a hash of every
file the build reads (the ``*.cu`` it compiles and the ``*.cuh``/``*.h``
they include) and of the flags, so an edited source or header rebuilds
and an unchanged tree is reused. Each source compiles in an ``nvcc`` of
its own, all started together; a last ``nvcc`` links the objects. Nothing
here runs at import: the CPU tests import every module on machines with
neither ``nvcc`` nor a card.

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
              "-Xcompiler", "-fPIC", "-lineinfo")

_lock = threading.Lock()
_lib = None
# what ptxas said (-Xptxas -v) in this process's last verbose build: each
# kernel's registers, shared memory, stack and spills
ptxas_log = ""

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures: (name, argtypes); every entry returns the cudaError_t int
_SIGNATURES = (
    ("tk_select_launch", (_P, _P, _P, _P, _P, _I, _I, _I, _P)),
    ("tk_trunc_probe_launch", (_P, _I, _I, _I, _P)),
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
    """Compile every csrc/*.cu into the shared library (if not built).
    With ``verbose``, ptxas reports each kernel's resources: printed, and
    kept in :data:`ptxas_log`."""
    global ptxas_log
    so = library_path()
    if so.exists():
        return so
    _OUT.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    stem = f"{so.stem}.{os.getpid()}"
    objects = [_OUT / f"{stem}.{src.stem}.o" for src in _sources()]
    procs = [subprocess.Popen(
        [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
         "-c", "-o", str(obj), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for src, obj in zip(_sources(), objects)]
    logs = [proc.communicate()[1] for proc in procs]
    tmp = _OUT / f"{stem}.tmp"
    try:
        for src, proc, log in zip(_sources(), procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name} ({proc.returncode}):\n{log}")
        res = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objects)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed to link ({res.returncode}):\n{res.stderr}")
    finally:
        for obj in objects:
            obj.unlink(missing_ok=True)
    if verbose:
        ptxas_log = "".join(logs)
        print(ptxas_log)
    os.replace(tmp, so)
    return so


def kernel_resources(name: str, log: str | None = None) -> list[dict]:
    """Registers, stack and spill bytes of each entry function whose
    mangled name holds ``name``, read from ptxas's report."""
    import re

    out = []
    entry = re.compile(
        r"Compiling entry function '(\S*" + re.escape(name) + r"\S*)'.*?"
        r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads.*?"
        r"Used (\d+) registers", re.S)
    for m in entry.finditer(ptxas_log if log is None else log):
        out.append({"function": m.group(1), "stack_bytes": int(m.group(2)),
                    "spill_store_bytes": int(m.group(3)),
                    "spill_load_bytes": int(m.group(4)), "registers": int(m.group(5))})
    return out


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
