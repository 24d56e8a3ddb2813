"""Step telemetry: timers, progress callbacks, and torch.profiler traces.

Counterpart of ``tiler_tpu/utils/progress.py``. :class:`StepTimer` is
its copy. :func:`trace_step` runs a step under ``torch.profiler`` when
``TILER_TPU_PROFILE=dir`` is set and writes a Chrome trace of it to
``dir/<step>.json`` (``dir/<step>.rank<r>.json`` on each rank of a
process group of more than one); open it in ``chrome://tracing`` or
Perfetto. Without the variable it costs one environment lookup."""
from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, Optional

import torch


class StepTimer:
    """Accumulates named step timings; optionally reports progress."""

    def __init__(self, log: Optional[Callable[[str], None]] = None,
                 on_progress: Optional[Callable[[str, float], None]] = None):
        self.timings: Dict[str, float] = {}
        self.log = log
        self.on_progress = on_progress
        self._t0 = time.monotonic()

    @contextlib.contextmanager
    def step(self, name: str):
        t = time.monotonic()
        if self.on_progress:
            self.on_progress(name, 0.0)
        try:
            yield
        finally:
            dt = time.monotonic() - t
            self.timings[name] = self.timings.get(name, 0.0) + dt
            if self.log:
                self.log(f"[{name}] {dt:.3f}s (cumulative {time.monotonic()-self._t0:.1f}s)")
            if self.on_progress:
                self.on_progress(name, 1.0)

    def report(self) -> str:
        total = sum(self.timings.values())
        lines = [f"{k:20s} {v:8.3f}s {100*v/max(total,1e-9):5.1f}%" for k, v in self.timings.items()]
        lines.append(f"{'total':20s} {total:8.3f}s")
        return "\n".join(lines)


def trace_path(prof_dir: str, name: str) -> str:
    """Where :func:`trace_step` writes the trace of step ``name``."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        name = f"{name}.rank{dist.get_rank()}"
    return os.path.join(prof_dir, f"{name}.json")


@contextlib.contextmanager
def trace_step(name: str, device=None):
    """Run a step under ``torch.profiler`` when TILER_TPU_PROFILE is set:
    CPU activity, and CUDA activity when ``device`` is a CUDA device,
    inside ``record_function(name)``; the device is synchronized before
    the profile closes, so the step's kernels fall inside it."""
    prof_dir = os.environ.get("TILER_TPU_PROFILE")
    if not prof_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = device is not None and torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(prof_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        with record_function(name):
            yield
        if cuda:
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(trace_path(prof_dir, name))
