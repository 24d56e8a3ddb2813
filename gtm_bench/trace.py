"""The traced run's profiler and its reduction to device time.

The profiler records CUDA activity only (kernels, copies, sets): no CPU
operators, no shapes, no stacks, the cheapest setting that still times
every device operation. Its timestamps are wall-clock nanoseconds, so the
benchmark's host spans (perf_counter plus the window's offset to
``time.time_ns``) place each idle gap in the step the host was running.

Busy time is the union of the device intervals inside the window (the
arithmetic of ``scripts/torch_profile.py::_busy_us``, copied here).
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field


@dataclass
class Trace:
    window_s: float
    busy_s: float
    kernel_s: dict = field(default_factory=dict)  # name -> device seconds in the window
    kernel_n: dict = field(default_factory=dict)  # name -> launches
    idle_by_step: dict = field(default_factory=dict)  # step -> idle seconds

    def seconds_matching(self, *parts: str) -> tuple[float, int]:
        """(seconds, launches) of the operations whose name holds every
        part."""
        s = n = 0
        for name, t in self.kernel_s.items():
            if all(p in name for p in parts):
                s += t
                n += self.kernel_n[name]
        return s, n


def start():
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.__enter__()
    return prof


def _union(spans):
    """Merged intervals of [(start, end)], sorted."""
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(prof, window, steps) -> Trace:
    """Stop ``prof`` and reduce its device operations inside ``window``
    (window.Window) to a :class:`Trace`; ``steps`` names the span keys."""
    import torch

    prof.__exit__(None, None, None)
    off = window.wall_offset_ns
    w0 = off + int(window.start * 1e9)
    w1 = off + int(window.end * 1e9)
    spans, kernel_s, kernel_n = [], defaultdict(float), defaultdict(int)
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        s, e = max(ev.start_ns(), w0), min(ev.end_ns(), w1)
        if e <= s:
            continue
        spans.append((s, e))
        kernel_s[ev.name()] += (e - s) * 1e-9
        kernel_n[ev.name()] += 1
    busy = _union(spans)
    gaps, cur = [], w0
    for s, e in busy:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if cur < w1:
        gaps.append((cur, w1))
    host = sorted((off + int(a * 1e9), off + int(b * 1e9), step)
                  for enc in window.encodes for step, (a, b) in enc.spans.items() if step in steps)
    starts = [h[0] for h in host]
    idle = defaultdict(float)
    for gs, ge in gaps:
        covered = 0
        i = max(0, bisect.bisect_right(starts, gs) - 1)
        while i < len(host) and host[i][0] < ge:
            hs, he, step = host[i]
            o = min(ge, he) - max(gs, hs)
            if o > 0:
                idle[step] += o * 1e-9
                covered += o
            i += 1
        if ge - gs > covered:
            idle["between_steps"] += (ge - gs - covered) * 1e-9
    return Trace(window_s=(w1 - w0) * 1e-9, busy_s=sum(e - s for s, e in busy) * 1e-9,
                 kernel_s=dict(kernel_s), kernel_n=dict(kernel_n), idle_by_step=dict(idle))


def short_name(name: str, limit: int = 96) -> str:
    """A kernel's name without ``void`` and its parameter list, cut to
    ``limit`` characters."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(name):  # cut the parameter list after the template
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0:
            name = name[:i]
            break
    return name[:limit]


def breakdown(trace: Trace, top: int = 10) -> dict:
    ops = defaultdict(float)
    for name, s in trace.kernel_s.items():
        ops[short_name(name)] += s
    return {"device_ops": [[n, s] for n, s in sorted(ops.items(), key=lambda kv: -kv[1])[:top]],
            "idle_gaps": [[n, s] for n, s in sorted(trace.idle_by_step.items(),
                                                      key=lambda kv: -kv[1])[:top]]}
