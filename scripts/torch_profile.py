#!/usr/bin/env python3
"""Where the time goes in a tiler_tpu_torch encode on one CUDA card.

Run from the repository root:  python3 scripts/torch_profile.py

For each path (the reference defaults, and motion_field="im2row" with
knn_backend="pallas_v1"), encodes the 1280x720x32 synthetic clip once to
warm up, then once more under torch.profiler (CPU and CUDA activities),
and prints:
- the wall time of the profiled encode and its per-stage seconds;
- device time: the sum of all kernel and copy times, and the union of
  their intervals (busy time); idle share = 1 - busy / wall;
- the kernels with the most self device time (name, calls, ms).
The first line names the card and its power limit (nvidia-smi).
"""
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from tiler_tpu_torch.config import EncoderSettings  # noqa: E402
from tiler_tpu_torch.pipeline.encoder import Encoder  # noqa: E402
from tiler_tpu_torch.utils.clips import synthetic_clip  # noqa: E402

PATHS = {
    "default": EncoderSettings(),
    "im2row_v1": EncoderSettings(motion_field="im2row", knn_backend="pallas_v1"),
}


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _busy_us(prof):
    """(sum, union) of the device intervals of the trace, in us."""
    spans = []
    for evt in prof.events():
        if getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA:
            spans.append((evt.time_range.start, evt.time_range.end))
    spans.sort()
    total = sum(e - s for s, e in spans)
    union, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                union += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        union += cur_e - cur_s
    return total, union


def profile_path(name, settings, clip, top=12):
    from torch.profiler import ProfilerActivity, profile

    out = os.path.join(ROOT, "build", "torch_profile", f"{name}.gtm")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    Encoder(settings, device="cuda", log=None).run_all(clip, fps=25.0, out_path=out)
    enc = Encoder(settings, device="cuda", log=None)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        enc.run_all(clip, fps=25.0, out_path=out)
        wall = time.monotonic() - t0
    total, busy = _busy_us(prof)
    print(f"[{name}] profiled encode {wall:.3f} s; stages "
          + " ".join(f"{k}={v:.3f}" for k, v in enc.timings.items()), flush=True)
    print(f"[{name}] device time {total / 1e6:.3f} s summed, {busy / 1e6:.3f} s busy; "
          f"idle share {1 - busy / 1e6 / wall:.3f}", flush=True)
    rows = sorted(prof.key_averages(), key=_device_us, reverse=True)[:top]
    for r in rows:
        print(f"[{name}]   {_device_us(r) / 1e3:10.3f} ms  {r.count:7d} calls  {r.key[:90]}",
              flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_profile: no CUDA card is visible", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.splitlines()[0]
    print(f"card: {card}", flush=True)
    clip = synthetic_clip(32, 720, 1280)
    for name, settings in PATHS.items():
        profile_path(name, settings, clip)
    return 0


if __name__ == "__main__":
    sys.exit(main())
