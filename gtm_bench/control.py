"""Readings that set the limits of ``limits/<workload>.json``.

    python3 gtm_bench/control.py --workload <name> --seeds 1,2,... \\
        [--control-seeds 3] [--controls a,b] [--fault-seeds 3] [--out FILE]

For every seed: one whole encode of the cell's clip, judged as a run is
(``judge.py``): the sound readings, whose largest over the seeds is each
number's lower reading. For the first ``--control-seeds`` seeds also each
control of ``faults.py`` (a lower precision put in the program's place:
Thomas Knoll in bfloat16 for the dither kernel's exact integers, the
top-k's keys from fp8 operands for its bfloat16, TF32 on, the EPU
re-rank's pair errors in bfloat16), and for the first ``--fault-seeds``
seeds each fault of ``faults.py``: one encode each, judged by the same
numbers. One JSON line a seed. The benchmark's own runs never run this.

A mesh cell (``chips`` above 1) reads as it runs: a mesh of that many
ranks over NCCL, one card a rank (``ranks.py``); the mesh's faults and
controls (``faults.MESH_FAULTS``, ``MESH_CONTROLS``) join the others,
planted in every rank, and rank 0 judges.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def one_encode(c: dict, seed: int, device: str, group=None) -> dict:
    """One encode of the cell's clip for ``seed``, judged: {"numbers",
    "failed", "quality"}; on a mesh (``group``) every rank encodes and
    rank 0 judges (the others return no numbers)."""
    from gtm_bench import clipgen, judge, run, window
    from tiler_tpu_torch.config import EncoderSettings

    cfg = c["config"]
    lead = group is None or group.rank == 0
    clip = clipgen.make_clip(c["traffic"], cfg["frames"], cfg["height"], cfg["width"], seed)
    capture = window.Capture(seed)
    uninstall = capture.install() if lead else (lambda: None)
    try:
        win = window.run(EncoderSettings(**cfg["settings"]), clip, cfg["fps"], 1e-3,
                         run.stream_path(), device, capture, lambda msg: print(msg, file=sys.stderr),
                         group)
    finally:
        uninstall()
    if not lead:
        return {"numbers": {}, "failed": 0, "quality": {}}
    if not win.encodes[0].ok:
        return {"numbers": {}, "failed": 1, "quality": {}}
    nums, quality, _ = judge.judge(win, clip, capture, device)
    return {"numbers": nums, "failed": nums["stream_errors"], "quality": quality}


def readings(c: dict, seeds, control_seeds: int, fault_seeds: int, device: str,
             controls=None, group=None):
    """Yields one record a seed. ``controls`` names the controls to read
    (by default all; on the CPU only those it can run,
    ``faults.CPU_CONTROLS``; on a mesh the mesh's too). ``group``: this
    rank of a mesh (``ranks.Group``)."""
    import torch

    from gtm_bench import faults

    mesh = group is not None
    names = controls or [*(faults.CONTROLS if device == "cuda" else faults.CPU_CONTROLS),
                         *(faults.MESH_CONTROLS if mesh else ())]
    controls = {k: faults.PLANTS[k] for k in names}
    plants = dict(faults.FAULTS, **(faults.MESH_FAULTS if mesh else {}))
    for i, seed in enumerate(seeds):
        sound = one_encode(c, seed, device, group)
        rec = {"seed": seed, "sound": sound["numbers"], "failed": sound["failed"],
               "quality": sound["quality"]}
        del sound
        for key, chosen, n in (("control", controls, control_seeds),
                               ("faults", plants, fault_seeds)):
            if i >= n:
                continue
            rec[key] = {}
            for name, plant in chosen.items():
                with plant():
                    got = one_encode(c, seed, device, group)
                rec[key][name] = {"numbers": got["numbers"], "failed": got["failed"],
                                  "quality": got["quality"]}
                del got
        if device == "cuda":
            torch.cuda.empty_cache()
        yield rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--controls", default="", help="comma-separated; all by default")
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from gtm_bench import ranks, run

    c = run.load_cell(args.workload)
    run.cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("control readings are taken on a CUDA device", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    controls = [n for n in args.controls.split(",") if n]
    if c["cell"]["chips"] > 1:
        chips = c["cell"]["chips"]
        if torch.cuda.device_count() < chips:
            print(f"this cell's readings take {chips} CUDA devices", file=sys.stderr)
            return 2
        job = {"kind": "readings", "cell": c, "seeds": seeds, "control_seeds": args.control_seeds,
               "fault_seeds": args.fault_seeds, "controls": controls, "device": "cuda",
               "plants": [], "out": args.out}
        for rec in ranks.launch(job, chips):
            print(json.dumps(rec), flush=True)
        return 0
    out = open(args.out, "a") if args.out else None
    try:
        for rec in readings(c, seeds, args.control_seeds, args.fault_seeds, "cuda", controls):
            line = json.dumps(rec)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
