"""Runs one benchmark cell of tiler_tpu_torch once on its NVIDIA cards.

    python3 gtm_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything the run needs is found by name: the cell in ``BENCHMARK.json``,
its configuration in ``configs/<config>.json``, its traffic in
``traffic/<traffic>.json`` (read by ``clipgen.py``), its limits in
``limits/<workload>.json`` and each metric's reader in
``metrics/<metric>.py``. Set-up makes the clip from the seed and runs one
whole encode (the first run in a checkout also builds the kernels into
``build/``); the window then runs whole encodes for ``--seconds``; after
it the reference judges the output (``judge.py``). The last line of
standard output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each compared number beside its limit, which also end
standard error. Without a card, or with fewer than the cell asks for, it
exits 2 and prints no result.

A cell whose ``chips`` is 1 runs in this process. One whose ``chips`` is
N > 1 (its configuration says ``"mesh": "auto"``) runs as a mesh of N
ranks, one process a card (``ranks.py``); set-up then counts from this
process's start, and rank 0 reports.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tiler_tpu")


def load_cell(workload: str) -> dict:
    """The cell's entry, configuration, traffic, limits and metric entries."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")

    def applies(m):
        return workload in m.get("workloads", [workload])

    return dict(
        cell=cell,
        config=json.loads((BENCH / "configs" / f"{cell['config']}.json").read_text()),
        traffic=json.loads((BENCH / "traffic" / f"{cell['traffic']}.json").read_text()),
        limits=json.loads((BENCH / "limits" / f"{workload}.json").read_text())["limits"],
        end_to_end=[m for m in spec["end_to_end"] if applies(m)],
        per_layer=[m for m in spec["per_layer"] if applies(m)])


def reader(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("gtm_bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cache_dirs():
    """Build and kernel caches at fixed paths inside the checkout."""
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")


def stream_path() -> str:
    tmp = os.environ.get("TMPDIR")
    folder = Path(tmp) if tmp else ROOT / "build" / "gtm_bench"
    folder.mkdir(parents=True, exist_ok=True)
    return str(folder / "gtm_bench_stream.gtm")


class Run:
    """What a metric reader may read."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    @property
    def encodes(self):
        return [e for e in self.window.encodes if e.ok]

    def span_mean(self, *steps) -> float | None:
        enc = self.encodes
        if not enc:
            return None
        return sum(e.spans[s][1] - e.spans[s][0] for e in enc for s in steps) / len(enc)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def mesh_mismatch(c: dict) -> str:
    """Why the cell's ``chips`` and its configuration's ``"mesh"`` key
    disagree, or "": a mesh exactly when ``chips`` is above 1."""
    chips, mesh = c["cell"]["chips"], c["config"].get("mesh")
    if (chips > 1) != (mesh is not None) or mesh not in (None, "auto"):
        return f"cell {c['cell']['name']!r} asks for {chips} chip(s), its configuration's mesh is {mesh!r}"
    return ""


def run_cell(c: dict, seed: int, seconds: float, trace_on: bool, device: str = "cuda",
             log=lambda msg: print(msg, file=sys.stderr), group=None,
             since: float | None = None):
    """One run of the cell ``c`` (:func:`load_cell`): (result line as a
    dict, lines for standard error). ``device="cpu"`` serves the tests.
    ``group`` (``ranks.Group``): this rank of a mesh run, which returns
    None on every rank but 0; ``since``: the wall time set-up counts from,
    where it is not this process's start."""
    import torch

    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from gtm_bench import clipgen, judge, roofline, trace, window
    from tiler_tpu_torch.config import EncoderSettings

    cfg = c["config"]
    mesh = group.mesh if group is not None else None
    lead = group is None or group.rank == 0
    settings = EncoderSettings(**cfg["settings"])
    clip = clipgen.make_clip(c["traffic"], cfg["frames"], cfg["height"], cfg["width"], seed)
    path = stream_path()
    capture = window.Capture(seed)
    uninstall = capture.install() if lead else (lambda: None)
    try:
        window.encode_once(settings, clip, cfg["fps"], path, device, mesh)  # warm-up
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        if group is not None:
            group.gather(None)  # every rank has warmed up
        setup_s = time.perf_counter() - T_START if since is None else time.time() - since
        prof = trace.start() if trace_on else None
        win = window.run(settings, clip, cfg["fps"], seconds, path, device, capture, log, group)
        tr = trace.reduce(prof, win, window.STEPS) if prof is not None else None
    finally:
        uninstall()
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    found = forbidden_modules()
    by_rank = []
    busy_s = tr.busy_s if tr is not None else None
    if group is not None:
        per_rank = group.gather((peak, found, len(win.encodes), tr.busy_s if tr else None))
        if found:
            raise SystemExit(f"rank {group.rank} loaded {found}, which the benchmark may not import")
        if not lead:
            return None
        by_rank = [n for _, _, n, _ in per_rank]
        if len(set(by_rank)) != 1:
            raise SystemExit(f"the ranks ran {by_rank} encodes: the window was not in lockstep")
        peak = max(r[0] for r in per_rank)  # the fullest card
        found = sorted({m for r in per_rank for m in r[1]})
        if tr is not None:  # the device's busy seconds: the mean over the ranks' cards
            busy_s = sum(r[3] for r in per_rank) / len(per_rank)
    if found:
        raise SystemExit(f"the run loaded {found}, which the benchmark may not import")

    if device == "cuda":
        torch.cuda.empty_cache()
    nums, quality, notes = judge.judge(win, clip, capture, device)
    ok, checks = judge.hold(nums, c["limits"])
    attempted = len(win.encodes)
    failed = sum(not e.ok for e in win.encodes) + nums["stream_errors"]
    correct = ok and failed == 0 and attempted > 0

    run = Run(window=win, trace=tr, capture=capture, setup_s=setup_s, peak_bytes=peak,
              frames=cfg["frames"], quality=quality)
    metrics = {}
    for m in (c["per_layer"] if trace_on else c["end_to_end"]):
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    kind = torch.cuda.get_device_name() if device == "cuda" else "cpu"
    dev = {"platform": "gpu" if device == "cuda" else device, "kind": kind,
           "count": group.size if group is not None else 1,
           "memory_peak_bytes": peak, "power_limit_w": roofline.power_limit_w()
           if device == "cuda" else None}
    if tr is not None:
        dev.update(busy_s=busy_s, window_s=tr.window_s)
    line = {"correct": correct, "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": dev}
    if tr is not None:
        line["breakdown"] = trace.breakdown(tr)
    line["checks"] = checks
    lines = [f"encode {i}: {e.spans['save'][1] - e.spans['load'][0]:.4f} s, " + ", ".join(
        f"{step} {b - a:.4f}" for step, (a, b) in e.spans.items()) for i, e in enumerate(run.encodes)]
    if by_rank:
        lines.append(f"encodes by rank: {by_rank}")
    lines += notes + [f"check {name}: {v['value']} (limit {v['limit']})" for name, v in checks.items()]
    return line, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    c = load_cell(args.workload)
    cache_dirs()
    import torch

    need = c["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"this cell needs {need} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    if mesh_mismatch(c):
        print(mesh_mismatch(c), file=sys.stderr)
        return 2
    if need == 1:
        line, lines = run_cell(c, args.seed, args.seconds, bool(args.trace))
    else:
        if str(ROOT) not in sys.path:
            sys.path.insert(0, str(ROOT))
        from gtm_bench import ranks

        started = time.time() - (time.perf_counter() - T_START)
        line, lines = ranks.run_mesh(c, args.seed, args.seconds, bool(args.trace),
                                     since=started)
        if forbidden_modules():  # the launcher prints the result: its own modules count too
            print(f"the launcher loaded {forbidden_modules()}, which the benchmark may not "
                  "import", file=sys.stderr)
            return 1
    sys.stdout.flush()
    print("\n".join(lines), file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
