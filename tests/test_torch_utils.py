"""The port's last four modules against tiler_tpu's originals.

- utils/progress.py: StepTimer as the JAX package's; trace_step writes a
  Chrome trace per step under TILER_TPU_PROFILE (six for an encode, each
  holding its step's record_function span) and nothing without it;
- utils/search.py: the same answers as the JAX package's on its own test
  cases (tests/test_utils_render.py, tests/test_io.py);
- cluster/kmodes.py: the numpy original's modes, labels and iteration
  count, with empty clusters re-seeded and tied counts;
- search.py, conformance/jsvm.py and conformance/player.py are copies of
  the originals, byte for byte apart from import lines; the interpreter's
  semantics check runs on the port's copy, and the player against the
  reference JS decoder where its files are present.
"""
import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from bench import synthetic_clip
from tiler_tpu.utils import search as j_search
from tiler_tpu.utils.progress import StepTimer as JaxStepTimer
from tiler_tpu_torch.config import EncoderSettings
from tiler_tpu_torch.conformance.player import REFERENCE_HTMLJS
from tiler_tpu_torch.pipeline.encoder import Encoder
from tiler_tpu_torch.utils import progress, search
from tiler_tpu_torch.utils import StepTimer, golden_ratio_search, powell_minimize, trace_step

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(palette_count=8, motion_predict_radius=4, epu_knn_k=8, kmeans_iters=4)
STEPS = ("predict_motion", "reduce", "prepare_palettes", "dither", "reconstruct", "reindex")
j_kmodes = importlib.import_module("tiler_tpu.cluster.kmodes")
t_kmodes = importlib.import_module("tiler_tpu_torch.cluster.kmodes")


def test_step_timer_as_the_reference():
    logs = {"port": [], "jax": []}
    progress_calls = {"port": [], "jax": []}
    timers = {"port": StepTimer(log=logs["port"].append,
                                on_progress=lambda n, f: progress_calls["port"].append((n, f))),
              "jax": JaxStepTimer(log=logs["jax"].append,
                                  on_progress=lambda n, f: progress_calls["jax"].append((n, f)))}
    for t in timers.values():
        for name in ("a", "b", "a"):
            with t.step(name):
                pass
    assert list(timers["port"].timings) == list(timers["jax"].timings) == ["a", "b"]
    assert progress_calls["port"] == progress_calls["jax"]
    assert len(logs["port"]) == len(logs["jax"]) == 3
    assert ([ln.split()[0] for ln in timers["port"].report().splitlines()]
            == [ln.split()[0] for ln in timers["jax"].report().splitlines()])


def test_trace_step_writes_one_trace_per_step(tmp_path, monkeypatch):
    """Under TILER_TPU_PROFILE an encode writes <step>.json for the six
    steps, each a Chrome trace holding its step's span; the timings stay
    the six steps' and the load's and save's."""
    prof = tmp_path / "prof"
    monkeypatch.setenv("TILER_TPU_PROFILE", str(prof))
    enc = Encoder(EncoderSettings(**SMALL), log=None, device="cpu")
    enc.run_all(synthetic_clip(4, 64, 96, seed=0), fps=25.0, out_path=str(tmp_path / "o.gtm"))
    assert sorted(os.listdir(prof)) == sorted(f"{s}.json" for s in STEPS)
    for step in STEPS:
        events = json.loads((prof / f"{step}.json").read_text())["traceEvents"]
        assert any(e.get("name") == step for e in events), step
    assert set(STEPS) <= set(enc.timings)


def test_trace_step_without_the_variable_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.delenv("TILER_TPU_PROFILE", raising=False)
    monkeypatch.chdir(tmp_path)
    with trace_step("reduce", "cpu"):
        torch.ones(4).sum()
    assert os.listdir(tmp_path) == []
    assert progress.trace_path(str(tmp_path), "dither") == str(tmp_path / "dither.json")


def test_golden_ratio_search_as_the_reference():
    f = lambda x: x * x  # noqa: E731  (monotone on [0, inf))
    x = golden_ratio_search(f, 0.0, 100.0, objective=49.0, eps_y=0.1)
    assert abs(x - 7.0) < 0.1
    assert x == j_search.golden_ratio_search(f, 0.0, 100.0, objective=49.0, eps_y=0.1)


@pytest.mark.parametrize("case", ["quadratic", "rosenbrock"])
def test_powell_as_the_reference(case):
    if case == "quadratic":
        target = np.array([1.5, -2.0, 0.5])
        f = lambda x: float(np.sum((x - target) ** 2)) + 3.0  # noqa: E731
        args, kw = ([0.0, 0.0, 0.0],), {}
    else:
        f = lambda x: float((1 - x[0]) ** 2 + 100 * (x[1] - x[0] ** 2) ** 2)  # noqa: E731
        args, kw = ([-1.0, 1.0],), {"maxiter": 400}
    x, fx = powell_minimize(f, *args, **kw)
    jx, jfx = j_search.powell_minimize(f, *args, **kw)
    assert np.array_equal(x, jx) and fx == jfx
    if case == "quadratic":
        assert np.allclose(x, target, atol=1e-3) and abs(fx - 3.0) < 1e-6
    else:
        assert fx < 1e-4


def test_least_squares_as_the_reference():
    a = np.array([[1.0, 0], [0, 2.0], [1, 1]])
    b = a @ np.array([3.0, -1.0])
    assert np.allclose(search.least_squares(a, b), [3.0, -1.0])
    assert np.array_equal(search.least_squares(a, b), j_search.least_squares(a, b))


def _clustered(seed, n, d, values, k, noise=0.3):
    """n rows of d attributes around k // 2 centers, a share ``noise`` of
    the attributes redrawn."""
    rng = np.random.default_rng(seed)
    centers = rng.integers(0, values, (max(1, k // 2), d))
    x = centers[rng.integers(0, len(centers), n)]
    return np.where(rng.random((n, d)) < noise, rng.integers(0, values, (n, d)), x).astype(np.uint8)


KMODES_CASES = {
    # several iterations before the labels settle
    "clustered": (_clustered(1, 3000, 12, 4, 10), 10),
    "binary": (_clustered(3, 4000, 24, 2, 16), 16),
    # 5 distinct rows for 8 and 20 modes: the farthest-first init repeats
    # rows, so clusters come out empty and are re-seeded
    "empty_reseed": (np.repeat(np.random.default_rng(2).integers(0, 3, (5, 8)), 40,
                               axis=0).astype(np.uint8), 8),
    "empty_reseed_20": (np.repeat(np.random.default_rng(2).integers(0, 3, (5, 8)), 40,
                                  axis=0).astype(np.uint8), 20),
    # two values an attribute in equal numbers: majority ties take the
    # smaller value
    "tied_counts": (np.tile(np.array([[0, 1, 2, 3], [3, 2, 1, 0]], np.uint8), (50, 1)), 1),
    "uniform16": (np.random.default_rng(0).integers(0, 16, (2000, 16)).astype(np.uint8), 20),
}


@pytest.mark.parametrize("name", sorted(KMODES_CASES))
def test_kmodes_equals_the_numpy_original(name):
    x, k = KMODES_CASES[name]
    modes, labels, it = t_kmodes.kmodes(torch.from_numpy(x), k, max_iter=50)
    jmodes, jlabels, jit = j_kmodes.kmodes(x.copy(), k, max_iter=50)
    assert it == jit
    assert np.array_equal(modes.numpy(), jmodes)
    assert np.array_equal(labels.numpy(), jlabels)
    if name == "tied_counts":
        assert modes.numpy().tolist() == [[0, 1, 1, 0]]


def test_kmodes_stops_at_max_iter_as_the_original():
    x, k = KMODES_CASES["binary"]
    modes, labels, it = t_kmodes.kmodes(torch.from_numpy(x), k, max_iter=2)
    jmodes, jlabels, jit = j_kmodes.kmodes(x.copy(), k, max_iter=2)
    assert it == jit == 2
    assert np.array_equal(modes.numpy(), jmodes) and np.array_equal(labels.numpy(), jlabels)


def _code_lines(path: Path):
    return [ln for ln in path.read_text().splitlines()
            if not ln.startswith(("import ", "from "))]


@pytest.mark.parametrize("rel", ["utils/search.py", "conformance/jsvm.py",
                                 "conformance/player.py", "conformance/__init__.py"])
def test_copies_equal_the_originals(rel):
    assert _code_lines(ROOT / "tiler_tpu_torch" / rel) == _code_lines(ROOT / "tiler_tpu" / rel)


@pytest.mark.parametrize("module", ["tiler_tpu_torch.utils", "tiler_tpu_torch.utils.progress",
                                    "tiler_tpu_torch.utils.search",
                                    "tiler_tpu_torch.cluster.kmodes",
                                    "tiler_tpu_torch.conformance"])
def test_new_module_imports_no_jax(module):
    code = ("import importlib, sys; importlib.import_module(sys.argv[1]); "
            "print(sorted(n for n in sys.modules "
            "if n.split('.')[0] in ('jax', 'jaxlib', 'tiler_tpu', 'bench', 'triton')))")
    out = subprocess.run([sys.executable, "-c", code, module], capture_output=True, text=True,
                         check=True, cwd=ROOT, timeout=120).stdout
    assert out.strip() == "[]", out


def test_jsvm_semantics():
    """The JAX package's micro-check of the interpreter's JS semantics
    (int32 wrap, switch fallthrough, prototypes, typed-array clamping,
    try/catch, % sign), on the port's copy."""
    from tiler_tpu_torch.conformance.jsvm import Interpreter

    interp = Interpreter()
    interp.eval_script(
        """
var x = 0;
for (var i = 0; i < 10; i++) { x += i; }
function fib(n){ return n < 2 ? n : fib(n-1)+fib(n-2); }
var F = function Named(a){ this.v = a; };
F.prototype.get = function(){ return this.v * 2; };
var o = new F(21);
var arr = [1,2,3]; arr.push(4);
var t = new Uint8Array(4); t[0] = 300;
var s = '';
switch (3) { case 1: s += 'a'; case 3: s += 'b'; case 4: s += 'c'; break; default: s += 'z'; }
var tr; try { throw Error('boom'); } catch (e) { tr = e.message; }
console.log(x, fib(10), o.get(), arr.length, t[0], s, -7 % 3,
            (0x80000000 | 0), 0xffffffff >>> 0, ~~(25 / 9), tr);
"""
    )
    assert interp.console[0][1] == "45 55 42 4 44 bc -1 -2147483648 4294967295 2 boom"


@pytest.mark.skipif(not os.path.isdir(REFERENCE_HTMLJS), reason="reference decoder not present")
def test_reference_player_plays_the_port_stream(tmp_path):
    """The port's stream through the port's copy of the player harness and
    the unchanged reference JS decoder: pixel-exact against the port's
    GTMDecoder."""
    from tiler_tpu_torch.bitstream.gtm import GTMDecoder
    from tiler_tpu_torch.conformance import decode_with_reference_player

    out = tmp_path / "o.gtm"
    enc = Encoder(EncoderSettings(**SMALL), log=None, device="cpu")
    enc.run_all(synthetic_clip(4, 64, 80, seed=7), fps=25.0, out_path=str(out))
    rgb, _, _ = decode_with_reference_player(str(out), 4)
    ours = np.stack(GTMDecoder(str(out)).decode_frames())[..., :3]
    assert np.array_equal(rgb, ours)
