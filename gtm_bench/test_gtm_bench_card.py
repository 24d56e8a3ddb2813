"""The command line: without a card it exits 2 and prints no result; on a
card (``-m cuda``) a short run of the wide cell is correct, and a short run
of the retro cell with a card-only control in the program's place is not."""
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
COMMAND = [sys.executable, str(ROOT / "gtm_bench" / "run.py"), "--workload",
           "wide256.retro.720p8", "--seed", str(2**31 + 77), "--seconds", "3", "--trace", "0"]


def test_without_a_card_it_exits_2_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    out = subprocess.run(COMMAND, capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 2 and out.stdout == ""


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = subprocess.run(COMMAND, capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert out.stderr.strip().splitlines()[-1].startswith("check ")


@pytest.mark.cuda
@pytest.mark.parametrize("control", ["knn_fp8", "epu_tf32"])
def test_a_card_only_control_is_not_correct(control):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from gtm_bench import faults, run

    run.cache_dirs()
    with faults.CONTROLS[control]():
        line, _ = run.run_cell(run.load_cell("default.retro.720p32"), 2**31 + 78, 1.0, False,
                               log=lambda msg: None)
    assert line["correct"] is False
