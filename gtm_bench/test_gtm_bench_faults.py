"""A whole run, the look for a card skipped, on a clip small enough for the
CPU: sound, it is correct; with each fault of faults.py planted under the
timed path, and with each control that the CPU can run put in the
program's place, ``correct`` comes out false."""
import json

import pytest

from gtm_bench import faults, run

SMALL = dict(frames=4, height=64, width=128)


def small_cell():
    c = run.load_cell("default.retro.720p32")
    c["config"] = dict(c["config"], **SMALL, settings={"palette_count": 16})
    c["limits"] = dict(c["limits"], hvs_mse=5000.0)
    c["limits"].pop("knn_gap")  # the top-k kernel runs on the card only
    return c


def test_a_sound_run_is_correct_and_prints_the_contract_line():
    line, lines = run.run_cell(small_cell(), 2**31 + 3, 0.5, False, device="cpu")
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"encode_fps", "psnr_hvs_db", "stream_bytes", "setup_s"}
    assert lines[-1].startswith("check ")
    json.dumps(line)


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_a_planted_fault_is_not_correct(fault):
    with faults.FAULTS[fault]():
        line, _ = run.run_cell(small_cell(), 2**31 + 3, 0.5, False, device="cpu",
                               log=lambda msg: None)
    assert line["correct"] is False


@pytest.mark.parametrize("control", faults.CPU_CONTROLS)
def test_a_control_in_the_program_place_is_not_correct(control):
    with faults.CONTROLS[control]():
        line, _ = run.run_cell(small_cell(), 2**31 + 3, 0.5, False, device="cpu",
                               log=lambda msg: None)
    assert line["correct"] is False
