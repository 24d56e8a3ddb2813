"""The mesh launcher on the CPU: a small mesh cell at world size 4 over
gloo, through the same multi-rank path the card's run takes (``ranks.py``),
prints one line with every rank in lockstep; a rank that raises ends the
run at once, with no result; every fault the cell can have, the
exchange's among them, and the mesh's control come out not correct."""
import json
import time

import pytest

from gtm_bench import faults, ranks, run

SMALL = dict(frames=4, height=64, width=128)
SEED = 2**31 + 3


def small_mesh_cell():
    c = run.load_cell("default.mesh4.720p32")
    c["config"] = dict(c["config"], **SMALL, settings={"palette_count": 16})
    c["limits"] = dict(c["limits"], hvs_mse=5000.0)
    return c


def test_a_mesh_run_over_gloo_prints_one_line_in_lockstep():
    line, lines = ranks.run_mesh(small_mesh_cell(), SEED, 1.0, False, device="cpu")
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert line["device"]["count"] == 4 and list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"encode_fps", "psnr_hvs_db", "stream_bytes", "setup_s"}
    assert set(line["checks"]) == {"stream_errors", "decode_vs_state_px", "hvs_mse",
                                   "tk_slots_off", "mesh_topk_gap", "kmeans_gap", "epu_gap"}
    by_rank = json.loads(next(s for s in lines if s.startswith("encodes by rank: "))
                         .removeprefix("encodes by rank: "))
    assert by_rank == [line["attempted"]] * 4
    assert lines[-1].startswith("check ")


def test_a_rank_that_raises_ends_the_run_with_no_result(capfd):
    t0 = time.monotonic()
    with pytest.raises(SystemExit) as exc:
        ranks.run_mesh(small_mesh_cell(), SEED, 1.0, False, device="cpu",
                       plants=["rank2_raises"])
    assert exc.value.code != 0 and time.monotonic() - t0 < ranks.GROUP_TIMEOUT_S
    out, err = capfd.readouterr()
    assert out == "" and "planted: rank 2 raises" in err and "failed; every rank is stopped" in err


# the check that judges each mesh stage on its own fails its plants
MESH_PLANTS = {"shard_left_out": ("mesh_topk_gap",), "kmeans_sums_left_out": ("kmeans_gap",),
               "sq_dists_bfloat16": ("mesh_topk_gap", "kmeans_gap")}


def test_every_mesh_plant_is_tested():
    assert set(MESH_PLANTS) == {*faults.MESH_FAULTS, *faults.MESH_CONTROLS}


@pytest.mark.parametrize("plant", sorted(faults.FAULTS) + sorted(MESH_PLANTS))
def test_a_planted_fault_or_control_on_the_mesh_is_not_correct(plant):
    line, _ = ranks.run_mesh(small_mesh_cell(), SEED, 0.5, False, device="cpu", plants=[plant])
    assert line["correct"] is False
    for name in MESH_PLANTS.get(plant, ()):
        assert line["checks"][name]["value"] > line["checks"][name]["limit"]


def test_control_readings_on_a_small_mesh():
    job = {"kind": "readings", "cell": small_mesh_cell(), "seeds": [SEED], "control_seeds": 1,
           "fault_seeds": 0, "controls": ["sq_dists_bfloat16"], "device": "cpu", "plants": []}
    (rec,) = ranks.launch(job, 4)
    low = rec["control"]["sq_dists_bfloat16"]["numbers"]["mesh_topk_gap"]
    assert rec["failed"] == 0 and rec["sound"]["mesh_topk_gap"] < 1e-5 < low
