"""BENCHMARK.json and the files the harness finds by name."""
import json
import re
from pathlib import Path

import pytest

from gtm_bench import run

ROOT = Path(__file__).resolve().parents[1]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level_keys_and_command():
    assert set(SPEC) == KEYS
    assert SPEC["command"] == ["python3", "gtm_bench/run.py"]
    assert SPEC["paths"] == ["gtm_bench"]
    assert 1 <= SPEC["run_seconds"] <= 51


def test_names_units_and_lines():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in SPEC[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group, entry["name"]))
            for key in ("config", "traffic"):
                if key in entry:
                    assert NAME.match(entry[key])
            for key in ("why", "layer", "source"):
                if key in entry:
                    assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] and "\t" not in entry[key]
            if "unit" in entry:
                assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
    assert len(set(names)) == len(names)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_finds_its_files(cell):
    c = run.load_cell(cell)
    assert c["cell"]["chips"] in (1, 4)
    assert ("mesh" in c["config"]) == (c["cell"]["chips"] > 1) and not run.mesh_mismatch(c)
    cfg = c["config"]
    assert cfg["name"] == c["cell"]["config"] and set(cfg["reduced"]) == set(
        next(x for x in SPEC["configs"] if x["name"] == cfg["name"])["reduced"])
    e2e = {m["name"] for m in c["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2 and c["per_layer"]
    for m in c["end_to_end"] + c["per_layer"]:
        assert callable(run.reader(m["name"]))
    assert c["limits"] and all(v >= 0 for v in c["limits"].values())


def test_at_most_a_quarter_of_the_cells_take_four_cards():
    cells = SPEC["workloads"]
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)


def test_the_launcher_refuses_a_mesh_that_disagrees_with_chips():
    c = run.load_cell("default.mesh4.720p32")
    assert not run.mesh_mismatch(c)
    assert run.mesh_mismatch(dict(c, cell=dict(c["cell"], chips=1)))
    one = run.load_cell("default.retro.720p32")
    assert run.mesh_mismatch(dict(one, config=dict(one["config"], mesh="auto")))
    assert run.mesh_mismatch(dict(c, config=dict(c["config"], mesh="data")))


def test_every_config_is_used_and_lies_under_paths():
    used = {w["config"] for w in SPEC["workloads"]}
    for cfg in SPEC["configs"]:
        assert cfg["name"] in used
        assert cfg["file"] == f"gtm_bench/configs/{cfg['name']}.json"
        assert (ROOT / cfg["file"]).exists()


def test_per_layer_metrics_move_a_reported_metric():
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].endswith("_roofline")
