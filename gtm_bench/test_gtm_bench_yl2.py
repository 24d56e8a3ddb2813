"""The Yliluoma2 cell and the wide grain cell: their files are found and
follow the rules of test_gtm_bench_files.py; the plan search's bound
arithmetic; the readers of yl2_select_roofline and yl2_candidates."""
import json
from pathlib import Path

import pytest

from gtm_bench import judge, run, trace, window, yl2_roofline
from tiler_tpu_torch.config import EncoderSettings
from tiler_tpu_torch.utils.clips import synthetic_clip

ROOT = Path(__file__).resolve().parents[1]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = {"wide256yl2.retro.720p8": "gtm_wide256_yl2", "wide256.grain.720p8": "gtm_wide256"}


@pytest.mark.parametrize("cell,config", CELLS.items())
def test_the_new_cells_find_their_files(cell, config):
    c = run.load_cell(cell)
    assert c["cell"]["chips"] == 1 and c["config"]["name"] == config
    assert not run.mesh_mismatch(c)
    assert {"stream_errors", "decode_vs_state_px", "hvs_mse", "epu_gap"} <= set(c["limits"])
    assert c["limits"]["stream_errors"] == 0 and c["limits"]["decode_vs_state_px"] == 0
    assert set(c["limits"]) <= set(judge.ORDER)
    names = {m["name"] for m in c["end_to_end"] + c["per_layer"]}
    assert {"setup_s", "encode_fps"} <= names
    if config == "gtm_wide256_yl2":
        assert {"yl2_select_roofline", "yl2_candidates"} <= names
        assert "tk_slots_off" not in c["limits"]  # Thomas Knoll does not run there
    else:
        assert "tk_select_wide_roofline" in names and c["limits"]["tk_slots_off"] == 0


def test_the_yl2_cell_waits_for_an_exact_slot_check():
    """No check of ``correct`` reads Yliluoma2's slots yet (a lower
    precision in the kernel's place passes every limit there is): the
    cell's limits hold the stream, the decoded quality and the EPU until
    judge.py gains a slot check, which its limits file then names."""
    c = run.load_cell("wide256yl2.retro.720p8")
    if "yl_slots_off" in judge.ORDER:
        assert c["limits"]["yl_slots_off"] == 0
    else:
        assert set(c["limits"]) == {"stream_errors", "decode_vs_state_px", "hvs_mse", "epu_gap"}
    for name in ("yl2_select_roofline", "yl2_candidates"):
        assert callable(run.reader(name))


def test_the_yl2_configuration_is_wide256_with_yliluoma2():
    yl2 = json.loads((ROOT / "gtm_bench/configs/gtm_wide256_yl2.json").read_text())
    wide = json.loads((ROOT / "gtm_bench/configs/gtm_wide256.json").read_text())
    assert yl2["settings"] == dict(wide["settings"], dithering_use_thomas_knoll=False,
                                   dithering_yliluoma2_mixed_colors=4)
    assert {k: yl2[k] for k in ("width", "height", "fps", "frames", "reduced")} == \
        {k: wide[k] for k in ("width", "height", "fps", "frames", "reduced")}
    assert yl2["name"] == "gtm_wide256_yl2" and 1 <= len(yl2["source"]) <= 200
    entry = next(x for x in SPEC["configs"] if x["name"] == "gtm_wide256_yl2")
    assert entry["source"] == yl2["source"] and entry["reduced"] == yl2["reduced"]
    EncoderSettings(**yl2["settings"])


@pytest.mark.parametrize("mixed,least", [(1, 1), (2, 2), (3, 4), (4, 4), (5, 7), (16, 16)])
def test_least_trials_a_color(mixed, least):
    assert yl2_roofline.least_trials(mixed) == least


def test_bound_at_the_wide_cells_corpus():
    """36,307 tiles of full 256-color palettes at mixed = 4: 4 trials a
    color of 28 operations at the float32 rate."""
    px = 36307 * 64
    s, by = yl2_roofline.bound_s(px, px * 256, 4)
    assert by == "operations"
    assert s == pytest.approx(28 * 4 * px * 256 / 67e12)


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    out = {}
    for use_tk in (True, False):
        path = str(tmp_path_factory.mktemp("gtm") / "s.gtm")
        settings = EncoderSettings(palette_count=4, palette_size=16, motion_predict_radius=2,
                                   epu_knn_k=8, kmeans_iters=2, dithering_use_thomas_knoll=use_tk,
                                   dithering_yliluoma2_mixed_colors=3)
        enc, _ = window.encode_once(settings, synthetic_clip(2, 32, 48), 25.0, path, "cpu")
        out[use_tk] = (open(path, "rb").read(), dict(enc.step_stats))
    return out


def test_the_plan_size_is_read_from_the_streams_settings(streams):
    assert yl2_roofline.stream_mixed(streams[False][0]) == 3
    assert yl2_roofline.stream_mixed(streams[True][0]) is None


def _run(raw, stats, seconds=None, launches=0):
    win = window.Window(0.0, 1.0, [window.Encode(True, {}, stats, "s")], {"s": raw}, "s", {}, 0)
    tr = None
    if seconds is not None:
        name = "(anonymous namespace)::yl2_select_kernel(...)"
        tr = trace.Trace(1.0, 1.0, {name: seconds} if launches else {}, {name: launches})
    return run.Run(window=win, trace=tr, capture=window.Capture(1), setup_s=0.0, peak_bytes=0,
                   frames=2, quality={})


def test_the_readers(streams):
    raw, stats = streams[False]
    assert run.reader("yl2_candidates")(_run(raw, stats)) == stats["yl2_candidates"] > 0
    roofline = run.reader("yl2_select_roofline")
    assert roofline(_run(raw, stats)) is None  # no trace
    assert roofline(_run(raw, stats, 1.0, 0)) is None  # the kernel did not run
    bound, _ = yl2_roofline.bound_s(64 * stats["corpus_tiles"], stats["dither_colors"], 3)
    assert roofline(_run(raw, stats, 2 * bound / 0.25, 2)) == pytest.approx(25.0)
    # a program without the counters (the parent's) reads nothing, and
    # the Thomas Knoll stream states no plan
    assert run.reader("yl2_candidates")(_run(raw, {})) is None
    assert roofline(_run(raw, {}, 1.0, 1)) is None
    assert roofline(_run(*streams[True], 1.0, 1)) is None
