"""The port reads back what it writes: its copies of the structured GTM
reader (GTMFile, GTMReader) and of io/export.py against tiler_tpu's
originals, and the CLI's decode, info --full and selftest, each run once
in a subprocess (the port's CLI imports no jax)."""
import argparse
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from bench import synthetic_clip
from tiler_tpu import cli as j_cli
from tiler_tpu.bitstream.gtm import GTMDecoder as JaxDecoder
from tiler_tpu.bitstream.gtm import GTMReader as JaxReader
from tiler_tpu.io import export as j_export
from tiler_tpu_torch.bitstream import gtm as t_gtm
from tiler_tpu_torch.config import EncoderSettings
from tiler_tpu_torch.io import export as t_export
from tiler_tpu_torch.pipeline.encoder import Encoder

ROOT = Path(__file__).resolve().parents[1]
CLIP = synthetic_clip(4, 64, 96, seed=3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small encode (the suite's
    parallel workers share the cores); restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def stream(tmp_path_factory):
    """A small clip encoded by the port on the CPU."""
    out = tmp_path_factory.mktemp("readback") / "port.gtm"
    enc = Encoder(EncoderSettings(palette_count=8, motion_predict_radius=4, epu_knn_k=8,
                                  kmeans_iters=4), log=None, device="cpu")
    enc.run_all(CLIP, fps=25.0, out_path=str(out))
    return out


def _cli(*args):
    return subprocess.run([sys.executable, "-m", "tiler_tpu_torch", *map(str, args)],
                          check=True, capture_output=True, text=True, timeout=300, cwd=ROOT)


def test_reader_equals_the_original(stream):
    raw = stream.read_bytes()
    got, want = t_gtm.GTMReader.read(raw), JaxReader.read(raw)
    assert type(got) is t_gtm.GTMFile
    for k in ("width", "height", "fps", "tile_count", "tileset_count", "palette_size",
              "settings_text", "keyframe_end", "header"):
        assert getattr(got, k) == getattr(want, k), k
    assert np.array_equal(got.tiles_pal, want.tiles_pal)
    assert np.array_equal(got.palettes_rgb, want.palettes_rgb)
    assert len(got.frames) == len(want.frames) == len(CLIP)
    for fa, fb in zip(got.frames, want.frames):
        da, db = dataclasses.asdict(fa), dataclasses.asdict(fb)
        assert da.keys() == db.keys()
        assert all(np.array_equal(np.asarray(da[k]), np.asarray(db[k])) for k in da)
    assert (got.tilemap_w, got.tilemap_h) == (96 // 8, 64 // 8)
    # the same stream from a path
    assert t_gtm.GTMReader.read(str(stream)).tile_count == got.tile_count


def test_reader_refuses_a_cut_stream(stream):
    raw = stream.read_bytes()
    with pytest.raises(t_gtm.GTMFormatError):
        t_gtm.GTMReader.read(raw[:30])


def test_export_equals_the_original(stream, tmp_path):
    frames = JaxDecoder(str(stream)).decode_frames()
    pal = JaxReader.read(stream.read_bytes()).palettes_rgb
    for mod, name in ((t_export, "port"), (j_export, "jax")):
        mod.write_y4m(str(tmp_path / f"{name}.y4m"), [f[..., :3] for f in frames], 25.0)
        mod.write_pngs(str(tmp_path / f"{name}.png"), frames[:2], pal)
    assert (tmp_path / "port.y4m").read_bytes() == (tmp_path / "jax.y4m").read_bytes()
    assert (tmp_path / "port.txt").read_text() == (tmp_path / "jax.txt").read_text()
    for i in range(2):
        assert ((tmp_path / f"port_{i:04d}.png").read_bytes()
                == (tmp_path / f"jax_{i:04d}.png").read_bytes())


def test_cli_decode_writes_the_original_y4m(stream, tmp_path):
    res = _cli("decode", stream, tmp_path / "port.y4m")
    assert f"decoded {len(CLIP)} frames" in res.stdout
    j_cli.cmd_decode(argparse.Namespace(input=str(stream), output=str(tmp_path / "jax.y4m")))
    assert (tmp_path / "port.y4m").read_bytes() == (tmp_path / "jax.y4m").read_bytes()


def test_cli_info_full_prints_the_original(stream, capsys):
    res = _cli("info", stream, "--full")
    j_cli.cmd_info(argparse.Namespace(input=str(stream), full=True))
    assert res.stdout == capsys.readouterr().out
    assert "palette_size: 16" in res.stdout and f"frames: {len(CLIP)}" in res.stdout


def test_cli_selftest():
    assert _cli("selftest").stdout.strip() == "selftest ok"
