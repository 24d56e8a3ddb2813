"""tiler_tpu_torch end to end against tiler_tpu, and checkpoints that
cross between the two packages.

The end-to-end gate is docs/DETERMINISM.md's: both streams decode to the
full frame count, with RGB-PSNR within 0.1 dB and bytes within 2%. On a
host whose XLA computes as the port's CPU path assumes, the port writes
the JAX package's stream byte for byte (equal sha256).
"""
import dataclasses
import hashlib
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from bench import synthetic_clip
from tiler_tpu.bitstream.gtm import GTMDecoder
from tiler_tpu.config import EncoderSettings
from tiler_tpu.io.export import write_y4m
from tiler_tpu.models import state as j_state
from tiler_tpu.pipeline.encoder import Encoder as JaxEncoder
from tiler_tpu_torch.pipeline.encoder import Encoder

CLIP = synthetic_clip(6, 64, 96, seed=0)
FPS = 25.0


def _settings():
    return EncoderSettings(palette_count=8, motion_predict_radius=4,
                           epu_knn_k=8, kmeans_iters=4)


def _psnr_rgb(path):
    frames = np.stack(GTMDecoder(str(path)).decode_frames())[..., :3]
    assert frames.shape == CLIP.shape
    mse = np.mean((frames.astype(np.float64) - CLIP) ** 2)
    return 10 * np.log10(255 * 255 / max(mse, 1e-9))


def _sha256(path):
    return hashlib.sha256(Path(path).read_bytes()).hexdigest()


@pytest.fixture(scope="module")
def xla_rec_bits():
    """Whether the host's XLA computes as the port's CPU encode assumes
    (tests/test_torch_reconstruct_order.py's probes)."""
    from test_torch_reconstruct_order import reconstruct_order_skip_reason
    return reconstruct_order_skip_reason() is None


@pytest.fixture(scope="module")
def jax_stream(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax") / "jax.gtm"
    with jax.enable_x64(False):
        enc = JaxEncoder(_settings(), log=None)
        enc.run_all(CLIP, fps=FPS, out_path=str(out))
    return out, enc.stats.total_bytes


def test_run_all_within_the_determinism_gate(jax_stream, tmp_path, xla_rec_bits):
    jpath, jbytes = jax_stream
    out = tmp_path / "torch.gtm"
    enc = Encoder(_settings(), log=None, device="cpu")
    enc.run_all(CLIP, fps=FPS, out_path=str(out))
    if xla_rec_bits:
        assert _sha256(out) == _sha256(jpath)
    assert abs(_psnr_rgb(out) - _psnr_rgb(jpath)) <= 0.1
    assert abs(enc.stats.total_bytes - jbytes) <= 0.02 * jbytes
    assert set(enc.timings) == {"load", "predict_motion", "reduce", "prepare_palettes",
                                "dither", "reconstruct", "reindex", "save"}
    assert enc.step_stats["knn_kernel_cells"] == 0  # no B2 below its corpus gate


def test_yliluoma2_run_all_within_the_determinism_gate(tmp_path, xla_rec_bits):
    """dithering_use_thomas_knoll off in both packages, on the first four
    frames: the same stream on an XLA-order host."""
    settings = dataclasses.replace(_settings(), dithering_use_thomas_knoll=False)
    clip = CLIP[:4]
    results = {}
    for name in ("jax", "torch"):
        out = tmp_path / f"{name}.gtm"
        if name == "jax":
            with jax.enable_x64(False):
                enc = JaxEncoder(settings, log=None)
                enc.run_all(clip, fps=FPS, out_path=str(out))
        else:
            enc = Encoder(settings, log=None, device="cpu")
            enc.run_all(clip, fps=FPS, out_path=str(out))
        frames = np.stack(GTMDecoder(str(out)).decode_frames())[..., :3]
        assert frames.shape == clip.shape
        mse = np.mean((frames.astype(np.float64) - clip) ** 2)
        results[name] = (10 * np.log10(255 * 255 / max(mse, 1e-9)), enc.stats.total_bytes)
    if xla_rec_bits:
        assert _sha256(tmp_path / "torch.gtm") == _sha256(tmp_path / "jax.gtm")
    assert abs(results["torch"][0] - results["jax"][0]) <= 0.1
    assert abs(results["torch"][1] - results["jax"][1]) <= 0.02 * results["jax"][1]


def test_jax_checkpoint_after_dither_finishes_in_the_port(jax_stream, tmp_path):
    ck = tmp_path / "after_dither.ckpt"
    with jax.enable_x64(False):
        enc = JaxEncoder(_settings(), log=None)
        enc.load_frames(CLIP, FPS).predict_motion().reduce().prepare_palettes().dither()
        enc.save_checkpoint(str(ck))
    port = Encoder.load_checkpoint(str(ck), log=None, device="cpu")
    out = tmp_path / "resumed.gtm"
    port.reconstruct().reindex().save(str(out))
    assert abs(_psnr_rgb(out) - _psnr_rgb(jax_stream[0])) <= 0.1


def _as_jax_checkpoint(src, dst):
    """The port writes its checkpoints with its own classes; rebuild the
    same fields in the JAX package's classes."""
    with open(src, "rb") as f:
        d = pickle.load(f)
    st = d["state"]
    js = j_state.EncodeState(**{f.name: getattr(st, f.name)
                                for f in dataclasses.fields(st)})
    js.tilemap = j_state.TileMapSoA(**vars(st.tilemap))
    js.keyframes = [j_state.KeyFrameInfo(**vars(k)) for k in st.keyframes]
    with open(dst, "wb") as f:
        pickle.dump({"state": js,
                     "settings": EncoderSettings(**dataclasses.asdict(d["settings"]))}, f)


def test_port_checkpoint_after_reduce_finishes_in_jax(jax_stream, tmp_path):
    ck = tmp_path / "after_reduce.ckpt"
    enc = Encoder(_settings(), log=None, device="cpu")
    enc.load_frames(CLIP, FPS).predict_motion().reduce()
    enc.save_checkpoint(str(ck))
    assert b"tiler_tpu." not in ck.read_bytes()  # only the port's classes
    _as_jax_checkpoint(ck, tmp_path / "as_jax.ckpt")
    out = tmp_path / "resumed.gtm"
    with jax.enable_x64(False):
        jenc = JaxEncoder.load_checkpoint(str(tmp_path / "as_jax.ckpt"), log=None)
        jenc.prepare_palettes().dither().reconstruct().reindex().save(str(out))
    assert abs(_psnr_rgb(out) - _psnr_rgb(jax_stream[0])) <= 0.1


def test_cli_encodes_a_y4m(tmp_path):
    src = tmp_path / "clip.y4m"
    write_y4m(str(src), list(CLIP), FPS)
    out = tmp_path / "cli.gtm"
    subprocess.run(
        [sys.executable, "-m", "tiler_tpu_torch", "encode", "-i", str(src), "-o", str(out),
         "--device", "cpu", "--palette-count", "8", "--radius", "4",
         "--checkpoint", str(tmp_path / "cli.ckpt")],
        check=True, capture_output=True, timeout=300, cwd=Path(__file__).resolve().parents[1])
    assert len(GTMDecoder(str(out)).decode_frames()) == len(CLIP)
    assert (tmp_path / "cli.ckpt").stat().st_size > 0


def test_cli_settings_file_with_yliluoma2_and_scaling(tmp_path):
    """The settings-file keys of the two settings: DitheringUseThomasKnoll=0
    and Scaling=0.5 encode (the y4m goes up as planes and is resampled by
    ops/resample.py), and the stream has the scaled size."""
    src = tmp_path / "clip.y4m"
    write_y4m(str(src), list(CLIP[:3]), FPS)
    out, ini = tmp_path / "cli.gtm", tmp_path / "s.ini"
    ini.write_text(f"[Load]\nInputFileName={src}\nOutputFileName={out}\nScaling=0.5\n"
                   "[Dither]\nPaletteCount=4\nDitheringUseThomasKnoll=0\n"
                   "DitheringYliluoma2MixedColors=2\n[MotionPredict]\nMotionPredictRadius=2\n")
    subprocess.run(
        [sys.executable, "-m", "tiler_tpu_torch", "encode", "-s", str(ini), "--device", "cpu"],
        check=True, capture_output=True, timeout=300, cwd=Path(__file__).resolve().parents[1])
    frames = GTMDecoder(str(out)).decode_frames()
    assert len(frames) == 3 and frames[0].shape[:2] == (32, 48)
