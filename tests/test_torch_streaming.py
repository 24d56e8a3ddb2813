"""Long clips in tiler_tpu_torch: the host-resident mode (a clip over
``hbm_frames_budget`` keeps its frames and tiles in host RAM and streams
them to the device per piece, chunk or keyframe) and the disk spill (past
``host_ram_budget`` the tiles, and frames decoded through a spilling
sink, are disk memmaps), as tests/test_e2e.py holds them in the JAX
package, and against the JAX package's own host mode.
"""
import copy

import jax
import numpy as np
import pytest

from bench import synthetic_clip
from tiler_tpu.bitstream.gtm import GTMDecoder, GTMReader
from tiler_tpu.config import EncoderSettings as JaxSettings
from tiler_tpu.io.export import write_y4m
from tiler_tpu.pipeline.encoder import Encoder as JaxEncoder
from tiler_tpu_torch.config import EncoderSettings
from tiler_tpu_torch.io import video
from tiler_tpu_torch.models.convert import state_to_numpy
from tiler_tpu_torch.pipeline import load as t_load
from tiler_tpu_torch.pipeline.encoder import Encoder

CLIP = synthetic_clip(6, 64, 96, seed=0)
FPS = 24.0
SMALL = dict(palette_count=8, motion_predict_radius=4, epu_knn_k=8, kmeans_iters=4)
HOST = dict(SMALL, hbm_frames_budget=1)  # every clip is over it
SPILL = dict(HOST, host_ram_budget=1)


def _encode(settings, path, clip=CLIP):
    enc = Encoder(EncoderSettings(**settings), log=None, device="cpu")
    enc.run_all(clip, fps=FPS, out_path=str(path))
    return enc


def _psnr_rgb(path):
    frames = np.stack(GTMDecoder(str(path)).decode_frames())[..., :3]
    assert frames.shape == CLIP.shape
    mse = np.mean((frames.astype(np.float64) - CLIP) ** 2)
    return 10 * np.log10(255 * 255 / max(mse, 1e-9))


@pytest.fixture(scope="module")
def device_stream(tmp_path_factory):
    path = tmp_path_factory.mktemp("device") / "device.gtm"
    _encode(SMALL, path)
    return path


def test_host_resident_writes_the_device_bytes(device_stream, tmp_path):
    enc = _encode(HOST, tmp_path / "host.gtm")
    assert type(enc.state.frames_rgb) is np.ndarray
    assert type(enc.state.tiles_canon) is np.ndarray
    assert (tmp_path / "host.gtm").read_bytes() == device_stream.read_bytes()


@pytest.mark.parametrize("piece", [1, 4])
def test_host_tile_pass_in_pieces_is_the_device_pass(piece, monkeypatch):
    """The tiles, flags and Pearson chain of host pieces of one and of
    four frames (the one-frame overlap across pieces) against the
    device-resident pass in one piece."""
    want = t_load.load(t_load.EncodeState(), CLIP, FPS, EncoderSettings(**SMALL), "cpu")
    monkeypatch.setattr(t_load, "_frames_per_chunk", lambda H, W: piece)
    got = t_load.load(t_load.EncodeState(), CLIP, FPS, EncoderSettings(**HOST), "cpu")
    assert np.array_equal(got.tiles_canon, want.tiles_canon.numpy())
    assert np.array_equal(got.tilemap.hmirror, want.tilemap.hmirror)
    assert np.array_equal(got.tilemap.vmirror, want.tilemap.vmirror)
    np.testing.assert_allclose(got.correlations, want.correlations, rtol=1e-6)
    assert got.frames_rgb is CLIP or np.array_equal(got.frames_rgb, CLIP)


@pytest.mark.parametrize("chunk", [1, 2, 5])
def test_host_motion_in_chunks_is_the_device_search(chunk, monkeypatch):
    """predict_motion over host frames in chunks (each stages its frames
    and the reference of its first; frame 0 searches frame 1) against the
    device-resident search."""
    from tiler_tpu_torch.models.convert import state_from_numpy
    from tiler_tpu_torch.pipeline import predict as t_predict

    dev = t_load.load(t_load.EncodeState(), CLIP, FPS, EncoderSettings(**SMALL), "cpu")
    host = state_from_numpy(state_to_numpy(dev), "cpu", host_resident=True)
    assert type(host.frames_rgb) is np.ndarray
    monkeypatch.setattr(t_predict, "_frame_chunk", lambda H, W, device: chunk)
    for st in (dev, host):
        t_predict.predict_motion(st, EncoderSettings(**SMALL), "cpu")
    for name in ("pred_y", "pred_x", "psnr"):
        assert np.array_equal(getattr(host.tilemap, name), getattr(dev.tilemap, name)), name
    assert host._hashes_prefetch is None and dev._hashes_prefetch is not None


def test_device_ingest_over_the_budget_is_made_on_the_host(tmp_path):
    """A resample over the frame budget: RGB made on the host (PIL
    Lanczos, as the JAX package does), said in the log, host-resident."""
    logs = []
    enc = Encoder(EncoderSettings(**HOST), log=logs.append, device="cpu")
    enc.load_frames(CLIP, FPS, resample_to=(40, 56))
    assert type(enc.state.frames_rgb) is np.ndarray
    assert enc.state.frames_rgb.shape == (6, 40, 56, 3)
    assert any("hbm_frames_budget" in line and "host" in line for line in logs)
    with jax.enable_x64(False):
        jenc = JaxEncoder(JaxSettings(**HOST), log=None)
        jenc.load_frames(CLIP, FPS, resample_to=(40, 56))
        jenc.state.ensure_ingest()
    assert np.array_equal(enc.state.frames_rgb, np.asarray(jenc.state.frames_rgb))
    assert np.array_equal(enc.state.tiles_canon, np.asarray(jenc.state.tiles_canon))


def test_disk_spill(device_stream, tmp_path):
    enc = _encode(SPILL, tmp_path / "spill.gtm")
    assert isinstance(enc.state.tiles_canon, np.memmap)
    # the embedded settings text differs (HostRamBudget is an INI field),
    # so compare decoded pixels and the stream's tables, not raw bytes
    f1 = np.stack(GTMDecoder(str(device_stream)).decode_frames())
    f2 = np.stack(GTMDecoder(str(tmp_path / "spill.gtm")).decode_frames())
    assert np.array_equal(f1, f2)
    g1, g2 = GTMReader.read(str(device_stream)), GTMReader.read(str(tmp_path / "spill.gtm"))
    assert np.array_equal(g1.tiles_pal, g2.tiles_pal)
    assert np.array_equal(g1.palettes_rgb, g2.palettes_rgb)

    # frames decoded through a spilling sink stay memmaps through load
    y4m = tmp_path / "clip.y4m"
    write_y4m(str(y4m), CLIP, fps=FPS)
    spilled, _ = video.load_y4m(str(y4m), spill_budget=1)
    assert isinstance(spilled, np.memmap)
    loaded = Encoder(EncoderSettings(**SPILL), log=None, device="cpu")
    loaded.load_frames(spilled, fps=FPS)
    assert isinstance(loaded.state.frames_rgb, np.memmap)

    # checkpoint: memmap fields go to a sidecar .npy, the live encoder
    # keeps its memmap, and the reload maps it again
    ck = tmp_path / "spill.ckpt"
    enc.save_checkpoint(str(ck))
    assert isinstance(enc.state.tiles_canon, np.memmap)
    assert (tmp_path / "spill.ckpt.tiles_canon.npy").exists()
    resumed = Encoder.load_checkpoint(str(ck), log=None, device="cpu")
    assert isinstance(resumed.state.tiles_canon, np.memmap)
    resumed.save(str(tmp_path / "resumed.gtm"))
    assert (tmp_path / "resumed.gtm").read_bytes() == (tmp_path / "spill.gtm").read_bytes()


def test_spilled_y4m_through_load_video(tmp_path):
    """Encoder.load_video hands host_ram_budget to the reader as its spill
    budget; the clip then stays a memmap through the encode."""
    y4m = tmp_path / "clip.y4m"
    write_y4m(str(y4m), CLIP, fps=FPS)
    s = EncoderSettings(**SPILL, input_file_name=str(y4m),
                        output_file_name=str(tmp_path / "out.gtm"), device_resample=False)
    enc = Encoder(s, log=None, device="cpu")
    enc.run_all()
    assert isinstance(enc.state.frames_rgb, np.memmap)
    assert len(GTMDecoder(str(tmp_path / "out.gtm")).decode_frames()) == len(CLIP)


@pytest.fixture(scope="module")
def jax_host_stream(tmp_path_factory):
    out = tmp_path_factory.mktemp("jaxhost") / "jax.gtm"
    with jax.enable_x64(False):
        enc = JaxEncoder(JaxSettings(**HOST), log=None)
        enc.run_all(CLIP, fps=FPS, out_path=str(out))
        assert isinstance(enc.state.tiles_canon, np.ndarray)
    return out, enc.stats.total_bytes


def test_host_resident_within_the_determinism_gate(jax_host_stream, tmp_path):
    jpath, jbytes = jax_host_stream
    enc = _encode(HOST, tmp_path / "host.gtm")
    assert abs(_psnr_rgb(tmp_path / "host.gtm") - _psnr_rgb(jpath)) <= 0.1
    assert abs(enc.stats.total_bytes - jbytes) <= 0.02 * jbytes


def test_jax_spill_checkpoint_after_dither_finishes_in_the_port(jax_host_stream, tmp_path):
    ck = tmp_path / "jax_spill.ckpt"
    with jax.enable_x64(False):
        enc = JaxEncoder(JaxSettings(**SPILL), log=None)
        enc.load_frames(CLIP, FPS).predict_motion().reduce().prepare_palettes().dither()
        enc.save_checkpoint(str(ck))
    assert (tmp_path / "jax_spill.ckpt.tiles_canon.npy").exists()
    port = Encoder.load_checkpoint(str(ck), log=None, device="cpu")
    assert isinstance(port.state.tiles_canon, np.memmap)
    assert type(port.state.frames_rgb) is np.ndarray
    out = tmp_path / "resumed.gtm"
    port.reconstruct().reindex().save(str(out))
    assert abs(_psnr_rgb(out) - _psnr_rgb(jax_host_stream[0])) <= 0.1
    # and back: the port's spill checkpoint names the port's classes only
    port.save_checkpoint(str(tmp_path / "port.ckpt"))
    assert b"tiler_tpu." not in (tmp_path / "port.ckpt").read_bytes()
    assert isinstance(state_to_numpy(copy.copy(port.state)).tiles_canon, np.memmap)
