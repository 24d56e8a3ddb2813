"""Device resample and planar y4m ingest (ops/resample.py, io/video.py,
pipeline/load.py, Encoder.load_video) against tiler_tpu.

- lanczos_matrix: the port's copy, equal to the original;
- planar_to_rgb at scaling=1: bit-identical to the host y4m ingest of
  both packages (each fp32 product and sum is a pass of its own);
- resize_rgb: two fp32 matrix products whose sums run in another order
  than XLA's, so a value that lands on a rounding boundary may move one
  code value; every pixel within 1, and the share that differs stated;
- load_video_planar: the original's planes, byte for byte.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import synthetic_clip
from tiler_tpu.io import video as j_video
from tiler_tpu.io.export import write_y4m
from tiler_tpu.ops import resample as j_resample
from tiler_tpu_torch.config import EncoderSettings
from tiler_tpu_torch.io import video as t_video
from tiler_tpu_torch.ops import resample as t_resample
from tiler_tpu_torch.pipeline import load as t_load
from tiler_tpu_torch.pipeline.encoder import Encoder

CLIP = synthetic_clip(5, 48, 72, seed=3)


def _write_c420(path, frames, fps=25.0):
    """Planar 4:2:0 y4m of RGB frames (BT.601 full range, chroma averaged
    over 2x2)."""
    H, W = frames[0].shape[:2]
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{W} H{H} F{round(fps * 1000)}:1000 Ip A1:1 C420jpeg\n".encode())
        for fr in frames:
            rgb = fr.astype(np.float32)
            y = rgb[..., 0] * 0.299 + rgb[..., 1] * 0.587 + rgb[..., 2] * 0.114
            u = ((rgb[..., 2] - y) * 0.492 + 128).reshape(H // 2, 2, W // 2, 2).mean((1, 3))
            v = ((rgb[..., 0] - y) * 0.877 + 128).reshape(H // 2, 2, W // 2, 2).mean((1, 3))
            f.write(b"FRAME\n" + b"".join(
                np.clip(np.round(p), 0, 255).astype(np.uint8).tobytes() for p in (y, u, v)))


@pytest.fixture(scope="module")
def c420(tmp_path_factory):
    path = tmp_path_factory.mktemp("y4m") / "clip420.y4m"
    _write_c420(str(path), list(CLIP))
    return str(path)


@pytest.mark.parametrize("n_in,n_out", [(48, 96), (72, 36), (50, 77), (64, 64), (7, 3)])
def test_lanczos_matrix_equals_the_original(n_in, n_out):
    got, want = t_resample.lanczos_matrix(n_in, n_out), j_resample.lanczos_matrix(n_in, n_out)
    assert got.dtype == np.float32 and np.array_equal(got, want)


@pytest.mark.parametrize("start,count", [(0, None), (1, 3), (4, 9)])
def test_load_video_planar_byte_identical(c420, start, count):
    got = t_video.load_video_planar(c420, start, count)
    want = j_video.load_video_planar(c420, start, count)
    assert isinstance(got, t_video.PlanarClip) and got.fps == want.fps
    assert (got.n_frames, got.src_h, got.src_w) == (want.n_frames, 48, 72)
    for a, b in ((got.y, want.y), (got.u, want.u), (got.v, want.v)):
        assert a.dtype == np.uint8 and np.array_equal(a, b)
    assert np.array_equal(got.to_rgb_host(), want.to_rgb_host())


def test_load_video_planar_is_none_for_rgb_sources(tmp_path):
    assert t_video.load_video_planar(str(tmp_path / "frame%04d.png")) is None
    assert t_video.load_video_planar(str(tmp_path / "clip.gtm")) is None


def test_planar_to_rgb_bit_identical_to_the_host_ingest(c420):
    clip = t_video.load_video_planar(c420)
    got = t_resample.planar_to_rgb(
        torch.from_numpy(clip.y), torch.from_numpy(clip.u), torch.from_numpy(clip.v),
        None, None, out_h=48, out_w=72, resize=False).numpy()
    host, fps = t_video.load_video(c420)
    jhost, jfps = j_video.load_video(c420)
    assert fps == jfps == clip.fps
    assert np.array_equal(got, host) and np.array_equal(host, jhost)
    with jax.enable_x64(False):
        z = jnp.zeros((1, 1), jnp.float32)
        jdev = np.asarray(j_resample.planar_to_rgb(
            jnp.asarray(clip.y), jnp.asarray(clip.u), jnp.asarray(clip.v), z, z,
            out_h=48, out_w=72, resize=False))
    assert np.array_equal(got, jdev)


def test_planar_to_rgb_pads_to_tile_multiples():
    rng = np.random.default_rng(0)
    y = torch.from_numpy(rng.integers(0, 256, (2, 20, 28), dtype=np.uint8))
    u = torch.from_numpy(rng.integers(0, 256, (2, 10, 14), dtype=np.uint8))
    got = t_resample.planar_to_rgb(y, u, u, None, None, out_h=20, out_w=28, resize=False)
    assert got.shape == (2, 24, 32, 3) and got.dtype == torch.uint8
    assert int(got[:, 20:].max()) == 0 and int(got[:, :, 28:].max()) == 0


@pytest.mark.parametrize("out_h,out_w", [(96, 144), (24, 36), (61, 50)])
def test_resize_rgb_within_one_code_value(out_h, out_w):
    lh, lw = t_resample.lanczos_matrix(48, out_h), t_resample.lanczos_matrix(72, out_w)
    with jax.enable_x64(False):
        want = np.asarray(j_resample.resize_rgb(jnp.asarray(CLIP), jnp.asarray(lh),
                                                jnp.asarray(lw), out_h=out_h, out_w=out_w))
    got = t_resample.resize_rgb(torch.from_numpy(CLIP), torch.from_numpy(lh),
                                torch.from_numpy(lw), out_h=out_h, out_w=out_w).numpy()
    assert got.shape == want.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - want)
    share = float((diff != 0).mean())
    print(f"resize_rgb {out_h}x{out_w}: {share:.6%} of the values differ from the JAX function")
    assert int(diff.max()) <= 1
    assert share <= 0.001


def test_load_planar_equals_the_host_path(c420):
    """The load stage from planes: the frames, tiles, mirrors and
    keyframes of the host-converted clip."""
    s = EncoderSettings()
    host, fps = t_video.load_video(c420)
    want = t_load.load(t_load.EncodeState(), host, fps, s, "cpu")
    got = t_load.load(t_load.EncodeState(), t_video.load_video_planar(c420), fps, s, "cpu")
    assert torch.equal(got.frames_rgb, want.frames_rgb)
    assert torch.equal(got.tiles_canon, want.tiles_canon)
    assert np.array_equal(got.tilemap.hmirror, want.tilemap.hmirror)
    assert np.array_equal(got.correlations, want.correlations)
    assert [k.start_frame for k in got.keyframes] == [k.start_frame for k in want.keyframes]


def test_load_resample_to_matches_the_original():
    """RGB frames resampled by the load stage, against the JAX package's
    load with the same target: within one code value."""
    from tiler_tpu.config import EncoderSettings as JaxSettings
    from tiler_tpu.models.state import EncodeState as JaxState
    from tiler_tpu.pipeline import load as j_load

    with jax.enable_x64(False):
        want = j_load.load(JaxState(), CLIP, 25.0, JaxSettings(), resample_to=(70, 100))
        want_frames = np.asarray(want.frames_rgb)
    got = t_load.load(t_load.EncodeState(), CLIP, 25.0, EncoderSettings(), "cpu",
                      resample_to=(70, 100))
    assert (got.tilemap_h, got.tilemap_w) == (want.tilemap_h, want.tilemap_w) == (9, 13)
    diff = np.abs(got.frames_rgb.numpy().astype(np.int16) - want_frames)
    assert diff.shape == (5, 72, 104, 3) and int(diff.max()) <= 1
    assert float((diff != 0).mean()) <= 0.001


@pytest.mark.parametrize("device_resample", [True, False])
def test_encoder_load_video_scaling_one(c420, device_resample):
    enc = Encoder(EncoderSettings(device_resample=device_resample), log=None, device="cpu")
    enc.load_video(c420)
    host, _ = t_video.load_video(c420)
    assert np.array_equal(enc.state.frames_rgb.numpy(), host)
    assert enc.state.fps == 25.0


@pytest.mark.parametrize("scaling", [2.0, 0.5])
def test_encoder_load_video_scaled_on_the_device(c420, tmp_path, scaling):
    """Planes and RGB sources (a y4m, a C444 y4m read as planes too, a
    PNG sequence) at scaling != 1: the target size, and close to the
    host's PIL Lanczos (another filter implementation: > 40 dB)."""
    from PIL import Image

    for i, f in enumerate(CLIP[:2]):
        Image.fromarray(f).save(tmp_path / f"f{i:04d}.png")
    c444 = tmp_path / "clip444.y4m"
    write_y4m(str(c444), list(CLIP[:2]), 25.0)
    th, tw = round(48 * scaling), round(72 * scaling)
    for src in (c420, str(c444), str(tmp_path / "f%04d.png")):
        dev = Encoder(EncoderSettings(scaling=scaling), log=None, device="cpu")
        dev.load_video(src)
        host = Encoder(EncoderSettings(scaling=scaling, device_resample=False), log=None,
                       device="cpu")
        host.load_video(src)
        a = dev.state.frames_rgb.numpy()[:, :th, :tw].astype(np.float64)
        b = host.state.frames_rgb.numpy()[:, :th, :tw].astype(np.float64)
        assert dev.state.frames_rgb.shape == host.state.frames_rgb.shape
        assert (dev.state.height, dev.state.width) == (-(-th // 8) * 8, -(-tw // 8) * 8)
        assert 10 * np.log10(255 ** 2 / np.mean((a - b) ** 2)) > 40.0, src
