"""Stage-by-stage parity of tiler_tpu_torch against tiler_tpu.

The JAX encoder runs the small synthetic clips step by step, and its
numpy state is snapshotted after each step. Each port stage then runs
from the JAX snapshot taken BEFORE it, and what it writes is held
against the snapshot taken AFTER it, so a drift upstream cannot hide or
fake a stage's agreement. The JAX side runs with 64-bit mode off, as in
production (the test configuration turns it on for the exact-math
tests, which would make jax.random draw float64).

On the CPU the port's kernel wrappers run their plain versions.
"""
import copy
import dataclasses

import jax
import numpy as np
import pytest
import torch

from bench import synthetic_clip
from tiler_tpu.config import EncoderSettings
from tiler_tpu.pipeline.encoder import Encoder as JaxEncoder
from tiler_tpu_torch.models.convert import state_from_numpy, state_to_numpy
from tiler_tpu_torch.pipeline import dither as t_dither
from tiler_tpu_torch.pipeline import load as t_load
from tiler_tpu_torch.pipeline import palettes as t_palettes
from tiler_tpu_torch.pipeline import predict as t_predict
from tiler_tpu_torch.pipeline import reconstruct as t_reconstruct
from tiler_tpu_torch.pipeline import reduce as t_reduce
from tiler_tpu_torch.pipeline import reindex as t_reindex

STEPS = ("predict_motion", "reduce", "prepare_palettes", "dither",
         "reconstruct", "reindex")


def _settings():
    return EncoderSettings(palette_count=8, motion_predict_radius=4,
                           epu_knn_k=8, kmeans_iters=4)


def _two_keyframe_clip():
    """Two scenes: at 2 fps the minimum keyframe spacing of 1 s is two
    frames, and the decorrelation rule starts a second keyframe."""
    a = synthetic_clip(3, 64, 96, seed=0)
    b = 255 - synthetic_clip(3, 64, 96, seed=1)[:, ::-1]
    return np.concatenate([a, b]), 2.0


CLIPS = {
    "one_kf": (synthetic_clip(6, 64, 96, seed=0), 25.0),
    "two_kf": _two_keyframe_clip(),
}


def _snapshot(state):
    return state_to_numpy(copy.copy(state))


@pytest.fixture(scope="module", params=sorted(CLIPS))
def jax_run(request):
    """{'load': snap, <step>: snap after the step} for one clip."""
    clip, fps = CLIPS[request.param]
    with jax.enable_x64(False):
        enc = JaxEncoder(_settings(), log=None)
        enc.load_frames(clip, fps)
        enc.state.ensure_ingest()
        snaps = {"load": _snapshot(enc.state), "clip": (clip, fps),
                 "name": request.param}
        for step in STEPS:
            getattr(enc, step)()
            snaps[step] = _snapshot(enc.state)
    return snaps


def _port(snap):
    return state_from_numpy(snap, "cpu")


def test_load_bit_identical(jax_run, xla_rec_bits):
    clip, fps = jax_run["clip"]
    want = jax_run["load"]
    got = t_load.load(type(want)(), clip, fps, _settings(), device="cpu")
    assert np.array_equal(got.tiles_canon.numpy(), np.asarray(want.tiles_canon))
    assert np.array_equal(got.frames_rgb.numpy(), np.asarray(want.frames_rgb))
    assert np.array_equal(got.tilemap.hmirror, want.tilemap.hmirror)
    assert np.array_equal(got.tilemap.vmirror, want.tilemap.vmirror)
    # the port's KeyFrameInfo is its own copy of the JAX class
    assert ([dataclasses.astuple(k) for k in got.keyframes]
            == [dataclasses.astuple(k) for k in want.keyframes])
    assert len(got.keyframes) == (2 if jax_run["name"] == "two_kf" else 1)
    assert np.array_equal(got.frame_kf, want.frame_kf)
    if xla_rec_bits:  # the mean LAB and the Pearson sums in XLA's CPU order
        assert np.array_equal(got.correlations.view(np.int32),
                              np.asarray(want.correlations).view(np.int32))
    # elsewhere f32 Pearson sums in another order: rounding only
    np.testing.assert_allclose(got.correlations, want.correlations, rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def xla_bits():
    """Whether the host's XLA compiles as the port's CPU motion search
    assumes (tests/test_torch_motion_order.py's probes)."""
    from test_torch_motion_order import motion_order_skip_reason
    return motion_order_skip_reason() is None


def test_predict_motion_vectors(jax_run, xla_bits):
    """On a host whose XLA compiles as ``ops/ordered.py`` assumes, every
    vector and every PSNR bit equal the JAX package's (the CPU search
    runs in its float order). Elsewhere >= 99% vector agreement; a cell
    whose two vectors reach the same exact distance (penalty aside) is a
    tie the bf16 rank breaks by rounding and counts as agreeing, and
    where the vectors agree the exact errors agree to rtol 1e-5, which is
    4.3e-5 dB of the stored PSNR."""
    want = jax_run["predict_motion"].tilemap
    st = _port(jax_run["load"])
    t_predict.predict_motion(st, _settings())
    got = st.tilemap
    if xla_bits:
        assert np.array_equal(got.pred_x, want.pred_x)
        assert np.array_equal(got.pred_y, want.pred_y)
        assert np.array_equal(got.psnr.view(np.int32), np.asarray(want.psnr).view(np.int32))
    same = (got.pred_x == want.pred_x) & (got.pred_y == want.pred_y)
    # PSNR saturates (mse clamped at 0.5) only for near-zero distances:
    # two vectors that both saturate tie on the distance
    tie = (got.psnr >= 51.0) & (want.psnr >= 51.0)
    assert (same | tie).mean() >= 0.99, (same.mean(), (same | tie).mean())
    np.testing.assert_allclose(got.psnr[same], want.psnr[same], rtol=0, atol=5e-5)


def test_reduce_bit_identical(jax_run):
    want = jax_run["reduce"]
    st = _port(jax_run["predict_motion"])
    t_reduce.reduce_tiles(st, _settings())
    assert np.array_equal(st.corpus_rgb.numpy(), np.asarray(want.corpus_rgb))
    assert np.array_equal(st.corpus_use, want.corpus_use)
    assert np.array_equal(st.tilemap.tile_idx, want.tilemap.tile_idx)
    assert np.array_equal(st.tilemap.predicted, want.tilemap.predicted)


def test_prepare_palettes_identical(jax_run):
    """Identical palettes given the threefry port: the random draws are
    the JAX package's (uniform/randint bits exactly; Gumbel logs to the
    last bit, see test_torch_prng), the k-means sums are f32 in another
    order."""
    want = jax_run["prepare_palettes"]
    st = _port(jax_run["reduce"])
    t_palettes.prepare_palettes(st, _settings())
    assert np.array_equal(st.corpus_pal_initial.numpy(), np.asarray(want.corpus_pal_initial))
    assert np.array_equal(st.palettes_valid.numpy(), np.asarray(want.palettes_valid))
    assert np.array_equal(st.palettes_rgb.numpy(), np.asarray(want.palettes_rgb))


def test_dither_bit_identical(jax_run):
    want = jax_run["dither"]
    st = _port(jax_run["prepare_palettes"])
    t_dither.dither(st, _settings())
    assert np.array_equal(st.corpus_pal_pixels.numpy(), np.asarray(want.corpus_pal_pixels))


def test_dither_yliluoma2_bit_identical(jax_run):
    """The same stage with dithering_use_thomas_knoll off in both
    packages, from the snapshot before it."""
    from tiler_tpu.pipeline import dither as j_dither

    flipped = dataclasses.replace(_settings(), dithering_use_thomas_knoll=False)
    with jax.enable_x64(False):
        want = j_dither.dither(copy.copy(jax_run["prepare_palettes"]), flipped)
        want = np.asarray(want.corpus_pal_pixels)
    st = _port(jax_run["prepare_palettes"])
    t_dither.dither(st, flipped)
    assert np.array_equal(st.corpus_pal_pixels.numpy(), want)
    assert not np.array_equal(want, np.asarray(jax_run["dither"].corpus_pal_pixels))


@pytest.mark.parametrize("plain", [dict(use_pallas_tk=False),
                                   dict(dithering_use_thomas_knoll=False)])
def test_dither_in_chunks_bit_identical(jax_run, plain):
    """``dither(..., chunk=7)`` on the plain paths (plain Thomas Knoll,
    Yliluoma2): the JAX package's stage at the same chunk, bit for bit."""
    from tiler_tpu.pipeline import dither as j_dither

    settings = dataclasses.replace(_settings(), **plain)
    with jax.enable_x64(False):
        want = j_dither.dither(copy.copy(jax_run["prepare_palettes"]), settings, chunk=7)
        want = np.asarray(want.corpus_pal_pixels)
    st = _port(jax_run["prepare_palettes"])
    t_dither.dither(st, settings, chunk=7)
    assert np.array_equal(st.corpus_pal_pixels.numpy(), want)


@pytest.fixture(scope="module")
def xla_rec_bits():
    """Whether the host's XLA computes reconstruct as the port's CPU path
    assumes (tests/test_torch_reconstruct_order.py's probes)."""
    from test_torch_reconstruct_order import reconstruct_order_skip_reason
    return reconstruct_order_skip_reason() is None


def test_reconstruct_winners_and_used_tiles(jax_run, xla_rec_bits):
    """On a host whose XLA computes as the port's CPU reconstruct assumes,
    the tilemap (predicted flags, tiles, palettes, vectors, PSNR bits) and
    total_psnr equal the JAX package's. Elsewhere >= 99% (tile, palette)
    winner agreement on the emitted cells and the post-reindex used-tile
    count within 1% (EPU tie shifts shrink the used-tile set even when
    every winner is at-or-better)."""
    want = jax_run["reconstruct"]
    st = _port(jax_run["dither"])
    t_reconstruct.reconstruct(st, _settings())
    g, w = st.tilemap, want.tilemap
    if xla_rec_bits:
        for field in ("predicted", "tile_idx", "pal_idx", "pred_y", "pred_x"):
            assert np.array_equal(getattr(g, field), getattr(w, field)), field
        assert np.array_equal(g.psnr.view(np.int32), np.asarray(w.psnr).view(np.int32))
        assert st.total_psnr == want.total_psnr
    assert (g.predicted == w.predicted).mean() >= 0.99
    both = ~g.predicted & ~w.predicted
    agree = (g.tile_idx[both] == w.tile_idx[both]) & (g.pal_idx[both] == w.pal_idx[both])
    assert agree.mean() >= 0.99, agree.mean()
    assert abs(st.total_psnr - want.total_psnr) <= 0.01
    t_reindex.reindex(st, _settings())
    used = len(st.corpus_pal_pixels)
    want_used = len(jax_run["reindex"].corpus_pal_pixels)
    assert abs(used - want_used) <= 0.01 * want_used, (used, want_used)


def test_reindex_bit_identical(jax_run):
    want = jax_run["reindex"]
    st = _port(jax_run["reconstruct"])
    t_reindex.reindex(st, _settings())
    assert np.array_equal(st.corpus_pal_pixels.numpy(), np.asarray(want.corpus_pal_pixels))
    assert np.array_equal(st.corpus_use, want.corpus_use)
    assert np.array_equal(st.tilemap.tile_idx, want.tilemap.tile_idx)
    assert np.array_equal(st.corpus_rgb.numpy(), np.asarray(want.corpus_rgb))
    assert np.array_equal(np.asarray(st.corpus_pal_initial), np.asarray(want.corpus_pal_initial))


def test_state_roundtrip_through_tensors(jax_run):
    """numpy -> torch -> numpy leaves every field of a snapshot intact."""
    snap = jax_run["reindex"]
    back = state_to_numpy(state_from_numpy(snap, "cpu"))
    for name in ("frames_rgb", "tiles_canon", "corpus_rgb", "palettes_rgb",
                 "palettes_valid", "corpus_pal_pixels", "corpus_pal_initial"):
        a, b = np.asarray(getattr(snap, name)), getattr(back, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert torch.is_tensor(state_from_numpy(snap, "cpu").corpus_pal_pixels)
