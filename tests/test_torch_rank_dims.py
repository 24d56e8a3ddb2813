"""``motion_rank_dims`` < 192 against tiler_tpu: the motion search ranks
its candidates on each channel's low-frequency r x r DCT block (dims =
3 r^2), in both window fields, and the im2row field's blockify relayout
runs at that depth.

- blockify: pure data movement at every depth the reference reaches
  (K = 3, 12, 27, 48, 75, 108, 147, 192), bit-identical to the Pallas
  kernel in interpret mode; a numpy model of the CUDA kernel's indexing
  (runs of eight rows, K 16-byte vectors each) equals the plain version.
- the two window fields at dims 3, 27, 48, 192: within one bf16 ulp of the
  JAX package's (f32 sums in another order), the same +inf masks, the
  finite norms within 1e-5 relative.
- motion_search at those dims: vectors agree except on near-ties
  (ROADMAP C5: both exact errors at or above 51 dB count as a tie), and
  where they agree the exact errors within 1e-5 relative (the winner's
  error comes from the full 192 features on both sides).
- phase B's re-search at dims 48 on one keyframe, and encodes at 48
  (passes) and 27 (im2row) within 0.1 dB RGB-PSNR and 2% bytes of the JAX
  package's (docs/DETERMINISM.md's gate).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import synthetic_clip
from tiler_tpu.bitstream.gtm import GTMDecoder
from tiler_tpu.config import EncoderSettings as JaxSettings
from tiler_tpu.kernels import blockify as j_blk
from tiler_tpu.pipeline import motion as j_motion
from tiler_tpu.pipeline import reconstruct as j_reconstruct
from tiler_tpu.pipeline.encoder import Encoder as JaxEncoder
from tiler_tpu_torch.config import EncoderSettings
from tiler_tpu_torch.kernels import blockify as t_blk
from tiler_tpu_torch.models.convert import state_from_numpy, state_to_numpy
from tiler_tpu_torch.ops.metrics import euclidean_to_psnr
from tiler_tpu_torch.pipeline import motion as t_motion
from tiler_tpu_torch.pipeline import reconstruct as t_reconstruct
from tiler_tpu_torch.pipeline.encoder import Encoder

torch.set_num_threads(1)  # many small tensor passes: workers share the host

DEPTHS = (3, 12, 27, 48, 75, 108, 147, 192)  # 3 r^2, r = 1..8
SEARCH_DIMS = (3, 27, 48, 192)
CLIP = synthetic_clip(6, 64, 96, seed=0)
FPS = 25.0
SMALL = dict(palette_count=8, motion_predict_radius=4, epu_knn_k=8, kmeans_iters=4)


@pytest.mark.parametrize("K", DEPTHS)
def test_blockify_plain_matches_pallas_at_every_depth(K):
    x = torch.as_tensor(np.random.default_rng(K).normal(0, 100, (16, 24, K)).astype(np.float32))
    t = x.to(torch.bfloat16)
    with jax.enable_x64(False):
        want = np.asarray(j_blk.blockify_field(jnp.asarray(t.float().numpy(), jnp.bfloat16)))
    got = t_blk.blockify_field(t)
    assert got.shape == (2, 3, 64, K)
    assert np.array_equal(got.view(torch.int16).numpy().view(np.uint16), want.view(np.uint16))


@pytest.mark.parametrize("K", DEPTHS)
def test_blockify_kernel_indexing_model(K):
    """csrc/blockify.cu's index math over 16-byte vectors, in numpy: output
    vector i of run (m, n, sy) = i // K is input vector ((8 m + sy) mw + n)
    K + i % K, for any K."""
    mh, mw = 3, 5
    F = torch.arange(64 * mh * mw * K, dtype=torch.int32).to(torch.int16)
    F = F.view(torch.bfloat16).reshape(8 * mh, 8 * mw, K)
    vec = F.view(torch.int16).numpy().reshape(-1, 8)  # 16-byte vectors
    i = np.arange(mh * mw * 8 * K)
    run, v = i // K, i % K
    sy, mn = run & 7, run >> 3
    m, n = mn // mw, mn % mw
    got = vec[((m * 8 + sy) * mw + n) * K + v].reshape(-1)
    want = t_blk.blockify_field_plain(F).view(torch.int16).numpy().reshape(-1)
    assert np.array_equal(got, want)


def _field_args(dims, seed=0, radius=8):
    frame = synthetic_clip(1, 48, 64, seed=seed)[0]
    Q = 1
    while Q * 8 < radius:
        Q *= 2
    P = 8 * Q
    H, W = frame.shape[:2]
    mh, mw = -(-(H - 7 + 2 * P) // 8), -(-(W - 7 + 2 * P) // 8)
    mu = np.random.default_rng(dims).normal(0, 20, dims).astype(np.float32)
    return frame, mu, P, mh, mw


@pytest.mark.parametrize("field", ["passes", "im2row"])
@pytest.mark.parametrize("dims", SEARCH_DIMS)
def test_window_field_matches_jax(dims, field):
    frame, mu, P, mh, mw = _field_args(dims)
    jfn = {"passes": j_motion._window_field_blocks,
           "im2row": j_motion._window_field_blocks_im2row}[field]
    tfn = {"passes": t_motion._window_field_blocks,
           "im2row": t_motion._window_field_blocks_im2row}[field]
    with jax.enable_x64(False):
        jF, jN = jfn(jnp.asarray(frame), jnp.asarray(mu), P, mh, mw, dims)
        jF, jN = np.asarray(jF.astype(jnp.float32)), np.asarray(jN)
    tF, tN = tfn(torch.from_numpy(frame), torch.from_numpy(mu), P, mh, mw, dims)
    tF, tN = tF.float().numpy(), tN.numpy()
    assert tF.shape == jF.shape == (mh, mw, 64, dims)
    # one bf16 ulp of the larger magnitude: f32 sums in another order may
    # round a value near a boundary either way
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(tF), np.abs(jF)) + 1e-30)) - 7)
    assert np.all(np.abs(tF - jF) <= ulp)
    assert np.array_equal(np.isinf(tN), np.isinf(jN))
    fin = np.isfinite(jN)
    np.testing.assert_allclose(tN[fin], jN[fin], rtol=1e-5)


def test_lowfreq_tiles_match_jax():
    T = np.random.default_rng(1).normal(0, 50, (5, 7, 192)).astype(np.float32)
    for dims in DEPTHS:
        want = np.asarray(j_motion._lowfreq_tiles(jnp.asarray(T), dims))
        assert np.array_equal(t_motion._lowfreq_tiles(torch.from_numpy(T), dims).numpy(), want)
    with pytest.raises(ValueError, match="3\\*r\\^2"):
        t_motion._lowfreq_side(50)


@pytest.mark.parametrize("field", ["passes", "im2row"])
@pytest.mark.parametrize("dims", SEARCH_DIMS)
def test_motion_search_matches_jax(dims, field):
    """Frame 1 against frame 0 of a 64 x 96 clip at radius 8."""
    with jax.enable_x64(False):
        want = [np.asarray(a) for a in j_motion.motion_search(
            jnp.asarray(CLIP[1]), jnp.asarray(CLIP[0]), 8, rank_dims=dims, field_impl=field)]
    got = [a.numpy() for a in t_motion.motion_search(
        torch.from_numpy(CLIP[1]), torch.from_numpy(CLIP[0]), 8, field, rank_dims=dims)]
    same = (got[0] == want[0]) & (got[1] == want[1])
    tp = euclidean_to_psnr(torch.from_numpy(got[2])).numpy()
    jp = euclidean_to_psnr(torch.from_numpy(want[2].copy())).numpy()
    tie = (tp >= 51.0) & (jp >= 51.0)
    assert (same | tie).mean() >= 0.99, (same.mean(), (same | tie).mean())
    np.testing.assert_allclose(got[2][same], want[2][same], rtol=1e-5)


RESEARCH48 = dict(SMALL, phase_b_motion="research", motion_rank_dims=48)


@pytest.fixture(scope="module")
def jax_research48():
    """The JAX encode with research at dims 48, up to the dither (numpy)."""
    with jax.enable_x64(False):
        enc = JaxEncoder(JaxSettings(**RESEARCH48), log=None)
        enc.load_frames(CLIP, FPS).predict_motion().reduce().prepare_palettes().dither()
        return state_to_numpy(copy.copy(enc.state))


def test_predict_motion_at_dims_48(jax_research48):
    """The predict stage's vectors from the JAX package's loaded clip: the
    same up to near-ties."""
    snap = jax_research48
    st = state_from_numpy(snap, "cpu")
    st.tilemap = copy.deepcopy(snap.tilemap)
    from tiler_tpu_torch.pipeline import predict as t_predict

    t_predict.predict_motion(st, EncoderSettings(**RESEARCH48))
    tm, jm = st.tilemap, snap.tilemap
    same = (tm.pred_y == jm.pred_y) & (tm.pred_x == jm.pred_x)
    tie = (tm.psnr >= 51.0) & (jm.psnr >= 51.0)
    assert (same | tie).mean() >= 0.99, (same.mean(), (same | tie).mean())
    # the exact errors within 1e-5 relative: 10 log10(1 + 1e-5) dB < 1e-4 dB
    np.testing.assert_allclose(tm.psnr[same], jm.psnr[same], rtol=0, atol=1e-4)


def test_phase_b_research_at_dims_48(jax_research48):
    """One keyframe through phase B's re-search at dims 48 in both
    packages, on the same phase-A results: the re-searched vectors, the
    prediction decisions, the cells' errors (ties as above)."""
    snap = jax_research48
    settings = EncoderSettings(**RESEARCH48)
    kt, kp, ke = t_reconstruct._knn_phase(state_from_numpy(snap, "cpu"), settings, {})
    tm = snap.tilemap
    args = (np.array(snap.frames_rgb), kt.int().numpy(), kp.int().numpy(), ke.numpy(),
            tm.hmirror, tm.vmirror, tm.pred_y.astype(np.int32), tm.pred_x.astype(np.int32))
    pp, pal = np.array(snap.corpus_pal_pixels), np.array(snap.palettes_rgb)
    kf_start = np.arange(len(CLIP)) == 0
    th, tw = snap.tilemap_h, snap.tilemap_w
    with jax.enable_x64(False):
        want = j_reconstruct._phase_b_scan(
            *(jnp.asarray(a) for a in args[:6]), jnp.asarray(kf_start),
            *(jnp.asarray(a) for a in args[6:]), jnp.asarray(pp), jnp.asarray(pal),
            4, th, tw, False, 48, "research")
        want = [np.asarray(a) for a in want]
    stats = {}
    got = t_reconstruct._phase_b_keyframe(
        *(torch.from_numpy(a) for a in args), torch.from_numpy(pp),
        torch.from_numpy(pal).long(), 4, th, tw, "research", False, "passes", stats,
        rank_dims=48)
    got = [a.numpy() for a in got]
    assert stats["phase_b_searches"] == len(CLIP) - 1
    same = (got[0] == want[0]) & (got[1] == want[1])
    tie = (euclidean_to_psnr(torch.from_numpy(got[3])).numpy() >= 51.0) & (
        euclidean_to_psnr(torch.from_numpy(want[3].copy())).numpy() >= 51.0)
    assert (same | tie).mean() >= 0.99, (same.mean(), (same | tie).mean())
    assert (got[2] == want[2]).mean() >= 0.99
    # f32 sums in another order; an exact 0 may come out as a few 1e-8
    np.testing.assert_allclose(got[3][same], want[3][same], rtol=1e-5, atol=1e-3)
    assert got[2][1:].any()  # cells after the first frame predict


def _psnr_rgb(path, clip):
    frames = np.stack(GTMDecoder(str(path)).decode_frames())[..., :3]
    assert frames.shape == clip.shape
    mse = np.mean((frames.astype(np.float64) - clip) ** 2)
    return 10 * np.log10(255 * 255 / max(mse, 1e-9))


@pytest.mark.parametrize("overrides", [dict(motion_rank_dims=48),
                                       dict(motion_rank_dims=27, motion_field="im2row")],
                         ids=["rank48", "rank27_im2row"])
def test_rank_dims_encode_within_the_determinism_gate(overrides, tmp_path):
    jpath, tpath = tmp_path / "jax.gtm", tmp_path / "torch.gtm"
    with jax.enable_x64(False):
        jenc = JaxEncoder(JaxSettings(**SMALL, **overrides), log=None)
        jenc.run_all(CLIP, fps=FPS, out_path=str(jpath))
    enc = Encoder(EncoderSettings(**SMALL, **overrides), log=None, device="cpu")
    enc.run_all(CLIP, fps=FPS, out_path=str(tpath))
    assert abs(_psnr_rgb(tpath, CLIP) - _psnr_rgb(jpath, CLIP)) <= 0.1
    jbytes = jenc.stats.total_bytes
    assert abs(enc.stats.total_bytes - jbytes) <= 0.02 * jbytes
