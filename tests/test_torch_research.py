"""The reference-parity settings of phase B and the features against
tiler_tpu: ``phase_b_motion="research"`` (a full motion search against
the reconstruction in every frame but a keyframe's first) and
``int16_features`` (features rounded at every exact-error site), and the
target-PSNR reduce.

Each stage runs from the JAX package's snapshot before it, both packages
with the same settings (docs/DETERMINISM.md's gate end to end). On a host
whose XLA computes as the port's CPU path assumes, every vector, error
and stream equals the JAX package's (but the im2row re-search, which the
JAX package's phase B does not run). Elsewhere motion vectors that differ
count as agreeing where they tie (ROADMAP C5): the two exact errors are
equal up to the rounding of the features.
"""
import copy
import dataclasses
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import synthetic_clip
from tiler_tpu.bitstream.gtm import GTMDecoder
from tiler_tpu.config import EncoderSettings
from tiler_tpu.pipeline import motion as j_motion
from tiler_tpu.pipeline import reconstruct as j_reconstruct
from tiler_tpu.pipeline.encoder import Encoder as JaxEncoder
from tiler_tpu_torch.models.convert import state_from_numpy, state_to_numpy
from tiler_tpu_torch.pipeline import motion as t_motion
from tiler_tpu_torch.pipeline import reconstruct as t_reconstruct
from tiler_tpu_torch.pipeline.encoder import Encoder

CLIP = synthetic_clip(6, 64, 96, seed=0)
FPS = 25.0
SMALL = dict(palette_count=8, motion_predict_radius=4, epu_knn_k=8, kmeans_iters=4)
RESEARCH = dict(SMALL, phase_b_motion="research", int16_features=True)


def _rounding_tie(a, b):
    """Two exact int16 errors equal up to a flip of the rounding of two of
    the 192 features (each moves a squared term d^2 by 2|d| + 1), plus
    float32 sums in another order."""
    return np.abs(a - b) <= 1e-5 * np.abs(b) + 4 * np.sqrt(np.abs(b)) + 2


def _psnr_rgb(path, clip):
    frames = np.stack(GTMDecoder(str(path)).decode_frames())[..., :3]
    assert frames.shape == clip.shape
    mse = np.mean((frames.astype(np.float64) - clip) ** 2)
    return 10 * np.log10(255 * 255 / max(mse, 1e-9))


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _sha256(path):
    return hashlib.sha256(open(path, "rb").read()).hexdigest()


@pytest.fixture(scope="module")
def xla_rec_bits():
    """Whether the host's XLA computes as the port's CPU encode assumes
    (tests/test_torch_reconstruct_order.py's probes)."""
    from test_torch_reconstruct_order import reconstruct_order_skip_reason
    return reconstruct_order_skip_reason() is None


@pytest.fixture(scope="module")
def jax_research(tmp_path_factory):
    """The JAX encode with research and int16: its state after dither
    (numpy) and its stream."""
    out = tmp_path_factory.mktemp("research") / "jax.gtm"
    with jax.enable_x64(False):
        enc = JaxEncoder(EncoderSettings(**RESEARCH), log=None)
        enc.load_frames(CLIP, FPS).predict_motion().reduce().prepare_palettes().dither()
        snap = state_to_numpy(copy.copy(enc.state))
        enc.reconstruct().reindex().save(str(out))
    return snap, out, enc.stats.total_bytes


@pytest.mark.parametrize("field", ["passes", "im2row"])
def test_motion_search_int16_with_windows(field, xla_rec_bits):
    """Frame 3 against a float32 stand-in for the reconstruction of frame
    2, radius 8 (the scroll of 3, 5 pixels a frame lies inside): equal on
    an XLA-order host, else within the rounding ties."""
    rng = np.random.default_rng(0)
    back = (CLIP[2] + rng.normal(0, 3, CLIP[2].shape)).astype(np.float32)
    with jax.enable_x64(False):
        want = [np.asarray(a) for a in j_motion._motion_core(
            jnp.asarray(CLIP[3].astype(np.float32)), jnp.asarray(back), 8, True, 192,
            return_windows=True, field_impl=field)]
    got = [a.numpy() for a in t_motion.motion_search(
        torch.from_numpy(CLIP[3]), torch.from_numpy(back), 8, field_impl=field, int16=True,
        return_windows=True)]
    if xla_rec_bits:
        assert all(np.array_equal(_bits(g), _bits(w)) for g, w in zip(got, want))
    same = (got[0] == want[0]) & (got[1] == want[1])
    tie = _rounding_tie(got[2], want[2])
    assert (same | tie).mean() >= 0.99, (same.mean(), (same | tie).mean())
    assert _rounding_tie(got[2], want[2])[same].all()
    # the winners' window pixels: the same gather of the same frame
    flat = same.reshape(-1)
    assert got[3].shape == want[3].shape == (flat.size, 8, 8, 3)
    assert np.array_equal(got[3][flat], want[3][flat])


def test_phase_a_int16_against_the_snapshot(jax_research, xla_rec_bits):
    """Phase A from the JAX state after dither, int16 on both sides: the
    same (tile, palette) winners and exact error bits on an XLA-order
    host; elsewhere >= 99% of the winners, and where they agree the same
    exact error up to feature rounding."""
    snap = jax_research[0]
    settings = EncoderSettings(**RESEARCH)
    with jax.enable_x64(False):
        jt, jp, je, _ = j_reconstruct._knn_phase(copy.copy(snap), settings)
        jt, jp, je = (np.asarray(a) for a in (jt, jp, je))
    stats = {}
    t, p, e = (a.numpy() for a in t_reconstruct._knn_phase(
        state_from_numpy(snap, "cpu"), settings, stats))
    assert stats["knn_kernel_cells"] == 0  # no top-k kernel on the CPU
    if xla_rec_bits:
        assert np.array_equal(t, jt) and np.array_equal(p, jp)
        assert np.array_equal(_bits(e), _bits(je))
    same = (t == jt) & (p == jp)
    assert same.mean() >= 0.99, same.mean()
    assert _rounding_tie(e, je)[same].all()


@pytest.mark.parametrize("field", ["passes", "im2row"])
def test_phase_b_research_one_keyframe(jax_research, field, xla_rec_bits):
    """One keyframe through phase B in research mode in both packages, on
    the same phase-A results: the re-searched vectors, the prediction
    decisions and the cells' errors, bit for bit with the passes field on
    an XLA-order host. The port's re-search takes the settings' window
    field (im2row runs blockify_field inside reconstruct); the JAX
    package's phase B always builds the passes field, which ranks the same
    up to float32 summation order."""
    snap = jax_research[0]
    settings = EncoderSettings(**RESEARCH)
    st = state_from_numpy(snap, "cpu")
    kt, kp, ke = t_reconstruct._knn_phase(st, settings, {})
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
            4, th, tw, True, 192, "research")
        want = [np.asarray(a) for a in want]
    stats = {}
    got = t_reconstruct._phase_b_keyframe(
        *(torch.from_numpy(a) for a in args), torch.from_numpy(pp),
        torch.from_numpy(pal).long(), 4, th, tw, "research", True, field, stats)
    got = [a.numpy() for a in got]
    assert stats["phase_b_searches"] == len(CLIP) - 1
    if xla_rec_bits and field == "passes":
        assert all(np.array_equal(_bits(g), _bits(w)) for g, w in zip(got, want))
    same = (got[0] == want[0]) & (got[1] == want[1])
    tie = _rounding_tie(got[3], want[3])
    assert (same | tie).mean() >= 0.99, (same.mean(), (same | tie).mean())
    assert (got[2] == want[2]).mean() >= 0.99
    assert tie[same].all()
    assert got[2][1:].any()  # cells after the first frame predict


def test_research_int16_run_all_within_the_determinism_gate(jax_research, tmp_path,
                                                           xla_rec_bits):
    _, jpath, jbytes = jax_research
    out = tmp_path / "torch.gtm"
    enc = Encoder(EncoderSettings(**RESEARCH), log=None, device="cpu")
    enc.run_all(CLIP, fps=FPS, out_path=str(out))
    assert enc.step_stats["phase_b_searches"] == len(CLIP) - len(enc.state.keyframes)
    if xla_rec_bits:
        assert _sha256(out) == _sha256(jpath)
    assert abs(_psnr_rgb(out, CLIP) - _psnr_rgb(jpath, CLIP)) <= 0.1
    assert abs(enc.stats.total_bytes - jbytes) <= 0.02 * jbytes


@pytest.mark.parametrize("target", [30.0])
def test_target_psnr_run_all_within_the_determinism_gate(target, tmp_path, xla_rec_bits):
    """GlobalTilingUseTargetPSNR: reduce thresholds the motion PSNRs at the
    target itself (tilingencoder.pas:1915-1918) in both packages; the same
    stream on an XLA-order host."""
    settings = dataclasses.replace(EncoderSettings(**SMALL), global_tiling_use_target_psnr=True,
                                   global_tiling_target_psnr=target)
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
        results[name] = (_psnr_rgb(out, clip), enc.stats.total_bytes,
                         len(enc.state.corpus_pal_pixels))
    if xla_rec_bits:
        assert _sha256(tmp_path / "torch.gtm") == _sha256(tmp_path / "jax.gtm")
    assert abs(results["torch"][0] - results["jax"][0]) <= 0.1, results
    assert abs(results["torch"][1] - results["jax"][1]) <= 0.02 * results["jax"][1], results
