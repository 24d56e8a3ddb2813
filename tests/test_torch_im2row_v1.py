"""The im2row window field with the blockify kernel, and the v1 corpus
top-k, against tiler_tpu (Pallas kernels in interpret mode, as the JAX
package's own tests run them on the CPU).

- blockify: pure data movement, bit-identical.
- v1 top-k: the plain version ranks on f32 sums of exact bf16 products
  in another order than the JAX kernel, so k=1 indices are equal, and the
  decoded keys are identical on >= 95% of entries and within 2^-12
  relative (a few key steps) elsewhere.
- im2row field: the f32 product sums in another order than XLA's einsum,
  so the bf16 field is within one bf16 ulp, the +inf masks are equal and
  the finite norms agree to 1e-5 relative.
- im2row motion: vectors agree except on near-ties (ROADMAP C5), counted
  as in test_torch_stages.py::test_predict_motion_vectors.
- end to end with motion_field="im2row", knn_backend="pallas_v1": port
  against JAX within 0.1 dB RGB-PSNR and 2% bytes. On the CPU neither
  package launches its v1 kernel (both gate it to an accelerator), so
  this holds the im2row path and the settings' plumbing; the v1 kernel
  itself is held against its plain version on the card
  (test_torch_cuda.py, chip_smoke.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import synthetic_clip
from tiler_tpu.bitstream.gtm import GTMDecoder
from tiler_tpu.config import EncoderSettings as JaxSettings
from tiler_tpu.kernels import blockify as j_blk
from tiler_tpu.kernels import knn_topk as j_knn
from tiler_tpu.pipeline import motion as j_motion
from tiler_tpu.pipeline.encoder import Encoder as JaxEncoder
from tiler_tpu_torch.config import EncoderSettings
from tiler_tpu_torch.kernels import blockify as t_blk
from tiler_tpu_torch.kernels import knn_topk as t_knn
from tiler_tpu_torch.ops.metrics import euclidean_to_psnr
from tiler_tpu_torch.pipeline import motion as t_motion
from tiler_tpu_torch.pipeline.encoder import Encoder


def _bf16_pair(shape, seed):
    """The same bf16 values as a torch tensor and a jax array."""
    x = torch.as_tensor(np.random.default_rng(seed).normal(0, 100, shape).astype(np.float32))
    t = x.to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy(), jnp.bfloat16)


# (HP, WP, K): mh x mw blocks; mw = 3 and 7 are not powers of two
@pytest.mark.parametrize("HP,WP,K", [(16, 24, 192), (40, 56, 64)])
def test_blockify_plain_matches_pallas(HP, WP, K):
    t, j = _bf16_pair((HP, WP, K), HP + WP)
    with jax.enable_x64(False):
        want = np.asarray(j_blk.blockify_field(j)).view(np.uint16)
    got = t_blk.blockify_field(t)
    assert got.shape == (HP // 8, WP // 8, 64, K)
    assert np.array_equal(got.view(torch.int16).numpy().view(np.uint16), want)


def test_blockify_wrapper_rejects_bad_arguments():
    F = torch.zeros(16, 16, 192, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16"):
        t_blk.blockify_field(F.float())
    with pytest.raises(ValueError, match="multiples of 8"):
        t_blk.blockify_field(F[:12])
    # every depth K >= 1 is taken (runs of eight rows are K 16-byte vectors)
    with pytest.raises(ValueError, match="depth"):
        t_blk.blockify_field(torch.zeros(16, 16, 0, dtype=torch.bfloat16))
    assert t_blk.blockify_field(torch.zeros(16, 16, 12, dtype=torch.bfloat16)).shape == (
        2, 2, 64, 12)
    with pytest.raises(ValueError, match="contiguous"):
        t_blk.blockify_field(F.transpose(0, 1))
    with pytest.raises(ValueError, match="no kernel"):
        t_blk.blockify_field(F.to("meta"))


def _v1_case(N=300, T=5000, Tp=8192, seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.normal(0, 50, (N, 192)).astype(np.float32)
    ds = rng.normal(0, 50, (T, 192)).astype(np.float32)
    return feats, ds, Tp


def _jax_v1_operands(ds, Tp):
    """As tiler_tpu/pipeline/reconstruct.py:443-448 prepares them."""
    T = ds.shape[0]
    dsp = jnp.pad(jnp.asarray(ds), ((0, Tp - T), (0, 0)))
    d2p = jnp.sum(dsp * dsp, axis=1) + jnp.where(jnp.arange(Tp) < T, 0.0, 1e30)
    return dsp.astype(jnp.bfloat16).T, d2p


def test_v1_prep_matches_the_reference_prep():
    feats, ds, Tp = _v1_case()
    with jax.enable_x64(False):
        jdsT, jd2 = _jax_v1_operands(ds, Tp)
        jdsT = np.asarray(jdsT).view(np.uint16)
        jd2 = np.asarray(jd2)
    dsT, d2 = t_knn.knn_prep_v1(torch.from_numpy(ds), Tp)
    assert dsT.shape == (t_knn.KD, Tp) and dsT.is_contiguous()
    assert np.array_equal(dsT.view(torch.int16).numpy().view(np.uint16), jdsT)
    # f32 sums of 192 squares in another order
    np.testing.assert_allclose(d2.numpy(), jd2, rtol=1e-6)
    assert np.all(d2.numpy()[len(ds):] >= 1e30)


@pytest.mark.parametrize("k", [1, 8])
def test_v1_plain_matches_pallas(k):
    feats, ds, Tp = _v1_case(seed=k)
    T = len(ds)
    with jax.enable_x64(False):
        jdsT, jd2 = _jax_v1_operands(ds, Tp)
        jidx, jerr = j_knn.knn_bucket_topk(jnp.asarray(feats), jdsT, jd2, k)
    jidx, jerr = np.asarray(jidx), np.asarray(jerr)
    dsT, d2 = t_knn.knn_prep_v1(torch.from_numpy(ds), Tp)
    idx, err = t_knn.knn_bucket_topk(torch.from_numpy(feats), dsT, d2, k)
    idx, err = idx.numpy(), err.numpy()
    assert idx.shape == jidx.shape == (len(feats), k)
    assert idx.max() < T  # padded corpus columns never rank
    assert np.all(np.diff(err, axis=1) >= 0)
    same = err == jerr
    assert same.mean() >= 0.95, same.mean()
    np.testing.assert_allclose(err, jerr, rtol=2.0 ** -12)
    if k == 1:
        assert np.array_equal(idx, jidx)
    else:
        assert (idx == jidx)[same].mean() >= 0.95


def test_v1_sortable_orders_signed_floats():
    x = torch.tensor([-3e5, -1.5, -0.0, 0.0, 2e-30, 1.0, 7e4, 1e30])
    key = t_knn.sortable(x.view(torch.int32))
    assert torch.equal(torch.argsort(key, stable=True), torch.arange(len(x)))
    assert torch.equal(t_knn.sortable(key).view(torch.float32), x)  # an involution


def test_v1_wrapper_rejects_bad_arguments():
    fb = torch.zeros(64, t_knn.KD, dtype=torch.bfloat16)
    dsT = torch.zeros(t_knn.KD, 512, dtype=torch.bfloat16)
    d2 = torch.zeros(512)
    with pytest.raises(ValueError, match="multiple"):
        t_knn.knn_bucket_top2_v1(fb[:10], dsT, d2)
    with pytest.raises(ValueError, match="bfloat16"):
        t_knn.knn_bucket_top2_v1(fb.float(), dsT, d2)
    with pytest.raises(ValueError, match="float32"):
        t_knn.knn_bucket_top2_v1(fb, dsT, d2.double())
    with pytest.raises(ValueError, match="d2 has"):
        t_knn.knn_bucket_top2_v1(fb, dsT, d2[:256])
    with pytest.raises(ValueError, match="depth"):
        t_knn.knn_bucket_top2_v1(torch.zeros(64, 208, dtype=torch.bfloat16), dsT, d2)
    with pytest.raises(ValueError, match="no kernel"):
        t_knn.knn_bucket_top2_v1(fb.to("meta"), dsT.to("meta"), d2.to("meta"))
    with pytest.raises(ValueError, match="outside"):
        t_knn.knn_bucket_topk(torch.zeros(3, 192), dsT, d2, 3)


def _frames(seed=0, F=2, H=48, W=64):
    return synthetic_clip(F, H, W, seed=seed)


@pytest.mark.parametrize("radius", [4, 16])
def test_im2row_field_matches_jax(radius):
    frame = _frames()[0]
    H, W = frame.shape[:2]
    Q = 1
    while Q * 8 < radius:
        Q *= 2
    P = 8 * Q
    mh, mw = -(-(H - 7 + 2 * P) // 8), -(-(W - 7 + 2 * P) // 8)
    mu = np.random.default_rng(radius).normal(0, 20, 192).astype(np.float32)
    with jax.enable_x64(False):
        jF, jN = j_motion._window_field_blocks_im2row(
            jnp.asarray(frame), jnp.asarray(mu), P, mh, mw, 192)
        jF = np.asarray(jF.astype(jnp.float32))
        jN = np.asarray(jN)
    tF, tN = t_motion._window_field_blocks_im2row(
        torch.from_numpy(frame), torch.from_numpy(mu), P, mh, mw)
    tF, tN = tF.float().numpy(), tN.numpy()
    assert tF.shape == jF.shape == (mh, mw, 64, 192)
    # one bf16 ulp of the larger magnitude: a value near a rounding
    # boundary may round either way after f32 sums in another order
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(tF), np.abs(jF)) + 1e-30)) - 7)
    assert np.all(np.abs(tF - jF) <= ulp)
    assert np.array_equal(np.isinf(tN), np.isinf(jN))
    fin = np.isfinite(jN)
    np.testing.assert_allclose(tN[fin], jN[fin], rtol=1e-5)


def test_im2row_field_matches_the_passes_field():
    """The two fields of the port are the same quantity (the JAX package's
    claim for its two): within one bf16 ulp plus the f32 rounding of sums
    whose terms reach the field's scale (the passes field adds its terms
    in another order, and values that cancel to near 0 keep that
    rounding), the same masks."""
    frame = torch.from_numpy(_frames(seed=3)[0])
    mu = torch.zeros(192)
    P, mh, mw = 8, 9, 11
    a, na = t_motion._window_field_blocks(frame, mu, P, mh, mw)
    b, nb = t_motion._window_field_blocks_im2row(frame, mu, P, mh, mw)
    a, b = a.float(), b.float()
    ulp = 2.0 ** (torch.floor(torch.log2(torch.maximum(a.abs(), b.abs()) + 1e-30)) - 7)
    assert bool(((a - b).abs() <= ulp + 2.0 ** -20 * a.abs().max()).all())
    assert torch.equal(torch.isinf(na), torch.isinf(nb))


@pytest.mark.parametrize("seed,radius", [(0, 8), (5, 16)])
def test_im2row_motion_matches_jax(seed, radius):
    clip = _frames(seed=seed, F=2, H=64, W=96)
    with jax.enable_x64(False):
        jy, jx, je = j_motion.motion_search(jnp.asarray(clip[1]), jnp.asarray(clip[0]),
                                            radius, field_impl="im2row")
        jy, jx, je = np.asarray(jy), np.asarray(jx), np.asarray(je)
    ty, tx, te = t_motion.motion_search(torch.from_numpy(clip[1]), torch.from_numpy(clip[0]),
                                        radius, "im2row")
    same = (ty.numpy() == jy) & (tx.numpy() == jx)
    tp = euclidean_to_psnr(te).numpy()
    jp = euclidean_to_psnr(torch.from_numpy(je.copy())).numpy()
    tie = (tp >= 51.0) & (jp >= 51.0)
    assert (same | tie).mean() >= 0.99, (same.mean(), (same | tie).mean())
    np.testing.assert_allclose(te.numpy()[same], je[same], rtol=1e-5)


def test_motion_search_rejects_an_unknown_field():
    f = torch.zeros(16, 16, 3, dtype=torch.uint8)
    with pytest.raises(ValueError, match="field_impl"):
        t_motion.motion_search(f, f, 4, "im2col")


SMALL = dict(palette_count=8, motion_predict_radius=4, epu_knn_k=8, kmeans_iters=4,
             motion_field="im2row", knn_backend="pallas_v1")


def _psnr_rgb(path, clip):
    frames = np.stack(GTMDecoder(str(path)).decode_frames())[..., :3]
    assert frames.shape == clip.shape
    mse = np.mean((frames.astype(np.float64) - clip) ** 2)
    return 10 * np.log10(255 * 255 / max(mse, 1e-9))


def test_im2row_v1_encode_within_the_determinism_gate(tmp_path):
    clip = synthetic_clip(6, 64, 96, seed=0)
    jpath, tpath = tmp_path / "jax.gtm", tmp_path / "torch.gtm"
    with jax.enable_x64(False):
        jenc = JaxEncoder(JaxSettings(**SMALL), log=None)
        jenc.run_all(clip, fps=25.0, out_path=str(jpath))
    enc = Encoder(EncoderSettings(**SMALL), log=None, device="cpu")
    enc.run_all(clip, fps=25.0, out_path=str(tpath))
    assert abs(_psnr_rgb(tpath, clip) - _psnr_rgb(jpath, clip)) <= 0.1
    jbytes = jenc.stats.total_bytes
    assert abs(enc.stats.total_bytes - jbytes) <= 0.02 * jbytes
    # the CPU runs the exact top-k: the v1 kernel's gate needs a card
    assert enc.step_stats["knn_kernel_cells"] == 0
