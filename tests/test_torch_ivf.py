"""``knn_backend="ivf"`` against tiler_tpu's pipeline/ivf.py and its phase A.

- The layout: given the JAX package's k-means assignment, the block
  member ids, member features and +inf pattern are bit-identical; the
  means are within one bf16 ulp and the norms within 1e-6 relative (f32
  sums over a block's members and a feature's 192 squares in another
  order).
- The k-means: the port's assignment of the same corpus agrees with the
  JAX package's on >= 97% of the tiles (99.1% measured; bf16-ranked
  Lloyd steps can tip a boundary tile).
- ivf_topk on the same layout: ids equal on >= 98% of the entries, and
  every ranking distance within one bf16 ulp of the JAX package's plus
  2^-18 of the largest |f|^2 (the distances round to bf16 after f32 sums
  in another order, whose terms cancel), also where a hot block overflows
  its capacity and the p-major order drops probes; ivf_probe_overflow
  equal.
- Phase A feeds the IVF the JAX package's rows of 8,192 cells, padded
  with the row's last cell, and sends the cheap k = 1 pass through it too.
- The ivf_min_corpus=1 encode of tests/test_ivf.py's clip within 0.1 dB
  RGB-PSNR and 2% bytes of the JAX package's (docs/DETERMINISM.md).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import synthetic_clip
from tiler_tpu.bitstream.gtm import GTMDecoder
from tiler_tpu.cluster.kmeans import kmeans as j_kmeans
from tiler_tpu.config import EncoderSettings as JaxSettings
from tiler_tpu.pipeline import ivf as j_ivf
from tiler_tpu.pipeline import reconstruct as j_reconstruct
from tiler_tpu.pipeline.encoder import Encoder as JaxEncoder
from tiler_tpu_torch.cluster.kmeans import kmeans as t_kmeans
from tiler_tpu_torch.config import EncoderSettings
from tiler_tpu_torch.models.convert import state_from_numpy, state_to_numpy
from tiler_tpu_torch.pipeline import ivf as t_ivf
from tiler_tpu_torch.pipeline import reconstruct as t_reconstruct
from tiler_tpu_torch.pipeline.encoder import Encoder

torch.set_num_threads(1)  # many small tensor passes: workers share the host

M = 64


def _corpus(T=4096, D=192, n_clusters=40, seed=3):
    """tests/test_ivf.py's clustered corpus."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(n_clusters, D).astype(np.float32) * 20
    return centers[rng.randint(0, n_clusters, T)] + rng.randn(T, D).astype(np.float32)


@pytest.fixture(scope="module")
def layouts():
    """The JAX package's IVF of the corpus, its assignment, and the port's
    layout from that assignment."""
    ds = _corpus()
    k = t_ivf.ivf_clusters(len(ds), M)
    with jax.enable_x64(False):
        jst = j_ivf.build_ivf(jnp.asarray(ds), block_size=M)
        _, assign, _ = j_kmeans(jnp.asarray(ds), k, iters=6, seed=t_ivf.IVF_SEED)
        assign = np.asarray(assign)
    return ds, assign, jst, t_ivf.ivf_layout(torch.from_numpy(ds), assign, M)


def _np(x):
    return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()


def _bf16_ulp(a, b):
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(a), np.abs(b)) + 1e-30)) - 7)


def test_layout_bit_identical_given_the_assignment(layouts):
    _, _, jst, got = layouts
    want = {f: np.asarray(getattr(jst, f)).astype(np.float32) if f != "gid_blk"
            else np.asarray(jst.gid_blk) for f in jst._fields}
    assert got.n_blocks == jst.n_blocks and got.block_size == jst.block_size == M
    assert got.gid_blk.dtype == torch.int32
    assert np.array_equal(got.gid_blk.numpy(), want["gid_blk"])
    assert np.array_equal(_np(got.ds_blk), want["ds_blk"])
    for f in ("d2_blk", "bm2"):
        g = _np(getattr(got, f))
        assert np.array_equal(np.isinf(g), np.isinf(want[f])), f
        fin = np.isfinite(g)
        np.testing.assert_allclose(g[fin], want[f][fin], rtol=1e-6)
    g, w = _np(got.block_means), want["block_means"]
    assert np.all(np.abs(g - w) <= _bf16_ulp(g, w))


def test_kmeans_assignment_agreement(layouts):
    ds, assign, _, _ = layouts
    _, mine, _ = t_kmeans(torch.from_numpy(ds), t_ivf.ivf_clusters(len(ds), M), iters=6,
                          seed=t_ivf.IVF_SEED)
    agree = float((mine.numpy() == assign).mean())
    assert agree >= 0.97, agree
    # build_ivf is that k-means and the layout of its assignment
    built = t_ivf.build_ivf(torch.from_numpy(ds), block_size=M)
    assert torch.equal(built.gid_blk, t_ivf.ivf_layout(torch.from_numpy(ds), mine, M).gid_blk)


def _queries(ds, case):
    rng = np.random.RandomState(7)
    if case == "clustered":
        return ds[rng.randint(0, len(ds), 512)] + 0.5
    # every query near one tile: its cluster's blocks draw all 512 cells'
    # probes, over the capacity (474 cells here), so the p-major order drops
    return ds[rng.randint(0, 1, 512)] + rng.randn(512, ds.shape[1]).astype(np.float32)


@pytest.mark.parametrize("case", ["clustered", "hot_block"])
@pytest.mark.parametrize("kk", [1, 16])
def test_ivf_topk_matches_jax(layouts, case, kk):
    ds, _, jst, got = layouts
    q = _queries(ds, case)
    with jax.enable_x64(False):
        jidx, jerr = (np.asarray(a) for a in j_ivf.ivf_topk(jnp.asarray(q), jst, kk, probes=8))
        jover = j_ivf.ivf_probe_overflow(jnp.asarray(q), jst, probes=8)
    idx, err, dropped = t_ivf.ivf_search(torch.from_numpy(q), got, kk, probes=8)
    over = t_ivf.ivf_probe_overflow(torch.from_numpy(q), got, probes=8)
    assert over == jover
    assert dropped.shape == (len(q),) and int(dropped.sum()) == round(over * len(q) * 8)
    if case == "hot_block":
        assert over > 0.05  # the capacity does drop (6.5% of the probes)
    idx, err = idx.numpy(), err.numpy()
    assert idx.shape == jidx.shape == (len(q), kk) and idx.dtype == np.int32
    assert (idx == jidx).mean() >= 0.98, (idx == jidx).mean()
    # one bf16 ulp, plus the f32 rounding of |f|^2 + |t|^2 - 2 f.t, whose
    # terms (~1e5) cancel to distances near 0: 2^-18 of the largest |f|^2
    scale = 2.0 ** -18 * float((q * q).sum(1).max())
    assert np.all(np.abs(err - jerr) <= _bf16_ulp(err, jerr) + scale)
    assert np.all(np.diff(err, axis=1) >= 0)
    assert np.array_equal(t_ivf.ivf_topk(torch.from_numpy(q), got, kk)[0].numpy(), idx)


def test_bucket_and_capacity_match_jax():
    for n in (0, 1, 2, 5, 100, 1000, 123456):
        assert t_ivf._bucket(n) == j_ivf._bucket(n)
    assert t_ivf._capacity(8192, 934, 8, 0) == max(128, j_ivf._bucket(int(8192 * 8 / 934 * 8)))


SMALL = dict(palette_count=8, motion_predict_radius=4, epu_knn_k=8, kmeans_iters=4,
             knn_backend="ivf", ivf_min_corpus=1)


def test_phase_a_feeds_the_ivf_padded_rows(monkeypatch):
    """Every IVF call gets a full row of CELL_ROW cells (the last one padded
    with its last cell), the full pass at kk and the cheap pass at 1, and
    phase A's winners agree with the JAX package's from its snapshot."""
    clip = synthetic_clip(6, 64, 96, seed=0)
    settings = JaxSettings(**SMALL)
    with jax.enable_x64(False):
        enc = JaxEncoder(settings, log=None)
        enc.load_frames(clip, 25.0).predict_motion().reduce().prepare_palettes().dither()
        snap = state_to_numpy(copy.copy(enc.state))
        jt, jp, _, _ = j_reconstruct._knn_phase(copy.copy(snap), settings)
        jt, jp = np.asarray(jt), np.asarray(jp)
    calls = []
    search = t_ivf.ivf_search

    def spy(feats, ivf, kk, probes=8, cap=0):
        calls.append((feats.shape[0], kk))
        return search(feats, ivf, kk, probes, cap)

    monkeypatch.setattr(t_reconstruct, "ivf_search", spy)
    stats = {}
    t, p, e = t_reconstruct._knn_phase(state_from_numpy(snap, "cpu"), EncoderSettings(**SMALL),
                                       stats)
    assert stats["ivf_blocks"] > 0 and stats["ivf_overflow"] == 0.0
    assert stats["knn_kernel_cells"] == 0
    assert all(n == t_reconstruct.CELL_ROW for n, _ in calls)
    assert [kk for _, kk in calls] == [8, 1]  # the full pass, then the cheap one
    same = (t.numpy() == jt) & (p.numpy() == jp)
    assert same.mean() >= 0.97, same.mean()
    assert np.isfinite(e.numpy()).all()


def _psnr_rgb(path, clip):
    frames = np.stack(GTMDecoder(str(path)).decode_frames())[..., :3]
    assert frames.shape == clip.shape
    mse = np.mean((frames.astype(np.float64) - clip) ** 2)
    return 10 * np.log10(255 * 255 / max(mse, 1e-9))


def test_ivf_encode_within_the_determinism_gate(tmp_path):
    """tests/test_ivf.py::test_phase_a_ivf_flag_end_to_end's clip and
    settings, in both packages."""
    rng = np.random.RandomState(0)
    yy, xx = np.mgrid[0:48, 0:64]
    base = np.stack([yy * 4, xx * 3, (yy + xx) * 2], -1).astype(np.uint8)
    clip = np.stack([np.roll(base + rng.randint(0, 9, base.shape, dtype=np.uint8),
                             (2 * f, 3 * f), (0, 1)) for f in range(5)])
    kw = dict(palette_count=8, palette_size=16, motion_predict_radius=4, epu_knn_k=8,
              global_tiling_quality_based_tile_count=4.0, kmeans_iters=4, knn_backend="ivf",
              ivf_min_corpus=1)
    jpath, tpath = tmp_path / "jax.gtm", tmp_path / "torch.gtm"
    with jax.enable_x64(False):
        jenc = JaxEncoder(JaxSettings(**kw), log=None)
        jenc.run_all(clip, fps=25.0, out_path=str(jpath))
    enc = Encoder(EncoderSettings(**kw), log=None, device="cpu")
    enc.run_all(clip, fps=25.0, out_path=str(tpath))
    assert enc.step_stats["ivf_blocks"] > 0  # the IVF searched
    assert abs(_psnr_rgb(tpath, clip) - _psnr_rgb(jpath, clip)) <= 0.1
    jbytes = jenc.stats.total_bytes
    assert abs(enc.stats.total_bytes - jbytes) <= 0.02 * jbytes
