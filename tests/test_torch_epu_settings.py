"""The EPU's two table settings of tiler_tpu_torch against tiler_tpu:
``epu_two_stage`` (int8 low-frequency G and int16 Q rank every pair, the
top ``epu_stage1_m`` are re-ranked by their exact errors) and
``epu_fused_fp`` (G's bf16 and Q's f32 rows in one byte row, one gather).
The JAX side runs with 64-bit mode off, as in production; tests/
test_epu_oracle.py holds the JAX functions to their own oracle.

Tolerances, each with its reason:
- the two-stage tables: G8lf and g_inv equal (rounded from equal f32
  values); Q16 equal but for +-1 on at most 0.1% of its entries, and
  q_inv within 1 ulp (the f32 sums of Q's products run in another order,
  which moves a value across a rounding boundary now and then);
- the two-stage rank on the same tables: the same (tile, palette) on at
  least 99% of the cells (stage 1 ranks on f32 sums in another order, so a
  near-tie at the M-th survivor may let another pair through), and where
  the pair agrees its exact error within 1e-5 relative;
- the fused table: its views equal G and Q bit for bit, and the rank on
  it equals the default's exactly (the same values in the same products);
- the encodes: two-stage within docs/DETERMINISM.md's gate of the JAX
  encode (0.1 dB RGB-PSNR, 2% bytes); fused the port's default stream to
  the byte, once written under the default's settings text (the stream
  embeds its settings, and EpuFusedFp is one of them).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import synthetic_clip
from tiler_tpu.bitstream.gtm import GTMDecoder
from tiler_tpu.config import EncoderSettings as JaxSettings
from tiler_tpu.ops.color import rgb_to_yuv as j_rgb_to_yuv
from tiler_tpu.pipeline import reconstruct as j_rec
from tiler_tpu.pipeline.encoder import Encoder as JaxEncoder
from tiler_tpu.pipeline.motion import tile_features_raster as j_features
from tiler_tpu_torch.config import EncoderSettings
from tiler_tpu_torch.pipeline import reconstruct as t_rec
from tiler_tpu_torch.pipeline.encoder import Encoder

DIMS = 48  # the default epu_stage1_dims: the 4 x 4 low-frequency block
FPS = 25.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors in many steps: one intra-op thread each, so that the
    suite's parallel workers do not oversubscribe the cores (restored
    after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _corpus(T, S, seed):
    return np.random.default_rng(seed).integers(0, S, (T, 8, 8)).astype(np.uint8)


@pytest.mark.parametrize("S", [16, 40])
def test_two_stage_tables_match_jax(S):
    pp = _corpus(300, S, S)
    with jax.enable_x64(False):
        want = [np.asarray(a) for a in j_rec._build_two_stage_tables(
            j_rec._indicator_dcts(pp, S), S, DIMS)]
    got = [a.numpy() for a in t_rec._build_two_stage_tables(torch.from_numpy(pp), S, DIMS)]
    G8lf, g_inv, Q16, q_inv = got
    assert G8lf.dtype == np.int8 and Q16.dtype == np.int16
    assert G8lf.shape == (300, DIMS // 3, S) and Q16.shape == (300, 3 * S * (S + 1) // 2)
    np.testing.assert_array_equal(G8lf, want[0])
    np.testing.assert_array_equal(g_inv, want[1])
    diff = np.abs(Q16.astype(np.int32) - want[2])
    assert diff.max() <= 1 and np.mean(diff != 0) <= 1e-3
    np.testing.assert_array_max_ulp(q_inv, want[3], maxulp=1)


def _rank_case(S, seed, B=64, kk=8, kp=8, T=64, P=16):
    """Cells that are corpus tiles through palettes plus noise, and sorted
    candidate tiles and palettes (tests/test_epu_oracle.py's shapes)."""
    rng = np.random.RandomState(seed)
    pp = rng.randint(0, S, (T, 8, 8)).astype(np.uint8)
    palettes = rng.randint(0, 256, (P, S, 3)).astype(np.uint8)
    cells = np.stack([np.clip(palettes[rng.randint(P)][pp[rng.randint(T)]].astype(np.int32)
                              + rng.randint(-6, 7, (8, 8, 3)), 0, 255) for _ in range(B)])
    cand_idx = np.sort(rng.randint(0, T, (B, kk)).astype(np.int32), axis=1)
    cand_pal = np.sort(rng.randint(0, P, (B, kp)).astype(np.int32), axis=1)
    with jax.enable_x64(False):
        feats = np.asarray(j_features(jnp.asarray(cells.astype(np.float32))))
        pal_yuv = np.asarray(j_rgb_to_yuv(jnp.asarray(palettes, jnp.float32)))
    return feats, cand_idx, cand_pal, pal_yuv, pp, palettes


@pytest.mark.parametrize("S", [16, 40])
def test_two_stage_rank_matches_jax(S):
    """Both rank functions on the JAX package's tables and inputs."""
    feats, cand_idx, cand_pal, pal_yuv, pp, palettes = _rank_case(S, 3 + S)
    with jax.enable_x64(False):
        tables = j_rec._build_two_stage_tables(j_rec._indicator_dcts(pp, S), S, DIMS)
        jt, jp, je = (np.asarray(a) for a in j_rec._epu_rank_two_stage(
            jnp.asarray(feats), jnp.asarray(cand_idx), jnp.asarray(cand_pal), *tables,
            jnp.asarray(pal_yuv), jnp.asarray(pp), jnp.asarray(palettes), S, dims=DIMS,
            M=16, cell_chunk=16))
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    tt, tp, te = (a.numpy() for a in t_rec._epu_rank_two_stage(
        t(feats), t(cand_idx), t(cand_pal), *map(t, tables), t(pal_yuv), t(pp),
        t(palettes), S, DIMS, 16, 16))
    same = (tt == jt) & (tp == jp)
    assert same.mean() >= 0.99, f"(tile, palette) agreement {same.mean():.2%}"
    np.testing.assert_allclose(te[same], je[same], rtol=1e-5)
    # the returned error is the exact error of the returned pair
    exact = t_rec._exact_choice_err(t(feats), t(tt), t(tp), t(pp), t(palettes)).numpy()
    np.testing.assert_array_equal(te, exact)


@pytest.mark.parametrize("S", [16, 40])
def test_fused_table_is_the_default_tables(S):
    """The fused table's views are G and Q bit for bit, at a corpus of
    several chunks of tiles (QUAD_CHUNK shrunk), and the rank on it (one
    gather) is the default's exactly."""
    feats, cand_idx, cand_pal, pal_yuv, pp, palettes = _rank_case(S, 13 + S)
    ppt = torch.from_numpy(pp)
    quad_chunk = t_rec.QUAD_CHUNK
    t_rec.QUAD_CHUNK = 20 * S * S  # chunks of 20 tiles, the last one ragged
    try:
        G, Q = t_rec._epu_tables(ppt, S)
        table, none = t_rec._epu_tables(ppt, S, fused=True)
    finally:
        t_rec.QUAD_CHUNK = quad_chunk
    assert none is None and table.dtype == torch.uint8
    assert table.shape == (len(pp), 64 * S * 2 + 4 * Q.shape[1])
    Gv, Qv = t_rec._fused_views(table, S)
    assert torch.equal(Gv.view(torch.int16), G.reshape(len(pp), -1).view(torch.int16))
    assert torch.equal(Qv.view(torch.int32), Q.view(torch.int32))
    with jax.enable_x64(False):  # and G is the JAX package's bf16 G
        jG = np.asarray(j_rec._indicator_dcts(pp, S).astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(G.float().numpy(), jG)
    args = [torch.from_numpy(np.array(a)) for a in (feats, cand_idx, cand_pal)]
    pal_yuv = torch.from_numpy(np.array(pal_yuv))
    want = t_rec._epu_rank_all(*args, G, Q, pal_yuv, S, 16)
    got = t_rec._epu_rank_all(*args, table, None, pal_yuv, S, 16)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def _settings(**kw):
    return dict(palette_count=8, motion_predict_radius=4, epu_knn_k=8, kmeans_iters=3,
                global_tiling_quality_based_tile_count=4.0, **kw)


CLIP = synthetic_clip(4, 48, 64, seed=2)


def _psnr_rgb(path):
    frames = np.stack(GTMDecoder(str(path)).decode_frames())[..., :3]
    assert frames.shape == CLIP.shape
    mse = np.mean((frames.astype(np.float64) - CLIP) ** 2)
    return 10 * np.log10(255 * 255 / max(mse, 1e-9))


def test_run_all_two_stage_within_the_determinism_gate(tmp_path):
    settings = _settings(epu_two_stage=True, epu_stage1_m=8)
    with jax.enable_x64(False):
        jenc = JaxEncoder(JaxSettings(**settings), log=None)
        jenc.run_all(CLIP, fps=FPS, out_path=str(tmp_path / "jax.gtm"))
    enc = Encoder(EncoderSettings(**settings), log=None, device="cpu")
    enc.run_all(CLIP, fps=FPS, out_path=str(tmp_path / "torch.gtm"))
    assert abs(_psnr_rgb(tmp_path / "torch.gtm") - _psnr_rgb(tmp_path / "jax.gtm")) <= 0.1
    jbytes = jenc.stats.total_bytes
    assert abs(enc.stats.total_bytes - jbytes) <= 0.02 * jbytes


def test_fused_fp_writes_the_default_stream(tmp_path):
    streams = {}
    for fused in (False, True):
        enc = Encoder(EncoderSettings(**_settings(epu_fused_fp=fused)), log=None, device="cpu")
        enc.run_all(CLIP, fps=FPS, out_path=str(tmp_path / f"{fused}.gtm"))
        if fused:  # the same state under the default's settings text
            enc.settings = dataclasses.replace(enc.settings, epu_fused_fp=False)
            enc.save(str(tmp_path / "resaved.gtm"))
        streams[fused] = enc.state.total_psnr
    assert streams[True] == streams[False]
    assert (tmp_path / "resaved.gtm").read_bytes() == (tmp_path / "False.gtm").read_bytes()
    assert (tmp_path / "True.gtm").read_bytes() != (tmp_path / "False.gtm").read_bytes()
