"""The median-cut quantizer and the wavelet psy-vis mode against
tiler_tpu, and the inverse feature transforms.

- cluster/mediancut.py: the port's copy gives the original's palettes;
- a JAX encode with ``color_quantizer="mediancut"`` and
  ``dithering_mode="wavelets"`` is snapshotted around each palette
  sub-stage (palettization on wavelet features, the median cut, its
  2-opt round trip); each port sub-stage runs from the snapshot before it
  and is held against the one after it (tests/test_torch_stages.py's
  method). The median cut is host numpy on the same sampled pixels:
  identical; the 2-opt moves byte colors: identical;
- tile_features in the wavelet mode, inv_tile_features in the three
  invertible modes, and the inverse color conversions against the JAX
  package (float32 in another summation order: within rounding), and
  their round trips exact in float64.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import synthetic_clip
from tiler_tpu.cluster.mediancut import median_cut as j_median_cut
from tiler_tpu.config import EncoderSettings
from tiler_tpu.ops import color as j_color
from tiler_tpu.ops import dct as j_dct
from tiler_tpu.pipeline import palettes as j_palettes
from tiler_tpu.pipeline.encoder import Encoder as JaxEncoder
from tiler_tpu_torch.cluster.mediancut import median_cut
from tiler_tpu_torch.models.convert import state_from_numpy, state_to_numpy
from tiler_tpu_torch.ops import color as t_color
from tiler_tpu_torch.ops import dct as t_dct
from tiler_tpu_torch.pipeline import palettes as t_palettes


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors in many steps: one intra-op thread each, so that the
    suite's parallel workers do not leave pools of spinning threads
    waiting on each other (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n,k,weighted", [(0, 4, False), (3, 16, True), (500, 1, True),
                                          (2048, 16, True), (2048, 256, False),
                                          (700, 64, True)])
def test_median_cut_equals_the_original(n, k, weighted):
    rng = np.random.default_rng(n + k)
    colors = rng.integers(0, 256, (n, 3)).astype(np.float32)
    colors[: n // 4] = colors[:1]  # a run of one color
    w = rng.random(n).astype(np.float32) if weighted else None
    got = median_cut(colors, w, k)
    assert got.dtype == np.uint8 and got.shape == (k, 3)
    assert np.array_equal(got, j_median_cut(colors, w, k))


def _settings():
    return EncoderSettings(palette_count=8, motion_predict_radius=4, epu_knn_k=8,
                           kmeans_iters=4, color_quantizer="mediancut",
                           dithering_mode="wavelets")


@pytest.fixture(scope="module")
def jax_palettes():
    """Snapshots around each palette sub-stage of a JAX encode."""
    snap = lambda st: state_to_numpy(copy.copy(st))  # noqa: E731
    with jax.enable_x64(False):
        enc = JaxEncoder(_settings(), log=None)
        enc.load_frames(synthetic_clip(4, 64, 96, seed=2), 25.0)
        enc.predict_motion().reduce()
        snaps = {"reduce": snap(enc.state)}
        st = j_palettes.palettization(enc.state, enc.settings)
        snaps["palettization"] = snap(st)
        st = j_palettes.quantization(st, enc.settings)
        snaps["quantization"] = snap(st)
        st = j_palettes.optimize_palettes(st, enc.settings)
        snaps["optimize"] = snap(st)
    return snaps


def _port(snap):
    return state_from_numpy(copy.copy(snap), "cpu")


def test_wavelet_palettization_identical(jax_palettes):
    st = t_palettes.palettization(_port(jax_palettes["reduce"]), _settings())
    want = jax_palettes["palettization"].corpus_pal_initial
    assert np.array_equal(st.corpus_pal_initial.numpy(), np.asarray(want))


def test_median_cut_quantization_identical(jax_palettes):
    st = t_palettes.quantization(_port(jax_palettes["palettization"]), _settings())
    want = jax_palettes["quantization"]
    assert np.array_equal(st.palettes_rgb.numpy(), want.palettes_rgb)
    assert np.array_equal(st.palettes_valid.numpy(), want.palettes_valid)


def test_median_cut_two_opt_identical(jax_palettes):
    stats = {}
    st = t_palettes.optimize_palettes(_port(jax_palettes["quantization"]), _settings(), stats)
    want = jax_palettes["optimize"]
    assert np.array_equal(st.palettes_rgb.numpy(), want.palettes_rgb)
    assert np.array_equal(st.palettes_valid.numpy(), want.palettes_valid)
    assert len(stats["two_opt_inner"]) >= 1 and min(stats["two_opt_inner"]) >= 1


def test_prepare_palettes_runs_the_median_cut_round_trip(jax_palettes):
    stats = {}
    st = t_palettes.prepare_palettes(_port(jax_palettes["reduce"]), _settings(), stats)
    want = jax_palettes["optimize"]
    assert np.array_equal(st.palettes_rgb.numpy(), want.palettes_rgb)
    assert stats["two_opt_inner"]


def _tiles(n=50, seed=0):
    rng = np.random.default_rng(seed)
    t = rng.integers(0, 256, (n, 8, 8, 3)).astype(np.float32)
    t[0] = 0
    t[1] = 255
    return t


@pytest.mark.parametrize("use_lab", [False, True])
def test_wavelet_features_match(use_lab):
    t = _tiles()
    with jax.enable_x64(False):
        want = np.asarray(j_dct.tile_features(jnp.asarray(t), mode="wavelets", use_lab=use_lab))
    got = t_dct.tile_features(torch.from_numpy(t), mode="wavelets", use_lab=use_lab).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-3)


@pytest.mark.parametrize("use_lab", [False, True])
@pytest.mark.parametrize("mode", ["dct", "weighted_dct", "wavelets"])
def test_inverse_features_match(mode, use_lab):
    """f32 on both sides: within rounding before the byte clamp; the
    clamped bytes of a byte tile are the tile itself."""
    t = _tiles(seed=1)
    with jax.enable_x64(False):
        f = j_dct.tile_features(jnp.asarray(t), mode=mode, use_lab=use_lab)
        want = np.asarray(j_dct.inv_tile_features(f, mode=mode, use_lab=use_lab, clamp=False))
        f = np.asarray(f)
    got = t_dct.inv_tile_features(torch.from_numpy(np.array(f)), mode=mode, use_lab=use_lab,
                                  clamp=False).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-3)
    back = t_dct.inv_tile_features(t_dct.tile_features(torch.from_numpy(t), mode=mode,
                                                       use_lab=use_lab), mode=mode,
                                   use_lab=use_lab)
    assert np.array_equal(back.numpy(), t)


def test_inverse_features_refuse_the_half_frequency_modes():
    with pytest.raises(ValueError, match="no inverse"):
        t_dct.inv_tile_features(torch.zeros(1, 192), mode="weighted_spe_dct")


def test_inverse_colors_match():
    rng = np.random.default_rng(3)
    rgb = rng.integers(0, 256, (4000, 3)).astype(np.float64)
    with jax.enable_x64(True):
        yuv = np.array(j_color.rgb_to_yuv(jnp.asarray(rgb)))
        lab = np.array(j_color.rgb_to_lab(jnp.asarray(rgb)))
        for clamp in (False, True):
            np.testing.assert_allclose(
                t_color.yuv_to_rgb(torch.from_numpy(yuv), clamp=clamp).numpy(),
                np.asarray(j_color.yuv_to_rgb(jnp.asarray(yuv), clamp=clamp)), rtol=0, atol=1e-9)
            np.testing.assert_allclose(
                t_color.lab_to_rgb(torch.from_numpy(lab), clamp=clamp).numpy(),
                np.asarray(j_color.lab_to_rgb(jnp.asarray(lab), clamp=clamp)), rtol=0, atol=1e-9)
    assert np.array_equal(t_color._XYZ_INV, j_color._XYZ_INV)
