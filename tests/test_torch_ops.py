"""tiler_tpu_torch's package rules and its ops against tiler_tpu.ops.

- Importing every module of the port, and chip_smoke.py, pulls in
  neither jax nor triton, nor the JAX package or bench.py.
- The constant tables the port rebuilds (the JAX modules that define
  them import jax) equal the JAX package's.
- Colorspace, DCT feature, mirror and metric ops agree with the JAX ops
  (float32; tolerances are summation-order rounding).
- Every setting off the ported slice is refused with a ValueError that
  names it.
"""
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiler_tpu.config import EncoderSettings
from tiler_tpu.ops import color as j_color
from tiler_tpu.ops import dct as j_dct
from tiler_tpu.ops import metrics as j_metrics
from tiler_tpu.ops import tiles as j_tiles
from tiler_tpu.pipeline import dither as j_dither
from tiler_tpu.pipeline import motion as j_motion
from tiler_tpu.pipeline import reduce as j_reduce
from tiler_tpu.pipeline import reindex as j_reindex
from tiler_tpu_torch.kernels import tk_dither as t_tk
from tiler_tpu_torch.ops import color as t_color
from tiler_tpu_torch.ops import dct as t_dct
from tiler_tpu_torch.ops import metrics as t_metrics
from tiler_tpu_torch.ops import tiles as t_tiles
from tiler_tpu_torch.pipeline import encoder as t_encoder
from tiler_tpu_torch.pipeline import motion as t_motion
from tiler_tpu_torch.pipeline import reduce as t_reduce
from tiler_tpu_torch.pipeline import reindex as t_reindex

_IMPORT_ALL = """
import pkgutil, sys, importlib
import tiler_tpu_torch
for m in pkgutil.walk_packages(tiler_tpu_torch.__path__, "tiler_tpu_torch."):
    if m.name != "tiler_tpu_torch.__main__":
        importlib.import_module(m.name)
import chip_smoke
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "triton", "tiler_tpu", "bench"))
print(len([n for n in sys.modules if n.startswith("tiler_tpu_torch")]), bad)
"""


def test_import_pulls_no_jax_or_triton():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], capture_output=True, text=True,
                         check=True, cwd=Path(__file__).resolve().parents[1]).stdout.split(maxsplit=1)
    assert int(out[0]) >= 30, out  # every module was imported
    assert out[1].strip() == "[]", out[1]


@pytest.mark.parametrize("name,port,ref", [
    ("DCT_MAT", t_dct.DCT_MAT, j_dct.DCT_MAT),
    ("DCT_MAT_SPE", t_dct.DCT_MAT_SPE, j_dct.DCT_MAT_SPE),
    ("DCT_WEIGHTS", t_dct.DCT_WEIGHTS, j_dct.DCT_WEIGHTS),
    ("SNAKE", t_dct.SNAKE, j_dct.SNAKE),
    ("XYZ_M_D50", t_color._XYZ_M_D50, j_color._XYZ_M_D50),
    ("BAYER8", t_tk.BAYER8, j_dither.BAYER8),
    ("reduce_C1", t_reduce._C1, j_reduce._C1),
    ("reduce_C2", t_reduce._C2, j_reduce._C2),
    ("reindex_C1", t_reindex._C1, j_reindex._C1),
    ("reindex_C2", t_reindex._C2, j_reindex._C2),
])
def test_rebuilt_constants_equal(name, port, ref):
    assert port.dtype == ref.dtype and np.array_equal(port, ref), name


def _tiles(n=300, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n, 8, 8, 3)).astype(np.uint8)


def _close(got, want, rtol=1e-5):
    """rtol relative to the array's scale: entries near zero come out of
    sums of large terms."""
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=rtol * np.abs(want).max())


def test_color_ops():
    x = _tiles().astype(np.float32)
    with jax.enable_x64(False):
        yuv = j_color.rgb_to_yuv(jnp.asarray(x))
        lab = j_color.rgb_to_lab(jnp.asarray(x))
        lum = j_color.luma(jnp.asarray(x))
    tx = torch.from_numpy(x)
    _close(t_color.rgb_to_yuv(tx).numpy(), yuv)
    _close(t_color.rgb_to_lab(tx).numpy(), lab)
    assert np.array_equal(t_color.luma(tx).numpy(), np.asarray(lum))
    ints = np.random.RandomState(1).randint(0, 256, (500, 3))
    assert np.array_equal(t_color.rgb_to_hsv_bytes(ints), j_color.rgb_to_hsv_bytes(ints))
    assert np.array_equal(t_color.posterize(ints, 255), j_color.posterize(ints, 255))


@pytest.mark.parametrize("mode", ["dct", "weighted_dct", "spe_dct", "weighted_spe_dct"])
@pytest.mark.parametrize("use_lab", [False, True])
def test_tile_features(mode, use_lab):
    x = _tiles(seed=2).astype(np.float32)
    with jax.enable_x64(False):
        want = j_dct.tile_features(jnp.asarray(x), mode=mode, use_lab=use_lab)
    _close(t_dct.tile_features(torch.from_numpy(x), mode=mode, use_lab=use_lab).numpy(), want)


def test_tile_features_raster():
    x = _tiles(seed=3).astype(np.float32)
    with jax.enable_x64(False):
        want = j_motion.tile_features_raster(jnp.asarray(x))
    _close(t_motion.tile_features_raster(torch.from_numpy(x)).numpy(), want)


def test_mirrors_and_padding():
    x = _tiles(seed=4)
    with jax.enable_x64(False):
        canon, hm, vm = j_tiles.canonicalize(jnp.asarray(x, jnp.float32))
    tc, thm, tvm = t_tiles.canonicalize(torch.from_numpy(x).float())
    assert np.array_equal(tc.numpy(), np.asarray(canon))
    assert np.array_equal(thm.numpy(), np.asarray(hm))
    assert np.array_equal(tvm.numpy(), np.asarray(vm))
    frame = np.ones((13, 21, 3), np.uint8)
    assert np.array_equal(t_tiles.pad_frame(frame), j_tiles.pad_frame(frame))


def test_metrics():
    rng = np.random.RandomState(5)
    err = np.concatenate([rng.uniform(0, 1e6, 500), [0.0, 50.0, 96.0]]).astype(np.float32)
    a = rng.randn(7, 300).astype(np.float32)
    b = (a + rng.randn(7, 300) * 0.3).astype(np.float32)
    b[3] = 2.0  # degenerate: correlation 1
    with jax.enable_x64(False):
        psnr = j_metrics.euclidean_to_psnr(jnp.asarray(err))
        corr = j_metrics.pearson(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(t_metrics.euclidean_to_psnr(torch.from_numpy(err)).numpy(),
                               psnr, rtol=1e-6)
    np.testing.assert_allclose(t_metrics.pearson(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                               corr, rtol=1e-5, atol=1e-6)
    assert t_metrics.PSNR_MAX == j_metrics.PSNR_MAX


# each case keeps the id it had before the settings ported since left
# the list (int16_features-6, host_ram_budget-10, hbm_frames_budget-14,
# use_pallas_tk-12, palette sizes up to 256, epu_two_stage-2,
# epu_fused_fp-3, knn_backend="ivf" and motion_rank_dims 3 r^2 are
# accepted now; ids 2 and 3 name the two-stage EPU's own settings, id 0
# the IVF's probe count and id 5 a depth that is not 3 r^2;
# phase_b_motion-7, color_quantizer-9 and dithering_mode-13 are unknown
# names, palette_size-16 and -17 sizes a byte cannot index)
OFF_SLICE = [
    # the IVF search itself is ported: only a probe count it cannot run
    ("knn_backend-0", "ivf_probes", dict(knn_backend="ivf", ivf_probes=0)),
    ("knn_backend-1", "knn_backend", dict(knn_backend="pallas_v3")),  # no such backend
    # the two-stage EPU's stage 1 ranks on the r x r low-frequency block
    ("epu_stage1_dims-2", "epu_stage1_dims", dict(epu_two_stage=True, epu_stage1_dims=50)),
    ("epu_stage1_m-3", "epu_stage1_m", dict(epu_two_stage=True, epu_stage1_m=0)),  # no pair
    ("motion_field-4", "motion_field", dict(motion_field="im2col")),  # no such field
    # motion ranks on each channel's r x r low-frequency block: 3 r^2 only
    ("motion_rank_dims-5", "motion_rank_dims", dict(motion_rank_dims=50)),
    ("phase_b_motion-7", "phase_b_motion", dict(phase_b_motion="recompute")),  # no such mode
    # Yliluoma2 itself is ported: only a plan size it cannot hold is refused
    ("dithering_use_thomas_knoll-8", "dithering_use_thomas_knoll",
     dict(dithering_use_thomas_knoll=False, dithering_yliluoma2_mixed_colors=0)),
    ("color_quantizer-9", "color_quantizer", dict(color_quantizer="octree")),  # no such one
    ("scaling-11", "scaling", dict(scaling=0.0)),  # any positive factor resamples
    ("dithering_mode-13", "dithering_mode", dict(dithering_mode="haar")),  # no such mode
    ("mesh-15", "mesh", None),
    ("palette_size-16", "palette_size", dict(palette_size=0)),
    ("palette_size-17", "palette_size", dict(palette_size=257)),
]


@pytest.mark.parametrize("flag,overrides", [c[1:] for c in OFF_SLICE],
                         ids=[c[0] for c in OFF_SLICE])
def test_off_slice_setting_raises(flag, overrides):
    frames = np.zeros((2, 16, 16, 3), np.uint8)
    if flag == "dithering_use_thomas_knoll":
        flag = "dithering_yliluoma2_mixed_colors"  # the rule that names it
    with pytest.raises(ValueError, match=flag):
        if overrides is None:
            t_encoder.Encoder(EncoderSettings(), device="cpu", mesh=object())
        else:
            enc = t_encoder.Encoder(EncoderSettings(**overrides), device="cpu", log=None)
            enc.load_frames(frames)


SMALL = dict(palette_count=4, motion_predict_radius=2, epu_knn_k=4, kmeans_iters=2)
# settings ported since they stood in OFF_SLICE: each encodes a tiny clip
ENCODED = {"int16": dict(int16_features=True), "research": dict(phase_b_motion="research"),
           "host_ram_budget": dict(host_ram_budget=1e9, hbm_frames_budget=1),
           "hbm_frames_budget": dict(hbm_frames_budget=1000.0),
           "use_pallas_tk-12": dict(use_pallas_tk=False),
           "color_quantizer-9": dict(color_quantizer="mediancut"),
           "dithering_mode-13": dict(dithering_mode="wavelets"),
           "palette_size-64": dict(palette_size=64), "palette_size-256": dict(palette_size=256),
           "epu_two_stage-2": dict(epu_two_stage=True), "epu_fused_fp-3": dict(epu_fused_fp=True),
           "knn_backend-ivf": dict(knn_backend="ivf", ivf_min_corpus=1),
           "motion_rank_dims-48": dict(motion_rank_dims=48),
           "motion_rank_dims-3_im2row": dict(motion_rank_dims=3, motion_field="im2row")}


@pytest.mark.parametrize("overrides", [
    dict(dithering_use_thomas_knoll=False),
    dict(dithering_use_thomas_knoll=False, dithering_yliluoma2_mixed_colors=16),
    dict(scaling=0.5), dict(scaling=2.0, device_resample=False),
    # stage 1's settings are read only under two-stage, as in the JAX package
    dict(epu_stage1_dims=50, epu_stage1_m=0), *ENCODED.values(),
], ids=["yliluoma2", "yliluoma2_16", "scaling_half", "scaling_host", "stage1_unread",
        *ENCODED])
def test_ported_settings_are_accepted(overrides):
    t_encoder.check_settings(EncoderSettings(**overrides))
    if overrides in ENCODED.values():
        from tiler_tpu_torch.bitstream.gtm import GTMDecoder
        from tiler_tpu_torch.utils.clips import synthetic_clip

        enc = t_encoder.Encoder(EncoderSettings(**SMALL, **overrides), device="cpu", log=None)
        with tempfile.TemporaryDirectory() as d:
            enc.run_all(synthetic_clip(3, 32, 48), 25.0, os.path.join(d, "out.gtm"))
            assert len(GTMDecoder(os.path.join(d, "out.gtm")).decode_frames()) == 3
        host = overrides.get("hbm_frames_budget", 8e9) < 3 * 32 * 48 * 3
        assert isinstance(enc.state.tiles_canon, np.ndarray) == host
