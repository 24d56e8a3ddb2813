"""The dither stage's Yliluoma2 half (pipeline/dither.py) against
tiler_tpu.pipeline.dither: all int32, bit-identical. The JAX side runs
with 64-bit mode off, as in production.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiler_tpu.pipeline import dither as j_dither
from tiler_tpu_torch.kernels import tk_dither as t_tk
from tiler_tpu_torch.pipeline import dither as t_dither


def _pixel_case(B, S, seed):
    """Pixels with their palettes; some palettes lose slots, a few keep
    one slot or none."""
    rng = np.random.default_rng(seed)
    pix = rng.integers(0, 256, (B, 3)).astype(np.int32)
    pal = rng.integers(0, 256, (B, S, 3)).astype(np.int32)
    valid = rng.random((B, S)) < 0.8
    valid[:4] = False
    valid[4:8] = False
    valid[4:8, S // 2] = True
    pal[8:12] = pal[8:12, :1]  # every slot the same color
    return pix, pal, valid


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("mixed", [1, 2, 4])
def test_yliluoma2_lists_bit_identical(mixed, seed):
    pix, pal, valid = _pixel_case(200, 16, seed)
    with jax.enable_x64(False):
        want_lists, want_count = j_dither.yliluoma2_lists(
            jnp.asarray(pix), jnp.asarray(pal), jnp.asarray(valid), 16, mixed)
    lists, count = t_dither.yliluoma2_lists(
        torch.from_numpy(pix), torch.from_numpy(pal), torch.from_numpy(valid), 16, mixed)
    assert lists.dtype == torch.int32 and count.dtype == torch.int32
    assert np.array_equal(count.numpy(), np.asarray(want_count))
    assert np.array_equal(lists.numpy(), np.asarray(want_lists))
    assert int(count.min()) >= mixed and int(count.max()) <= 2 * mixed


def _tile_case(T, P, S, seed):
    rng = np.random.default_rng(seed)
    tiles = rng.integers(0, 256, (T, 8, 8, 3)).astype(np.uint8)
    pidx = rng.integers(0, P, T).astype(np.int32)
    pal = rng.integers(0, 256, (P, S, 3)).astype(np.int32)
    valid = rng.random((P, S)) < 0.8
    valid[0] = False
    hm, vm = rng.random(T) < 0.5, rng.random(T) < 0.5
    return tiles, pidx, pal, valid, hm, vm


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("mixed", [1, 2, 4])
def test_yliluoma2_select_in_chunks_bit_identical(mixed, seed):
    """The selected slots of a whole tile set, in chunks that do not
    divide it, against the JAX package's chunk function."""
    tiles, pidx, pal, valid, hm, vm = _tile_case(11, 4, 8, seed)
    with jax.enable_x64(False):
        want = np.asarray(j_dither._dither_chunk(
            jnp.asarray(tiles), jnp.asarray(pidx), jnp.asarray(hm), jnp.asarray(vm),
            jnp.asarray(pal), jnp.asarray(valid), 8, False, mixed))
    mirror = torch.from_numpy(hm.astype(np.uint8) | (vm.astype(np.uint8) << 1))
    got = t_dither.yliluoma2_select(
        torch.from_numpy(tiles), mirror, torch.from_numpy(pidx), torch.from_numpy(pal),
        torch.from_numpy(valid), mixed, chunk=4)
    assert got.dtype == torch.uint8 and got.shape == (11, 8, 8)
    assert np.array_equal(got.numpy(), want)


def test_color_compare_matches():
    rng = np.random.default_rng(5)
    a = rng.integers(-1500, 1800, (6, 500)).astype(np.int32)
    with jax.enable_x64(False):
        want = np.asarray(j_dither.color_compare(*(jnp.asarray(v) for v in a)))
    got = t_dither.color_compare(*(torch.from_numpy(v) for v in a))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


def test_mirrored_bayer_matches():
    mirror = torch.arange(4, dtype=torch.uint8)
    got = t_tk.mirrored_bayer(mirror).numpy()
    base = j_dither.BAYER8
    assert np.array_equal(t_tk.BAYER8, base)
    assert np.array_equal(got[0], base) and np.array_equal(got[1], base[:, ::-1])
    assert np.array_equal(got[2], base[::-1]) and np.array_equal(got[3], base[::-1, ::-1])


def test_yliluoma2_rejects_a_palette_of_another_size():
    pix, pal, valid = _pixel_case(16, 8, 0)
    with pytest.raises(ValueError, match="S=16"):
        t_dither.yliluoma2_lists(torch.from_numpy(pix), torch.from_numpy(pal),
                                 torch.from_numpy(valid), 16, 4)
