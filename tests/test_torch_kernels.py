"""The port's two kernels: plain versions against the Pallas kernels (in
interpret mode, as the JAX package's own tests run them on the CPU), the
wrappers' dispatch and argument checks. The CUDA kernels themselves are
held against these plain versions on the card by test_torch_cuda.py and
chip_smoke.py.

B1 tk_select (kernels/tk_dither.py) is all integer: bit-identical.
B2 knn_bucket_top2 (kernels/knn_topk.py) ranks on f32 sums of exact bf16
products in another order: idx equal apart from near-ties, err within
2^-14 relative, recall against a float64 brute force no worse than the
JAX kernel's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiler_tpu.kernels import knn_topk as j_knn
from tiler_tpu.kernels import tk_dither as j_tk
from tiler_tpu.pipeline import dither as j_dither
from tiler_tpu_torch.kernels import blockify as t_blk
from tiler_tpu_torch.kernels import knn_topk as t_knn
from tiler_tpu_torch.kernels import tk_dither as t_tk
from tiler_tpu_torch.kernels import launch_counts, reset_launch_counts


def _tk_case(T=40, P=5, S=16, seed=0):
    """tests/test_tk_kernel.py's shapes, plus random mirror flags."""
    rng = np.random.RandomState(seed)
    tiles = rng.randint(0, 256, (T, 8, 8, 3)).astype(np.uint8)
    pidx = rng.randint(0, P, T).astype(np.int32)
    pal = rng.randint(0, 256, (P, S, 3)).astype(np.int32)
    valid = np.ones((P, S), bool)
    valid[min(2, P - 1), -3:] = False
    hm = rng.rand(T) < 0.5
    vm = rng.rand(T) < 0.5
    return tiles, pidx, pal, valid, hm, vm


def _tk_port(tiles, pidx, pal, valid, hm, vm, device="cpu"):
    T = len(tiles)
    mirror = (hm.astype(np.uint8) | (vm.astype(np.uint8) << 1))
    args = [torch.from_numpy(tiles.reshape(T, 64, 3)), torch.from_numpy(mirror),
            torch.from_numpy(pidx),
            t_tk.pal_table(torch.from_numpy(pal), torch.from_numpy(valid))]
    return [a.to(device) for a in args]


@pytest.mark.parametrize("seed", [0, 1])
def test_tk_plain_matches_pallas_and_xla(seed):
    tiles, pidx, pal, valid, hm, vm = _tk_case(seed=seed)
    T = len(tiles)
    bay = np.broadcast_to(j_dither.BAYER8, (T, 8, 8))
    bay = np.where(hm[:, None, None], bay[:, :, ::-1], bay)
    bay = np.where(vm[:, None, None], bay[:, ::-1, :], bay)
    with jax.enable_x64(False):
        pallas = np.asarray(j_tk.tk_dither_pallas(
            jnp.asarray(tiles), jnp.asarray(pidx), jnp.asarray(pal),
            jnp.asarray(valid), jnp.asarray(bay), interpret=True))
        xla = np.asarray(j_dither._dither_chunk(
            jnp.asarray(tiles), jnp.asarray(pidx), jnp.asarray(hm), jnp.asarray(vm),
            jnp.asarray(pal), jnp.asarray(valid), pal.shape[1], True, 4))
    got = t_tk.tk_select(*_tk_port(tiles, pidx, pal, valid, hm, vm)).numpy().reshape(T, 8, 8)
    assert np.array_equal(got, pallas)
    assert np.array_equal(got, xla)


def test_tk_all_invalid_palette_keeps_slot_zero():
    """A palette with no valid color: the TPU kernel keeps slot 0 and a
    black pick for every step."""
    tiles, pidx, pal, valid, hm, vm = _tk_case(T=4, P=2, S=4)
    valid[:] = False
    got = t_tk.tk_select(*_tk_port(tiles, pidx, pal, valid, hm, vm))
    assert int(got.max()) == 0


def test_tk_wrapper_rejects_bad_arguments():
    tiles, pidx, pal, valid, hm, vm = _tk_case(T=4, P=2, S=4)
    pix, mirror, pal_idx, table = _tk_port(tiles, pidx, pal, valid, hm, vm)
    with pytest.raises(ValueError, match="pal_idx"):
        t_tk.tk_select(pix, mirror, pal_idx.long(), table)
    with pytest.raises(ValueError, match="pal_idx outside"):
        t_tk.tk_select(pix, mirror, pal_idx + 7, table)
    with pytest.raises(ValueError, match="palette size"):
        t_tk.tk_select(pix, mirror, pal_idx, torch.zeros(2, 33, 8, dtype=torch.int32))
    with pytest.raises(ValueError, match="no kernel"):
        t_tk.tk_select(*(a.to("meta") for a in (pix, mirror, pal_idx, table)))


def _knn_case(N, T, Tp, seed):
    rng = np.random.default_rng(seed)
    feats = rng.normal(0, 50, (N, 192)).astype(np.float32)
    ds = rng.normal(0, 50, (T, 192)).astype(np.float32)
    return feats, ds


def _recall(idx, feats, ds, k):
    f, d = feats.astype(np.float64), ds.astype(np.float64)
    dist = (f * f).sum(1)[:, None] - 2 * f @ d.T + (d * d).sum(1)[None, :]
    want = np.argsort(dist, axis=1)[:, :k]
    return np.mean([len(set(idx[i]) & set(want[i])) / k for i in range(len(idx))])


# tests/test_knn_topk.py's v2 cases: (N, T, padded Tp, k, seed)
KNN_CASES = [(64, 4096, 4096, 1, 3), (16, 8092, 8192, 4, 4)]


@pytest.mark.parametrize("N,T,Tp,k,seed", KNN_CASES)
def test_knn_plain_matches_pallas(N, T, Tp, k, seed):
    feats, ds = _knn_case(N, T, Tp, seed)
    with jax.enable_x64(False):
        jidx, jerr = j_knn.knn_bucket_topk2(
            jnp.asarray(feats), j_knn.knn_prep2(jnp.asarray(ds), Tp), k)
    jidx, jerr = np.asarray(jidx), np.asarray(jerr)
    idx, err = t_knn.knn_bucket_topk2(torch.from_numpy(feats),
                                      t_knn.knn_prep2(torch.from_numpy(ds), Tp), k)
    idx, err = idx.numpy(), err.numpy()
    assert idx.max() < T  # padded corpus columns never rank
    # err: the same 15-bit ranking mantissa; one key step is 2^-14 relative
    np.testing.assert_allclose(err, jerr, rtol=2.0 ** -14)
    # idx: equal apart from near-ties (keys within one key step)
    differ = idx != jidx
    assert np.all(np.abs(err[differ] - jerr[differ]) <= 2.0 ** -14 * np.abs(jerr[differ]))
    assert differ.mean() <= 0.05
    assert _recall(idx, feats, ds, k) >= _recall(jidx, feats, ds, k) - 1e-9


def test_knn_prep_and_fold_layout():
    feats, ds = _knn_case(5, 100, 512, 0)
    dsTa = t_knn.knn_prep2(torch.from_numpy(ds), 512)
    fa = t_knn.fold_cells(torch.from_numpy(feats), 64)
    assert dsTa.shape == (t_knn.KDA, 512) and fa.shape == (64, t_knn.KDA)
    d = (fa.float() @ dsTa.float()).numpy()
    true = ((feats[:, None, :].astype(np.float64) - ds[None]) ** 2).sum(-1)
    np.testing.assert_allclose(d[:5, :100], true, rtol=2e-2, atol=100.0)
    assert np.all(d[:5, 100:] > 1e29)  # padded corpus columns
    assert np.all(d[5:] == 0)  # zero rows past the real cells


def test_knn_wrapper_rejects_bad_arguments():
    fa = torch.zeros(t_knn.CELL_BLOCK, t_knn.KDA, dtype=torch.bfloat16)
    dsTa = torch.zeros(t_knn.KDA, 512, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple"):
        t_knn.knn_bucket_top2(fa[:10], dsTa)
    with pytest.raises(ValueError, match="bfloat16"):
        t_knn.knn_bucket_top2(fa.float(), dsTa)
    with pytest.raises(ValueError, match="no kernel"):
        t_knn.knn_bucket_top2(fa.to("meta"), dsTa.to("meta"))


def test_plain_versions_count_no_launches():
    reset_launch_counts()
    tiles, pidx, pal, valid, hm, vm = _tk_case(T=4, P=2, S=4)
    t_tk.tk_select(*_tk_port(tiles, pidx, pal, valid, hm, vm))
    t_knn.knn_bucket_top2(torch.zeros(t_knn.CELL_BLOCK, t_knn.KDA, dtype=torch.bfloat16),
                          torch.zeros(t_knn.KDA, 512, dtype=torch.bfloat16))
    t_knn.knn_bucket_top2_v1(torch.zeros(t_knn.CELL_BLOCK, t_knn.KD, dtype=torch.bfloat16),
                             torch.zeros(t_knn.KD, 512, dtype=torch.bfloat16),
                             torch.zeros(512))
    t_blk.blockify_field(torch.zeros(16, 16, 8, dtype=torch.bfloat16))
    assert launch_counts() == {"tk_select": 0, "knn_bucket_top2": 0,
                               "knn_bucket_top2_v1": 0, "blockify_field": 0}
