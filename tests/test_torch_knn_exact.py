"""The corpus top-k's yardstick tied exactly to the TPU kernels.

On small integer features every product, partial sum and norm split is an
exact f32 integer, so the summation order cannot matter: the port's
``knn_bucket_topk2`` and ``knn_bucket_topk`` (their plain versions, on
the CPU) must give idx and err bit-identical to the JAX package's Pallas
kernels run as its own tests run them (interpret mode on the CPU),
ties included. The card kernels are held bit-identical to the same plain
versions on the same kind of inputs by test_torch_cuda.py.

Also here: the kernel library's name covers every file the build reads.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiler_tpu.kernels import knn_topk as j_knn
from tiler_tpu_torch.kernels import _build
from tiler_tpu_torch.kernels import knn_topk as t_knn


def _exact_case(N=300, T=4000, seed=0):
    """Features in [-4, 4]; a third of the cells copy corpus tiles and
    every seventh tile repeats the one before (zero-distance ties)."""
    rng = np.random.default_rng(seed)
    ds = rng.integers(-4, 5, (T, 192)).astype(np.float32)
    ds[1::7] = ds[0::7][:len(ds[1::7])]
    feats = rng.integers(-4, 5, (N, 192)).astype(np.float32)
    feats[:N // 3] = ds[rng.integers(0, T, N // 3)]
    return feats, ds


TP = 4096  # the JAX kernels take whole groups of 8 buckets


def _assert_bits_equal(got, want):
    idx, err = (t.numpy() for t in got)
    jidx, jerr = (np.asarray(a) for a in want)
    assert idx.shape == jidx.shape
    assert np.array_equal(idx, jidx)
    assert np.array_equal(err.view(np.int32), jerr.view(np.int32))


@pytest.mark.parametrize("k", [1, 8])
def test_b2_plain_bit_identical_to_pallas(k):
    feats, ds = _exact_case(seed=k)
    with jax.enable_x64(False):
        want = j_knn.knn_bucket_topk2(jnp.asarray(feats),
                                      j_knn.knn_prep2(jnp.asarray(ds), TP), k)
        want = [np.asarray(a) for a in want]
    got = t_knn.knn_bucket_topk2(torch.from_numpy(feats),
                                 t_knn.knn_prep2(torch.from_numpy(ds), TP), k)
    _assert_bits_equal(got, want)
    assert np.all(want[1][:100, 0] == 0)  # the copied cells found their tiles


@pytest.mark.parametrize("k", [1, 8])
def test_v1_plain_bit_identical_to_pallas(k):
    feats, ds = _exact_case(seed=10 + k)
    T = ds.shape[0]
    with jax.enable_x64(False):
        dsp = jnp.pad(jnp.asarray(ds), ((0, TP - T), (0, 0)))
        d2p = jnp.sum(dsp * dsp, axis=1) + jnp.where(jnp.arange(TP) < T, 0.0, 1e30)
        want = j_knn.knn_bucket_topk(jnp.asarray(feats), dsp.astype(jnp.bfloat16).T, d2p, k)
        want = [np.asarray(a) for a in want]
    dsT, d2 = t_knn.knn_prep_v1(torch.from_numpy(ds), TP)
    got = t_knn.knn_bucket_topk(torch.from_numpy(feats), dsT, d2, k)
    _assert_bits_equal(got, want)


def test_library_name_follows_headers(tmp_path, monkeypatch):
    """An edit to a header the kernels include names a new library, so a
    stale build is never loaded."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for src in _build._inputs():
        (csrc / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "_CSRC", csrc)
    assert any(p.suffix == ".cuh" for p in _build._inputs())
    before = _build.library_path()
    assert _build.library_path() == before  # the same tree, the same name
    header = sorted(csrc.glob("*.cuh"))[0]
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    assert _build.library_path() != before
    assert [p.name for p in _build._sources()] == sorted(p.name for p in csrc.glob("*.cu"))
