"""The port's palettization computes what the JAX package's computes, bit
for bit and at any thread count (ROADMAP C8).

The palettization's k-means is chaotic: one feature a unit in the last
place off, or one segment sum added in another order, moves a point to
another centroid, and a few iterations later most palettes differ. At
640x360x8 (T = 9,359, k1 = 512) the port's first k-means fed the JAX
package's features left the reference by up to 13.79 after one Lloyd
step and agreed on 62.9% of the assignments at the end; the port's own
features differed by up to 0.0039; and ``index_put_(accumulate=True)``
on the CPU added the segment sums in another order on every call at more
than one thread, so the stream changed from run to run. With the float
order of ``ops/ordered.py`` the whole of prepare_palettes is bit-identical
to the JAX package's at that size, from the same corpus.

- the k-means segment sum (``ops/ordered.segment_sum``) and the Lloyd step on
  65,536 x 192 rows at 4 threads: three calls, one result, and the sum is
  ``jax.ops.segment_sum``'s;
- the k-means on the same seeded features: the same centroids and
  assignments as the JAX package's after 1, 2 and 10 steps;
- the ordered primitives and features against their XLA counterparts;
- prepare_palettes from the JAX package's corpus of an 8x128x256 clip
  (where the port's palettes used to agree on 6.8% of the corpus);
- the port's encode of that clip writes one stream at 1 and at 4
  threads (its palettes used to give one stream a thread count).

The tests that hold the port to XLA's bits need XLA to compile as the
build ``ops/ordered.py`` was read from; the ``xla_order`` fixture probes
that and skips them, with the reason, on a host where it does not.
"""
import contextlib
import copy
import hashlib
import importlib
import platform

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import synthetic_clip
from tiler_tpu.config import EncoderSettings as JaxSettings
from tiler_tpu.ops import dct as j_dct
from tiler_tpu.pipeline import palettes as j_palettes
from tiler_tpu.pipeline.encoder import Encoder as JaxEncoder
from tiler_tpu_torch.config import EncoderSettings
from tiler_tpu_torch.models.convert import state_from_numpy, state_to_numpy
from tiler_tpu_torch.ops import dct as t_dct
from tiler_tpu_torch.pipeline import palettes as t_palettes
from tiler_tpu_torch.pipeline.encoder import Encoder

j_kmeans = importlib.import_module("tiler_tpu.cluster.kmeans")
t_kmeans = importlib.import_module("tiler_tpu_torch.cluster.kmeans")

CLIP = (8, 128, 256)  # frames, height, width


@contextlib.contextmanager
def threads(n):
    old = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(old)


def _seq_sum(v):
    acc = v[..., 0].copy()
    for j in range(1, v.shape[-1]):
        acc = acc + v[..., j]
    return acc


@pytest.fixture(scope="module")
def xla_order():
    """Skip unless the host's XLA compiles as ``ops/ordered.py`` assumes:
    x86-64, glibc 2.28 or later (its powf), ``a * b + c`` fused into one
    FMA, and a row of 64 summed as two windows of 32."""
    libc, version = platform.libc_ver()
    if platform.machine() != "x86_64" or libc != "glibc" or \
            tuple(int(p) for p in version.split(".")[:2]) < (2, 28):
        pytest.skip(f"ops/ordered.py follows XLA on x86-64 with glibc >= 2.28, not "
                    f"{platform.machine()} with {libc} {version}")
    rng = np.random.default_rng(0)
    a, b = (rng.uniform(1, 2, 1024).astype(np.float32) for _ in range(2))
    c = rng.uniform(-4, 4, 1024).astype(np.float32)
    x = (rng.standard_normal((64, 64)) * 1000).astype(np.float32)
    with jax.enable_x64(False):
        fused = np.asarray(jax.jit(lambda a, b, c: a * b + c)(a, b, c))
        sums = np.asarray(jax.jit(lambda v: jnp.sum(v, axis=1))(x))
    if not np.array_equal(fused, (a.astype(np.float64) * b + c).astype(np.float32)):
        pytest.skip(f"this host's XLA (jax {jax.__version__}) does not fuse a * b + c "
                    "into one FMA, as ops/ordered.py assumes")
    if not np.array_equal(sums, _seq_sum(x[:, :32]) + _seq_sum(x[:, 32:])):
        pytest.skip(f"this host's XLA (jax {jax.__version__}) does not sum in windows "
                    "of 32, as ops/ordered.py assumes")


def _features(n, seed=0):
    """Seeded features with the corpus's spread: strong low frequencies."""
    rng = np.random.default_rng(seed)
    scale = (4000.0 / (1 + np.arange(192) % 64)).astype(np.float32)
    return ((rng.standard_normal((n, 192)) * scale).astype(np.float32),
            rng.integers(1, 6, n).astype(np.float32))


def test_segment_sum_repeats_and_equals_jax():
    from tiler_tpu_torch.ops import ordered

    x, _ = _features(65536)
    ids = np.random.default_rng(1).integers(0, 512, 65536)
    with threads(4):
        got = [ordered.segment_sum(torch.from_numpy(x), torch.from_numpy(ids), 512)
               for _ in range(3)]
    assert all(torch.equal(got[0], g) for g in got[1:])
    with jax.enable_x64(False):
        want = np.asarray(jax.ops.segment_sum(x, ids, num_segments=512))
    assert np.array_equal(got[0].numpy(), want)


def test_lloyd_step_repeats():
    x, w = _features(65536)
    cents = torch.from_numpy(x[::128].copy())  # 512 centroids
    with threads(4):
        got = [t_kmeans._lloyd(torch.from_numpy(x), torch.from_numpy(w), cents, 16384)
               for _ in range(3)]
    assert all(torch.equal(got[0], g) for g in got[1:])


@pytest.mark.parametrize("iters", [1, 2, 10])
def test_kmeans_equals_jax(iters, xla_order):
    x, w = _features(16384)
    with jax.enable_x64(False):
        jc, ja, _ = j_kmeans.kmeans(x, 256, weights=w, iters=iters, seed=0)
    with threads(4):
        tc, ta, _ = t_kmeans.kmeans(torch.from_numpy(x), 256, weights=w, iters=iters, seed=0)
    assert np.array_equal(tc.numpy(), np.asarray(jc))
    assert np.array_equal(ta.numpy(), np.asarray(ja))


@pytest.mark.parametrize("n", [3, 16, 32, 33, 64, 192, 1000])
def test_row_sum_is_xla_order(n, xla_order):
    from tiler_tpu_torch.ops import ordered

    x = np.random.default_rng(n).standard_normal((512, n)).astype(np.float32) * 1000
    with jax.enable_x64(False):
        want = np.asarray(jax.jit(lambda v: jnp.sum(v, axis=1))(x))
    assert np.array_equal(ordered.row_sum(torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("y", [2.4, 1 / 3])
def test_powf_is_xla_pow(y, xla_order):
    from tiler_tpu_torch.ops import ordered

    rng = np.random.default_rng(0)
    # positive normal x whose power is normal: the domain powf takes
    x = np.concatenate([rng.uniform(0.008, 1.3, 200000),
                        10 ** rng.uniform(-10, 3, 50000)]).astype(np.float32)
    with jax.enable_x64(False):
        want = np.asarray(jax.jit(lambda v: v ** y)(x))
    assert np.array_equal(ordered.powf(torch.from_numpy(x), y).numpy(), want)


def test_fma32_rounds_once():
    from tiler_tpu_torch.ops import ordered

    rng = np.random.default_rng(0)
    a, b = (rng.standard_normal(100000).astype(np.float32) for _ in range(2))
    c = rng.standard_normal(100000).astype(np.float32)
    c[:50000] = -(a[:50000].astype(np.float64) * b[:50000]).astype(np.float32)  # cancellation
    want = (a.astype(np.float64) * b + c).astype(np.float32)
    got = ordered.fma32(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    assert np.array_equal(got, want)
    # a float64 sum that lands on a float32 midpoint above the exact one:
    # (2^13 + 2^-10)(2^13 - 2^-10) = 2^26 - 2^-20, plus 2^50 + 2^27, is
    # 2^50 + 2^27 + 2^26 - 2^-20; float64 rounds it to the midpoint and
    # ties-to-even would then go up to 2^50 + 2^28
    one = lambda v: torch.tensor([v], dtype=torch.float32)  # noqa: E731
    got = ordered.fma32(one(8192 + 2.0 ** -10), one(8192 - 2.0 ** -10), one(2.0 ** 50 + 2.0 ** 27))
    assert got.item() == 2.0 ** 50 + 2.0 ** 27


@pytest.mark.parametrize("mode", ["dct", "weighted_dct", "wavelets", "spe_dct",
                                  "weighted_spe_dct"])
def test_ordered_features_equal_jax(mode, xla_order):
    tiles = np.random.default_rng(0).integers(0, 256, (4000, 8, 8, 3)).astype(np.float32)
    with jax.enable_x64(False):
        want = np.asarray(j_dct.tile_features(jnp.asarray(tiles), mode=mode, use_lab=True))
    got = t_dct.tile_features(torch.from_numpy(tiles), mode=mode, use_lab=True).numpy()
    assert np.array_equal(got, want)


@pytest.fixture(scope="module")
def jax_snapshots():
    """The JAX package's state after reduce and after prepare_palettes."""
    with jax.enable_x64(False):
        enc = JaxEncoder(JaxSettings(palette_count=64), log=None)
        enc.load_frames(synthetic_clip(*CLIP, seed=0), 25.0)
        enc.state.ensure_ingest()
        enc.predict_motion()
        enc.reduce()
        reduced = state_to_numpy(copy.copy(enc.state))
        enc.prepare_palettes()
        return reduced, state_to_numpy(copy.copy(enc.state))


def test_prepare_palettes_bit_identical(jax_snapshots, xla_order):
    reduced, want = jax_snapshots
    st = state_from_numpy(reduced, "cpu")
    settings = EncoderSettings(palette_count=64)
    with jax.enable_x64(False):
        jfeat = np.asarray(j_palettes._corpus_features(reduced, JaxSettings(palette_count=64)))
    assert np.array_equal(t_palettes._corpus_features(st, settings).numpy(), jfeat)
    with threads(4):
        t_palettes.prepare_palettes(st, settings)
    assert np.array_equal(st.corpus_pal_initial.numpy(), np.asarray(want.corpus_pal_initial))
    assert np.array_equal(st.palettes_rgb.numpy(), np.asarray(want.palettes_rgb))
    assert np.array_equal(st.palettes_valid.numpy(), np.asarray(want.palettes_valid))


def test_encode_independent_of_threads(tmp_path):
    clip = synthetic_clip(*CLIP, seed=0)
    digests = []
    for n in (1, 4):
        out = tmp_path / f"t{n}.gtm"
        with threads(n):
            Encoder(EncoderSettings(palette_count=64), log=None, device="cpu").run_all(
                clip, fps=25.0, out_path=str(out))
        digests.append(hashlib.sha256(out.read_bytes()).hexdigest())
    assert digests[0] == digests[1]
