"""The port's threefry generator against jax.random (64-bit mode off, as
in production).

uniform / randint / split / PRNGKey, the Gumbel draws and the categorical
and Gumbel top-k selections must be bit-identical. XLA's float32 log on
the CPU is not correctly rounded (about 8% of inputs come out one unit in
the last place off); the port's Gumbel draws take XLA's log
(``ops/ordered.log32``), so on a host whose XLA has that log they equal
jax.random.gumbel bit for bit, and elsewhere they agree to float32
rounding.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiler_tpu_torch.ops import prng

SEEDS = (0, 1, 0x42381337, 0x42381338, 12345)
SHAPES = ((5,), (1000,), (33, 7))


def _bits(a):
    return np.asarray(a).view(np.int32)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_split(seed):
    with jax.enable_x64(False):
        key = jax.random.PRNGKey(seed)
        assert tuple(int(v) for v in np.asarray(key)) == prng.prng_key(seed)
        for num in (2, 7, 1023):
            want = np.asarray(jax.random.split(key, num)).astype(np.int64)
            assert np.array_equal(prng.split(prng.prng_key(seed), num).numpy(), want)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_and_randint(seed, shape):
    k = prng.prng_key(seed)
    with jax.enable_x64(False):
        key = jax.random.PRNGKey(seed)
        u = jax.random.uniform(key, shape)
        tiny = jax.random.uniform(key, shape, minval=np.finfo(np.float32).tiny)
        r20 = jax.random.randint(key, shape, 0, 1 << 20, dtype=jnp.int32)
        r = jax.random.randint(key, shape, 3, 1000, dtype=jnp.int32)
    assert np.array_equal(_bits(u), _bits(prng.uniform(k, shape).numpy()))
    assert np.array_equal(
        _bits(tiny), _bits(prng.uniform(k, shape, np.finfo(np.float32).tiny).numpy()))
    assert np.array_equal(np.asarray(r20), prng.randint(k, shape, 0, 1 << 20).numpy())
    assert np.array_equal(np.asarray(r), prng.randint(k, shape, 3, 1000).numpy())


@pytest.fixture(scope="module")
def xla_log():
    """Whether the host's XLA has the log ``ops/ordered.log32`` copies
    (tests/test_torch_motion_order.py's probes)."""
    from test_torch_motion_order import motion_order_skip_reason
    return motion_order_skip_reason() is None


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(4096,), (64, 2048)])
def test_gumbel_to_the_last_bits(seed, shape, xla_log):
    """-log(-log(u)) bit for bit on a host with XLA's log. Elsewhere: one
    unit in the last place of the inner log is a relative 6e-8, which the
    outer log turns into an absolute 6e-8; the outer log adds its own
    last-place rounding."""
    with jax.enable_x64(False):
        g = np.asarray(jax.random.gumbel(jax.random.PRNGKey(seed), shape))
    got = prng.gumbel(prng.prng_key(seed), shape).numpy()
    if xla_log:
        assert np.array_equal(_bits(got), _bits(g))
    np.testing.assert_allclose(got, g, rtol=2.4e-7, atol=2.5e-7)
    assert (got == g).mean() > 0.5


def test_batched_gumbel_topk_selects_the_same(xla_log):
    """The per-palette sample init: one key per palette seed, Gumbel top-k
    over the valid slots (the draws bit for bit on a host with XLA's
    log)."""
    P, n, k = 64, 2048, 16
    seeds = np.arange(P) + 0x42381337
    valid = np.random.RandomState(0).rand(P, n) < 0.6
    with jax.enable_x64(False):
        g = jax.vmap(lambda s: jax.random.gumbel(jax.random.PRNGKey(s), (n,)))(
            jnp.asarray(seeds, jnp.int32))
        keyv = jnp.where(jnp.asarray(valid), 0.0, -jnp.inf) + g
        want = np.asarray(jax.lax.top_k(keyv, k)[1])
    keys = torch.tensor([prng.prng_key(int(s)) for s in seeds])
    gt = prng.gumbel(keys, (n,))
    if xla_log:
        assert np.array_equal(_bits(gt.numpy()), _bits(g))
    kv = torch.where(torch.from_numpy(valid), 0.0, -torch.inf) + gt
    got = torch.sort(kv, dim=1, descending=True, stable=True).indices[:, :k].numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
def test_categorical_draws(seed):
    logits = np.random.RandomState(seed & 0xFFFF).randn(20, 500).astype(np.float32)
    logits[:, ::7] = -np.inf
    with jax.enable_x64(False):
        keys = jax.random.split(jax.random.PRNGKey(seed), 20)
        want = [int(jax.random.categorical(keys[i], jnp.asarray(logits[i]))) for i in range(20)]
    tkeys = prng.split(prng.prng_key(seed), 20)
    got = [int(prng.categorical((int(tkeys[i, 0]), int(tkeys[i, 1])), torch.from_numpy(logits[i])))
           for i in range(20)]
    assert got == want
