"""Threefry-2x32 counter-based random numbers: the draws of jax.random.

The JAX package draws its palette seeds from ``jax.random`` (k-means++
init, Gumbel top-k sampling, the member-tile shuffle). A
``torch.Generator`` gives other numbers from the same seed, and then the
palettes, and every stage after them, agree only in distribution. This
module is the port's explicit generator: the same threefry2x32 hash, the
same counter layout (``jax_threefry_partitionable=True``, the jax 0.9
default) and the same bits-to-float transforms. Keys, splits, uniform,
randint and the Gumbel draws are bit-identical to jax.random on XLA's
CPU build (see :func:`gumbel`).

Torch has no usable uint32 arithmetic, so every word is held in int64 and
masked to 32 bits after each add and shift. A key is a Python pair of
ints ``(k1, k2)``; a batch of keys is an int64 tensor [B, 2].
"""
from __future__ import annotations

import math

import torch

from .ordered import log32

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_TINY = 1.1754943508222875e-38  # np.finfo(np.float32).tiny


def prng_key(seed: int):
    """jax.random.PRNGKey(seed): the 64-bit seed split into two words."""
    seed = int(seed)
    return ((seed >> 32) & _M32, seed & _M32)


def _rotl(x, d: int):
    return ((x << d) | (x >> (32 - d))) & _M32


def threefry2x32(k1, k2, x1, x2):
    """The threefry2x32 hash of counter words (x1, x2) under key (k1, k2).
    Keys are ints or int64 tensors broadcastable against the counters."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _M32
    return x1, x2


def _counters(shape, device):
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    return idx >> 32, idx & _M32


def split(key, num: int = 2, device=None) -> torch.Tensor:
    """jax.random.split(key, num) -> int64 [num, 2]."""
    hi, lo = _counters((num,), device)
    b1, b2 = threefry2x32(int(key[0]), int(key[1]), hi, lo)
    return torch.stack([b1, b2], dim=-1)


def random_bits(key, shape, device=None) -> torch.Tensor:
    """32 random bits per element (as int64 in [0, 2^32)). ``key`` may be a
    pair, or an int64 tensor [B, 2] of keys, giving [B, *shape]."""
    shape = tuple(shape)
    hi, lo = _counters(shape, device)
    if isinstance(key, torch.Tensor):
        k1 = key[:, 0].reshape(-1, *([1] * len(shape)))
        k2 = key[:, 1].reshape(-1, *([1] * len(shape)))
    else:
        k1, k2 = int(key[0]), int(key[1])
    b1, b2 = threefry2x32(k1, k2, hi, lo)
    return b1 ^ b2


def _bits_to_unit_f32(bits):
    """Mantissa trick of jax.random.uniform: [1, 2) minus 1 -> [0, 1)."""
    fb = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return fb.view(torch.float32) - 1.0


def uniform(key, shape, minval: float = 0.0, maxval: float = 1.0,
            device=None) -> torch.Tensor:
    """jax.random.uniform(key, shape, float32, minval, maxval)."""
    f = _bits_to_unit_f32(random_bits(key, shape, device))
    lo = torch.tensor(minval, dtype=torch.float32, device=f.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=f.device)
    return torch.maximum(lo, f * (hi - lo) + lo)


def randint(key, shape, minval: int, maxval: int, device=None) -> torch.Tensor:
    """jax.random.randint(key, shape, minval, maxval) for int32 results."""
    span = (maxval - minval) & _M32 if maxval > minval else 1
    keys = split(key, 2, device)
    higher = random_bits((int(keys[0, 0]), int(keys[0, 1])), shape, device)
    lower = random_bits((int(keys[1, 0]), int(keys[1, 1])), shape, device)
    mult = (1 << 16) % span
    mult = ((mult * mult) & _M32) % span
    off = (((higher % span) * mult) & _M32) + lower % span
    off = (off & _M32) % span
    return (off + minval).to(torch.int32)


def gumbel(key, shape, device=None) -> torch.Tensor:
    """jax.random.gumbel(key, shape, float32) in its default "low" mode.
    ``key`` may be an int64 tensor [B, 2] of keys (one draw each).

    Both logs are XLA's CPU float32 log (``ops/ordered.log32``), which is
    not correctly rounded: the draws equal jax.random.gumbel's bit for bit
    (u lies in [tiny, 1 - 2^-23], so -log(u) in [2^-23, 87.4], both inside the
    range log32 was swept over), and give the same bits on the card."""
    u = uniform(key, shape, _F32_TINY, 1.0, device)
    return -log32(-log32(u))


def categorical(key, logits: torch.Tensor) -> torch.Tensor:
    """jax.random.categorical(key, logits) over the last axis (Gumbel max,
    first index on ties)."""
    g = gumbel(key, tuple(logits.shape), logits.device)
    return torch.argmax(g + logits, dim=-1)
