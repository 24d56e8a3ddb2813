"""Device-resident weighted k-means (the port of ``tiler_tpu/cluster/
kmeans.py:26-155``).

Exact 1-NN assignment by distance matmuls, k-means++ or weighted-sample
(Gumbel top-k) seeding drawn from the port's threefry generator, and
weighted Lloyd with bf16 assignment ranking and the fixed-point early
exit: once an iteration reproduces its input centroids exactly, every
further one is the identity, so stopping is bit-identical to running on.
The segment sums add rows in order on every device
(``ops/ordered.segment_sum``). On the CPU the squared norms are summed in
the JAX package's order (``ops/ordered.row_sum``, XLA's windows of 32)
and the products through ``@`` equal the JAX package's bit for bit
(held by ``tests/test_torch_parity_gap.py``). On a card the norms are
one reduction launch (the ordered sum is 36 launches, and k-means++
seeding takes a norm a centroid: ~37k launches at P = 1,024) and cuBLAS
sums the products: fixed orders, other than the CPU's, so the card's
result is its own run after run.
"""
from __future__ import annotations

import torch

from ..ops import prng
from ..ops.ordered import row_sum, segment_sum


def sq_norms(x: torch.Tensor) -> torch.Tensor:
    """Row sums of x * x over the last axis (see the module docstring)."""
    return row_sum(x * x) if x.device.type == "cpu" else (x * x).sum(dim=-1)


def log_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 log rounded from float64: the same value on every device."""
    return torch.log(x.double()).float()


def _log_weights(weights: torch.Tensor) -> torch.Tensor:
    return torch.where(weights > 0, log_f32(torch.clamp_min(weights, 1e-30)),
                       -torch.inf)


def assign_nearest(points: torch.Tensor, centroids: torch.Tensor,
                   chunk: int = 16384):
    """Exact 1-NN: argmin_c |x - c|^2 -> (assign int32 [N], d2 [N])."""
    c2 = sq_norms(centroids)
    assign, dist = [], []
    for i in range(0, points.shape[0], chunk):
        x = points[i:i + chunk]
        d2 = sq_norms(x)[:, None] - 2.0 * (x @ centroids.T) + c2
        a = torch.argmin(d2, dim=1)
        assign.append(a.to(torch.int32))
        dist.append(d2.gather(1, a[:, None])[:, 0])
    return torch.cat(assign), torch.cat(dist)


def kmeans_pp_init(points: torch.Tensor, weights: torch.Tensor, k: int, key):
    """k-means++ seeding (yakmo's D. Arthur init); the Gumbel draws of all
    k - 1 steps are made up front, one row per split key."""
    n = points.shape[0]
    logw = _log_weights(weights)
    first = int(prng.categorical(key, logw))
    cents = [points[first]]
    if k > 1:
        keys = prng.split(key, k - 1, device=points.device)
        g = prng.gumbel(keys, (n,), device=points.device)  # [k-1, n]
        min_d2 = torch.full((n,), torch.inf, dtype=points.dtype, device=points.device)
        for i in range(k - 1):
            dd = points - cents[-1]
            min_d2 = torch.minimum(min_d2, sq_norms(dd))
            logits = logw + log_f32(torch.clamp_min(min_d2, 1e-30))
            cents.append(points[torch.argmax(g[i] + logits)])
    return torch.stack(cents)


def _lloyd(points, weights, cents, chunk: int, x2=None):
    """One weighted Lloyd step; ``x2`` [N] = sq_norms(points), computed
    here when not given."""
    k, d = cents.shape
    if x2 is None:
        x2 = sq_norms(points)
    c2 = sq_norms(cents)
    cb = cents.to(torch.bfloat16).float()
    sums = torch.zeros(k, d, dtype=points.dtype, device=points.device)
    cnts = torch.zeros(k, dtype=points.dtype, device=points.device)
    for i in range(0, points.shape[0], chunk):
        x = points[i:i + chunk]
        wi = weights[i:i + chunk]
        # assignment ranking in bf16 (exact products, f32 sums)
        d2 = x2[i:i + chunk, None] - 2.0 * (x.to(torch.bfloat16).float() @ cb.T) + c2
        a = torch.argmin(d2, dim=1)
        # one segment sum of [x * w, w]: the chunk's sums and counts
        part = segment_sum(torch.cat([x * wi[:, None], wi[:, None]], dim=1), a, k)
        sums = sums + part[:, :d]
        cnts = cnts + part[:, d]
    return torch.where(cnts[:, None] > 0, sums / torch.clamp_min(cnts[:, None], 1e-30), cents)


def kmeans(points, k: int, *, weights=None, iters: int = 30, seed: int = 0,
           chunk: int = 16384, init: str = "sample"):
    """Weighted k-means. Returns (centroids [k, D], assign [N], d2 [N]).

    N is padded to a power of two (>= 256) with zero-weight points, as in
    the JAX package: the random draws depend on that padded length."""
    points = points.float()
    dev = points.device
    n = points.shape[0]
    weights = (torch.ones(n, device=dev) if weights is None
               else torch.as_tensor(weights, dtype=torch.float32, device=dev))
    k = int(min(k, n))
    npad = 256
    while npad < n:
        npad *= 2
    points = torch.nn.functional.pad(points, (0, 0, 0, npad - n))
    weights = torch.nn.functional.pad(weights, (0, npad - n))
    key = prng.prng_key(seed)
    chunk = int(min(chunk, npad))
    if init == "kpp":
        cents = kmeans_pp_init(points, weights, k, key)
    else:  # weighted sample without replacement (Gumbel top-k)
        g = prng.gumbel(key, (npad,), device=dev)
        order = torch.sort(_log_weights(weights) + g, descending=True, stable=True)
        cents = points[order.indices[:k]]
    x2 = sq_norms(points)
    for _ in range(iters):
        new = _lloyd(points, weights, cents, chunk, x2)
        done = torch.equal(new, cents)
        cents = new
        if done:
            break
    assign, d2 = assign_nearest(points, cents, chunk=chunk)
    return cents, assign[:n], d2[:n]
