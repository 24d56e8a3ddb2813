"""Point-sharded weighted k-means (the port of
``tiler_tpu/parallel/kmeans.py``): each rank assigns its shard of the
points and contributes partial centroid sums, which are summed over the
axis in rank order (``collectives.psum``).

The assignment ranks float32 distances at the precision the JAX
package's reference computes on the CPU (not the bf16 ranking of
``cluster/kmeans._lloyd``); the segment sums add each rank's rows in row
order (``ops/ordered.segment_sum``), at any thread count and on either
device. Every rank then holds the same centroids bit for bit, so
the fixed-point early exit takes the same trip count on every rank and
the collectives inside the loop stay in step.
"""
from __future__ import annotations

import torch

from ..cluster.kmeans import _log_weights
from ..ops import prng
from ..ops.ordered import segment_sum
from .collectives import all_gather_stack, axis_index, psum
from .knn import sq_dists
from .mesh import mesh_shape

CHUNK = 16384  # points a distance matmul


def _nearest(pts, cents):
    """Per point the nearest centroid (ties to the lower index) and its
    squared distance, ``|p|^2 - 2 p.c + |c|^2`` in float32."""
    c2 = (cents * cents).sum(dim=1)
    assign, dist = [], []
    for i in range(0, pts.shape[0], CHUNK):
        d2 = sq_dists(pts[i:i + CHUNK], cents, c2)
        a = torch.argmin(d2, dim=1)
        assign.append(a)
        dist.append(d2.gather(1, a[:, None])[:, 0])
    return torch.cat(assign), torch.cat(dist)


def sharded_lloyd_step(points, weights, cents, mesh, data_axis: str = "corpus"):
    """One Lloyd iteration. points [n/s, D] and weights [n/s]: this
    rank's shard on ``data_axis`` (s ranks); cents [k, D], the same on
    every rank. Returns the new centroids (an empty cluster keeps its
    centroid), the same on every rank."""
    k, d = cents.shape
    a, _ = _nearest(points, cents)
    part = segment_sum(torch.cat([points * weights[:, None], weights[:, None]], dim=1), a, k)
    part = psum(part, mesh, data_axis)
    sums, cnts = part[:, :d], part[:, d:]
    return torch.where(cnts > 0, sums / torch.clamp_min(cnts, 1e-30), cents)


def sharded_lloyd(points, weights, cents, iters: int, mesh, data_axis: str = "corpus"):
    """Up to ``iters`` Lloyd iterations, leaving early at an exact fixed
    point (every further iteration is then the identity, so this equals
    ``iters`` steps bit for bit). The test is on the summed centroids,
    the same on every rank, so every rank takes the same trip count."""
    for _ in range(iters):
        new = sharded_lloyd_step(points, weights, cents, mesh, data_axis)
        done = torch.equal(new, cents)
        cents = new
        if done:
            break
    return cents


def sharded_assign(points, cents, mesh, data_axis: str = "corpus"):
    """Exact 1-NN of this rank's shard of points against the centroids,
    gathered over the axis: (assign [n] int32, d2 [n]) for all the
    points, in shard order, on every rank."""
    a, d2 = _nearest(points, cents)
    return (all_gather_stack(a.to(torch.int32), mesh, data_axis).reshape(-1),
            all_gather_stack(d2, mesh, data_axis).reshape(-1))


def sharded_kmeans(points, k: int, *, weights, iters: int, seed: int, mesh,
                   data_axis: str = "corpus"):
    """Weighted k-means of points [n, D] (the whole set, the same on
    every rank) with the points sharded over ``data_axis``. The points
    are padded with zero-weight rows to a multiple of the axis size (not
    the single-device k-means' power of two), and the weighted-sample
    init draws its Gumbel noise over that padded length, so the seeding
    depends on the shard count. Returns (cents [k, D], assign [n] int32,
    d2 [n]), the same on every rank."""
    n = points.shape[0]
    nshard = mesh_shape(mesh)[data_axis]
    npad = -(-n // nshard) * nshard
    pts = torch.nn.functional.pad(points.float(), (0, 0, 0, npad - n))
    w = torch.nn.functional.pad(torch.as_tensor(weights, dtype=torch.float32,
                                                device=pts.device), (0, npad - n))
    g = prng.gumbel(prng.prng_key(seed), (npad,), device=pts.device)
    order = torch.sort(_log_weights(w) + g, descending=True, stable=True).indices
    cents = pts[order[:min(k, n)]]
    tloc = npad // nshard
    lo = axis_index(mesh, data_axis) * tloc
    mine, wmine = pts[lo:lo + tloc], w[lo:lo + tloc]
    cents = sharded_lloyd(mine, wmine, cents, iters, mesh, data_axis)
    assign, d2 = sharded_assign(mine, cents, mesh, data_axis)
    return cents, assign[:n], d2[:n]
