"""The reference for the bucket top-2 kernel (B2) and for the mesh's
corpus-sharded exact top-k, each on the timed encode's own operands.

The kernel multiplies cell rows fa [Np, depth] by corpus columns dsTa
[depth, Tp] (both bfloat16; the product is each cell's squared distance to
each tile, folded into one product), clamps at 0, and returns for every
cell and bucket of 512 tiles the smallest and second-smallest key: the
float32 bits of the distance with the low 9 bits holding the tile's lane.
Here the same products are summed in float64 (products of bfloat16 values
are exact, so only the kernel's float32 summation and its 14-bit key
mantissa separate the two), and each of the kernel's picks is measured
against the true best of its bucket:

    gap = max over cells and buckets of
          (d[pick1] - d_min1) / s1,  (d[pick2] - d_min2) / s2,
          |key1 - d[pick1]| / a1,    |key2 - d[pick2]| / a2

where d is the clamped distance, d_min1 <= d_min2 the two smallest in the
bucket, a the sum of absolute products of a pick (the scale of its
rounding) and s the sum of a at the pick and at the true one. A repeated
lane reads 1.

The mesh's top-k (:func:`topk_gap`) picks the k nearest of every corpus
row to each cell, ranked on float32 squared distances ``|f|^2 - 2 f.d +
|d|^2`` against one shard of the corpus and merged over the shards.
Here the whole corpus is ranked in float64, and the picks' distances,
sorted, are held place by place against the true k smallest:

    gap = max over cells and places j of (d(p_j) - d_j) / (a(p_j) + a(t_j))

where d_j is the j-th smallest distance, t_j its row, p_j the pick
whose distance is the j-th smallest of the picks, and a = |f|^2 +
2 sum |f_i d_i| + |d|^2 the scale of a distance's float32 rounding. A
gap is never negative (the j-th smallest of any k rows is at least
d_j) and 0 where the picks are the true k nearest or differ from them
at exact ties. A pick outside the corpus, or repeated, reads 1.

The mesh's k-means (:func:`kmeans_gap`) assigns every point to its
nearest centroid on the same float32 distances, each rank its shard,
the assignments gathered. Here every point's distance to every returned
centroid is taken in float64, and the assigned one is held against the
nearest:

    gap = max over points of (d(c_a) - d(c_b)) / (a(c_a) + a(c_b))

where c_a is the assigned centroid, c_b the nearest, and a as above. An
assignment outside the centroids reads 1.
"""
from __future__ import annotations

import torch

TB = 512
LANE = 0x1FF


def _key_value(keys: torch.Tensor) -> torch.Tensor:
    return (keys & ~LANE).view(torch.float32).double()


def gap(fa: torch.Tensor, dsTa: torch.Tensor, k1: torch.Tensor, k2: torch.Tensor,
        cells_at_once: int = 512) -> float:
    """The widest normalized gap of the kernel's keys k1, k2 [nb, Np]."""
    Np, Tp = fa.shape[0], dsTa.shape[1]
    nb = Tp // TB
    ds = dsTa.double()
    ads = ds.abs()
    worst = 0.0
    for c0 in range(0, Np, cells_at_once):
        f = fa[c0:c0 + cells_at_once].double()
        n = f.shape[0]
        d = torch.clamp_min(f @ ds, 0.0).reshape(n, nb, TB)
        a = (f.abs() @ ads).reshape(n, nb, TB)
        low = torch.topk(d, 2, dim=-1, largest=False).values  # [n, nb, 2]
        best_a = a.gather(-1, torch.topk(d, 1, dim=-1, largest=False).indices)[..., 0]
        terms = []
        for j, keys in enumerate((k1, k2)):
            kk = keys[:, c0:c0 + n].T  # [n, nb]
            lane = (kk & LANE).long()[..., None]
            dp = d.gather(-1, lane)[..., 0]
            ap = a.gather(-1, lane)[..., 0]
            s = ap + best_a
            terms.append(torch.where(s > 0, (dp - low[..., j]) / s, 0.0))
            terms.append(torch.where(ap > 0, (_key_value(kk) - dp).abs() / ap, 0.0))
        same = (k1[:, c0:c0 + n] == k2[:, c0:c0 + n]).T
        terms.append(same.double())
        worst = max(worst, float(torch.stack(terms).max()))
    return worst


def _quantized(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x through ``dtype`` with one scale for the tensor (its largest
    magnitude to the format's largest), back in float64."""
    x = x.double()
    scale = float(x.abs().max()) / float(torch.finfo(dtype).max) or 1.0
    return (x / scale).to(dtype).double() * scale


def keys_in(fa: torch.Tensor, dsTa: torch.Tensor, dtype: torch.dtype = torch.float8_e4m3fn,
            cells_at_once: int = 512) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's keys (k1, k2) [nb, Np] int32 from the operands taken
    through ``dtype`` (the control: fp8, below the kernel's bfloat16)."""
    Np, Tp = fa.shape[0], dsTa.shape[1]
    nb = Tp // TB
    ds = _quantized(dsTa, dtype)
    fq = _quantized(fa, dtype)
    lane = torch.arange(TB, dtype=torch.int32, device=fa.device)
    k1 = torch.empty(nb, Np, dtype=torch.int32, device=fa.device)
    k2 = torch.empty_like(k1)
    for c0 in range(0, Np, cells_at_once):
        d = torch.clamp_min(fq[c0:c0 + cells_at_once] @ ds, 0.0).float()
        key = (d.view(torch.int32).reshape(-1, nb, TB) & ~LANE) | lane
        two = torch.topk(key, 2, dim=-1, largest=False).values
        k1[:, c0:c0 + cells_at_once] = two[..., 0].T
        k2[:, c0:c0 + cells_at_once] = two[..., 1].T
    return k1, k2


def topk_gap(feats: torch.Tensor, picks: torch.Tensor, ds: torch.Tensor,
             rows_at_once: int = 64) -> float:
    """The widest normalized gap of the k picks [n, k] (rows of ds [T, D])
    of the cells feats [n, D] against their k nearest rows in float64."""
    T, k = ds.shape[0], picks.shape[1]
    d = ds.double()
    d2 = (d * d).sum(dim=1)
    ad = d.abs().T
    worst = 0.0
    for r0 in range(0, feats.shape[0], rows_at_once):
        f = feats[r0:r0 + rows_at_once].double()
        p = picks[r0:r0 + rows_at_once].long().to(f.device)
        f2 = (f * f).sum(dim=1, keepdim=True)
        dist = (f2 - 2.0 * (f @ d.T) + d2).clamp_min(0.0)
        scale = f2 + 2.0 * (f.abs() @ ad) + d2
        true = torch.topk(dist, k, dim=1, largest=False)  # ascending
        bad = (p < 0) | (p >= T)
        ps = p.clamp(0, T - 1)
        repeated = (ps.sort(dim=1).values.diff(dim=1) == 0).any(dim=1)
        dp = dist.gather(1, ps)
        order = dp.argsort(dim=1)
        dp_sorted = dp.gather(1, order)
        ap_sorted = scale.gather(1, ps.gather(1, order))
        at = scale.gather(1, true.indices)
        gap = (dp_sorted - true.values) / (ap_sorted + at)
        if bool(bad.any()) or bool(repeated.any()):
            return 1.0
        worst = max(worst, float(gap.max()))
    return worst


def kmeans_gap(points: torch.Tensor, cents: torch.Tensor, assign: torch.Tensor,
               rows_at_once: int = 2048) -> float:
    """The widest normalized gap of the assignments [n] of points [n, D]
    to centroids cents [k, D] against each point's nearest in float64."""
    c = cents.double()
    k = c.shape[0]
    c2 = (c * c).sum(dim=1)
    ac = c.abs().T
    worst = 0.0
    for r0 in range(0, points.shape[0], rows_at_once):
        p = points[r0:r0 + rows_at_once].double()
        a = assign[r0:r0 + rows_at_once].long().to(p.device)[:, None]
        if bool(((a < 0) | (a >= k)).any()):
            return 1.0
        p2 = (p * p).sum(dim=1, keepdim=True)
        dist = (p2 - 2.0 * (p @ c.T) + c2).clamp_min(0.0)
        scale = p2 + 2.0 * (p.abs() @ ac) + c2
        best = dist.argmin(dim=1, keepdim=True)
        gap = (dist.gather(1, a) - dist.gather(1, best)) / (scale.gather(1, a)
                                                             + scale.gather(1, best))
        worst = max(worst, float(gap.max()))
    return worst
