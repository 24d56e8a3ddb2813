"""K-modes clustering over categorical (byte) vectors, on torch tensors.

Counterpart of ``tiler_tpu/cluster/kmodes.py`` (numpy), with its
results: farthest-point-first init from the densest point, matching
dissimilarity (the Hamming distance over attributes) by chunks of rows,
and per-cluster per-attribute majority values by one ``bincount``. The
original's tie rules hold: ``argmin``/``argmax`` take the first index,
and among equal counts the mode is the smallest value (``np.unique``
sorts). An empty cluster is re-seeded with the point that fits its own
mode worst. Runs on the device of its input.
"""
from __future__ import annotations

from typing import Tuple

import torch

CHUNK = 4096  # rows a distance block ([CHUNK, K, D] booleans)


def _matching_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[N, D] x [K, D] -> [N, K] Hamming distances (int32)."""
    return torch.cat([(a[i:i + CHUNK, None, :] != b[None, :, :]).sum(dim=2, dtype=torch.int32)
                      for i in range(0, a.shape[0], CHUNK)])


def init_farthest_first(x: torch.Tensor, k: int, seed: int = 0) -> torch.Tensor:
    """Start from the densest point (the largest sum of its values'
    per-attribute frequencies), then repeatedly take the point farthest
    (max-min) from the chosen set. ``seed`` is unused, as in the
    original."""
    n, d = x.shape
    freq_score = torch.zeros(n, dtype=torch.int64, device=x.device)
    for j in range(d):
        _, inv, counts = torch.unique(x[:, j], return_inverse=True, return_counts=True)
        freq_score += counts[inv]
    chosen = [int(torch.argmax(freq_score))]
    min_d = _matching_dist(x, x[chosen])[:, 0]
    while len(chosen) < min(k, n):
        nxt = int(torch.argmax(min_d))
        chosen.append(nxt)
        min_d = torch.minimum(min_d, _matching_dist(x, x[[nxt]])[:, 0])
    return x[chosen].clone()


def _majority(x: torch.Tensor, labels: torch.Tensor, k: int) -> torch.Tensor:
    """Per cluster and attribute the most frequent value, the smallest
    among equal counts: [k, D] (a cluster without points gets garbage)."""
    n, d = x.shape
    vals, rank = torch.unique(x, sorted=True, return_inverse=True)  # rank: x's value order
    nv = len(vals)
    key = (labels[:, None] * d + torch.arange(d, device=x.device)) * nv + rank
    counts = torch.bincount(key.reshape(-1), minlength=k * d * nv).reshape(k, d, nv)
    return vals[torch.argmax(counts, dim=2)]


def kmodes(x: torch.Tensor, k: int, max_iter: int = 100, seed: int = 0
           ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Returns (modes [k, D], labels [N] int64, n_iter), as the numpy
    original does for the same input."""
    n, d = x.shape
    k = min(k, n)
    modes = init_farthest_first(x, k, seed)
    labels = torch.full((n,), -1, dtype=torch.int64, device=x.device)
    for it in range(max_iter):
        dist = _matching_dist(x, modes)
        new_labels = torch.argmin(dist, dim=1)
        if torch.equal(new_labels, labels):
            return modes, labels, it
        labels = new_labels
        empty = torch.bincount(labels, minlength=k) == 0
        modes = _majority(x, labels, k).to(x.dtype)
        if bool(empty.any()):
            # every empty cluster takes the worst-fit point
            worst = torch.argmax(dist.gather(1, labels[:, None])[:, 0])
            modes[empty] = x[worst]
    return modes, labels, max_iter
