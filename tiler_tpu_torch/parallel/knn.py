"""Corpus-sharded exact KNN (the port of ``tiler_tpu/parallel/knn.py``):
each rank ranks its shard of the corpus, then every shard's candidates
are gathered for the global re-rank.

The distances are float32, ``|f|^2 - 2 f.d + |d|^2`` as the JAX package
writes them (TF32 is off, ``tiler_tpu_torch/__init__.py``). Both top-k
passes keep ``jax.lax.top_k``'s order: ascending distance, ties to the
lower index. ``torch.topk`` does not promise that, so it ranks unique
int64 keys, the distance's order-preserving bits over the column.
"""
from __future__ import annotations

import torch

from .collectives import all_gather_stack, axis_index

# bytes a pass of an exact top-k may hold over its [cells, T] distances
# (here and in pipeline/reconstruct.py's meshless exact path)
TOPK_BUDGET = 4e9
# bytes a distance takes in a chunk of sharded_topk: the f32 product and
# distances, the int32 bits, the int64 keys
CHUNK_BYTES = 32


def sq_dists(x: torch.Tensor, y: torch.Tensor, y2: torch.Tensor | None = None):
    """[n, m] float32 squared L2 distances of x [n, D] to y [m, D],
    ``|x|^2 - 2 x.y + |y|^2``; ``y2`` is ``|y|^2`` where the caller holds it."""
    if y2 is None:
        y2 = (y * y).sum(dim=1)
    return (x * x).sum(dim=1, keepdim=True) - 2.0 * (x @ y.T) + y2


def chunk_rows(t: int) -> int:
    """Rows of cells a chunk of sharded_topk ranks against t corpus rows."""
    return max(1, int(TOPK_BUDGET / (t * CHUNK_BYTES)))


def stable_topk(d: torch.Tensor, k: int):
    """The k least entries of each row of d [N, T] float32, ascending,
    ties to the lower column. Returns (columns int64 [N, k], values)."""
    bits = (d + 0.0).view(torch.int32)  # + 0.0 folds -0.0 into +0.0
    order = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).long()
    cols = torch.arange(d.shape[1], device=d.device)
    sel = torch.topk((order << 32) | cols, k, dim=1, largest=False, sorted=True).indices
    return sel, d.gather(1, sel)


def sharded_topk(feats: torch.Tensor, ds_local: torch.Tensor, k: int, mesh,
                 corpus_axis: str = "corpus"):
    """feats [N, D] (the same on every rank), ds_local [T/n, D]: this
    rank's shard of a corpus of T rows (T a multiple of the axis size n,
    shards in coordinate order). Returns (idx [N, k] int32 global rows,
    err [N, k] ascending squared L2), the same on every rank of the axis."""
    tloc = ds_local.shape[0]
    kk = min(k, tloc)
    dn = (ds_local * ds_local).sum(dim=1)
    rows = chunk_rows(tloc)
    sels, errs = [], []
    for i in range(0, feats.shape[0], rows):
        sel, err = stable_topk(sq_dists(feats[i:i + rows], ds_local, dn), kk)
        sels.append(sel)
        errs.append(err)
    gidx = (torch.cat(sels) + axis_index(mesh, corpus_axis) * tloc).to(torch.int32)
    N = feats.shape[0]
    # every shard's candidates, shard-major within a row (the JAX layout)
    all_e = all_gather_stack(torch.cat(errs), mesh, corpus_axis).transpose(0, 1).reshape(N, -1)
    all_i = all_gather_stack(gidx, mesh, corpus_axis).transpose(0, 1).reshape(N, -1)
    sel, err = stable_topk(all_e, k)
    return all_i.gather(1, sel), err
