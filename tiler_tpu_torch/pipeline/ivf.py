"""IVF (inverted-file) two-level corpus search for phase A's top-k
(``knn_backend="ivf"``).

Counterpart of ``tiler_tpu/pipeline/ivf.py``:

  1. once an encode: k-means the corpus features into ~T/(2M) clusters,
     order the tiles by cluster, pad each cluster to whole blocks of M
     tiles and keep each block's mean (:func:`build_ivf`; the host layout
     from the assignment is :func:`ivf_layout`);
  2. a row of cells: rank the B block means (an [N, B] product), take each
     cell's top ``probes`` blocks, group the cells by probed block with a
     fixed capacity a block, and rank exact distances only against the
     probed blocks' members (a block-batched product) (:func:`ivf_topk`).

The capacity ``cap = max(128, _bucket(N * P / B * 8))`` depends on the
row's cell count N, and when a block draws more probes than that, the
probes that ranked it lowest drop (p-major order): the drops depend on
the row's composition, so the caller sends the JAX package's rows of
8,192 cells (``pipeline/reconstruct.py``). Ties go as ``jax.lax.top_k``
takes them, to the lower index (stable sorts).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..cluster.kmeans import kmeans

IVF_SEED = 0x42381337


class IVFState(NamedTuple):
    """B (blocks) and M (block size) are the shapes of ds_blk [B, M, 192]."""

    block_means: torch.Tensor  # [B, 192] bf16 block representatives
    bm2: torch.Tensor          # [B] f32 |mean|^2 (+inf for empty blocks)
    ds_blk: torch.Tensor       # [B, M, 192] bf16 block member features
    d2_blk: torch.Tensor       # [B, M] f32 |member|^2 (+inf padding)
    gid_blk: torch.Tensor      # [B, M] int32 global tile ids (0 padding)

    @property
    def n_blocks(self) -> int:
        return int(self.ds_blk.shape[0])

    @property
    def block_size(self) -> int:
        return int(self.ds_blk.shape[1])


def _bucket(n: int) -> int:
    """1.5-step size buckets: 1, 2, 3, 4, 6, 9, 13, 19, ..."""
    b = 1
    while b < n:
        b = b * 3 // 2 if b * 3 // 2 > b else b + 1
    return b


def ivf_clusters(T: int, block_size: int) -> int:
    """k of the corpus k-means: clusters average two blocks."""
    return max(1, min(T // (2 * block_size) + 1, T))


def ivf_layout(ds: torch.Tensor, assign, block_size: int = 128) -> IVFState:
    """The IVF of the corpus features ds [T, D] f32 (on their device) from
    a cluster assignment [T] (any integer array): per cluster its member
    indexes in corpus order, then sentinel padding to a multiple of M, so
    that no block straddles two clusters; the block count bucketed. The
    layout is built on the host with numpy, as the JAX package builds it."""
    T, D = ds.shape
    M = block_size
    a = (assign.cpu().numpy() if isinstance(assign, torch.Tensor)
         else np.asarray(assign)).astype(np.int64)
    k = int(a.max()) + 1 if len(a) else 1
    order = np.argsort(a, kind="stable")
    counts = np.bincount(a, minlength=k)
    nblocks = np.maximum(1, -(-counts // M)) * (counts > 0)
    B = _bucket(int(nblocks.sum()))
    layout = np.full(B * M, T, np.int64)  # sentinel T: a zero row at +inf
    pos = off = 0
    for c in range(k):
        n = int(counts[c])
        if n == 0:
            continue
        layout[pos:pos + n] = order[off:off + n]
        off += n
        pos += int(nblocks[c]) * M
    gid = torch.as_tensor(layout.reshape(B, M), device=ds.device)
    valid = gid < T
    ds_pad = torch.cat([ds.float(), torch.zeros(1, D, device=ds.device)])
    blk = ds_pad[gid.reshape(-1)].reshape(B, M, D)
    d2 = torch.where(valid, (blk * blk).sum(dim=-1), torch.inf)
    cnt = valid.sum(dim=1).clamp_min(1).float()
    means = blk.sum(dim=1) / cnt[:, None]
    bm2 = torch.where(valid.any(dim=1), (means * means).sum(dim=-1), torch.inf)
    return IVFState(
        block_means=means.to(torch.bfloat16),
        bm2=bm2,
        ds_blk=blk.to(torch.bfloat16),
        d2_blk=d2,
        # padding slots point at tile 0: they surface only when a cell has
        # fewer than kk finite candidates, and the gathers downstream must
        # stay in range
        gid_blk=torch.where(valid, gid, 0).to(torch.int32),
    )


def build_ivf(ds: torch.Tensor, block_size: int = 128, kmeans_iters: int = 6,
              seed: int = IVF_SEED) -> IVFState:
    """k-means of the corpus features ds [T, 192] (the port's
    ``cluster.kmeans.kmeans``), then :func:`ivf_layout`."""
    k = ivf_clusters(ds.shape[0], block_size)
    _, assign, _ = kmeans(ds, k, iters=kmeans_iters, seed=seed)
    return ivf_layout(ds, assign, block_size)


def _capacity(N: int, B: int, P: int, cap: int) -> int:
    """Cells a block takes in one row: 8x the average load, at least 128."""
    return cap or max(128, _bucket(int(N * P / max(1, B) * 8)))


def _probe_blocks(feats: torch.Tensor, ivf: IVFState, P: int) -> torch.Tensor:
    """Each cell's P nearest block means [N, P] (the per-cell |f|^2 is left
    out: it does not change the order), ties to the lower block."""
    fb = feats.to(torch.bfloat16).float()
    cd = ivf.bm2[None, :] - 2.0 * (fb @ ivf.block_means.float().T)
    return torch.sort(cd, dim=1, stable=True).indices[:, :P]


def ivf_search(feats: torch.Tensor, ivf: IVFState, kk: int, probes: int = 8,
               cap: int = 0):
    """:func:`ivf_topk` that also returns how many of each cell's probes
    the capacity dropped ([N] int64, on the cells' device)."""
    dev = feats.device
    N, D = feats.shape
    B, M = ivf.n_blocks, ivf.block_size
    P = min(probes, B)
    K = _capacity(N, B, P, cap)
    blk = _probe_blocks(feats, ivf, P)  # [N, P]

    # group the N*P probe slots by (block, probe rank): when a hot block
    # is over its capacity, the probes that ranked it lowest drop
    flat_b = blk.reshape(-1)
    slots = torch.arange(N * P, device=dev)
    sort_idx = torch.sort(flat_b * P + slots % P, stable=True).indices
    sorted_b = flat_b[sort_idx]
    sorted_q = (slots // P)[sort_idx]
    starts = torch.searchsorted(sorted_b, torch.arange(B, device=dev))
    rank_sorted = slots - starts[sorted_b]
    keep = rank_sorted < K
    qidx = torch.full((B, K), N, dtype=torch.long, device=dev)
    qidx.index_put_((sorted_b[keep], rank_sorted[keep]), sorted_q[keep])
    rank_flat = torch.empty_like(rank_sorted)
    rank_flat[sort_idx] = rank_sorted
    ok_flat = rank_flat < K

    # block-batched distances [B, K, M], |f|^2 folded in before the bf16
    # cast (the values then sit near the true distance, not at -|f|^2)
    fb = feats.to(torch.bfloat16)
    fg = torch.cat([fb, torch.zeros(1, D, dtype=fb.dtype, device=dev)])[qidx]
    f2 = (feats * feats).sum(dim=1)
    f2g = torch.cat([f2, torch.zeros(1, device=dev)])[qidx]
    prod = torch.bmm(fg.float(), ivf.ds_blk.float().transpose(1, 2))
    dist = (f2g[:, :, None] + ivf.d2_blk[:, None, :] - 2.0 * prod).to(torch.bfloat16)

    # back to cell-major [N, P * M], then the kk smallest
    lin = flat_b * K + rank_flat.clamp_max(K - 1)
    probe_dist = dist.reshape(B * K, M)[lin]
    probe_dist = torch.where(ok_flat[:, None], probe_dist, torch.inf)
    cand = probe_dist.reshape(N, P * M)
    top = torch.sort(cand, dim=1, stable=True)
    loc = top.indices[:, :kk]
    b_win = blk.gather(1, loc // M)
    gid = ivf.gid_blk[b_win, loc % M]
    return gid.to(torch.int32), top.values[:, :kk].float(), (~ok_flat).view(N, P).sum(dim=1)


def ivf_topk(feats: torch.Tensor, ivf: IVFState, kk: int, probes: int = 8,
             cap: int = 0):
    """Top-kk nearest corpus tiles of feats [N, 192]: (idx [N, kk] int32 by
    ascending distance, the bf16 ranking distances [N, kk] as f32). The
    exact errors are recomputed downstream, as after any top-k."""
    idx, err, _ = ivf_search(feats, ivf, kk, probes, cap)
    return idx, err


def ivf_probe_overflow(feats: torch.Tensor, ivf: IVFState, probes: int = 8,
                       cap: int = 0) -> float:
    """Share of the probe slots that the capacity drops (well under 1% at
    the default 8x slack)."""
    N = feats.shape[0]
    B = ivf.n_blocks
    P = min(probes, B)
    K = _capacity(N, B, P, cap)
    counts = torch.bincount(_probe_blocks(feats, ivf, P).reshape(-1), minlength=B)
    return float((counts - K).clamp_min(0).sum()) / float(N * P)
