"""esReconstruct: the rate-distortion core.

Counterpart of the default path of ``tiler_tpu/pipeline/reconstruct.py``:

  Phase A (independent per cell): each cell's top-k corpus tiles by
    squared feature distance -- kernel B2 (``kernels/knn_topk.py``), or
    the v1 kernel under ``knn_backend="pallas_v1"``, on the card when the
    corpus is wide enough, an exact bf16 top-k below that; under
    ``knn_backend="ivf"`` from ``ivf_min_corpus`` tiles up the two-level
    IVF search (``pipeline/ivf.py``) -- then the EPU cartesian re-rank of
    (candidate tile, candidate palette) pairs and the exact fp32 error of
    the winner. Cells whose motion prediction is already perfect get only
    a cheap k=1 nearest tile. The cells run in rows of ``CELL_ROW``, the
    port's frame loop; under the IVF a short last row is padded with its
    last cell, as the JAX package pads it, since the IVF's capacity and
    drops depend on the row. With a mesh (the JAX package's mesh branch,
    ``tiler_tpu/pipeline/reconstruct.py:766-820``) every cell instead
    takes the exact float32 top-k of the corpus sharded over the "corpus"
    axis (``parallel/knn.py``), in groups of frames, with no cheap cells,
    no top-k kernel and no IVF, before the same re-rank.
  Phase B (sequential per keyframe): a frame loop with the framebuffer
    carried. Under ``phase_b_motion="reuse"`` (the default) each cell
    keeps its phase-A motion vector, whose error is evaluated exactly
    against the reconstruction; under ``"research"`` every frame but a
    keyframe's first re-runs the full-radius motion search against the
    reconstruction (the reference's TFrame.Reconstruct,
    tilingencoder.pas:1496-1532). Prediction wins unless the KNN error
    beats it by more than TOL.

``int16_features`` rounds the features at every exact-error site: the
rendered corpus (which the top-k kernels then rank), the cells, the EPU
winner's error and phase B's (SmallInt semantics, tilingencoder.pas:3126).
Host-resident cells and frames (``pipeline/load.py``) are gathered on the
host and go up a row of cells, or a keyframe, at a time.

EPU tie-break: among minimal-error pairs, the smallest packed
``tile * P + palette`` id, which is the reference's strict-< scan over
candidates sorted tile-major, palette-minor.

On the CPU both phases compute in the JAX package's CPU float order
(``ops/ordered.py``, ``ops/introsort.py``; ``tests/test_torch_reconstruct_
order.py``), so that their winners, flags and PSNR bits are the
reference's: the features as XLA fuses them, the exact errors as fma(z, w,
-rf) summed in XLA's windows, the exact top-k's keys from a bounded
float32 product with the open ones summed again in XLA's order and the
order of equal keys that its unstable sort leaves (:func:`_topk_ordered`),
the EPU's deciding pair errors in XLA's batched-dot orders
(:func:`_ordered_pick`, at the palette sizes :func:`_epu_ordered` names),
and phase B's errors (:func:`_eval_vectors`). On a card both keep the
card's own arithmetic, chosen by the device alone.

The EPU's tables, three ways (``tiler_tpu/pipeline/reconstruct.py:209-368``):
the default bf16 G and f32 Q rows; ``epu_two_stage``, int8 low-frequency
G and int16 Q that rank every pair, then the exact errors of each cell's
best ``epu_stage1_m`` pairs; ``epu_fused_fp``, one byte row of the
default's G and Q a tile, gathered once, ranking bit for bit as the
default. On a card where a palette count P is no more than Q's row
length (the wide palettes, :func:`_epu_table`), the port's own fourth:
G and a [T, P] table of every tile's Q . R with every palette, built once
a reconstruct, in place of Q and the per-cell product of its rows.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import EncoderSettings
from ..kernels.knn_topk import (TB, TP_ALIGN, knn_bucket_topk, knn_bucket_topk2,
                                knn_prep2, knn_prep_v1)
from ..models.state import EncodeState
from ..ops.color import rgb_to_yuv
from ..ops.dct import DCT_MAT, DCT_WEIGHTS
from ..ops.introsort import sorted_prefix
from ..ops.metrics import euclidean_to_psnr
from ..ops.ordered import U32, bf16_pairs_sum, gamma, lanes4_sum, row_sum
from ..parallel.collectives import axis_index
from ..parallel.knn import TOPK_BUDGET, sharded_topk
from ..parallel.mesh import mesh_shape
from .ivf import build_ivf, ivf_search
from .load import to_device
from .motion import feature_residual, motion_search, tile_dct_features

TILE_W = 8
K = 192
TOL = 192.0  # cTileDCTSize comparison tolerance
CELL_ROW = 8192  # cells per phase-A row
MESH_GROUP_BYTES = 4e8  # the mesh branch's group of frames: features and EPU pairs
PAD_FEATURE = 1e12  # the mesh branch pads the corpus with rows that never rank
INT32_MAX = 2**31 - 1
# elements of the quadratic tables' [tiles, S, S] products a chunk of tiles
# (1 GiB of f32): 4,096 tiles at S = 256
QUAD_CHUNK = 1 << 28
IDCT_CHUNK = 16384  # tiles a chunk of _indicator_dcts' one-hot products
# the CPU's ordered phase A: (cell, tile) entries a chunk of the ordered
# ranking sums, and the bytes of one [cells, T] float32 matrix of the
# ordered top-k
ORDERED_ENTRIES = 1 << 17
ORDERED_TOPK_BYTES = 2.5e8
SLACK = 1.01  # margin on a summation bound for its own float32 rounding
# what the ordered phase A computes and sums again in XLA's order, counted
# into reconstruct's stats (as "ordered_<name>")
ORDERED_COUNTS = ("topk_keys", "topk_keys_resummed", "topk_rows", "topk_rows_replayed",
                  "epu_pairs", "epu_pairs_resummed")


def _render_corpus(palettes_rgb, pal_initial, pal_pixels):
    """Corpus tiles through their own palettes -> RGB uint8 [T, 8, 8, 3]."""
    return palettes_rgb[pal_initial.long()[:, None, None], pal_pixels.long()]


def _indicator_dcts(pal_pixels, S: int, chunk: int = IDCT_CHUNK):
    """G[t, vu, s] = DCT2D(indicator(pal_pixels == s)): the linear map
    from palette YUV colors to the tile's DCT features. One [B*S, 64] x
    [64, 64] matmul of the bf16 one-hot map (exact products, f32 sums).
    Returns float32 [T, 64, S]."""
    dev = pal_pixels.device
    D = np.asarray(DCT_MAT, np.float64)
    basis = torch.as_tensor(np.einsum("vy,ux->vuyx", D, D).reshape(64, 64).T,
                            dtype=torch.bfloat16, device=dev).float()
    outs = []
    for i in range(0, len(pal_pixels), chunk):
        pp = pal_pixels[i:i + chunk].reshape(-1, 64).long()
        B = pp.shape[0]
        oh = torch.nn.functional.one_hot(pp, S).float()  # [B, 64, S]
        g = oh.transpose(1, 2).reshape(B * S, 64) @ basis  # [B*S, 64]
        outs.append(g.reshape(B, S, 64).transpose(1, 2))
    return torch.cat(outs)


def _quad_rows(Gf, wf2, tri_i, tri_j, dbl):
    """Packed upper-triangle quadratic rows of a chunk of tiles:
    [tiles, 3 * ntri] float32 from Gf [tiles, V, S] float32 and the
    squared weights wf2 [V, 3] of its V coefficients. At V = 64 both
    torch's CPU bmm and cuBLAS's sum each entry as the JAX package's CPU
    batched dot does, one FMA chain over v
    (``tests/test_torch_reconstruct_order.py``; on the card
    ``scripts/torch_profile.py --order-cost``)."""
    outs = [torch.bmm((Gf * wf2[:, c][None, :, None]).transpose(1, 2), Gf)[:, tri_i, tri_j] * dbl
            for c in range(3)]
    return torch.stack(outs, dim=1).reshape(Gf.shape[0], -1)


def _triangle(S: int, dev):
    """Upper-triangle indexes of an S x S matrix and the doubling of its
    off-diagonal entries."""
    tri_i, tri_j = (torch.as_tensor(v, device=dev) for v in np.triu_indices(S))
    return tri_i, tri_j, (tri_i != tri_j).float() + 1.0


def _quad_chunk(S: int) -> int:
    """Tiles a chunk of the quadratic-table builds: their [tiles, S, S]
    products hold at most QUAD_CHUNK elements."""
    return max(1, QUAD_CHUNK // (S * S))


def _epu_table(dev, P: int, S: int) -> bool:
    """Whether the EPU takes each pair's Q . R from a [T, P] table built
    once a reconstruct (``_epu_tables(..., rall=...)``) rather than
    multiplying the gathered Q and R rows per cell: on a card, where a
    table row (P values) is no longer than the Q row it replaces (3 S(S+1)
    / 2 values). At 16 palettes of 256 colours the table is 2.3 MB
    against 14.3 GB of Q at T = 36,307; at 1,024 palettes of 16 it would
    be larger than Q, so the default keeps the per-cell product. The CPU
    keeps it too: there the JAX package sums Q . R per cell in XLA's
    order (:func:`_ordered_pick`)."""
    return dev.type == "cuda" and P <= 3 * S * (S + 1) // 2


def _epu_tables(pal_pixels, S: int, fused: bool = False, rall=None):
    """The EPU's rank tables of the corpus: G = _indicator_dcts in bf16
    [T, 64, S] (ranking only), and the per-tile quadratic form, packed
    upper triangle, Q[t, (c, s<=s')] = sum_v wf[v,c]^2 G[t,v,s] G[t,v,s']
    with the off-diagonal entries doubled, so that |rendered feature|^2 of
    (tile t, palette j) is Q[t] . R[j]: [T, 3*S*(S+1)/2] float32, 394,752
    bytes a tile at S = 256. Both are built by chunks of tiles whose
    [tiles, S, S] products hold at most ``QUAD_CHUNK`` elements (16,384
    tiles at most), so that G in f32 never stands whole.

    Given the palettes' outer products ``rall`` [P, X] (:func:`_rall`;
    the table path, :func:`_epu_table`), each chunk's Q rows are
    multiplied by ``rall.T`` in one float32 GEMM and dropped: returns (G,
    QR) with QR[t, j] = Q[t] . R[j] [T, P], and no Q stands whole (with
    Q gone there is nothing to fuse: ``fused`` is False).

    With ``fused`` (``epu_fused_fp``) both go into one uint8 table, G's
    bf16 bytes followed by Q's f32 bytes a row, [T, 64 * S * 2 + 4 *
    ntri3], written through dtype views chunk by chunk as the separate
    tables are (so no whole G or Q stands beside it): returns (table,
    None), whose views (:func:`_fused_views`) are the separate tables bit
    for bit. Otherwise (G, Q)."""
    dev = pal_pixels.device
    T = pal_pixels.shape[0]
    w = torch.as_tensor(DCT_WEIGHTS, dtype=torch.float32, device=dev)
    wf2 = (w * w).permute(1, 2, 0).reshape(64, 3)
    tri = _triangle(S, dev)
    ntri3 = 3 * len(tri[0])
    if fused:
        table = torch.empty(T, 64 * S * 2 + 4 * ntri3, dtype=torch.uint8, device=dev)
        G, Q = _fused_views(table, S)
    else:
        G = torch.empty(T, 64 * S, dtype=torch.bfloat16, device=dev)
        Q = torch.empty(T, ntri3 if rall is None else rall.shape[0], dtype=torch.float32,
                        device=dev)
    chunk = min(IDCT_CHUNK, _quad_chunk(S))
    for i in range(0, T, chunk):
        g = _indicator_dcts(pal_pixels[i:i + chunk], S).to(torch.bfloat16)
        G[i:i + chunk] = g.reshape(g.shape[0], -1)
        q = _quad_rows(g.float(), wf2, *tri)
        Q[i:i + chunk] = q if rall is None else q @ rall.T
    return (table, None) if fused else (G.reshape(T, 64, S), Q)


def _fused_views(rows, S: int):
    """The bf16 G [..., 64 * S] and f32 Q [..., 3 * S(S+1)/2] views of
    fused table rows (bytes [..., 64 * S * 2 + 4 * ntri3], in any dtype)."""
    gb = 64 * S * 2
    rows = rows.view(torch.uint8)
    return rows[..., :gb].view(torch.bfloat16), rows[..., gb:].view(torch.float32)


def _div(num: float, t):
    """num / t correctly rounded, as jnp's division (``num / t`` on a
    tensor multiplies by t's reciprocal, which is not)."""
    return torch.full_like(t, num) / t


def _lowfreq_vu(dims: int) -> np.ndarray:
    """(v, u) raster indexes of the low-frequency r x r block of the 8 x 8
    DCT, dims = 3 * r^2 (epu_stage1_dims)."""
    r = int(round((dims / 3) ** 0.5))
    if 3 * r * r != dims or not 1 <= r <= TILE_W:
        raise ValueError(f"epu_stage1_dims must be 3*r^2 with 1 <= r <= 8, got {dims}")
    v, u = np.mgrid[0:r, 0:r]
    return (v * 8 + u).reshape(-1)


def _build_two_stage_tables(pal_pixels, S: int, dims: int):
    """Stage-1 rank tables of the two-stage EPU (``epu_two_stage``), the
    JAX package's ``_build_two_stage_tables`` on G = _indicator_dcts:

    - G8lf [T, L, S] int8: G's low-frequency coefficients (L = dims / 3)
      with a scale per coefficient; g_inv [L] dequantizes them (folded
      into the cell features, so int8 -> bf16 is exact);
    - Q16 [T, 3 * S(S+1)/2] int16 with a scale per column, q_inv: the
      quadratic table of the dequantized low-frequency G (folded into the
      palette outer products).

    Built by chunks of tiles: G in f32 and Q in f32 never stand whole
    (14.3 GB of Q at T = 36,307, S = 256). The column scales need the
    whole f32 Q, so it is computed twice, once for its column maxima and
    once to quantize."""
    dev = pal_pixels.device
    T = pal_pixels.shape[0]
    lf = torch.as_tensor(_lowfreq_vu(dims), device=dev)
    Glf = torch.cat([_indicator_dcts(pal_pixels[i:i + IDCT_CHUNK], S)[:, lf, :]
                     for i in range(0, T, IDCT_CHUNK)])  # [T, L, S] f32
    vmax = Glf.abs().amax(dim=(0, 2)).clamp_min(1e-6)
    gsc = _div(127.0, vmax)
    G8lf = torch.round(Glf * gsc[None, :, None]).to(torch.int8)
    del Glf
    g_inv = _div(1.0, gsc)
    w = np.asarray(DCT_WEIGHTS, np.float64).transpose(1, 2, 0).reshape(64, 3)
    wlf2 = torch.as_tensor((w * w)[lf.cpu().numpy()], dtype=torch.float32, device=dev)
    tri = _triangle(S, dev)
    chunk = _quad_chunk(S)

    def qlf(i):
        return _quad_rows(G8lf[i:i + chunk].float() * g_inv[None, :, None], wlf2, *tri)

    cmax = torch.zeros(3 * len(tri[0]), device=dev)
    for i in range(0, T, chunk):
        cmax = torch.maximum(cmax, qlf(i).abs().amax(dim=0))
    qsc = _div(32767.0, cmax.clamp_min(1e-9))
    Q16 = torch.empty(T, len(cmax), dtype=torch.int16, device=dev)
    for i in range(0, T, chunk):
        Q16[i:i + chunk] = torch.round(qlf(i) * qsc[None, :]).to(torch.int16)
    return G8lf, g_inv, Q16, _div(1.0, qsc)


def _topk_oneshot(feats, ds, k: int):
    """Exact top-k of the bf16-rounded distance expansion (stable sort:
    ties to the lower corpus index). Returns (idx [N, k] int32, err
    [N, k] f32 ascending)."""
    d2 = (ds * ds).sum(dim=1)
    f2 = (feats * feats).sum(dim=1, keepdim=True)
    d = f2 - 2.0 * (feats.to(torch.bfloat16).float()
                    @ ds.to(torch.bfloat16).float().T) + d2
    d = d.to(torch.bfloat16)
    if k == 1:
        a = torch.argmin(d, dim=1, keepdim=True)
        return a.to(torch.int32), d.gather(1, a).float()
    srt = torch.sort(d, dim=1, stable=True)
    return srt.indices[:, :k].to(torch.int32), srt.values[:, :k].float()


def _topk_candidates(feats, ds, k: int):
    """_topk_oneshot over cell blocks whose [cells, T] f32 ranking matrix
    fits TOPK_BUDGET."""
    cell_chunk = max(256, int(TOPK_BUDGET / (ds.shape[0] * 4)))
    outs = [_topk_oneshot(feats[i:i + cell_chunk], ds, k)
            for i in range(0, feats.shape[0], cell_chunk)]
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


def _rank_keys(f2, dot, d2):
    """The top-k's ranking keys bf16(f2 - 2 dot + d2), as float32."""
    return (f2 - 2.0 * dot + d2).to(torch.bfloat16).float()


def _exact_keys(fb, db, f2, d2, rows, cols):
    """The ranking keys of the (cell, tile) entries rows, cols with the
    product fb[rows] . db[cols] as XLA's CPU dot sums it here: the exact
    products of the bf16 values added from k = 0 in float32."""
    out = torch.empty(len(rows))
    for i in range(0, len(rows), ORDERED_ENTRIES):
        r, c = rows[i:i + ORDERED_ENTRIES], cols[i:i + ORDERED_ENTRIES]
        p = (fb[r] * db[c]).T.contiguous()  # [K, n]: each step one contiguous row
        acc = p[0]
        for k in range(1, K):
            acc = acc + p[k]
        out[i:i + ORDERED_ENTRIES] = _rank_keys(f2[r], acc, d2[c])
    return out


def _by_key(ids: np.ndarray, key: np.ndarray) -> np.ndarray:
    """ids ordered by (key, id)."""
    return ids[np.lexsort((ids, key[ids]))]


def _topk_ordered(feats, ds, d2, k: int, pal_k: int, counts=None):
    """The JAX package's CPU top-k (``_topk_oneshot`` with the exact sort
    that ``approx_max_k`` lowers to there), as far as phase A reads it:
    [N, k] int32 corpus indexes whose first ``pal_k`` and whole k are the
    reference's sets (in order of key, then index); for k = 1 the argmin,
    the first of equal keys.

    The product comes from one float32 matmul, bounded by 2 gamma_192
    |fb| |db| around XLA's sum from k = 0; a key is read at both ends of
    its bound and summed again in XLA's order (:func:`_exact_keys`) only
    where the two differ and it could still rank. The reference's sort
    is unstable: where equal keys straddle the k-th or the pal_k-th
    place, the row's keys are all made exact and libstdc++'s introsort is
    replayed on the padded row (``ops/introsort.py``). ``counts`` (a dict)
    adds up the (cell, tile) keys, those summed again, the rows and the
    rows replayed."""
    N, T = feats.shape[0], ds.shape[0]
    fb, db = feats.to(torch.bfloat16).float(), ds.to(torch.bfloat16).float()
    f2 = row_sum(feats * feats)[:, None]
    dot = fb @ db.T
    bound = (2 * gamma(K) * SLACK) * fb.norm(dim=1)[:, None] * db.norm(dim=1)
    lo, hi = _rank_keys(f2, dot + bound, d2), _rank_keys(f2, dot - bound, d2)
    del dot, bound
    n = min(k + 1, T)
    cand = lo <= hi.kthvalue(n, dim=1, keepdim=True).values
    key = torch.where(cand, lo, torch.inf)
    r, c = (cand & (lo != hi)).nonzero(as_tuple=True)
    key[r, c] = _exact_keys(fb, db, f2[:, 0], d2, r, c)
    if counts is not None:
        counts["topk_keys"] += N * T
        counts["topk_keys_resummed"] += len(r)
    if k == 1:
        return key.argmin(dim=1, keepdim=True).to(torch.int32)
    vals, ids = key.topk(n, dim=1, largest=False)
    ids, perm = ids.sort(dim=1)
    vals, order = vals.gather(1, perm).sort(dim=1, stable=True)
    ids = ids.gather(1, order)
    out = ids[:, :k].clone()
    tie = torch.zeros(N, dtype=torch.bool)
    for p in {k, pal_k}:
        if p < n:
            tie |= vals[:, p - 1] == vals[:, p]
    rows = tie.nonzero()[:, 0]
    if counts is not None:
        counts["topk_rows"] += N
        counts["topk_rows_replayed"] += len(rows)
    if len(rows):
        Tpad = 256
        while Tpad < T:
            Tpad *= 2
        full = lo[rows]
        rr, cc = (full != hi[rows]).nonzero(as_tuple=True)
        full[rr, cc] = _exact_keys(fb, db, f2[:, 0], d2, rows[rr], cc)
        if counts is not None:
            counts["topk_keys_resummed"] += len(rr)
        keys = torch.full((len(rows), Tpad), torch.inf, dtype=torch.float64)
        keys[:, :T] = full.double()
        for i, row in enumerate(rows.tolist()):
            key_row = keys[i].numpy()
            pre = sorted_prefix(key_row, (k, pal_k))
            head = pre[pal_k]
            rest = np.setdiff1d(pre[k], head) if pal_k < k else head[:0]
            out[row] = torch.as_tensor(np.concatenate([_by_key(head, key_row),
                                                       _by_key(rest, key_row)]))
    return out.to(torch.int32)


def _topk_ordered_candidates(feats, ds, d2, k: int, pal_k: int, counts=None):
    """_topk_ordered over cell blocks whose [cells, T] float32 matrices fit
    ORDERED_TOPK_BYTES each."""
    cells = max(256, int(ORDERED_TOPK_BYTES / (ds.shape[0] * 4)))
    return torch.cat([_topk_ordered(feats[i:i + cells], ds, d2, k, pal_k, counts)
                      for i in range(0, feats.shape[0], cells)])


def _rall(pal_yuv, S: int):
    """Per-palette outer products at the triangle's indexes: [P, 3 * ntri],
    R[j, (c, s<=s')] = Py[j, s, c] Py[j, s', c]."""
    tri_i, tri_j, _ = _triangle(S, pal_yuv.device)
    Pc = pal_yuv.transpose(1, 2)  # [P, 3, S]
    return (Pc[..., tri_i] * Pc[..., tri_j]).reshape(pal_yuv.shape[0], -1)


def _ftw(f, wf):
    """Weighted cell features [b, 64, 3] from feats [b, 192]."""
    return f.reshape(f.shape[0], 3, 64).transpose(1, 2) * wf


def _cand_products(Gi, ftw):
    """C[b, k, (s, c)] = sum_v Gi[b, k, v, s] ftw[b, v, c]: [b, kk, S * 3]."""
    b, kk, V, S = Gi.shape
    return torch.bmm(Gi.transpose(2, 3).reshape(b, kk * S, V), ftw).reshape(b, kk, S * 3)


def _pair_err(Gi, Qi, ftw, Py, Rj):
    """Norm-expansion error of every (candidate tile, candidate palette)
    pair of a chunk of cells, [b, kk * kp]: Q_i . R_j - 2 <C_i, Py_j> with
    C[b, k, s, c] = sum_v Gi[b, k, v, s] ftw[b, v, c]. Gi [b, kk, V, S]
    float32, ftw [b, V, 3], Py [b, kp, S, 3]. The per-cell path (the CPU,
    and a card where P > X, :func:`_epu_table`) gives the gathered rows Qi
    [b, kk, X] and Rj [b, kp, X] and multiplies them here; the table path
    gives Rj None and Qi the pairs' Q . R entries of the [T, P] table,
    [b, kk, kp], built once a reconstruct, since that term depends on the
    tile and the palette alone."""
    b, S = Gi.shape[0], Gi.shape[3]
    C = _cand_products(Gi, ftw)
    qr = Qi if Rj is None else torch.bmm(Qi, Rj.transpose(1, 2))
    err = qr - 2.0 * torch.bmm(C, Py.reshape(b, -1, S * 3).transpose(1, 2))
    return err.reshape(b, -1)


def _ordered_pick(Gi, Qi, ftw, Py, Rj, tile, pal, P: int, counts=None):
    """:func:`_tie_break` on the JAX package's CPU pair errors. Every
    pair's error is computed in float64 from a float32 C, and bounded
    around XLA's float32 one: XLA sums C over v from k = 0 and the float32
    product any order (each within gamma(V) sum |Gi| |ftw| of exact, a sum
    bounded by Cauchy-Schwarz), then C . Py (3 S terms) and Q . R (X
    terms) in four FMA lanes each (n / 4 + 2 roundings on a term's path),
    so each sum lies within gamma of its count of roundings times the sum
    of |terms|, C's errors carry into C . Py, and the last subtraction
    rounds. Every pair whose bound reaches the cell's least upper bound is
    computed again in XLA's order (C by the bf16 pair sum, the rest by
    four FMA lanes); the others cannot be minimal. ``counts`` (a dict)
    adds up the pairs and those summed again. Returns (tile, pal) [b]."""
    b, kk, V, S = Gi.shape
    kp, X = Py.shape[1], Qi.shape[2]
    Gt = Gi.transpose(2, 3).reshape(b, kk * S, V)
    C = torch.bmm(Gt, ftw).reshape(b, kk, S * 3)
    Py3 = Py.reshape(b, kp, S * 3).transpose(1, 2)
    err = (torch.bmm(Qi.double(), Rj.double().transpose(1, 2))
           - 2.0 * torch.bmm(C.double(), Py3.double())).reshape(b, -1)
    D = (Gt.norm(dim=2)[:, :, None] * ftw.norm(dim=1)[:, None, :]).reshape(b, kk, S * 3)
    H = torch.bmm(D, Py3.abs())
    E = torch.bmm(C.abs(), Py3.abs())
    A = torch.bmm(Qi.abs(), Rj.abs().transpose(1, 2))
    gc = gamma(V)
    bnd = gamma(X // 4 + 2) * A + 2 * (gamma(3 * S // 4 + 2) * (E + 2 * gc * H) + 2 * gc * H)
    bnd = SLACK * (bnd.reshape(b, -1).double() + 2 * U32 * err.abs())
    ub = (err + bnd).min(dim=1, keepdim=True).values
    cb, slot = (err - bnd <= ub).nonzero(as_tuple=True)
    ck, cj = slot // kp, slot % kp
    n = len(cb)
    if counts is not None:
        counts["epu_pairs"] += err.numel()
        counts["epu_pairs_resummed"] += n
    ct, inv = torch.unique(cb * kk + ck, return_inverse=True)  # the (cell, tile) pairs
    Cx = bf16_pairs_sum(Gi[ct // kk, ct % kk].transpose(1, 2)[:, :, None, :],
                        ftw[ct // kk].transpose(1, 2)[:, None, :, :])[inv]  # [n, S, 3]
    e2 = lanes4_sum(Cx.transpose(1, 2).reshape(n, -1), Py[cb, cj].transpose(1, 2).reshape(n, -1))
    ex = lanes4_sum(Qi[cb, ck], Rj[cb, cj]) - 2.0 * e2
    m = torch.full((b,), torch.inf).scatter_reduce(0, cb, ex, "amin")
    win = ex == m[cb]
    combo = tile[cb, slot] * P + pal[cb, slot]
    best = torch.full((b,), INT32_MAX, dtype=combo.dtype).scatter_reduce(
        0, cb[win], combo[win], "amin")
    return best // P, best % P


def _tie_break(err, tile, pal, P: int):
    """Among a cell's minimal-error pairs the smallest packed
    tile * P + pal (the reference's strict-< scan over candidates sorted
    tile-major, palette-minor). err, tile, pal [b, n]. Returns (tile,
    pal, min err) [b]."""
    combo = tile * P + pal
    m = err.min(dim=1, keepdim=True).values
    best = torch.where(err <= m, combo, INT32_MAX).min(dim=1).values
    return best // P, best % P, m[:, 0]


def _epu_ordered(S: int, dev) -> bool:
    """Whether the EPU ranks in XLA's CPU order: on the CPU, at palette
    sizes whose two sums (3 S and 3 S(S+1)/2 terms) XLA splits into four
    equal lanes, up to 32 colors (the order read at S = 8, 16 and 32)."""
    return dev.type == "cpu" and S % 8 == 0 and S <= 32


def _epu_rank_all(feats, cand_idx, cand_pal, G, Q, pal_yuv, S: int, cell_chunk: int,
                  counts=None, *, table: bool = False):
    """Cartesian re-rank of (candidate tile, candidate palette) pairs.

    Norm expansion: argmin over (i, j) of |rf|^2 - 2 <rf, ft> with
    rf = (G_i @ Py_j) * wf; |rf|^2 = Q_i . R_j. Returns (tile [B],
    pal [B]) int64, tie-break by the smallest packed tile * P + pal.

    With ``table`` (:func:`_epu_table`: a card, P <= X) ``Q`` is the
    [T, P] table QR[t, j] = Q[t] . R[j] (``_epu_tables(..., rall=...)``)
    and each pair takes its term from it by (tile, palette): a chunk
    gathers only its G rows and kk * kp table entries, where the per-cell
    path gathers 394,752 bytes of Q a candidate at S = 256 and multiplies
    them again for every cell. Otherwise ``Q`` is the Q table, gathered
    and multiplied by the candidate palettes' R rows per cell; with
    ``Q`` None, ``G`` is the fused table (``epu_fused_fp``): one gather of
    its byte rows, split by dtype views into the same bf16 G and f32 Q
    rows, so the ranking is the default's bit for bit. On the CPU
    (:func:`_epu_ordered`) the per-cell errors that can decide are the
    JAX package's (:func:`_ordered_pick`, which adds to ``counts``),
    given its Q (``_epu_tables``)."""
    dev = feats.device
    B, kk = cand_idx.shape
    kp = cand_pal.shape[1]
    P = pal_yuv.shape[0]
    ordered = _epu_ordered(S, dev) and not table
    w = torch.as_tensor(DCT_WEIGHTS, dtype=torch.float32, device=dev)
    wf = w.permute(1, 2, 0).reshape(64, 3)
    Rall = None if table else _rall(pal_yuv, S)
    tiles, pals = [], []
    for i in range(0, B, cell_chunk):
        f = feats[i:i + cell_chunk]
        ci = cand_idx[i:i + cell_chunk].long()
        cp = cand_pal[i:i + cell_chunk].long()
        b = f.shape[0]
        if table:
            Gi, Qi = G[ci], Q[ci[:, :, None], cp[:, None, :]]  # Q . R entries [b, kk, kp]
        elif Q is None:
            # one gather of whole rows, as 4-byte words (a row is 4 * ntri3
            # + 128 * S bytes; PERF.md section 6); the Q view goes into the
            # product as it is, row stride and all
            Gi, Qi = _fused_views(G.view(torch.int32)[ci], S)
        else:
            Gi, Qi = G[ci], Q[ci]  # [b, kk, 64, S] bf16 (ranking only); [b, kk, 3*ntri]
        Gi = Gi.reshape(b, kk, 64, S).float()
        ftw = _ftw(f, wf).to(torch.bfloat16).float()
        Py, Rj = pal_yuv[cp], None if table else Rall[cp]
        tile = ci[:, :, None].expand(b, kk, kp).reshape(b, -1)
        pal = cp[:, None, :].expand(b, kk, kp).reshape(b, -1)
        if ordered:
            t, p = _ordered_pick(Gi, Qi, ftw, Py, Rj, tile, pal, P, counts)
        else:
            t, p, _ = _tie_break(_pair_err(Gi, Qi, ftw, Py, Rj), tile, pal, P)
        tiles.append(t)
        pals.append(p)
    return torch.cat(tiles), torch.cat(pals)


def _epu_rank_two_stage(feats, cand_idx, cand_pal, G8lf, g_inv, Q16, q_inv, pal_yuv, pp,
                        palettes, S: int, dims: int, M: int, cell_chunk: int,
                        int16: bool = False):
    """Two-stage cartesian re-rank (``epu_two_stage``). Stage 1 is
    _epu_rank_all's norm expansion on the int8 low-frequency G and the
    int16 Q (_build_two_stage_tables), its scales folded into the cell
    features and the palette outer products; stage 2 takes each cell's M
    pairs of least stage-1 error (ties to the lower pair index, as
    ``lax.top_k``) and ranks them by their exact errors, tie-break by the
    smallest packed tile * P + pal. Returns (tile [B], pal [B], exact
    err [B]): the error is already exact."""
    dev = feats.device
    B, kk = cand_idx.shape
    kp = cand_pal.shape[1]
    P = pal_yuv.shape[0]
    M = min(M, kk * kp)
    lf = torch.as_tensor(_lowfreq_vu(dims), device=dev)
    w = torch.as_tensor(DCT_WEIGHTS, dtype=torch.float32, device=dev)
    wf = w.permute(1, 2, 0).reshape(64, 3)
    Rall = _rall(pal_yuv, S) * q_inv[None, :]  # the int16 Q's dequantization
    tiles, pals, errs = [], [], []
    for i in range(0, B, cell_chunk):
        f = feats[i:i + cell_chunk]
        ci = cand_idx[i:i + cell_chunk].long()
        cp = cand_pal[i:i + cell_chunk].long()
        b = f.shape[0]
        ftw = _ftw(f, wf)[:, lf, :] * g_inv[None, :, None]
        err = _pair_err(G8lf[ci].float(), Q16[ci].float(), ftw.to(torch.bfloat16).float(),
                        pal_yuv[cp], Rall[cp])
        top = torch.sort(err, dim=1, stable=True).indices[:, :M]  # [b, M] pair slots
        mt = ci.gather(1, top // kp)
        mp = cp.gather(1, top % kp)
        ex = _exact_choice_err(f.repeat_interleave(M, dim=0), mt.reshape(-1), mp.reshape(-1),
                               pp, palettes, int16).reshape(b, M)
        t, p, e = _tie_break(ex, mt, mp, P)
        tiles.append(t)
        pals.append(p)
        errs.append(e)
    return torch.cat(tiles), torch.cat(pals), torch.cat(errs)


def _features(tiles_rgb, int16: bool, ordered: bool = False, luma_fma: bool = True):
    """(z, feats): motion.tile_dct_features's, the features rounded under
    int16_features."""
    z, f = tile_dct_features(tiles_rgb, ordered, luma_fma)
    return z, (torch.round(f) if int16 else f)


def _sq_err(feats, rf, z=None, int16: bool = False):
    """|feats - rf|^2 of each row [..., 192]. Given the rows' unweighted
    DCT z, in the JAX package's CPU order: the difference fused as fma(z,
    w, -rf) (under int16_features the rounded features subtract exactly)
    and the squares summed in XLA's windows."""
    if z is None or int16:
        d = feats - rf
    else:
        d = feature_residual(z, rf).reshape(feats.shape)
    return (d * d).sum(dim=-1) if z is None else row_sum(d * d)


def _exact_choice_err(feats, tile, pal, pp, palettes, int16: bool = False, z=None):
    """Exact fp32 error of the chosen (tile, palette) per cell; given the
    cells' unweighted DCT z, in the JAX package's CPU order."""
    n = tile.shape[0]
    rgb = palettes[pal.long()[:, None], pp[tile.long()].reshape(n, 64).long()]
    _, rf = _features(rgb.float().reshape(n, 8, 8, 3), int16, z is not None)
    return _sq_err(feats, rf, z, int16)


def _knn_cells(tiles, ctx, kk: int, pal_k: int, epu: bool, kernel: str, cells: int):
    """Phase A for one row of cells: tiles [M, 8, 8, 3] uint8 ->
    (tile int64 [M], pal int64 [M], exact err f32 [M]). With an IVF in
    ``ctx`` it searches every row (as the JAX package's ``ivf`` argument
    takes precedence), and counts the probes it dropped of the row's first
    ``cells`` cells (the rest pad the row); else ``kernel`` is "v2" (B2),
    "v1" or "" (the exact top-k). With a mesh in ``ctx`` every row takes
    the corpus-sharded exact top-k. On the CPU (``ctx["ordered"]``) the
    features, the exact top-k, the EPU's deciding errors and the exact
    errors are the JAX package's CPU values (its mesh branch takes the
    features outside a program: their luma is not fused)."""
    ordered = ctx["ordered"]
    z, feats = _features(tiles.float(), ctx["int16"], ordered, "mesh" not in ctx)
    z = z if ordered else None
    if "mesh" in ctx:
        idx, _ = sharded_topk(feats, ctx["ds_local"], kk, ctx["mesh"])
        idx = idx.clamp_max(ctx["ds"].shape[0] - 1)  # the padding never ranks
    elif ctx["ivf"] is not None:
        idx, _, dropped = ivf_search(feats, ctx["ivf"], kk, ctx["ivf_probes"])
        ctx["ivf_dropped"] += dropped[:cells].sum()
        ctx["ivf_slots"] += cells * min(ctx["ivf_probes"], ctx["ivf"].n_blocks)
    elif kernel == "v1":
        idx, _ = knn_bucket_topk(feats, ctx["dsT"], ctx["d2p"], kk)
        ctx["kernel_cells"] += feats.shape[0]
    elif kernel == "v2":
        idx, _ = knn_bucket_topk2(feats, ctx["dsTa"], kk)
        ctx["kernel_cells"] += feats.shape[0]
    elif ordered:
        idx = _topk_ordered_candidates(feats, ctx["ds"], ctx["d2"], kk, pal_k, ctx["counts"])
    else:
        idx, _ = _topk_candidates(feats, ctx["ds"], kk)
    idx = idx.long()
    if not epu:
        t = idx[:, 0]
        return t, ctx["pal_initial"][t], _sq_err(feats, ctx["ds"][t], z, ctx["int16"])
    cand_pal = ctx["pal_initial"][idx[:, :pal_k]]
    if "two_stage" in ctx:  # stage 2 gives the exact error of its pick
        return _epu_rank_two_stage(feats, idx, cand_pal, *ctx["two_stage"], ctx["pal_yuv"],
                                   ctx["pp"], ctx["palettes"], ctx["S"], *ctx["stage1"],
                                   ctx["cell_chunk"], ctx["int16"])
    t, p = _epu_rank_all(feats, idx, cand_pal, ctx["G"], ctx["Q"], ctx["pal_yuv"],
                         ctx["S"], ctx["cell_chunk"], ctx["counts"], table=ctx["table"])
    if ctx["table"]:
        ctx["table_cells"] += cells
    return t, p, _exact_choice_err(feats, t, p, ctx["pp"], ctx["palettes"], ctx["int16"], z)


def mesh_corpus_shard(ds, mesh):
    """This rank's [Tpad/n, D] slice of the corpus features ds [T, D],
    padded with PAD_FEATURE rows to a multiple Tpad of the "corpus" axis
    size n (the JAX package's mesh branch)."""
    T = ds.shape[0]
    nshard = mesh_shape(mesh)["corpus"]
    tloc = -(-T // nshard)
    lo = axis_index(mesh, "corpus") * tloc
    return torch.nn.functional.pad(ds, (0, 0, 0, tloc * nshard - T),
                                   value=PAD_FEATURE)[lo:lo + tloc]


def _knn_phase(state: EncodeState, settings: EncoderSettings, stats: dict, mesh=None):
    """Phase A: per-cell best (tile, palette, err) as [F, N] tensors;
    cells skipped as perfectly predicted get the cheap k=1 choice. Writes
    the corpus size, the cells that went through a top-k kernel (B2 or
    v1), the IVF's block count (0 without one) and the share of the
    cells' probes that its capacity dropped (the padding of a short row
    not counted) to ``stats``, with the CPU's ordered counts
    (``ORDERED_COUNTS``, 0 on a card) and the cells whose EPU pair errors
    took Q . R from the [T, P] table (``epu_table_cells``). With ``mesh`` the
    corpus is sharded over its "corpus" axis: every cell, in groups of
    frames, takes the exact top-k, and ``knn_backend`` is not read.

    The EPU's tables (unless ``epu_two_stage``, which builds its own): on
    a card where P <= X = 3 S(S+1)/2 (:func:`_epu_table`, the wide
    palettes) G and the [T, P] table of Q . R, each Q row dropped once
    multiplied, so no Q stands (``epu_fused_fp`` then has nothing to
    fuse); elsewhere (P > X, as the default's 1,024 palettes of 16, where
    the table would outgrow Q; and the CPU, which sums Q . R per cell in
    XLA's order) G and Q, or their fused table."""
    F, N = state.n_frames, state.tilemap_size
    dev = state.corpus_pal_pixels.device
    S = settings.palette_size
    palettes = torch.as_tensor(state.palettes_rgb, device=dev)
    pal_initial = torch.as_tensor(state.corpus_pal_initial, device=dev).long()
    pp = state.corpus_pal_pixels
    int16 = settings.int16_features
    # the JAX package computes the corpus features outside a program: on
    # the CPU in XLA's order with the luma unfused
    ordered = dev.type == "cpu"
    _, ds = _features(_render_corpus(palettes, pal_initial, pp).float(), int16, ordered,
                      luma_fma=False)
    T = ds.shape[0]
    # (tile, palette) packs into one int32 for the EPU tie-break and the
    # phase-A results: fail loudly rather than wrap
    pbits = max(1, (settings.palette_count - 1).bit_length())
    if T >= (1 << (31 - pbits)) or T * settings.palette_count >= 2**31:
        raise ValueError(
            f"corpus of {T} tiles with {settings.palette_count} palettes "
            f"overflows the int32 (tile, palette) packing (tile count must "
            f"stay under {1 << (31 - pbits)}); lower "
            f"GlobalTilingTileCount/quality")
    epu = settings.frame_tiling_extended_palette_usage
    kk = min(settings.epu_knn_k, T) if epu else 1
    pal_k = min(settings.epu_pal_k or kk, kk)
    ntri3 = 3 * (S * (S + 1) // 2)
    table = epu and not settings.epu_two_stage and _epu_table(dev, palettes.shape[0], S)
    # cell_chunk bounds a chunk's gathered rows (Gi, Qi, Rj), 64 cells at
    # least; on the table path what it still gathers, the G rows, the f32
    # copy the product makes of them and the Q . R entries, within 3e8 bytes
    if settings.epu_two_stage:
        # the port holds an f32 copy beside each int8 low-frequency G and
        # int16 Q gather (XLA fuses that conversion into the product), so
        # an entry takes 1 + 4 and 2 + 4 bytes, not the JAX formula's 1
        # and 2; and G has epu_stage1_dims / 3 rows, not 64
        row = settings.epu_stage1_dims // 3 * S * (1 + 4) + ntri3 * (2 + 4)
    else:
        row = 64 * S * 2 + ntri3 * 4  # the JAX package's formula
    per_cell = kk * row + pal_k * ntri3 * 4
    if table:
        per_cell = kk * (64 * S * (2 + 4) + pal_k * 4)
    # the kernels need a card and a corpus much wider than kk buckets, so
    # that the bucket top-2s cover the top-kk (the JAX package's gate)
    kernel = ""
    if (mesh is None and dev.type == "cuda" and kk > 1 and T >= 2 * kk * TB
            and settings.knn_backend in ("pallas", "pallas_v1")):
        kernel = "v1" if settings.knn_backend == "pallas_v1" else "v2"
    ctx = {
        "ds": ds, "d2": row_sum(ds * ds) if ordered else None, "ordered": ordered,
        "pal_initial": pal_initial, "pp": pp, "palettes": palettes,
        "pal_yuv": rgb_to_yuv(palettes.float()), "S": S,
        "cell_chunk": max(1 if table else 64, min(4096, int(3e8 / per_cell))),
        "table": table, "table_cells": 0, "kernel_cells": 0, "int16": int16, "ivf": None,
        "ivf_probes": settings.ivf_probes, "ivf_dropped": 0, "ivf_slots": 0,
        "counts": dict.fromkeys(ORDERED_COUNTS, 0),
    }
    if mesh is not None:
        ctx["mesh"] = mesh
        ctx["ds_local"] = mesh_corpus_shard(ds, mesh)
    elif settings.knn_backend == "ivf" and T >= settings.ivf_min_corpus:
        ctx["ivf"] = build_ivf(ds)
    Tp = -(-T // TP_ALIGN) * TP_ALIGN
    if kernel == "v1":
        ctx["dsT"], ctx["d2p"] = knn_prep_v1(ds, Tp)
    elif kernel == "v2":
        ctx["dsTa"] = knn_prep2(ds, Tp)
    if epu and settings.epu_two_stage:  # it takes precedence, as in the JAX package
        ctx["two_stage"] = _build_two_stage_tables(pp, S, settings.epu_stage1_dims)
        ctx["stage1"] = (settings.epu_stage1_dims, settings.epu_stage1_m)
    elif table:
        ctx["G"], ctx["Q"] = _epu_tables(pp, S, rall=_rall(ctx["pal_yuv"], S))
    elif epu:
        ctx["G"], ctx["Q"] = _epu_tables(pp, S, fused=settings.epu_fused_fp)

    # cell compaction: cells that Reduce marked predicted with a perfect
    # phase-A motion PSNR (euclidean TOL -> 48.13 dB) get only the cheap
    # k=1 choice; keyframe-start frames never predict and keep the full
    # search
    tm = state.tilemap
    perfect_db = 10.0 * np.log10(255.0 * 255.0 / max(0.5, TOL / 192.0))
    if (mesh is None and settings.knn_skip_perfect_pred and not settings.count_predicted_tiles
            and tm.predicted.any()):
        need = ~(tm.predicted & (tm.psnr >= perfect_db - 1e-6))
        for kf in state.keyframes:
            need[kf.start_frame] = True
        sel = np.flatnonzero(need.reshape(-1))
        sel_cheap = np.flatnonzero(~need.reshape(-1))
    else:
        sel = np.arange(F * N)
        sel_cheap = np.empty(0, np.int64)

    tiles_flat = state.tiles_canon.reshape(F * N, 8, 8, 3)
    host = isinstance(tiles_flat, np.ndarray)
    kt = torch.zeros(F * N, dtype=torch.long, device=dev)
    kp = torch.zeros(F * N, dtype=torch.long, device=dev)
    ke = torch.full((F * N,), torch.inf, device=dev)
    # the mesh branch's groups: the JAX package's frames a group
    row_cells = (max(1, int(MESH_GROUP_BYTES / (N * (K * 4 + kk * kk * 4)))) * N
                 if mesh is not None else CELL_ROW)
    for cells, args in ((sel, (kk, pal_k, epu, kernel)),
                        (sel_cheap, (1, 1, False, ""))):
        for r0 in range(0, len(cells), row_cells):
            rows = cells[r0:r0 + row_cells]
            n = len(rows)
            if ctx["ivf"] is not None and n < CELL_ROW:
                rows = np.concatenate([rows, np.full(CELL_ROW - n, rows[-1])])
            c = torch.as_tensor(rows, device=dev)
            tiles = to_device(tiles_flat[rows], dev) if host else tiles_flat[c]
            t, p, e = _knn_cells(tiles, ctx, *args, cells=n)
            kt[c[:n]], kp[c[:n]], ke[c[:n]] = t[:n], p[:n], e[:n]
    stats["corpus_tiles"] = T
    stats["knn_kernel_cells"] = ctx["kernel_cells"]
    stats["epu_table_cells"] = ctx["table_cells"]
    stats["ivf_blocks"] = 0 if ctx["ivf"] is None else ctx["ivf"].n_blocks
    stats["ivf_overflow"] = float(ctx["ivf_dropped"]) / max(1, ctx["ivf_slots"])
    stats.update({f"ordered_{k}": v for k, v in ctx["counts"].items()})
    return kt.reshape(F, N), kp.reshape(F, N), ke.reshape(F, N)


def _eval_vectors(cur, back, oy, ox, th: int, tw: int, int16: bool = False):
    """Exact weighted-DCT error of the given per-cell motion vectors
    against ``back`` plus the Manhattan penalty (on the CPU in the JAX
    package's order: :func:`_sq_err`). Returns (err [N] f32, win [N, 8,
    8, 3] f32 window pixels)."""
    dev = cur.device
    ordered = dev.type == "cpu"
    H, W = cur.shape[0], cur.shape[1]
    N = th * tw
    curt = cur.reshape(th, TILE_W, tw, TILE_W, 3).transpose(1, 2)
    z, T = _features(curt, int16, ordered)
    wy = torch.arange(th, device=dev)[:, None] * TILE_W + oy.reshape(th, tw)
    wx = torch.arange(tw, device=dev)[None, :] * TILE_W + ox.reshape(th, tw)
    wyc = wy.clamp(0, H - TILE_W).reshape(-1)
    wxc = wx.clamp(0, W - TILE_W).reshape(-1)
    d8 = torch.arange(TILE_W, device=dev)
    win = back[(wyc[:, None, None] + d8[None, :, None]),
               (wxc[:, None, None] + d8[None, None, :])]
    _, Wv = _features(win, int16, ordered)
    err = _sq_err(T.reshape(N, K), Wv, z.reshape(N, 3, 64) if ordered else None, int16)
    return err + oy.abs().float() + ox.abs().float(), win


def _phase_b_keyframe(frames, kt, kp, ke, hm, vm, pay, pax, pp, palettes,
                      radius: int, th: int, tw: int, mode: str, int16: bool,
                      field_impl: str, stats: dict, rank_dims: int = K):
    """Sequential selection/render over one keyframe's frames, carrying
    the framebuffer. Inputs are [L, ...] slices; returns per-frame
    (oy, ox int32 [L, N], use_pred bool [L, N], err f32 [L, N]).
    ``mode`` "reuse" evaluates the phase-A vectors against the
    reconstruction, "research" searches it again (``field_impl``, ranked
    at ``rank_dims``); each re-searched frame adds one to
    ``stats["phase_b_searches"]``."""
    dev = frames.device
    L = frames.shape[0]
    H, W = th * TILE_W, tw * TILE_W
    N = th * tw
    back = torch.zeros(H, W, 3, device=dev)
    outs = []
    for f in range(L):
        cur = frames[f].float()
        if f == 0 or radius < 1:  # a keyframe start never predicts
            oy = torch.zeros(N, dtype=torch.int32, device=dev)
            ox = torch.zeros(N, dtype=torch.int32, device=dev)
            mperr = torch.full((N,), torch.inf, device=dev)
            win = torch.zeros(N, TILE_W, TILE_W, 3, device=dev)
        elif mode == "research":
            oy, ox, mperr, win = motion_search(cur, back, radius, int16, rank_dims, field_impl,
                                               return_windows=True)
            oy, ox, mperr = oy.reshape(N), ox.reshape(N), mperr.reshape(N)
            stats["phase_b_searches"] = stats.get("phase_b_searches", 0) + 1
        else:
            oy, ox = pay[f], pax[f]
            mperr, win = _eval_vectors(cur, back, oy, ox, th, tw, int16)
        perfect = mperr <= TOL
        knn_wins = (~perfect) & (ke[f] < mperr - TOL)
        use_pred = ~knn_wins
        cell_err = torch.where(use_pred, mperr, ke[f])
        rgb = palettes[kp[f][:, None], pp[kt[f]].reshape(N, 64).long()]
        rgb = rgb.float().reshape(N, TILE_W, TILE_W, 3)
        rgb = torch.where(hm[f][:, None, None, None], rgb.flip(2), rgb)
        rgb = torch.where(vm[f][:, None, None, None], rgb.flip(1), rgb)
        chosen = torch.where(use_pred[:, None, None, None], win, rgb)
        back = chosen.reshape(th, tw, TILE_W, TILE_W, 3).transpose(1, 2).reshape(H, W, 3)
        outs.append((oy, ox, use_pred, cell_err))
    return [torch.stack(v) for v in zip(*outs)]


def reconstruct(state: EncodeState, settings: EncoderSettings, mesh=None, *,
                stats: dict | None = None) -> EncodeState:
    """``mesh``: a DeviceMesh whose "corpus" axis shards phase A's corpus."""
    F, N = state.n_frames, state.tilemap_size
    th, tw = state.tilemap_h, state.tilemap_w
    tm = state.tilemap
    R = settings.motion_predict_radius
    stats = {} if stats is None else stats
    stats["phase_b_searches"] = 0
    kt, kp, ke = _knn_phase(state, settings, stats, mesh)
    dev = kt.device
    pp = state.corpus_pal_pixels
    palettes = torch.as_tensor(state.palettes_rgb, device=dev)
    hm = torch.as_tensor(tm.hmirror, device=dev)
    vm = torch.as_tensor(tm.vmirror, device=dev)
    pay = torch.as_tensor(tm.pred_y.astype(np.int32), device=dev)
    pax = torch.as_tensor(tm.pred_x.astype(np.int32), device=dev)

    oy = np.empty((F, N), np.int32)
    ox = np.empty((F, N), np.int32)
    use_pred = np.empty((F, N), bool)
    psnr = np.empty((F, N), np.float32)
    frames = state.frames_rgb
    host = isinstance(frames, np.ndarray)
    for kf in state.keyframes:
        s = slice(kf.start_frame, kf.end_frame + 1)
        y, x, u, e = _phase_b_keyframe(
            to_device(frames[s], dev) if host else frames[s], kt[s], kp[s], ke[s],
            hm[s], vm[s], pay[s], pax[s], pp, palettes, R, th, tw,
            settings.phase_b_motion, settings.int16_features, settings.motion_field, stats,
            settings.motion_rank_dims)
        oy[s], ox[s], use_pred[s] = y.cpu().numpy(), x.cpu().numpy(), u.cpu().numpy()
        psnr[s] = euclidean_to_psnr(e).cpu().numpy()

    knn_tile = kt.cpu().numpy()
    knn_pal = kp.cpu().numpy()
    tm.predicted = use_pred
    tm.pred_y = oy.astype(np.int16)
    tm.pred_x = ox.astype(np.int16)
    if settings.count_predicted_tiles:
        tm.tile_idx = knn_tile.astype(np.int64)
        tm.pal_idx = knn_pal.astype(np.int64)
    else:
        tm.tile_idx = np.where(~use_pred, knn_tile, -1).astype(np.int64)
        tm.pal_idx = np.where(~use_pred, knn_pal, -1).astype(np.int32)
    tm.psnr = psnr

    kf_psnr_accum = np.zeros(len(state.keyframes), np.float64)
    np.add.at(kf_psnr_accum, state.frame_kf, tm.psnr.sum(axis=1))
    state.kf_psnr = np.array(
        [kf_psnr_accum[k.index] / (N * k.frame_count) for k in state.keyframes])
    state.total_psnr = float(kf_psnr_accum.sum() / (N * F))
    return state
