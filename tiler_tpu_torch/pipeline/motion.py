"""Motion search: windowed weighted-DCT L2 search over a radius.

Counterpart of ``tiler_tpu/pipeline/motion.py``:

  1. The weighted DCT of every 8x8 window of the reference frame in a
     padded block layout, centered by the mean tile feature and rounded
     to bf16 for ranking. ``field_impl="passes"`` (the default) builds it
     by two shifted elementwise passes (:func:`_window_field_blocks`);
     ``"im2row"`` by one f32 product of the windows' pixels with the
     weighted DCT basis and the blockify kernel
     (:func:`_window_field_blocks_im2row`).
  2. |t - w|^2 = |t|^2 - 2 t.w + |w|^2 with offsets split o = 8q + s: one
     batched bf16 product of each field block against its 2Qx2Q
     neighbouring tiles, halo-blocked by row blocks.
  3. A Manhattan penalty toward the zero offset breaks ties
     (:func:`make_penalty`); the winner (first in q-major, s-minor order)
     gets its error recomputed exactly in fp32 from pixels.

``rank_dims`` < 192 (``motion_rank_dims``, 3 r^2 with 1 <= r <= 8) ranks
the candidates on each channel's low-frequency r x r DCT block only, in
both fields; the winner's error is still recomputed from the full 192
features, so the reported error is exact and only near-ties can pick
another vector. ``int16=True`` rounds the tile and window features
before they are compared (the reference's SmallInt features, tilingencoder.pas:3126).
Phase B's re-search (``phase_b_motion="research"``) searches the float32
reconstruction and takes the winner's window pixels as its render
(``return_windows``).

On the CPU the search runs in the JAX package's CPU float order
(``ops/ordered.py``; ``tests/test_torch_motion_order.py``): the luma and
both field passes as XLA's FMA chains, the K = 64 basis products as one
FMA chain over k, the mean tile feature, T2 and the norms in XLA's
windows of 32, the centering as fma(z, w, -mu), XLA's log in the PSNR,
and the bf16 rank product from one float32 product, with the entries
whose bf16 value its error bound leaves open and that could still win
their tile summed again in XLA's order (:func:`_rank_bounds`,
:func:`_rank_merge_ordered`). So the default search (the passes field,
192 dims) gives the reference's vectors, errors and PSNR bits bit for
bit; so did int16 features, rank depth 48 and the im2row field in the
tests, but not depth 27, whose norms XLA sums in an order not read
here. On a card it keeps its
own arithmetic (cuBLAS's bf16 product, plain float32 passes), chosen by
the device alone: the field alone in XLA's order takes 5.5 times as
long there (PERF.md section 6).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..kernels.blockify import blockify_field
from ..ops.color import rgb_to_yuv, rgb_to_yuv_ordered
from ..ops.dct import DCT_MAT, DCT_WEIGHTS
from ..ops.ordered import dot_fma, fma32, fma_sum, row_sum

TILE_W = 8
K = 192
RANK_ROWS = 8  # field block rows per batched rank product


@functools.lru_cache(maxsize=None)
def _dct_basis64() -> np.ndarray:
    """[(y,x), (v,u)] 2D-DCT basis, accumulated in float64."""
    D = np.asarray(DCT_MAT, np.float64)
    return np.einsum("vy,ux->vuyx", D, D).reshape(64, 64).T.astype(np.float32)


def _dct64(tiles_rgb: torch.Tensor, ordered: bool = False, luma_fma: bool = True) -> torch.Tensor:
    """Unweighted 2D DCT of YUV tiles: [..., 8, 8, 3] RGB -> [..., 3,
    64 (v,u)] float32; ``ordered``: in XLA's CPU order, one FMA chain over
    the 64 pixels after the luma as XLA fuses it inside a program (the FMA
    luma) or, without ``luma_fma``, as the JAX package's calls outside
    one round it, product by product."""
    yuv = (rgb_to_yuv_ordered if ordered and luma_fma else rgb_to_yuv)(tiles_rgb.float())
    lead = yuv.shape[:-3]
    x = torch.movedim(yuv, -1, -3).reshape(*lead, 3, 64)
    basis = torch.as_tensor(_dct_basis64(), device=x.device)
    if ordered:
        return dot_fma(x.reshape(-1, 64), basis).reshape(*lead, 3, 64)
    return x @ basis


def _weights64(device) -> torch.Tensor:
    return torch.as_tensor(DCT_WEIGHTS, dtype=torch.float32, device=device).reshape(3, 64)


def tile_dct_features(tiles_rgb: torch.Tensor, ordered: bool = False,
                      luma_fma: bool = True):
    """(z, feats) of tiles_rgb [..., 8, 8, 3]: the unweighted DCT [..., 3,
    64] and the weighted-DCT YUV features in (c, v, u) raster layout (no
    zigzag) [..., 192] float32. ``ordered`` and ``luma_fma``:
    :func:`_dct64`'s."""
    z = _dct64(tiles_rgb, ordered, luma_fma)
    return z, (z * _weights64(z.device)).reshape(*z.shape[:-2], K)


def tile_features_raster(tiles_rgb: torch.Tensor) -> torch.Tensor:
    """Weighted-DCT YUV features in (c, v, u) raster layout (no zigzag);
    tiles_rgb [..., 8, 8, 3] -> [..., 192] float32."""
    return tile_dct_features(tiles_rgb)[1]


def feature_residual(z: torch.Tensor, rf: torch.Tensor) -> torch.Tensor:
    """The features of the tiles whose unweighted DCT is z [..., 3, 64]
    less rf [..., 192], as XLA's CPU build fuses the difference: fma(z,
    w, -rf) -> [..., 192]."""
    return fma32(z, _weights64(z.device), -rf.reshape(z.shape)).reshape(*z.shape[:-2], K)


def window_dct_field(frame_rgb: torch.Tensor) -> torch.Tensor:
    """Weighted-DCT features of every 8x8 window of frame_rgb [H, W, 3]:
    [H-7, W-7, 192] float32, channel blocks of 64 in (v, u) raster order
    (not zigzagged). The JAX package's grouped convolution as two
    separable float32 passes (x, then y) and the PSNR-HVS weights; within
    float32 summation-order rounding of it."""
    yuv = rgb_to_yuv(frame_rgb.float())
    H, W = yuv.shape[0], yuv.shape[1]
    D = torch.as_tensor(DCT_MAT, dtype=torch.float32, device=yuv.device)  # [u, x]
    A = sum(yuv[:, x:x + W - 7, :, None] * D[:, x] for x in range(8))  # [H, W-7, 3, u]
    F = sum(A[y:y + H - 7, :, :, None, :] * D[:, y][:, None] for y in range(8))
    w = torch.as_tensor(DCT_WEIGHTS, dtype=torch.float32, device=yuv.device)  # [c, v, u]
    return (F * w).reshape(H - 7, W - 7, K)


def make_penalty(radius: int, P: int) -> np.ndarray:
    """pen[s=(sy,sx), q=(qy,qx)] = |oy| + |ox|, +inf outside the
    [-R, R-1] search square; NQ = 2*P/8 block offsets per axis."""
    NQ = 2 * (P // TILE_W)
    s = np.arange(TILE_W)
    q = np.arange(NQ) * TILE_W - P
    o = q[:, None] + s[None, :]  # oy[qy, sy]
    val = (o >= -radius) & (o <= radius - 1)
    pen1 = np.where(val, np.abs(o).astype(np.float32), np.inf)
    pen = pen1[:, None, :, None] + pen1[None, :, None, :]  # [qy, qx, sy, sx]
    return pen.transpose(2, 3, 0, 1).reshape(64, NQ * NQ).astype(np.float32)


def _lowfreq_side(dims: int) -> int:
    """r of a ranking depth dims = 3 r^2."""
    r = int(round((dims / 3) ** 0.5))
    if 3 * r * r != dims:
        raise ValueError(f"motion rank dims must be 3*r^2, got {dims}")
    return r


def _lowfreq_tiles(T: torch.Tensor, dims: int) -> torch.Tensor:
    """Tile features [..., 192] (c, v, u raster) cut to each channel's
    low-frequency r x r block -> [..., dims]."""
    r = _lowfreq_side(dims)
    return T.reshape(*T.shape[:-1], 3, 8, 8)[..., :r, :r].reshape(*T.shape[:-1], dims)


def _window_field_blocks(frame_rgb, mu, P: int, mh: int, mw: int, dims: int = K,
                         ordered: bool | None = None):
    """Centered window-DCT field in the padded block layout:
    Fblk [mh, mw, 64 (sy,sx), dims] bf16 and its norms N2blk [mh, mw, 64]
    f32, +inf at windows that fall outside the frame. dims < 192 keeps
    each channel's low-frequency r x r block (mu is [dims]). ``ordered``
    (default: on the CPU): the JAX package's CPU bits
    (:func:`_pass_b_ordered`), the norms in XLA's windows of 32."""
    dev = frame_rgb.device
    ordered = dev.type == "cpu" if ordered is None else ordered
    yuv = (rgb_to_yuv_ordered if ordered else rgb_to_yuv)(frame_rgb.float())
    H, W = yuv.shape[0], yuv.shape[1]
    HP, WP = mh * TILE_W, mw * TILE_W
    yuvp = torch.nn.functional.pad(
        yuv, (0, 0, P, WP + 7 - W - P, P, HP + 7 - H - P))
    r = _lowfreq_side(dims)
    D = torch.as_tensor(DCT_MAT[:r], dtype=torch.float32, device=dev)  # [r, 8]
    w = torch.as_tensor(DCT_WEIGHTS[:, :r, :r], dtype=torch.float32, device=dev)
    mu = mu.reshape(3, r, r)
    # pass A (x contraction): A[h, n, sx, c, u]
    terms = [(yuvp[:, x:x + WP, :, None], D[:, x]) for x in range(8)]
    if ordered:
        A = fma_sum(terms).reshape(HP + 7, mw, TILE_W, 3, r)
        Fblk = _pass_b_ordered(A, D, w, mu)
    else:
        A = sum(a * b for a, b in terms).reshape(HP + 7, mw, TILE_W, 3, r)
        # pass B (y contraction): stride-8 slices collapse the row index to m
        Fblk = torch.stack([
            sum(A[sy + y:sy + y + HP:TILE_W][..., None, :] * D[:, y][:, None]
                for y in range(8))  # [mh, mw, 8 sx, 3, r v, r u]
            for sy in range(TILE_W)], dim=2)  # [mh, mw, 8 sy, 8 sx, 3, r, r]
        Fblk = (Fblk * w - mu).to(torch.bfloat16)
    Fblk = Fblk.reshape(mh, mw, 64, dims)
    return Fblk, _block_norms(Fblk, P, H, W, ordered)


_U32 = 2.0 ** -24  # float32's unit roundoff


def _pass_b_ordered(A, D, w, mu) -> torch.Tensor:
    """Pass B and the centering, bf16 [mh, mw, 8 sy, 8 sx, 3, r, r], as
    the JAX package's CPU build rounds them: F = fma(A_7, D_7, ... fma(A_0,
    D_0, A_1 D_1)), then bf16(fma(F, w, -mu)). Summed in plain float32
    first: that sum and XLA's chain are each within 9 u sum |A D| of the
    exact one (u = 2^-24: a rounding a product and one a partial sum, and
    each partial sum at most sum |A D|). An element whose bf16 value is
    the same at both ends of that bound is that value; the few others
    (~1%) go through the float32 FMA chain (``ops/ordered.fma_sum``)."""
    HP = A.shape[0] - 7
    Aabs, Dabs = A.abs(), D.abs()
    w64, mu64 = w.double(), mu.double()
    # 17 u sum |A D| |w|, with room for float32's rounding of the sum of
    # |A D| itself and float64's of acc w - mu
    k1 = w64.abs() * (17 * _U32 * (1 + 2.0 ** -16))
    k2 = mu64.abs() * 2.0 ** -50
    los, his = [], []
    for sy in range(TILE_W):
        acc = S = None
        for y in range(8):
            rows = slice(sy + y, sy + y + HP, TILE_W)
            a, d = A[rows][..., None, :], D[:, y][:, None]  # [mh, mw, 8, 3, 1, r], [r, 1]
            acc = a * d if acc is None else torch.addcmul(acc, a, d)
            S = Aabs[rows][..., None, :] * Dabs[:, y][:, None] if S is None else \
                torch.addcmul(S, Aabs[rows][..., None, :], Dabs[:, y][:, None])
        v = acc.double() * w64 - mu64
        E = S.double() * k1 + k2 + v.abs() * 2.0 ** -50
        los.append((v - E).float().to(torch.bfloat16))
        his.append((v + E).float().to(torch.bfloat16))
    lo = torch.stack(los, dim=2)  # [mh, mw, 8 sy, 8 sx, 3, r, r]
    amb = lo != torch.stack(his, dim=2)
    if bool(amb.any()):
        m, n, sy, sx, c, v, u = amb.nonzero(as_tuple=True)
        terms = [(A[sy + y + TILE_W * m, n, sx, c, u], D[v, y]) for y in range(8)]
        lo[m, n, sy, sx, c, v, u] = fma32(fma_sum(terms), w[c, v, u], -mu[c, v, u]).to(torch.bfloat16)
    return lo


def _block_norms(Fblk, P: int, H: int, W: int, ordered: bool = False):
    """|F|^2 [mh, mw, 64] f32 of the bf16 field (``ordered``: in XLA's
    windows), +inf at the windows whose top-left field position falls
    outside [0, H-7] x [0, W-7]."""
    dev = Fblk.device
    mh, mw = Fblk.shape[0], Fblk.shape[1]
    Ff = Fblk.float()
    n2 = row_sum(Ff * Ff) if ordered else (Ff * Ff).sum(dim=-1)
    fy = (torch.arange(mh, device=dev) * TILE_W)[:, None] + torch.arange(TILE_W, device=dev) - P
    fx = (torch.arange(mw, device=dev) * TILE_W)[:, None] + torch.arange(TILE_W, device=dev) - P
    vy = (fy >= 0) & (fy <= H - TILE_W)
    vx = (fx >= 0) & (fx <= W - TILE_W)
    valid = (vy[:, None, :, None] & vx[None, :, None, :]).reshape(mh, mw, 64)
    return torch.where(valid, n2, torch.inf)


@functools.lru_cache(maxsize=None)
def _weighted_basis() -> np.ndarray:
    """[3 c, 64 (y,x), 64 (v,u)] f32: the 2D-DCT basis times the PSNR-HVS
    weights, accumulated in float64."""
    D = np.asarray(DCT_MAT, np.float64)
    basis = np.einsum("vy,ux->yxvu", D, D).reshape(64, 8, 8)
    w = np.asarray(DCT_WEIGHTS, np.float64)  # [c, v, u]
    return np.einsum("xvu,cvu->cxvu", basis, w).reshape(3, 64, 64).astype(np.float32)


def _window_field_blocks_im2row(frame_rgb, mu, P: int, mh: int, mw: int, dims: int = K):
    """The same centered field as :func:`_window_field_blocks`, computed as
    one product: the 64 pixels of every window plus a ones column (X, the
    im2row stack) times the weighted DCT basis (its r x r low-frequency
    columns, dims = 3 r^2) with -mu in its 65th row, in f32 (TF32 is off),
    cast to bf16, then relaid out into the block layout by the blockify
    kernel at depth dims (``kernels/blockify.py``). Values match the
    passes field to f32 summation-order rounding."""
    dev = frame_rgb.device
    yuv = rgb_to_yuv(frame_rgb.float())
    H, W = yuv.shape[0], yuv.shape[1]
    HP, WP = mh * TILE_W, mw * TILE_W
    yuvp = torch.nn.functional.pad(
        yuv, (0, 0, P, WP + 7 - W - P, P, HP + 7 - H - P)).permute(2, 0, 1)
    # X: the JAX package's [HP, WP, 65, 3] stored as [3 c, 65, HP*WP], so
    # each of the 65 rows (window pixel (y, x), then the ones) is written
    # contiguously and the product is one batched matmul over the 3
    # channels with X transposed in place
    X = torch.empty(3, 65, HP, WP, device=dev)
    for y in range(8):
        for x in range(8):
            X[:, 8 * y + x] = yuvp[:, y:y + HP, x:x + WP]
    X[:, 64] = 1.0
    r = _lowfreq_side(dims)
    basis = _weighted_basis().reshape(3, 64, 8, 8)[:, :, :r, :r].reshape(3, 64, r * r)
    B3 = torch.cat([torch.as_tensor(basis, device=dev),
                    -mu.reshape(3, 1, r * r)], dim=1)  # [3, 65, r*r]
    Fc = torch.matmul(X.view(3, 65, HP * WP).transpose(1, 2), B3)  # [3, HP*WP, r*r]
    del X  # ~0.8 GB f32 at 720p: gone before the relayouts
    F = Fc.to(torch.bfloat16).permute(1, 0, 2).contiguous().view(HP, WP, dims)
    del Fc
    Fblk = blockify_field(F)  # [mh, mw, 64, dims]
    return Fblk, _block_norms(Fblk, P, H, W, dev.type == "cpu")


def motion_search(cur_rgb: torch.Tensor, prev_rgb: torch.Tensor, radius: int,
                  int16: bool = False, rank_dims: int = K, field_impl: str = "passes", *,
                  return_windows: bool = False):
    """Full-frame motion search of cur against prev ([H, W, 3] uint8 or
    float, H and W multiples of 8). Returns (pred_y, pred_x) int32
    [th, tw] and the exact error f32 [th, tw] (squared weighted-DCT L2 +
    Manhattan penalty), and with ``return_windows`` the winner's window
    pixels [th*tw, 8, 8, 3] f32. ``int16`` rounds the features;
    ``rank_dims`` (3 r^2) is the depth the candidates are ranked at;
    ``field_impl`` picks the window field: "passes" or "im2row"."""
    dev = cur_rgb.device
    ordered = dev.type == "cpu"
    H, W = cur_rgb.shape[0], cur_rgb.shape[1]
    th, tw = H // TILE_W, W // TILE_W
    R = int(radius)
    Q = 1
    while Q * TILE_W < R:
        Q *= 2
    P = Q * TILE_W
    NQ = 2 * Q

    cur = cur_rgb.float().reshape(th, TILE_W, tw, TILE_W, 3).transpose(1, 2)
    z, T = tile_dct_features(cur, ordered)  # [th, tw, 3, 64], [th, tw, K]
    if int16:
        T = torch.round(T)
    KR = int(rank_dims)
    Tr = T if KR == K else _lowfreq_tiles(T, KR)
    # centering keeps the DC energy out of the bf16 cross terms
    if ordered:  # XLA: the mean as a windowed column sum times 1/n, fused centering
        mu = row_sum(Tr.reshape(-1, KR), dim=0) * float(np.float32(1 / (th * tw)))
        if int16:
            Tc = Tr - mu
        else:
            zr = z.reshape(th, tw, K) if KR == K else _lowfreq_tiles(z.reshape(th, tw, K), KR)
            w = _weights64(dev).reshape(K)
            wr = w if KR == K else _lowfreq_tiles(w, KR)
            Tc = fma32(zr, wr, -mu)
        T2 = row_sum(Tc * Tc)
    else:
        mu = Tr.reshape(-1, KR).mean(dim=0)
        Tc = Tr - mu
        T2 = (Tc * Tc).sum(dim=-1)

    mh = -(-(H - 7 + 2 * P) // TILE_W)
    mw = -(-(W - 7 + 2 * P) // TILE_W)
    pen = torch.as_tensor(make_penalty(R, P), device=dev)  # [64 s, NQ^2 q]
    tpad = torch.nn.functional.pad(
        Tc.to(torch.bfloat16), (0, 0, NQ - 1, mw - tw, NQ - 1, mh - th))
    if field_impl == "im2row":
        Fblk, N2blk = _window_field_blocks_im2row(prev_rgb, mu, P, mh, mw, KR)
    elif field_impl == "passes":
        Fblk, N2blk = _window_field_blocks(prev_rgb, mu, P, mh, mw, KR, ordered)
    else:
        raise ValueError(f"field_impl={field_impl!r}: 'passes' or 'im2row'")

    # halo-blocked rank: each row block builds only its own [BM, mw, NQ^2,
    # KR] shift stack of tile features, one bf16 batched product per block
    # (ordered: float32 with the bounds of _rank_bounds)
    D = torch.empty(mh, mw, NQ * NQ, 64, dtype=torch.bfloat16, device=dev)
    D_hi = torch.empty_like(D) if ordered else None
    for r0 in range(0, mh, RANK_ROWS):
        bm = min(RANK_ROWS, mh - r0)
        halo = tpad[r0:r0 + bm + NQ - 1]
        nb = torch.stack([
            halo[NQ - 1 - qy:NQ - 1 - qy + bm, NQ - 1 - qx:NQ - 1 - qx + mw]
            for qy in range(NQ) for qx in range(NQ)
        ], dim=2).reshape(-1, NQ * NQ, KR)  # [bm * mw, NQ^2, KR]
        fb = Fblk[r0:r0 + bm].reshape(-1, 64, KR)  # [bm * mw, 64, KR]
        if ordered:
            lo, hi = _rank_bounds(nb, fb)
            D[r0:r0 + bm] = lo.reshape(bm, mw, NQ * NQ, 64)
            D_hi[r0:r0 + bm] = hi.reshape(bm, mw, NQ * NQ, 64)
        else:
            D[r0:r0 + bm] = torch.matmul(nb, fb.transpose(1, 2)).reshape(bm, mw, NQ * NQ, 64)
    if ordered:
        return _rank_merge_ordered(D, D_hi, tpad[NQ - 1:NQ - 1 + th, NQ - 1:NQ - 1 + tw], Fblk,
                                   z, T, T2, N2blk, pen, th, tw, NQ, P, prev_rgb, int16,
                                   return_windows)
    return _rank_merge(_rank_error(T2, D, N2blk, pen, th, tw, NQ), z, T, th, tw, NQ, P,
                       prev_rgb, int16, return_windows, False)


def motion_search_batch(cur_rgb: torch.Tensor, prev_rgb: torch.Tensor, radius: int,
                        int16: bool = False, rank_dims: int = K, field_impl: str = "passes"):
    """:func:`motion_search` of each pair along a leading frame axis
    ([B, H, W, 3] each): (pred_y, pred_x) int32 and err f32, [B, th, tw]."""
    outs = [motion_search(c, p, radius, int16, rank_dims, field_impl)
            for c, p in zip(cur_rgb, prev_rgb)]
    return tuple(torch.stack(v) for v in zip(*outs))


_RANK_SLACK = 1.01  # margin on the summation bound for its own float32 rounding


def _rank_bounds(nb: torch.Tensor, fb: torch.Tensor):
    """The rank product nb [B, Q, K] @ fb [B, S, K]^T of bf16 tensors as
    two bf16 bounds (lo, hi) on what the JAX package's CPU build gives:
    the float32 sum of the (exact) products from k = 0 to K-1, rounded
    once to bf16. One float32 product lies within 2 gamma_K |n| |f| of
    that sum (each order is within gamma_K sum |p| of the exact value,
    and sum |p| <= |n| |f|); lo and hi are the bf16 roundings of its two
    ends, equal wherever no bf16 rounding boundary lies between."""
    n32, f32 = nb.float(), fb.float()
    d = torch.matmul(n32, f32.transpose(1, 2))  # [B, Q, S]
    k = n32.shape[-1]
    gamma = k * _U32 / (1 - k * _U32)
    nn = torch.sqrt((n32 * n32).sum(dim=-1))
    ff = torch.sqrt((f32 * f32).sum(dim=-1))
    bound = (2 * gamma * _RANK_SLACK) * nn[:, :, None] * ff[:, None, :]
    return (d - bound).to(torch.bfloat16), (d + bound).to(torch.bfloat16)


def _rank_error(T2, D, N2blk, pen, th, tw, NQ):
    """e [th, tw, NQ^2, 64] bf16 = bf16(T2 - 2 D + N2 + pen) for each
    tile, block shift q and phase s."""
    return torch.stack([
        T2[:, :, None]
        - 2.0 * D[qy:qy + th, qx:qx + tw, qy * NQ + qx].float()
        + N2blk[qy:qy + th, qx:qx + tw]
        + pen[:, qy * NQ + qx]
        for qy in range(NQ) for qx in range(NQ)
    ], dim=2).to(torch.bfloat16)


def _rank_merge_ordered(D_lo, D_hi, Tb, Fblk, z, T, T2, N2blk, pen, th, tw, NQ, P, prev_rgb,
                        int16, return_windows):
    """:func:`_rank_merge` from the bounds of :func:`_rank_bounds`. e falls
    as D rises, so e_hi = e(D_lo) and e_lo = e(D_hi) bound each
    candidate's error. A candidate whose e_lo lies above the tile's
    smallest e_hi cannot win; of the others, each whose bounds differ is
    summed again in XLA's order (the tile's bf16 features Tb times the
    window's, k = 0 .. K-1 in float32). Then every candidate that can win
    has its exact e, the rest lie above them, and the argmin is XLA's."""
    e = _rank_error(T2, D_lo, N2blk, pen, th, tw, NQ)  # the upper bound
    e_lo = _rank_error(T2, D_hi, N2blk, pen, th, tw, NQ)
    top = e.reshape(th, tw, -1).min(dim=-1).values[:, :, None, None]
    redo = (e_lo != e) & (e_lo <= top)
    if bool(redo.any()):
        ty, tx, q, sx = redo.nonzero(as_tuple=True)
        qy, qx = q // NQ, q % NQ
        n32 = Tb[ty, tx].float()  # [n, K]
        f32 = Fblk[ty + qy, tx + qx, sx].float()
        p = n32 * f32  # exact
        acc = p[:, 0]
        for k in range(1, p.shape[1]):
            acc = acc + p[:, k]
        d = acc.to(torch.bfloat16).float()
        e[ty, tx, q, sx] = (T2[ty, tx] - 2.0 * d + N2blk[ty + qy, tx + qx, sx]
                            + pen[sx, q]).to(torch.bfloat16)
    return _rank_merge(e, z, T, th, tw, NQ, P, prev_rgb, int16, return_windows, True)


def _rank_merge(e, z, T, th, tw, NQ, P, prev_rgb, int16, return_windows, ordered):
    """Argmin over (q, s) of the bf16-rounded rank error (first in
    q-major, s-minor order), then the exact fp32 winner recompute
    (``ordered``: the tile's weighted feature fused into the difference,
    fma(z, w, -Wv), as XLA fuses it, and the squares summed in its
    windows)."""
    dev = e.device
    H, W = prev_rgb.shape[0], prev_rgb.shape[1]
    best = torch.argmin(e.reshape(th, tw, -1), dim=-1)
    bestq, bests = best // 64, best % 64
    best_oy = ((bestq // NQ) * TILE_W - P + bests // TILE_W).to(torch.int32)
    best_ox = ((bestq % NQ) * TILE_W - P + bests % TILE_W).to(torch.int32)

    # exact fp32 error of the winner, recomputed from pixels
    wy = torch.arange(th, dtype=torch.int32, device=dev)[:, None] * TILE_W + best_oy
    wx = torch.arange(tw, dtype=torch.int32, device=dev)[None, :] * TILE_W + best_ox
    wyc = wy.clamp(0, H - TILE_W).reshape(-1).long()
    wxc = wx.clamp(0, W - TILE_W).reshape(-1).long()
    d8 = torch.arange(TILE_W, device=dev)
    win = prev_rgb.float()[(wyc[:, None, None] + d8[None, :, None]),
                           (wxc[:, None, None] + d8[None, None, :])]
    _, Wv = tile_dct_features(win, ordered)  # [th*tw, K]
    if int16:
        diff = T.reshape(-1, K) - torch.round(Wv)
    elif ordered:
        diff = feature_residual(z.reshape(-1, 3, 64), Wv)
    else:
        diff = T.reshape(-1, K) - Wv
    sq = diff * diff
    exact = (row_sum(sq) if ordered else sq.sum(dim=-1)).reshape(th, tw)
    exact = exact + best_oy.abs().float() + best_ox.abs().float()
    if return_windows:
        return best_oy, best_ox, exact, win
    return best_oy, best_ox, exact
