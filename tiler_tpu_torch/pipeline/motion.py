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
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..kernels.blockify import blockify_field
from ..ops.color import rgb_to_yuv
from ..ops.dct import DCT_MAT, DCT_WEIGHTS

TILE_W = 8
K = 192
RANK_ROWS = 8  # field block rows per batched rank product


@functools.lru_cache(maxsize=None)
def _dct_basis64() -> np.ndarray:
    """[(y,x), (v,u)] 2D-DCT basis, accumulated in float64."""
    D = np.asarray(DCT_MAT, np.float64)
    return np.einsum("vy,ux->vuyx", D, D).reshape(64, 64).T.astype(np.float32)


def tile_features_raster(tiles_rgb: torch.Tensor) -> torch.Tensor:
    """Weighted-DCT YUV features in (c, v, u) raster layout (no zigzag);
    tiles_rgb [..., 8, 8, 3] -> [..., 192] float32."""
    yuv = rgb_to_yuv(tiles_rgb.float())
    lead = yuv.shape[:-3]
    x = torch.movedim(yuv, -1, -3).reshape(*lead, 3, 64)
    basis = torch.as_tensor(_dct_basis64(), device=x.device)
    z = x @ basis  # [..., 3, (v,u)]
    w = torch.as_tensor(DCT_WEIGHTS, dtype=torch.float32, device=x.device).reshape(3, 64)
    return (z * w).reshape(*lead, K)


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


def _window_field_blocks(frame_rgb, mu, P: int, mh: int, mw: int, dims: int = K):
    """Centered window-DCT field in the padded block layout:
    Fblk [mh, mw, 64 (sy,sx), dims] bf16 and its norms N2blk [mh, mw, 64]
    f32, +inf at windows that fall outside the frame. dims < 192 keeps
    each channel's low-frequency r x r block (mu is [dims])."""
    dev = frame_rgb.device
    yuv = rgb_to_yuv(frame_rgb.float())
    H, W = yuv.shape[0], yuv.shape[1]
    HP, WP = mh * TILE_W, mw * TILE_W
    yuvp = torch.nn.functional.pad(
        yuv, (0, 0, P, WP + 7 - W - P, P, HP + 7 - H - P))
    r = _lowfreq_side(dims)
    D = torch.as_tensor(DCT_MAT[:r], dtype=torch.float32, device=dev)  # [r, 8]
    w = torch.as_tensor(DCT_WEIGHTS[:, :r, :r], dtype=torch.float32, device=dev)
    # pass A (x contraction): A[h, n, sx, c, u]
    A = 0
    for x in range(8):
        A = A + yuvp[:, x:x + WP, :, None] * D[:, x]
    A = A.reshape(HP + 7, mw, TILE_W, 3, r)
    # pass B (y contraction): stride-8 slices collapse the row index to m
    mats = []
    for sy in range(TILE_W):
        F_sy = 0
        for y in range(8):
            F_sy = F_sy + A[sy + y:sy + y + HP:TILE_W][..., None, :] * D[:, y][:, None]
        mats.append(F_sy)  # [mh, mw, 8 sx, 3, r v, r u]
    Fblk = torch.stack(mats, dim=2)  # [mh, mw, 8 sy, 8 sx, 3, r, r]
    Fblk = Fblk * w - mu.reshape(3, r, r)
    Fblk = Fblk.to(torch.bfloat16).reshape(mh, mw, 64, dims)
    return Fblk, _block_norms(Fblk, P, H, W)


def _block_norms(Fblk, P: int, H: int, W: int):
    """|F|^2 [mh, mw, 64] f32 of the bf16 field, +inf at the windows whose
    top-left field position falls outside [0, H-7] x [0, W-7]."""
    dev = Fblk.device
    mh, mw = Fblk.shape[0], Fblk.shape[1]
    Ff = Fblk.float()
    n2 = (Ff * Ff).sum(dim=-1)
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
    return Fblk, _block_norms(Fblk, P, H, W)


def motion_search(cur_rgb: torch.Tensor, prev_rgb: torch.Tensor, radius: int,
                  field_impl: str = "passes", int16: bool = False,
                  return_windows: bool = False, rank_dims: int = K):
    """Full-frame motion search of cur against prev ([H, W, 3] uint8 or
    float, H and W multiples of 8). Returns (pred_y, pred_x) int32
    [th, tw] and the exact error f32 [th, tw] (squared weighted-DCT L2 +
    Manhattan penalty), and with ``return_windows`` the winner's window
    pixels [th*tw, 8, 8, 3] f32. ``field_impl`` picks the window field:
    "passes" or "im2row"; ``int16`` rounds the features; ``rank_dims``
    (3 r^2) is the depth the candidates are ranked at."""
    dev = cur_rgb.device
    H, W = cur_rgb.shape[0], cur_rgb.shape[1]
    th, tw = H // TILE_W, W // TILE_W
    R = int(radius)
    Q = 1
    while Q * TILE_W < R:
        Q *= 2
    P = Q * TILE_W
    NQ = 2 * Q

    cur = cur_rgb.float().reshape(th, TILE_W, tw, TILE_W, 3).transpose(1, 2)
    T = tile_features_raster(cur)  # [th, tw, 192]
    if int16:
        T = torch.round(T)
    KR = int(rank_dims)
    Tr = T if KR == K else _lowfreq_tiles(T, KR)
    # centering keeps the DC energy out of the bf16 cross terms
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
        Fblk, N2blk = _window_field_blocks(prev_rgb, mu, P, mh, mw, KR)
    else:
        raise ValueError(f"field_impl={field_impl!r}: 'passes' or 'im2row'")

    # halo-blocked rank: each row block builds only its own [BM, mw, NQ^2,
    # KR] shift stack of tile features, one bf16 batched product per block
    D = torch.empty(mh, mw, NQ * NQ, 64, dtype=torch.bfloat16, device=dev)
    for r0 in range(0, mh, RANK_ROWS):
        bm = min(RANK_ROWS, mh - r0)
        halo = tpad[r0:r0 + bm + NQ - 1]
        nb = torch.stack([
            halo[NQ - 1 - qy:NQ - 1 - qy + bm, NQ - 1 - qx:NQ - 1 - qx + mw]
            for qy in range(NQ) for qx in range(NQ)
        ], dim=2)  # [bm, mw, NQ^2, KR]
        fb = Fblk[r0:r0 + bm]  # [bm, mw, 64, KR]
        D[r0:r0 + bm] = torch.matmul(
            nb.reshape(-1, NQ * NQ, KR), fb.reshape(-1, 64, KR).transpose(1, 2)
        ).reshape(bm, mw, NQ * NQ, 64)
    return _rank_merge(D, T, T2, N2blk, pen, th, tw, NQ, P, prev_rgb, int16, return_windows)


def _rank_merge(D, T, T2, N2blk, pen, th, tw, NQ, P, prev_rgb, int16, return_windows):
    """Argmin over (q, s) of the bf16-rounded rank error (first in
    q-major, s-minor order), then the exact fp32 winner recompute."""
    dev = D.device
    H, W = prev_rgb.shape[0], prev_rgb.shape[1]
    e = torch.stack([
        T2[:, :, None]
        - 2.0 * D[qy:qy + th, qx:qx + tw, qy * NQ + qx].float()
        + N2blk[qy:qy + th, qx:qx + tw]
        + pen[:, qy * NQ + qx]
        for qy in range(NQ) for qx in range(NQ)
    ], dim=2).to(torch.bfloat16)  # [th, tw, NQ^2, 64]
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
    Wv = tile_features_raster(win)
    if int16:
        Wv = torch.round(Wv)
    diff = T.reshape(-1, K) - Wv
    exact = (diff * diff).sum(dim=-1).reshape(th, tw)
    exact = exact + best_oy.abs().float() + best_ox.abs().float()
    if return_windows:
        return best_oy, best_ox, exact, win
    return best_oy, best_ox, exact
