"""esPreparePalettes: palettization, per-palette color quantization, and
the cross-palette permutation optimization.

Counterpart of ``tiler_tpu/pipeline/palettes.py:38-431``: two levels of
weighted k-means over the corpus's LAB psy-vis features assign every tile
a palette; per palette, a uniform sample of member tiles' pixels is
quantized to S colors and sorted by integer HSV, and a 2-opt search
permutes each palette's slots to maximize the cross-palette per-slot
spread. The quantizer is a batched weighted k-means on the device
(``color_quantizer="kmeans"``), or the host median cut (``"mediancut"``,
``cluster/mediancut.py``); the 2-opt (:func:`optimize_palettes`) then
runs on the device after either (the JAX package fuses it into the
k-means path's quantization). On a mesh with a "corpus" axis the first
k-means is corpus-sharded. Random draws come from the
port's threefry generator, so they are the JAX package's draws. The
2-opt's inner iterations per round go to ``stats["two_opt_inner"]``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..cluster.kmeans import kmeans
from ..cluster.mediancut import median_cut
from ..config import EncoderSettings
from ..models.state import EncodeState
from ..ops import dct, prng
from ..ops.color import posterize, rgb_to_hsv_bytes
from ..ops.ordered import fma32
from ..parallel.kmeans import sharded_kmeans

RED_MUL, GREEN_MUL, BLUE_MUL, LUMA_DIV = 299, 587, 114, 1000
COLOR_CAP = 2048  # sampled member pixels per palette
MAX_ROUNDS = 16  # outer rounds of the 2-opt


def _corpus_features(state: EncodeState, settings: EncoderSettings, chunk=65536):
    """Per-tile dither-mode features in LAB, in the JAX package's float
    order (``dct.tile_features``): the k-means they feed turns a
    last-bit difference into other palettes."""
    corpus = state.corpus_rgb
    return torch.cat([
        dct.tile_features(corpus[i:i + chunk], mode=settings.dithering_mode, use_lab=True)
        for i in range(0, len(corpus), chunk)
    ])


def palettization(state: EncodeState, settings: EncoderSettings, mesh=None) -> EncodeState:
    """Two levels of weighted k-means; with a mesh that has a "corpus"
    axis the first runs corpus-sharded (``parallel/kmeans.py``), the
    second, over its centroids, on each rank as without one."""
    feats = _corpus_features(state, settings)
    dev = feats.device
    P = settings.palette_count
    k1 = min(P * 8, len(feats))  # BICO coreset size
    weights = torch.as_tensor(state.corpus_use.astype(np.float32), device=dev)
    if mesh is not None and "corpus" in mesh.mesh_dim_names:
        cents, assign1, _ = sharded_kmeans(feats, k1, weights=weights,
                                           iters=settings.kmeans_iters, seed=settings.seed,
                                           mesh=mesh)
    else:
        cents, assign1, _ = kmeans(feats, k1, weights=weights, iters=settings.kmeans_iters,
                                   seed=settings.seed, init="sample")
    k1 = int(cents.shape[0])
    if k1 > P and P > 1:
        _, assign2, _ = kmeans(cents, P, iters=settings.kmeans_iters,
                               seed=settings.seed + 1, init="kpp")
        pal_of_c1 = assign2.long()
    elif k1 > P:  # P == 1
        pal_of_c1 = torch.zeros(k1, dtype=torch.long, device=dev)
    else:
        pal_of_c1 = torch.arange(k1, device=dev)
    # palettes renumbered by use count, descending, stable
    pal_initial = pal_of_c1[assign1.long()]
    use = torch.bincount(pal_initial, minlength=P)
    order = torch.sort(-use, stable=True).indices
    lut = torch.empty(P, dtype=torch.int32, device=dev)
    lut[order] = torch.arange(P, dtype=torch.int32, device=dev)
    state.corpus_pal_initial = lut[pal_initial]
    return state


def _sample_member_pixels(corpus_rgb, pal_initial, P: int, cap: int, key):
    """Per-palette uniform sample (without replacement) of member tiles,
    expanded to their pixels. Returns (cols [P, cap, 3] f32, wts [P, cap]
    f32 0/1, npix [P] i32 = the true member-pixel count)."""
    dev = corpus_rgb.device
    T = corpus_rgb.shape[0]
    ctiles = cap // 64
    pix = corpus_rgb.reshape(T, 64, 3).float()
    pal = pal_initial.to(torch.int32)
    if (P + 1) * (1 << 20) + (1 << 20) >= 2**31:
        raise ValueError(f"palette_count={P} is beyond the one-key sample sort")
    r20 = prng.randint(key, (T,), 0, 1 << 20, device=dev)
    order = torch.sort(pal * (1 << 20) + r20, stable=True).indices
    spal = pal[order].contiguous()
    ids = torch.arange(P, dtype=torch.int32, device=dev)
    starts = torch.searchsorted(spal, ids)
    ends = torch.searchsorted(spal, ids, right=True)
    ntiles = (ends - starts).to(torch.int32)
    idx = starts[:, None] + torch.arange(ctiles, device=dev)
    tvalid = torch.arange(ctiles, device=dev) < torch.clamp_max(ntiles, ctiles)[:, None]
    cols = pix[order[idx.clamp(0, T - 1)]].reshape(P, ctiles * 64, 3)
    valid = tvalid.repeat_interleave(64, dim=1)
    if ctiles * 64 < cap:
        cols = torch.nn.functional.pad(cols, (0, 0, 0, cap - ctiles * 64))
        valid = torch.nn.functional.pad(valid, (0, cap - ctiles * 64))
    return cols, valid.float(), ntiles * 64


def _sq_norm3(x):
    """|x|^2 over the last axis of 3, as the JAX package's compiled sum
    of squares: x0 * x0, then two FMAs."""
    return fma32(x[..., 2], x[..., 2], fma32(x[..., 1], x[..., 1], x[..., 0] * x[..., 0]))


def _kmeans_small_batch(colors, weights, seeds, k: int, iters: int):
    """All P per-palette k-means at once: colors [P, n, 3], weights [P, n]
    (0/1), seeds [P] ints. Weighted-Gumbel sample init, lowest-index
    argmin ties, exact weighted means, batch-wide fixed-point exit.
    Returns centroids [P, k, 3]."""
    P, n, _ = colors.shape
    keys = torch.tensor([prng.prng_key(int(s)) for s in seeds],
                        dtype=torch.int64, device=colors.device)
    g = prng.gumbel(keys, (n,), device=colors.device)  # [P, n]
    keyv = torch.where(weights > 0, torch.log(torch.clamp_min(weights, 1e-30)), -torch.inf) + g
    idx = torch.sort(keyv, dim=1, descending=True, stable=True).indices[:, :k]
    cents = colors.gather(1, idx[:, :, None].expand(P, k, 3))

    colsT = colors.transpose(1, 2)  # [P, 3, n]
    x2 = _sq_norm3(colors)  # [P, n]
    karange = torch.arange(k, device=colors.device)[None, :, None]
    for _ in range(iters):
        c2 = _sq_norm3(cents)
        d2 = x2[:, None, :] - 2.0 * torch.bmm(cents, colsT) + c2[:, :, None]
        a = torch.argmin(d2, dim=1)  # [P, n], ties -> lowest k
        oh = (a[:, None, :] == karange).float() * weights[:, None, :]
        cnt = oh.sum(dim=-1)
        s = torch.bmm(oh, colors)  # [P, k, 3]
        new = torch.where(cnt[:, :, None] > 0, s / torch.clamp_min(cnt[:, :, None], 1e-30), cents)
        done = torch.equal(new, cents)
        cents = new
        if done:
            break
    return cents


def _hsv_sort(cents, npix, S: int):
    """Round/clip the centroids, zero the invalid slots (valid count =
    min(S, member pixels)), stable sort by integer HSV (Val, Sat, Hue).
    Returns (rgb f32 [P, S, 3] byte-exact integers, valid bool [P, S])."""
    rgb = torch.clamp(torch.round(torch.nan_to_num(cents)), 0, 255).to(torch.int32)
    ncols = torch.clamp_max(npix.to(torch.int32), S)
    valid = torch.arange(S, dtype=torch.int32, device=rgb.device)[None, :] < ncols[:, None]
    rgb = torch.where(valid[..., None], rgb, 0)

    def muldiv(a, b, c):  # Windows MulDiv: round-half-away-from-zero
        num = a * b
        return torch.sign(num) * torch.div(num.abs() + torch.div(c, 2, rounding_mode="floor"),
                                           c, rounding_mode="floor")

    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    delta = mx - mn
    nz = delta != 0
    safe_delta = torch.where(nz, delta, 1)
    s = torch.where(nz, muldiv(delta, 255, torch.where(mx == 0, 1, mx)), 0)
    h_r = muldiv(42, g - b, safe_delta)
    h_g = muldiv(42, b - r, safe_delta) + 84
    h_b = muldiv(42, r - g, safe_delta) + 168
    h = torch.where(r == mx, h_r, torch.where(g == mx, h_g, h_b))
    # Pascal mod truncates toward zero (keeps the sign), then `and $ff`
    h = torch.where(nz, torch.fmod(h, 252) & 0xFF, 0)
    sort_key = torch.where(valid, (mx << 16) | (s << 8) | h, 1 << 30)
    order = torch.sort(sort_key, dim=1, stable=True).indices
    rgb = rgb.gather(1, order[..., None].expand_as(rgb))
    return rgb.float(), valid.gather(1, order)


def _optimize_palettes(pal, valid, S: int, max_rounds: int, max_inner: int,
                       inner_counts: list):
    """2-opt on the OptimizePalettes objective: maximize
    sum_c w_c * sqrt(sum_slot (acc_c + pal_c - mean_c)^2 / S), with swap
    gains in the cancellation-free form 2 (rj - ri)(ti - tj) and
    sqrt(a + d) - sqrt(a) = d / (sqrt(a + d) + sqrt(a)). Each round's
    inner iterations are appended to ``inner_counts`` (the host reads a
    flag after every one; up to ``max_inner`` = S * S of them a round)."""
    dev = pal.device
    wch = torch.tensor([RED_MUL, GREEN_MUL, BLUE_MUL], dtype=torch.float32, device=dev) / LUMA_DIV
    iu_i, iu_j = (torch.as_tensor(v, device=dev) for v in np.triu_indices(S, 1))
    mean = pal.sum(dim=(0, 1)) / S
    slots = torch.arange(S, device=dev)[None, :]
    prev_obj = torch.tensor(0.0, device=dev)
    for _ in range(max_rounds):
        t = pal.sum(dim=0, keepdim=True) - pal - mean  # held fixed inside
        dt2 = 2.0 * (t[:, iu_i] - t[:, iu_j])  # [P, pairs, 3]
        inner = 0
        for _ in range(max_inner):
            inner += 1
            d = t + pal
            ss = (d * d).sum(dim=1)  # [P, 3]
            dss = (pal[:, iu_j] - pal[:, iu_i]) * dt2
            sq_cur = torch.sqrt(ss / S)
            sq_new = torch.sqrt(torch.clamp_min(ss[:, None, :] + dss, 0) / S)
            gain = (wch * (dss / S) / (sq_new + sq_cur[:, None, :] + 1e-20)).sum(dim=-1)
            bg, best = gain.max(dim=1)
            do = bg > 1e-4
            bi = iu_i[best][:, None]
            bj = iu_j[best][:, None]
            sw = torch.where(slots == bi, bj, torch.where(slots == bj, bi, slots))
            sw = torch.where(do[:, None], sw, slots)
            pal = pal.gather(1, sw[:, :, None].expand_as(pal))
            valid = valid.gather(1, sw)
            if not bool(do.any()):
                break
        inner_counts.append(inner)
        dall = (pal.sum(dim=0, keepdim=True) - pal) + pal - mean
        obj = (wch * torch.sqrt((dall ** 2).sum(dim=1) / S)).sum(dim=-1).mean()
        improved = bool(obj > prev_obj * (1 + 1e-5))
        prev_obj = obj
        if not improved:
            break
    return pal, valid


def _median_cut_palettes(cols, wts, npix, S: int):
    """The host median cut of every palette's sample, as the JAX package
    runs it (``tiler_tpu/pipeline/palettes.py:155-190``): cols [P, n, 3],
    wts [P, n] and npix [P] tensors in; numpy (rgb uint8 [P, S, 3], valid
    bool [P, S]) out, HSV-sorted (Val, Sat, Hue) with invalid slots last."""
    cols_h, wts_h = cols.cpu().numpy(), wts.cpu().numpy()
    npix = npix.cpu().numpy().astype(np.int64)
    cents = np.stack([median_cut(cols_h[p][wts_h[p] > 0], wts_h[p][wts_h[p] > 0], S)
                      for p in range(len(cols_h))]).astype(np.float64)
    rgb = np.clip(np.round(np.nan_to_num(cents)), 0, 255).astype(np.int64)
    rgb = posterize(rgb, 255)  # the identity at 8 bits a component
    valid = np.arange(S)[None, :] < np.minimum(S, npix)[:, None]
    rgb[~valid] = 0
    hsv = rgb_to_hsv_bytes(rgb)
    sort_key = np.where(valid, (hsv[..., 2] << 16) | (hsv[..., 1] << 8) | hsv[..., 0], 1 << 40)
    order = np.argsort(sort_key, axis=1, kind="stable")
    return (np.take_along_axis(rgb, order[..., None], axis=1).astype(np.uint8),
            np.take_along_axis(valid, order, axis=1))


def quantization(state: EncodeState, settings: EncoderSettings) -> EncodeState:
    """Per-palette colors, HSV-sorted: the k-means on the device, or
    (``color_quantizer="mediancut"``) the host median cut."""
    P, S = settings.palette_count, settings.palette_size
    key = prng.prng_key(settings.seed)
    corpus = state.corpus_rgb
    dev = corpus.device
    T = len(corpus)
    Tpad = 256  # the sample draw's length is the padded corpus's
    while Tpad < T:
        Tpad *= 2
    pidx = torch.as_tensor(state.corpus_pal_initial, device=dev).to(torch.int32)
    corpus = torch.nn.functional.pad(corpus, (0, 0, 0, 0, 0, 0, 0, Tpad - T))
    pidx = torch.nn.functional.pad(pidx, (0, Tpad - T), value=P)
    cols, wts, npix = _sample_member_pixels(corpus, pidx, P, COLOR_CAP, key)
    if settings.color_quantizer == "mediancut":
        rgb, valid = _median_cut_palettes(cols, wts, npix, S)
    else:
        cents = _kmeans_small_batch(cols, wts, np.arange(P) + settings.seed, S,
                                    settings.kmeans_iters)
        rgb, valid = _hsv_sort(cents, npix, S)
    state.palettes_rgb = torch.as_tensor(rgb, device=dev).to(torch.uint8)
    state.palettes_valid = torch.as_tensor(valid, device=dev)
    return state


def optimize_palettes(state: EncodeState, settings: EncoderSettings,
                      stats: dict | None = None) -> EncodeState:
    """The 2-opt on the palettes the state holds
    (``tiler_tpu/pipeline/palettes.py:393-420``); its inner iterations a
    round go to ``stats["two_opt_inner"]``."""
    S = settings.palette_size
    pal = torch.as_tensor(state.palettes_rgb).float()
    valid = torch.as_tensor(state.palettes_valid)
    inner = []
    pal, valid = _optimize_palettes(pal, valid, S, MAX_ROUNDS, S * S, inner)
    if stats is not None:
        stats["two_opt_inner"] = inner
    state.palettes_rgb = pal.to(torch.uint8)
    state.palettes_valid = valid
    return state


def prepare_palettes(state: EncodeState, settings: EncoderSettings,
                     stats: dict | None = None, mesh=None) -> EncodeState:
    state = palettization(state, settings, mesh)
    state = quantization(state, settings)
    return optimize_palettes(state, settings, stats)
