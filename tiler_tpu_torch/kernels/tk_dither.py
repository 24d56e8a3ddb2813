"""Thomas Knoll dithering of corpus tiles: the CUDA kernel and its plain
PyTorch version.

Replaces the Pallas TPU kernel ``tiler_tpu/kernels/tk_dither.py::tk_select``
(the call at :147, body ``_make_kernel`` :49-123) at every palette size
1..256. The CUDA source is ``csrc/tk_dither.cu``; its header says what
bounds it on the card and how the design answers that. S <= 32 runs the
two narrow instantiations (:func:`tk_select`), S = 33..256 the wide kernel
(:func:`tk_select_wide`), each wrapper counting its own launches.

:func:`tk_select` dispatches on the device of its inputs: CPU tensors go
to :func:`tk_select_plain`, CUDA tensors to a kernel. There is no
fallback from one to the other.
"""
from __future__ import annotations

import numpy as np
import torch

from . import _build

STEPS = 64
BIG = 1 << 30
NARROW_S = 32  # the widest palette of the narrow instantiations
MAX_S = 256  # GTM writes a palette slot as a byte
# tk_select_plain's [tiles, 64, S] int32 step tensors hold at most this
# many elements a chunk of tiles (256 MiB each)
PLAIN_CHUNK = 1 << 26
RED_MUL, GREEN_MUL, BLUE_MUL, LUMA_DIV = 299, 587, 114, 1000
RGB_W = 13

# cDitheringMap (the reference's utils.pas:47-56); a test holds it equal
# to tiler_tpu.pipeline.dither.BAYER8
BAYER8 = np.array(
    [
        0, 48, 12, 60, 3, 51, 15, 63,
        32, 16, 44, 28, 35, 19, 47, 31,
        8, 56, 4, 52, 11, 59, 7, 55,
        40, 24, 36, 20, 43, 27, 39, 23,
        2, 50, 14, 62, 1, 49, 13, 61,
        34, 18, 46, 30, 33, 17, 45, 29,
        10, 58, 6, 54, 9, 57, 5, 53,
        42, 26, 38, 22, 41, 25, 37, 21,
    ],
    dtype=np.int32,
).reshape(8, 8)


def pal_table(pal_rgb: torch.Tensor, pal_valid: torch.Tensor) -> torch.Tensor:
    """[P, S, 3] ints + [P, S] bool -> [P, S, 8] int32 rows
    (r, g, b, luma, valid, 0, 0, 0), the kernel's palette layout."""
    rgb = pal_rgb.to(torch.int32)
    lum = rgb[..., 0] * RED_MUL + rgb[..., 1] * GREEN_MUL + rgb[..., 2] * BLUE_MUL
    table = torch.zeros(*rgb.shape[:2], 8, dtype=torch.int32, device=rgb.device)
    table[..., 0:3] = rgb
    table[..., 3] = lum
    table[..., 4] = pal_valid.to(torch.int32)
    return table


def _trunc_div(a: torch.Tensor, b: int) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="trunc")


def mirrored_bayer(mirror: torch.Tensor) -> torch.Tensor:
    """[n] uint8 (hmirror | vmirror << 1) -> [n, 8, 8] int32 Bayer maps:
    canonical pixels are dithered against the map mirrored as their tile
    is on screen."""
    n = mirror.shape[0]
    bay = torch.as_tensor(BAYER8, device=mirror.device).reshape(1, 8, 8).expand(n, 8, 8)
    m = mirror.to(torch.int32)[:, None, None]
    bay = torch.where((m & 1) != 0, bay.flip(-1), bay)
    return torch.where((m & 2) != 0, bay.flip(-2), bay)


def tk_select_plain(pix, mirror, pal_idx, table) -> torch.Tensor:
    """Plain PyTorch version of the kernel, same arguments and result.

    pix uint8 [T, 64, 3] canonical tile pixels; mirror uint8 [T]
    (hmirror | vmirror << 1, selects the mirrored Bayer map); pal_idx
    int32 [T]; table int32 [P, S, 8] from :func:`pal_table`.
    Returns uint8 [T, 64] palette slots. Tiles go in chunks whose
    [tiles, 64, S] step tensors hold at most ``PLAIN_CHUNK`` elements."""
    T = pix.shape[0]
    chunk = max(1, PLAIN_CHUNK // (64 * table.shape[1]))
    if T > chunk:
        return torch.cat([tk_select_plain(pix[i:i + chunk], mirror[i:i + chunk],
                                          pal_idx[i:i + chunk], table)
                          for i in range(0, T, chunk)])
    pal = table[pal_idx.long()]  # [T, S, 8]
    pr, pg, pb, pl = (pal[:, None, :, i] for i in range(4))  # [T, 1, S]
    pv = pal[:, None, :, 4] > 0
    src = pix.to(torch.int32)
    sr, sg, sb = src[..., 0], src[..., 1], src[..., 2]  # [T, 64]
    er = torch.zeros_like(sr)
    eg = torch.zeros_like(sr)
    eb = torch.zeros_like(sr)
    keys, picks = [], []
    for c in range(STEPS):
        tr = sr + _trunc_div(er * 9, 100)
        tg = sg + _trunc_div(eg * 9, 100)
        tb = sb + _trunc_div(eb * 9, 100)
        lum_t = tr * RED_MUL + tg * GREEN_MUL + tb * BLUE_MUL
        dr, dg, db = tr[..., None] - pr, tg[..., None] - pg, tb[..., None] - pb
        ld = _trunc_div(lum_t[..., None] - pl, LUMA_DIV)
        pen = (dr * dr + dg * dg + db * db) * RGB_W + ld * ld * 32
        pen = torch.where(pv, pen, BIG)
        best, idx = pen.min(dim=-1)  # first minimum
        found = best < BIG  # the kernel keeps slot 0 / black otherwise
        idx = torch.where(found, idx, 0)

        def pick(v):
            return torch.where(found, v.expand_as(pen).gather(-1, idx[..., None])[..., 0], 0)

        br, bg, bb, bl = pick(pr), pick(pg), pick(pb), pick(pl)
        keys.append(bl * STEPS + c)
        picks.append(idx)
        er = er + sr - br
        eg = eg + sg - bg
        eb = eb + sb - bb
    keys = torch.stack(keys, dim=-1)  # [T, 64, 64] distinct per pixel
    picks = torch.stack(picks, dim=-1)
    mapv = mirrored_bayer(mirror).reshape(T, 64, 1).long()
    order = torch.sort(keys, dim=-1, stable=True).indices
    at_rank = order.gather(-1, mapv)
    return picks.gather(-1, at_rank)[..., 0].to(torch.uint8)


def _check(pix, mirror, pal_idx, table):
    dev = pix.device
    T = pix.shape[0]
    for name, t, dtype, shape in (
        ("pix", pix, torch.uint8, (T, 64, 3)),
        ("mirror", mirror, torch.uint8, (T,)),
        ("pal_idx", pal_idx, torch.int32, (T,)),
        ("table", table, torch.int32, None),
    ):
        if t.device != dev:
            raise ValueError(f"tk_select: {name} is on {t.device}, pix on {dev}")
        if t.dtype != dtype:
            raise ValueError(f"tk_select: {name} must be {dtype}, got {t.dtype}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"tk_select: {name} shape {tuple(t.shape)} != {shape}")
        if not t.is_contiguous():
            raise ValueError(f"tk_select: {name} must be contiguous")
    if table.dim() != 3 or table.shape[2] != 8:
        raise ValueError(f"tk_select: table must be [P, S, 8], got {tuple(table.shape)}")
    if not 1 <= table.shape[1] <= MAX_S:
        raise ValueError(f"tk_select: palette size {table.shape[1]} outside 1..{MAX_S}")
    if T and dev.type == "cpu":
        # on the card this read would stall the host on the device inside
        # the dither stage: there the caller checks the range while
        # pal_idx is still a host array (check_pal_idx, pipeline/dither.py)
        check_pal_idx(pal_idx.numpy(), table.shape[0])


def check_pal_idx(pal_idx: np.ndarray, P: int):
    """Raise unless every palette index (a host array) lies in [0, P)."""
    if pal_idx.size and (int(pal_idx.min()) < 0 or int(pal_idx.max()) >= P):
        raise ValueError(f"tk_select: pal_idx outside [0, {P})")


def _launch(pix, mirror, pal_idx, table) -> torch.Tensor:
    T, P, S = pix.shape[0], table.shape[0], table.shape[1]
    out = torch.empty((T, 64), dtype=torch.uint8, device=pix.device)
    code = _build.lib().tk_select_launch(
        pix.data_ptr(), mirror.data_ptr(), pal_idx.data_ptr(),
        table.data_ptr(), out.data_ptr(), T, P, S,
        _build.stream_ptr(pix.device))
    _build.check(code, "tk_select_launch")
    return out


def tk_select(pix, mirror, pal_idx, table) -> torch.Tensor:
    """Thomas Knoll palette slot per pixel; see :func:`tk_select_plain`.
    CPU tensors run the plain version, CUDA tensors a kernel: S <= 32 the
    narrow instantiations (counted here), S = 33..256 the wide kernel
    (:func:`tk_select_wide`, counted there). The kernels' integer ranges
    assume colors in 0..255 with the luma of :func:`pal_table`; on the
    card the caller answers for pal_idx in [0, P) (:func:`check_pal_idx`)."""
    if table.dim() == 3 and table.shape[1] > NARROW_S:
        return tk_select_wide(pix, mirror, pal_idx, table)
    if pix.device.type not in ("cpu", "cuda"):
        raise ValueError(f"tk_select: no kernel for device {pix.device}")
    _check(pix, mirror, pal_idx, table)
    if pix.device.type == "cpu":
        return tk_select_plain(pix, mirror, pal_idx, table)
    out = _launch(pix, mirror, pal_idx, table)
    tk_select.launches += 1
    return out


def tk_select_wide(pix, mirror, pal_idx, table) -> torch.Tensor:
    """:func:`tk_select` for palettes of S = 33..256 colors: the wide
    kernel (``tk_select_wide_kernel``, points 9-12 of csrc/tk_dither.cu's
    header) on CUDA tensors, the plain version on CPU tensors."""
    if pix.device.type not in ("cpu", "cuda"):
        raise ValueError(f"tk_select_wide: no kernel for device {pix.device}")
    _check(pix, mirror, pal_idx, table)
    if not NARROW_S < table.shape[1]:
        raise ValueError(f"tk_select_wide: palette size {table.shape[1]} is not above "
                         f"{NARROW_S} (tk_select runs those)")
    if pix.device.type == "cpu":
        return tk_select_plain(pix, mirror, pal_idx, table)
    out = _launch(pix, mirror, pal_idx, table)
    tk_select_wide.launches += 1
    return out


tk_select.launches = 0
tk_select_wide.launches = 0


def trunc_probe(lo: int, count: int, which: int, device) -> torch.Tensor:
    """The kernel's two truncating divisions, each one fp32 multiply-add
    rounding toward zero (``luma_quotient`` and ``feedback`` in
    csrc/tk_dither.cu), on the ``count`` integers n from ``lo`` on,
    computed on the card: ``which`` 0 gives floor(|n| / 1000), 1 gives
    trunc(n * 9 / 100), int32 [count]. A test holds them against the
    integer divisions over their whole ranges."""
    out = torch.empty(count, dtype=torch.int32, device=device)
    code = _build.lib().tk_trunc_probe_launch(out.data_ptr(), lo, count, which,
                                              _build.stream_ptr(out.device))
    _build.check(code, "tk_trunc_probe_launch")
    return out


def adversarial_case(S: int, seed: int = 0, reps: int = 2):
    """Tiles and palettes that provoke the kernel's edge cases, as numpy
    arrays (pix uint8 [T, 64, 3], mirror uint8 [T], pal_idx int32 [T],
    pal_rgb int32 [P, S, 3], pal_valid bool [P, S]); T is odd.

    Palettes: one color 255 in every slot and one color 0 (against all-0
    and all-255 pixels: the error grows to its bound, and every slot is a
    duplicate, so the first minimum must win); duplicated colors; colors of
    equal luma (their picks rank by step); black and white only; a single
    valid slot (the last, the first); no valid slot; random with invalid
    slots; equal lumas, duplicates and invalid slots together."""
    rng = np.random.default_rng(seed)
    rand = lambda: rng.integers(0, 256, (S, 3))  # noqa: E731
    # colors of one luma: a base plus moves (a, b, c) with 299a + 587b +
    # 114c = 0; 8 such colors within +-40 of grey 120, 98 within +-120 of
    # grey 128 for the wide palettes (repeated up to S: equal lumas across
    # every slot)
    r, grey = (40, 120) if S <= NARROW_S else (120, 128)
    d = np.arange(-r, r + 1)
    a, b, c = np.meshgrid(d, d, d, indexing="ij")
    zero = (RED_MUL * a + GREEN_MUL * b + BLUE_MUL * c == 0) & ((a != 0) | (b != 0))
    steps = np.stack([a[zero], b[zero], c[zero]], axis=1)  # luma-neutral moves
    base = np.array([grey, grey, grey])
    same_luma = base + steps[rng.permutation(len(steps))[:S]]
    if len(same_luma) < S:
        same_luma = np.resize(same_luma, (S, 3))
    dup = rand()
    dup[S // 2:] = dup[:S - S // 2]
    bw = np.where((np.arange(S) % 2 == 0)[:, None], 0, 255) * np.ones((1, 3), int)
    mixed = same_luma.copy()
    mixed[::3] = mixed[0]
    pals = [np.full((S, 3), 255), np.zeros((S, 3), int), dup[rng.permutation(S)],
            same_luma, bw, rand(), rand(), rand(), rand(), mixed]
    valid = np.ones((len(pals), S), bool)
    valid[5] = False
    valid[5, S - 1] = True
    valid[6] = False
    valid[6, 0] = True
    valid[7] = False
    valid[8] = rng.random(S) < 0.7
    valid[9, 1::4] = False
    pal = np.stack(pals).astype(np.int32)
    assert pal.min() >= 0 and pal.max() <= 255
    # each palette against tiles of 0, of 255, random, and random with
    # every channel at 0 or 255
    tiles, pidx = [], []
    for _ in range(reps):
        for p in range(len(pals)):
            random = rng.integers(0, 256, (2, 64, 3))
            tiles += [np.zeros((64, 3), int), np.full((64, 3), 255), random[0],
                      np.where(random[1] < 128, 0, 255)]
            pidx += [p] * 4
    tiles.append(rng.integers(0, 256, (64, 3)))
    pidx.append(3)
    pix = np.stack(tiles).astype(np.uint8)
    mirror = rng.integers(0, 4, len(pix)).astype(np.uint8)
    return pix, mirror, np.asarray(pidx, np.int32), pal, valid


def slot_edge_case(S: int, seed: int = 0, reps: int = 1):
    """Palettes that provoke the wide kernel's scan over valid rows only
    (csrc/tk_dither.cu, header points 9 and 10), as numpy arrays shaped as
    :func:`adversarial_case`'s; T is odd.

    Palettes: invalid slots below the first valid one that hold the valid
    slots' colors (a tie an invalid slot must not win); one color in every
    slot, valid from the middle on (the first valid slot wins); no valid
    color (slot 0); a single valid slot, the last (255 at S = 256); valid
    counts 16k + 1 and 16k + 15 that leave a group partly padded, the last
    valid color repeated in an earlier valid slot (the copies that pad the
    group must lose its ties); random with about half the slots valid, the
    invalid ones holding valid colors; every slot valid, slots 16..31
    repeating slots 15..0 (ties across a group boundary where the later
    row has the lower place in its group). Each palette against tiles of 0, of
    255, random, and of the palette's own colors drawn from every slot
    (exact matches, pen 0, for valid and invalid slots alike)."""
    rng = np.random.default_rng(seed)
    rand = lambda: rng.integers(0, 256, (S, 3))  # noqa: E731
    pals, valid = [], []

    def add(pal, ok):
        pals.append(pal)
        valid.append(ok)

    k = S // 3
    pal = rand()
    pal[:k] = pal[k:2 * k]
    add(pal, np.arange(S) >= k)
    add(np.tile(rng.integers(0, 256, (1, 3)), (S, 1)), np.arange(S) >= S // 2)
    add(rand(), np.zeros(S, bool))
    add(rand(), np.arange(S) == S - 1)
    for n in (16 * ((S - 1) // 16) + 1, 16 * ((S - 16) // 16) + 15):
        ok = np.zeros(S, bool)
        ok[rng.choice(S, n, replace=False)] = True
        slots = np.flatnonzero(ok)
        pal = rand()
        pal[slots[len(slots) // 2]] = pal[slots[-1]]
        add(pal, ok)
    ok = rng.random(S) < 0.5
    ok[rng.integers(S)] = True
    pal = rand()
    pal[~ok] = pal[rng.choice(np.flatnonzero(ok), int((~ok).sum()))]
    add(pal, ok)
    pal = rand()
    pal[16:32] = pal[15::-1]
    add(pal, np.ones(S, bool))
    tiles, pidx = [], []
    for _ in range(reps):
        for p, pal in enumerate(pals):
            tiles += [np.zeros((64, 3), int), np.full((64, 3), 255),
                      rng.integers(0, 256, (64, 3)), pal[rng.integers(0, S, 64)]]
            pidx += [p] * 4
    tiles.append(pals[0][rng.integers(0, S, 64)])
    pidx.append(0)
    pix = np.stack(tiles).astype(np.uint8)
    mirror = rng.integers(0, 4, len(pix)).astype(np.uint8)
    return (pix, mirror, np.asarray(pidx, np.int32), np.stack(pals).astype(np.int32),
            np.stack(valid))
