"""8x8 psycho-visual DCT features of RGB tiles.

Counterpart of ``tiler_tpu/ops/dct.py`` for the five psy-vis modes: the
four DCT modes (``dct``, ``weighted_dct``, ``spe_dct``,
``weighted_spe_dct``: per channel Z = D @ P @ D^T, optionally times the
PSNR-HVS weights) and ``wavelets`` (a 2-level normalized Haar transform),
scattered through the zigzag "snake" map; and the inverse of the three
invertible modes (:func:`inv_tile_features`). The constant tables are
rebuilt here with the same numpy code, because the JAX module imports jax
at its top; a test holds them equal to the JAX package's.
"""
from __future__ import annotations

import numpy as np
import torch

from .color import lab_to_rgb, rgb_to_lab_ordered, rgb_to_yuv, yuv_to_rgb
from .ordered import dot8, fma32

TILE_W = 8
TILE_DCT_SIZE = 192

# zigzag scatter map, cDCTSnake
SNAKE = np.array(
    [
        0, 1, 5, 6, 14, 15, 27, 28,
        2, 4, 7, 13, 16, 26, 29, 42,
        3, 8, 12, 17, 25, 30, 41, 43,
        9, 11, 18, 24, 31, 40, 44, 53,
        10, 19, 23, 32, 39, 45, 52, 54,
        20, 22, 33, 38, 46, 51, 55, 60,
        21, 34, 37, 47, 50, 56, 59, 61,
        35, 36, 48, 49, 57, 58, 62, 63,
    ],
    dtype=np.int32,
)
SNAKE_INV = np.argsort(SNAKE).astype(np.int32)

# PSNR-HVS weights for (Y, U, V), upper triangles of symmetric 8x8 tables
_W_Y = [1.6193873005, 2.2901594831, 2.08509755623, 1.48366094411, 1.00227514334, 0.678296995242, 0.466224900598, 0.3265091542,
        1.94321815382, 2.04793073064, 1.68731108984, 1.2305666963, 0.868920337363, 0.61280991668, 0.436405793551,
        1.34329019223, 1.09205635862, 0.875748795257, 0.670882927016, 0.501731932449, 0.372504254596,
        0.772819797575, 0.605636379554, 0.48309405692, 0.380429446972, 0.295774038565,
        0.448996256676, 0.352889268808, 0.283006984131, 0.226951348204,
        0.27032073436, 0.215017739696, 0.17408067321,
        0.168869545842, 0.136153931001,
        0.109083846276]
_W_U = [1.91113096927, 2.46074210438, 1.18284184739, 1.14982565193, 1.05017074788, 0.898018824055, 0.74725392039, 0.615105596242,
        1.58529308355, 1.21363250036, 1.38190029285, 1.33100189972, 1.17428548929, 0.996404342439, 0.830890433625,
        0.978712413627, 1.02624506078, 1.03145147362, 0.960060382087, 0.849823426169, 0.731221236837,
        0.861317501629, 0.801821139099, 0.751437590932, 0.685398513368, 0.608694761374,
        0.676555426187, 0.605503172737, 0.55002013668, 0.495804539034,
        0.514674450957, 0.454353482512, 0.407050308965,
        0.389234902883, 0.342353999733,
        0.295530605237]
_W_V = [2.03871978502, 2.62502345193, 1.26180942886, 1.11019789803, 1.01397751469, 0.867069376285, 0.721500455585, 0.593906509971,
        1.69112867013, 1.17180569821, 1.3342742857, 1.28513006198, 1.13381474809, 0.962064122248, 0.802254508198,
        0.944981930573, 0.990876405848, 0.995903384143, 0.926972725286, 0.820534991409, 0.706020324706,
        0.831632933426, 0.77418706195, 0.725539939514, 0.661776842059, 0.587716619023,
        0.653238524286, 0.584635025748, 0.531064164893, 0.478717061273,
        0.496936637883, 0.438694579826, 0.393021669543,
        0.375820256136, 0.330555063063,
        0.285345396658]


def _expand_sym(tri):
    """Expand an upper-triangle-with-diagonal row-major list into 8x8."""
    m = np.zeros((8, 8))
    it = iter(tri)
    for i in range(8):
        for j in range(i, 8):
            m[i, j] = next(it)
            m[j, i] = m[i, j]
    return m


DCT_WEIGHTS = np.stack([_expand_sym(_W_Y), _expand_sym(_W_U), _expand_sym(_W_V)])  # [3,8,8]


def _dct_matrix(spe: bool) -> np.ndarray:
    """D[u, x] = q[u]*cos((x+0.5)*u*pi/(8 or 16))."""
    q = np.ones(8)
    q[0] = np.sqrt(0.5)
    x = np.arange(8)[None, :]
    u = np.arange(8)[:, None]
    div = TILE_W * 2 if spe else TILE_W
    return q[:, None] * np.cos((x + 0.5) * u * np.pi / div)


DCT_MAT = _dct_matrix(spe=False)  # [8(u), 8(x)]
DCT_MAT_SPE = _dct_matrix(spe=True)

MODES = ("dct", "weighted_dct", "wavelets", "spe_dct", "weighted_spe_dct")


def tile_features(tiles_rgb: torch.Tensor, mode: str = "weighted_dct",
                  use_lab: bool = False) -> torch.Tensor:
    """Psycho-visual features of RGB tiles [..., 8, 8, 3] (float, 0..255)
    -> [..., 192] in the reference's snake layout. In LAB (the
    palettization's features) the tiles are byte-valued and the features
    are computed in float32 as the JAX package's CPU build computes them
    (``ops/ordered.py``): the LAB of :func:`~.color.rgb_to_lab_ordered`,
    and each DCT as two products over K = 8, first over y, then over x,
    summed as XLA's CPU dot sums them. The same bits on the CPU and on
    CUDA."""
    if not use_lab:
        return cpn_features(rgb_to_yuv(tiles_rgb), mode)
    if mode not in MODES:
        raise ValueError(f"dithering_mode={mode!r}: the psy-vis modes are {MODES}")
    lead = tiles_rgb.shape[:-3]
    cpn = rgb_to_lab_ordered(tiles_rgb.reshape(-1, 8, 8, 3).float())
    n = cpn.shape[0]
    inv = np.concatenate([SNAKE_INV, SNAKE_INV + 64, SNAKE_INV + 128])
    inv = torch.as_tensor(inv, dtype=torch.long, device=cpn.device)
    if mode == "wavelets":
        z = torch.movedim(_wavelet2_ordered(cpn), -1, -3)  # [n, c, v, u]
    else:
        Dt = torch.as_tensor((DCT_MAT_SPE if "spe" in mode else DCT_MAT).T,
                             dtype=torch.float32, device=cpn.device)
        z = dot8(cpn.permute(0, 2, 3, 1).reshape(-1, 8), Dt).reshape(n, 8, 3, 8)  # [n, x, c, v]
        z = dot8(z.permute(0, 2, 3, 1).reshape(-1, 8), Dt).reshape(n, 3, 8, 8)  # [n, c, v, u]
        if mode.startswith("weighted"):
            z = z * torch.as_tensor(DCT_WEIGHTS, dtype=torch.float32, device=z.device)
    return z.reshape(n, TILE_DCT_SIZE)[:, inv].reshape(*lead, TILE_DCT_SIZE)


def cpn_features(cpn: torch.Tensor, mode: str = "weighted_dct") -> torch.Tensor:
    """DCT features from component planes [..., 8(y), 8(x), 3(c)]."""
    if mode not in MODES:
        raise ValueError(f"dithering_mode={mode!r}: the psy-vis modes are {MODES}")
    if mode == "wavelets":
        z = _wavelet2(cpn)  # [..., v, u, c]
    else:
        spe = mode in ("spe_dct", "weighted_spe_dct")
        D = torch.as_tensor(DCT_MAT_SPE if spe else DCT_MAT, dtype=cpn.dtype,
                            device=cpn.device)
        z = torch.einsum("vy,...yxc,ux->...vuc", D, cpn, D)
        if mode in ("weighted_dct", "weighted_spe_dct"):
            w = torch.as_tensor(DCT_WEIGHTS, dtype=cpn.dtype, device=cpn.device)
            z = z * w.permute(1, 2, 0)
    zflat = torch.movedim(z, -1, -3).reshape(*z.shape[:-3], TILE_DCT_SIZE)
    inv = np.concatenate([SNAKE_INV, SNAKE_INV + 64, SNAKE_INV + 128])
    return zflat[..., torch.as_tensor(inv, dtype=torch.long, device=cpn.device)]


def inv_tile_features(feat: torch.Tensor, mode: str = "weighted_dct", use_lab: bool = False,
                      clamp: bool = True) -> torch.Tensor:
    """Inverse of :func:`tile_features` for the modes without the half-
    frequency DCT (``dct``, ``weighted_dct``, ``wavelets``): [..., 192]
    -> RGB tiles [..., 8, 8, 3] (rounded bytes with ``clamp``)."""
    if mode not in ("dct", "weighted_dct", "wavelets"):
        raise ValueError(f"inv_tile_features: mode {mode!r} has no inverse")
    idx = np.concatenate([SNAKE, SNAKE + 64, SNAKE + 128])
    zflat = feat[..., torch.as_tensor(idx, dtype=torch.long, device=feat.device)]
    z = torch.movedim(zflat.reshape(*feat.shape[:-1], 3, 8, 8), -3, -1)  # [..., v, u, c]
    if mode == "weighted_dct":
        w = torch.as_tensor(DCT_WEIGHTS, dtype=z.dtype, device=z.device)
        z = z / w.permute(1, 2, 0)
    if mode == "wavelets":
        cpn = _inv_wavelet2(z)
    else:
        # P = E^T (Z * q q^T) E / 16, E[u, x] = cos((x + 0.5) u pi / 8) = D / q
        q = np.array([np.sqrt(0.5), 1, 1, 1, 1, 1, 1, 1])
        E = torch.as_tensor(DCT_MAT / q[:, None], dtype=z.dtype, device=z.device)
        qt = torch.as_tensor(q, dtype=z.dtype, device=z.device)
        zq = z * qt[:, None, None] * qt[None, :, None]
        cpn = torch.einsum("vy,...vuc,ux->...yxc", E, zq, E) / 16.0
    return lab_to_rgb(cpn, clamp=clamp) if use_lab else yuv_to_rgb(cpn, clamp=clamp)


# a Python float: keeps float32 operands float32
_ISQRT2 = float(np.sqrt(2) / 2)


def _wavelet2(cpn: torch.Tensor) -> torch.Tensor:
    """2-level normalized Haar transform over the top-left quadrant, rows
    then columns at each level (the reference's WaveletGS)."""
    x = cpn
    for size in (8, 4):
        sub = x[..., :size, :size, :]
        a, b = sub[..., :, 0::2, :], sub[..., :, 1::2, :]
        rows = torch.cat([(a + b), (a - b)], dim=-2) * _ISQRT2
        a, b = rows[..., 0::2, :, :], rows[..., 1::2, :, :]
        cols = torch.cat([(a + b), (a - b)], dim=-3) * _ISQRT2
        x = x.clone()
        x[..., :size, :size, :] = cols
    return x


def _wavelet2_ordered(cpn: torch.Tensor) -> torch.Tensor:
    """:func:`_wavelet2` as the JAX package's CPU build computes it: each
    product by 1/sqrt(2) that feeds an add or a subtraction is fused
    into it (an FMA on the first operand), in both levels."""
    c = float(np.float32(_ISQRT2))

    def cols(rows):  # (a + b) c, (a - b) c of row pairs, each a pending product
        p, q = rows[..., 0::2, :, :], rows[..., 1::2, :, :]
        return torch.cat([fma32(p, c, q * c), fma32(p, c, -(q * c))], dim=-3)

    a, b = cpn[..., :, 0::2, :], cpn[..., :, 1::2, :]
    u = cols(torch.cat([a + b, a - b], dim=-2))  # level 1, before its last product
    x = u * c
    ua, xb = u[..., :4, 0:4:2, :], x[..., :4, 1:4:2, :]
    x = x.clone()
    x[..., :4, :4, :] = cols(torch.cat([fma32(ua, c, xb), fma32(ua, c, -xb)], dim=-2)) * c
    return x


def _inv_wavelet2(z: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_wavelet2` (the reference's DeWaveletGS)."""
    x = z
    for size in (4, 8):
        sub = x[..., :size, :size, :]
        h = size // 2
        s, d = sub[..., :h, :, :], sub[..., h:, :, :]
        a, b = (s + d) * _ISQRT2, (s - d) * _ISQRT2
        cols = torch.stack([a, b], dim=-3).reshape(*a.shape[:-3], size, size, a.shape[-1])
        s, d = cols[..., :, :h, :], cols[..., :, h:, :]
        a, b = (s + d) * _ISQRT2, (s - d) * _ISQRT2
        rows = torch.stack([a, b], dim=-2).reshape(*a.shape[:-3], size, size, a.shape[-1])
        x = x.clone()
        x[..., :size, :size, :] = rows
    return x
