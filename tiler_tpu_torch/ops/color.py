"""Colorspace conversions on torch tensors, batched over leading axes.

Counterpart of ``tiler_tpu/ops/color.py`` with the same constants:
Rec.601 luma 299/587/114, YUV u=(b-y)*0.492 v=(r-y)*0.877 and its
inverse 1.13983/0.39465/0.58060/2.03211, CIE LAB via the Wright-Guild XYZ
matrix and illuminant D50 (back through the reference's hand-rounded
inverse matrix), and the integer HSV used to order palette colors. RGB is
on the 0..255 byte scale.
"""
from __future__ import annotations

import numpy as np
import torch

from .ordered import fma32, fma_sum, fold_lanes, powf

RED_MUL = 299
GREEN_MUL = 587
BLUE_MUL = 114
LUMA_DIV = RED_MUL + GREEN_MUL + BLUE_MUL  # 1000

# Wright-Guild CIE XYZ matrix scaled by 1/0.17697, then the D50 white
# point division (built in float64 exactly as the JAX package builds it)
_XYZ_M = np.array(
    [
        [0.49000, 0.31000, 0.20000],
        [0.17697, 0.81240, 0.01063],
        [0.00000, 0.01000, 0.99000],
    ]
) / 0.17697
_D50 = np.array([96.6797 / 100, 100.000 / 100, 82.5188 / 100])
_XYZ_M_D50 = _XYZ_M / _D50[:, None]
# the inverse LABToRGB uses: the reference's hand-rounded constants, not
# the exact inverse of _XYZ_M
_XYZ_INV = np.array(
    [
        [0.41847, -0.15866, -0.082835],
        [-0.091169, 0.25243, 0.015708],
        [0.00092090, -0.0025498, 0.17860],
    ]
)


def rgb_to_yuv(rgb: torch.Tensor) -> torch.Tensor:
    """RGB (0..255) -> YUV; y in 0..255, u and v signed."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = (
        r * (RED_MUL / LUMA_DIV)
        + g * (GREEN_MUL / LUMA_DIV)
        + b * (BLUE_MUL / LUMA_DIV)
    )
    u = (b - y) * 0.492
    v = (r - y) * 0.877
    return torch.stack([y, u, v], dim=-1)


# the luma weights as the float32 constants XLA multiplies by
_LUMA32 = [float(np.float32(m / LUMA_DIV)) for m in (RED_MUL, GREEN_MUL, BLUE_MUL)]


def rgb_to_yuv_ordered(rgb: torch.Tensor) -> torch.Tensor:
    """:func:`rgb_to_yuv` as the JAX package's CPU build computes it
    (``ops/ordered.py``): the luma as fma(b, 0.114, fma(r, 0.299,
    g * 0.587)). The same bits on the CPU and on CUDA."""
    rgb = rgb.float()
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    kr, kg, kb = _LUMA32
    y = fma_sum([(r, kr), (g, kg), (b, kb)])
    return torch.stack([y, (b - y) * 0.492, (r - y) * 0.877], dim=-1)


def yuv_to_rgb(yuv: torch.Tensor, clamp: bool = True) -> torch.Tensor:
    """YUV -> RGB floats (0..255 scale); with ``clamp``, rounded and
    clamped to bytes."""
    y, u, v = yuv[..., 0], yuv[..., 1], yuv[..., 2]
    r = y + v * 1.13983
    g = y - u * 0.39465 - v * 0.58060
    b = y + u * 2.03211
    rgb = torch.stack([r, g, b], dim=-1)
    if clamp:
        rgb = torch.clamp(torch.round(rgb), 0, 255)
    return rgb


def _srgb_to_linear(c):
    return torch.where(c > 0.04045, ((c + 0.055) / 1.055) ** 2.4, c / 12.92)


def _linear_to_srgb(c):
    return torch.where(c > 0.0031308, 1.055 * torch.clamp_min(c, 0.0) ** (1 / 2.4) - 0.055,
                       12.92 * c)


def rgb_to_lab(rgb: torch.Tensor) -> torch.Tensor:
    """RGB bytes (0..255 scale, float tensor) -> CIE L*a*b*."""
    c = rgb / 255.0
    lin = _srgb_to_linear(c)
    xyz = lin @ torch.as_tensor(_XYZ_M_D50.T, dtype=lin.dtype, device=lin.device)
    f = torch.where(xyz > 0.008856, torch.clamp_min(xyz, 1e-30) ** (1 / 3),
                    7.787 * xyz + 16 / 116)
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    L = 116 * fy - 16
    a = 500 * (fx - fy)
    b = 200 * (fy - fz)
    return torch.stack([L, a, b], dim=-1)


# the constants of the JAX package's compiled rgb_to_lab: its divisions
# by constants folded into products by float32 reciprocals
_INV_255 = float.fromhex("0x1.010102p-8")  # f32(1 / 255)
_INV_1055 = float.fromhex("0x1.e54edep-1")  # f32(1 / f32(1.055))
_INV_255_1292 = float.fromhex("0x1.3e4568p-12")  # f32(1 / 255 / 12.92)
_F16_116 = float(np.float32(16 / 116))


def _lab_f_ordered(rgb: torch.Tensor):
    """(fx, fy, fz) of :func:`rgb_to_lab_ordered`."""
    m = rgb * _INV_255
    lin = torch.where(m > 0.04045, powf((m + 0.055) * _INV_1055, 2.4), rgb * _INV_255_1292)
    M = torch.as_tensor(_XYZ_M_D50.T, dtype=torch.float32, device=rgb.device)
    l0, l1, l2 = lin[..., 0], lin[..., 1], lin[..., 2]
    xyz = torch.stack([(l0 * M[0, 0] + l1 * M[1, 0]) + l2 * M[2, 0],
                       (l0 * M[0, 1] + l1 * M[1, 1]) + l2 * M[2, 1],
                       fma32(l2, M[2, 2], fma32(l1, M[1, 2], l0 * M[0, 2]))], dim=-1)
    f = torch.where(xyz > 0.008856, powf(torch.clamp_min(xyz, 1e-30), 1 / 3),
                    fma32(xyz, float(np.float32(7.787)), _F16_116))
    return f[..., 0], f[..., 1], f[..., 2]


def rgb_to_lab_ordered(rgb: torch.Tensor) -> torch.Tensor:
    """:func:`rgb_to_lab` of byte-valued RGB, computed as the JAX
    package's CPU build computes it (``ops/ordered.py``): divisions by
    constants as products by their float32 reciprocals, glibc's powf,
    the XYZ product with its third column as an FMA chain and the other
    two summed in order, and the FMAs of ``7.787 x + 16/116`` and
    ``116 fy - 16``. The same bits on the CPU and on CUDA."""
    fx, fy, fz = _lab_f_ordered(rgb)
    return torch.stack([fma32(fy, 116.0, -16.0), (fx - fy) * 500, (fy - fz) * 200], dim=-1)


def tile_mean_lab_ordered(tiles_rgb: torch.Tensor) -> torch.Tensor:
    """The mean CIE L*a*b* of byte-valued tiles [..., 8, 8, 3] -> [..., 3],
    as the JAX package's compiled load computes it on the CPU: the LAB of
    :func:`rgb_to_lab_ordered` summed in eight lanes, one a tile row, each
    along its row (the a and b channels' products by 500 and 200 fused
    into the sum), the lanes then folded (``ops/ordered.fold_lanes``), times 1/64.
    The same bits on the CPU and on CUDA."""
    fx, fy, fz = _lab_f_ordered(tiles_rgb.float())
    L, da, db = fma32(fy, 116.0, -16.0), fx - fy, fy - fz
    sl, sa, sb = L[..., 0], da[..., 0] * 500, db[..., 0] * 200  # [..., 8 rows]
    for x in range(1, 8):
        sl = sl + L[..., x]
        sa = fma32(da[..., x], 500.0, sa)
        sb = fma32(db[..., x], 200.0, sb)
    return torch.stack([fold_lanes(sl), fold_lanes(sa), fold_lanes(sb)], dim=-1) * 0.015625


def lab_to_rgb(lab: torch.Tensor, clamp: bool = True) -> torch.Tensor:
    """CIE L*a*b* -> RGB (0..255 scale); with ``clamp``, rounded and
    clamped to bytes."""
    L, a, b = lab[..., 0], lab[..., 1], lab[..., 2]
    fy = (L + 16) / 116
    fx = a / 500 + fy
    fz = fy - b / 200
    f = torch.stack([fx, fy, fz], dim=-1)
    f3 = f * f * f
    xyz = torch.where(f3 > 0.008856, f3, (f - 16 / 116) / 7.787)
    xyz = xyz * torch.as_tensor(_D50, dtype=xyz.dtype, device=xyz.device)
    lin = xyz @ torch.as_tensor(_XYZ_INV.T, dtype=xyz.dtype, device=xyz.device)
    rgb = _linear_to_srgb(lin) * 255.0
    if clamp:
        rgb = torch.clamp(torch.round(rgb), 0, 255)
    return rgb


def luma(rgb):
    """Integer-scale luma r*299+g*587+b*114 (not divided)."""
    return rgb[..., 0] * RED_MUL + rgb[..., 1] * GREEN_MUL + rgb[..., 2] * BLUE_MUL


def _muldiv(a, b, c):
    """Windows MulDiv: round-half-away-from-zero of a*b/c (c > 0)."""
    num = a * b
    return np.sign(num) * ((np.abs(num) + c // 2) // c)


def rgb_to_hsv_bytes(rgb: np.ndarray) -> np.ndarray:
    """Integer HSV (h mod 252) used for the palette color sort; host numpy.

    rgb: integer array [..., 3] of bytes. Returns int64 [..., 3] (h, s, v).
    """
    rgb = rgb.astype(np.int64)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    mx = np.maximum(np.maximum(r, g), b)
    mn = np.minimum(np.minimum(r, g), b)
    delta = mx - mn
    nz = delta != 0
    safe_delta = np.where(nz, delta, 1)
    s = np.where(nz, _muldiv(delta, 255, np.where(mx == 0, 1, mx)), 0)
    h_r = _muldiv(42, g - b, safe_delta)
    h_g = _muldiv(42, b - r, safe_delta) + 84
    h_b = _muldiv(42, r - g, safe_delta) + 168
    h = np.where(r == mx, h_r, np.where(g == mx, h_g, h_b))
    # Pascal mod truncates toward zero (keeps the sign), then `and $ff`
    h = np.where(nz, np.fmod(h, 252).astype(np.int64) & 0xFF, 0)
    return np.stack([h, s, mx], axis=-1).astype(np.int64)


def posterize(v: np.ndarray, cvt: int) -> np.ndarray:
    """Posterize byte values; cvt=255 is the identity."""
    return np.round(np.round(v * cvt / 255.0) * 255.0 / cvt).astype(v.dtype)
