"""PSNR-HVS, the codec's own quality measure, in plain PyTorch float64.

Per 8x8 cell: RGB to YUV (Rec. 601 luma 299/587/114 thousandths,
u = (b - y) * 0.492, v = (r - y) * 0.877), the 2-D DCT of each channel
(D[u, x] = q[u] cos((x + 1/2) u pi / 8), q = (sqrt(1/2), 1, ..., 1)),
each coefficient weighted by the daala PSNR-HVS table of its channel, and
the squared distance between the two cells' 192 weighted coefficients:
err. A cell's PSNR-HVS is 10 log10(255^2 / max(0.5, err / 192)); a clip's
is the mean over every cell of every frame. This is the arithmetic of
``EuclideanToPSNR`` and the weighted DCT of gligli/tiler (utils.pas
72-112 and 1006-1078), rewritten from the JAX package's definition
(ops/dct.py, ops/metrics.py), which it does not import.
"""
from __future__ import annotations

import math

import numpy as np
import torch

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


def _symmetric(tri) -> np.ndarray:
    """The 8x8 symmetric matrix whose upper triangle, row by row, is tri."""
    m = np.zeros((8, 8))
    m[np.triu_indices(8)] = tri
    return m + np.triu(m, 1).T


WEIGHTS = np.stack([_symmetric(w) for w in (_W_Y, _W_U, _W_V)])  # [3, v, u]
_Q = np.where(np.arange(8) == 0, math.sqrt(0.5), 1.0)
DCT = _Q[:, None] * np.cos((np.arange(8)[None, :] + 0.5) * np.arange(8)[:, None] * math.pi / 8)


def cell_errors(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared weighted-DCT distance of every 8x8 cell of two frame stacks
    [F, H, W, 3] (uint8, any device) -> [F, H/8 * W/8] float64."""
    F, H, W, _ = a.shape
    d = a.double() - b.double()  # the transform is linear
    y = d[..., 0] * 0.299 + d[..., 1] * 0.587 + d[..., 2] * 0.114
    yuv = torch.stack([y, (d[..., 2] - y) * 0.492, (d[..., 0] - y) * 0.877], 1)
    cells = yuv.reshape(F, 3, H // 8, 8, W // 8, 8).permute(0, 2, 4, 1, 3, 5)
    D = torch.as_tensor(DCT, dtype=torch.float64, device=a.device)
    z = D @ cells @ D.T  # [F, th, tw, 3, v, u]
    z = z * torch.as_tensor(WEIGHTS, dtype=torch.float64, device=a.device)
    return (z * z).sum(dim=(-3, -2, -1)).reshape(F, -1)


def per_cell_mse(a: torch.Tensor, b: torch.Tensor, frames_at_once: int = 4) -> torch.Tensor:
    """max(0.5, err / 192) of every cell, [F, cells] float64, frames in blocks."""
    out = [torch.clamp_min(cell_errors(a[i:i + frames_at_once], b[i:i + frames_at_once]) / 192.0, 0.5)
           for i in range(0, a.shape[0], frames_at_once)]
    return torch.cat(out)


def psnr_hvs(mse: torch.Tensor) -> float:
    """Mean PSNR-HVS in dB over the cells of :func:`per_cell_mse`."""
    return float((10.0 * torch.log10(255.0 * 255.0 / mse)).mean())
