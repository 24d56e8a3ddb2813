"""The reference for the EPU re-rank (reconstruct's cartesian re-rank of
each cell's candidate (tile, palette) pairs) on the timed encode's own
inputs.

For a cell with weighted-DCT features f [192] in (c, v, u) order, a
candidate tile i (its palette-index pixels) and a candidate palette j (its
S colours), the re-rank's error is the norm expansion of the pair

    e(i, j) = sum_{vu, c} w[vu, c]^2 M[vu, c]^2 - 2 sum_{vu, c} M[vu, c] ft[vu, c]

with M = G_i @ Y_j, G_i[vu, s] the DCT of the indicator of colour s in
tile i, Y_j the palette's YUV colours, w the PSNR-HVS weights and ft = f w.
That is |rf - f|^2 - |f|^2 with rf the pair's rendered features, so its
least value is the best pair. The program ranks in the precision its
design states: G built from the DCT basis in bfloat16 and rounded to
bfloat16, ft rounded to bfloat16, float32 sums. Here G, Y and ft are
worked out again from the tiles' palette indices, the palettes' RGB and
the cell features in that precision, and the errors summed in float64.
Each of the program's picks is measured against the best pair:

    gap = max over cells of (e[pick] - e_min) / (a[pick] + a[best])

where a is a pair's sum of absolute terms, the scale of its rounding. A
pick that is not among the cell's candidate pairs reads 1.
"""
from __future__ import annotations

import numpy as np
import torch

from .psnr_hvs import DCT, WEIGHTS


def _basis(device) -> torch.Tensor:
    """[64 (y, x), 64 (v, u)]: D[v, y] D[u, x] in bfloat16, as float64."""
    b = np.einsum("vy,ux->yxvu", DCT, DCT).reshape(64, 64)
    return torch.as_tensor(b, dtype=torch.float64, device=device).to(torch.bfloat16).double()


def _weights(device) -> torch.Tensor:
    """[64 (v, u), 3] float32 weights, as float64."""
    w = torch.as_tensor(WEIGHTS, dtype=torch.float32, device=device)
    return w.permute(1, 2, 0).reshape(64, 3).double()


def indicator_dcts(pal_pixels: torch.Tensor, S: int) -> torch.Tensor:
    """G [n, 64 (v, u), S] of tiles' palette indices [n, 64], in bfloat16
    (as float64): the sums of bfloat16 basis values are exact in float64
    and in float32 alike."""
    oh = torch.nn.functional.one_hot(pal_pixels.long(), S).double()  # [n, 64 yx, S]
    g = oh.transpose(1, 2) @ _basis(pal_pixels.device)  # [n, S, 64 vu]
    return g.to(torch.bfloat16).double().transpose(1, 2)


def yuv(rgb: torch.Tensor) -> torch.Tensor:
    """RGB -> YUV in float64 (Rec. 601 luma; u = (b - y) 0.492, v = (r - y) 0.877)."""
    rgb = rgb.double()
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = r * 0.299 + g * 0.587 + b * 0.114
    return torch.stack([y, (b - y) * 0.492, (r - y) * 0.877], -1)


def gap(feats, cand_tiles, cand_pals, tile, pal, pal_pixels, palettes,
        cells_at_once: int = 8) -> float:
    """The widest normalized gap of the picks (tile, pal) [n] of cells with
    features feats [n, 192] float32 among their candidates cand_tiles
    [n, kk] and cand_pals [n, kp], given the corpus's palette indices
    pal_pixels [T, 8, 8] and the palettes' RGB palettes [P, S, 3]."""
    dev = feats.device
    n, kk = cand_tiles.shape
    kp = cand_pals.shape[1]
    S = palettes.shape[1]
    w = _weights(dev)
    w2 = w * w
    wf32 = w.float()
    Y = yuv(torch.as_tensor(palettes, device=dev))
    pp = torch.as_tensor(pal_pixels, device=dev).reshape(-1, 64)
    worst = 0.0
    for c0 in range(0, n, cells_at_once):
        f = feats[c0:c0 + cells_at_once].float()
        b = f.shape[0]
        ci = cand_tiles[c0:c0 + b].long()
        cp = cand_pals[c0:c0 + b].long()
        G = indicator_dcts(pp[ci.reshape(-1)], S).reshape(b, kk * 64, S)
        Py = Y[cp].permute(0, 2, 1, 3).reshape(b, S, kp * 3)  # [b, S, (j, c)]
        ft = (f.reshape(b, 3, 64).transpose(1, 2) * wf32).to(torch.bfloat16).double()
        M = (G @ Py).reshape(b, kk, 64, kp, 3)
        A = (G.abs() @ Py.abs()).reshape(b, kk, 64, kp, 3)
        ftx = ft[:, None, :, None, :]
        w2x = w2[None, None, :, None, :]
        e = (w2x * M * M - 2.0 * M * ftx).sum(dim=(2, 4))  # [b, kk, kp]
        a = (w2x * A * A + 2.0 * A * ftx.abs()).sum(dim=(2, 4))
        e, a = e.reshape(b, -1), a.reshape(b, -1)
        best = e.argmin(dim=1, keepdim=True)
        hit = ((ci[:, :, None] == tile[c0:c0 + b, None, None].long())
               & (cp[:, None, :] == pal[c0:c0 + b, None, None].long())).reshape(b, -1)
        rel = (e - e.gather(1, best)) / (a + a.gather(1, best))
        rel = torch.where(hit, rel, torch.inf).min(dim=1).values
        worst = max(worst, float(torch.where(torch.isinf(rel), 1.0, rel).max()))
    return worst
