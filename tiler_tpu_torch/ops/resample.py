"""On-device Lanczos resampling and planar (YUV) ingest conversion.

Counterpart of ``tiler_tpu/ops/resample.py``. The reference resamples on
the host; a device-first ingest ships SOURCE-resolution pixels to the
device and resamples there: a separable Lanczos-3 resize is two small
dense matrix products per frame.

Semantics: the host path's order (io/video.py), so ``device_resample``
only moves WHERE the work runs:
  y4m C420:   nearest chroma upsample -> BT.601 full-range YUV->RGB
              -> round/clip uint8  (bit-identical math to load_y4m)
  scaling!=1: Lanczos-3 resize of the uint8 RGB -> round/clip uint8.
The filter differs from the host's PIL Lanczos only in implementation
detail (PIL quantizes its coefficients to fixed point and rounds the
intermediate pass to uint8; fp32 is kept between the passes here). The
products run in full fp32 (``tiler_tpu_torch/__init__.py`` turns TF32
off); against the JAX function they differ by summation order only.
"""
from __future__ import annotations

import numpy as np
import torch

TILE_W = 8


def lanczos_matrix(n_in: int, n_out: int, a: int = 3) -> np.ndarray:
    """Dense [n_out, n_in] row-normalized Lanczos-a resampling matrix with
    PIL/sws-style center alignment: out pixel i samples input coordinate
    (i + 0.5) * n_in / n_out. For downscale the kernel widens by the
    scale factor (anti-aliasing), matching PIL's convention."""
    scale = n_in / n_out
    fscale = max(scale, 1.0)
    centers = (np.arange(n_out, dtype=np.float64) + 0.5) * scale
    # window of contributing input pixels per output pixel
    j = np.arange(n_in, dtype=np.float64)
    x = (j[None, :] + 0.5 - centers[:, None]) / fscale  # [n_out, n_in]
    with np.errstate(divide="ignore", invalid="ignore"):
        w = np.sinc(x) * np.sinc(x / a)
    w[np.abs(x) >= a] = 0.0
    # out-of-range taps clamp to the edge in PIL; with a dense matrix the
    # same effect comes from renormalizing each row over in-range taps
    rs = w.sum(axis=1, keepdims=True)
    rs[rs == 0] = 1.0
    return (w / rs).astype(np.float32)


def _pad_to_tiles(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Zero-pad [B, out_h, out_w, 3] to tile multiples (pad_frame parity)."""
    ph = -(-out_h // TILE_W) * TILE_W
    pw = -(-out_w // TILE_W) * TILE_W
    return torch.nn.functional.pad(x, (0, 0, 0, pw - out_w, 0, ph - out_h))


def resize_rgb(frames_u8: torch.Tensor, lh: torch.Tensor, lw: torch.Tensor, *,
               out_h: int, out_w: int) -> torch.Tensor:
    """uint8 [B, h, w, 3] -> uint8 [B, Hp, Wp, 3]: Lanczos resize to
    (out_h, out_w) with the matrices lh [out_h, h] and lw [out_w, w], then
    zero-pad to tile multiples. Vertical then horizontal pass, fp32 end to
    end, round half to even."""
    B, h, w, _ = frames_u8.shape
    x = frames_u8.float()
    x = (lh @ x.reshape(B, h, w * 3)).reshape(B, out_h, w, 3)
    x = lw @ x  # [out_w, w] @ [B, out_h, w, 3]
    x = x.round().clamp(0, 255).to(torch.uint8)
    return _pad_to_tiles(x, out_h, out_w)


def planar_to_rgb(y, u, v, lh, lw, *, out_h: int, out_w: int, resize: bool):
    """Y [B, h, w] + U/V [B, hc, wc] uint8 -> uint8 RGB [B, Hp, Wp, 3].

    Exactly the host y4m path's math (io/video.py load_y4m): nearest
    chroma upsample, BT.601 full-range, round/clip to uint8 — then the
    optional resize. Each product and sum is an fp32 pass of its own (no
    fused multiply-add), so at scaling=1 the result is bit-identical to
    the host path."""
    h, w = y.shape[1:]
    yf = y.float()
    uf = u.float() - 128.0
    vf = v.float() - 128.0
    if u.shape[1] != h or u.shape[2] != w:  # nearest upsample (host parity)
        ry, rx = h // u.shape[1], w // u.shape[2]
        uf = uf.repeat_interleave(ry, dim=1).repeat_interleave(rx, dim=2)
        vf = vf.repeat_interleave(ry, dim=1).repeat_interleave(rx, dim=2)
    r = yf + 1.13983 * vf
    g = yf - 0.39465 * uf - 0.58060 * vf
    b = yf + 2.03211 * uf
    rgb = torch.stack([r, g, b], dim=-1).round().clamp(0, 255).to(torch.uint8)
    if resize:
        return resize_rgb(rgb, lh, lw, out_h=out_h, out_w=out_w)
    return _pad_to_tiles(rgb, out_h, out_w)
