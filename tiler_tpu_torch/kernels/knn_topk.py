"""Corpus top-k for the phase-A KNN: the CUDA bucket top-2 kernels, their
plain PyTorch versions, and the folding and merge around them.

B2 replaces the Pallas TPU kernel ``tiler_tpu/kernels/knn_topk.py::
knn_bucket_topk2`` (the call at :149, body ``_kernel2`` :73-99, prep
``knn_prep2`` :109-123, ``_split_bf16`` :102-106); v1 replaces
``knn_bucket_topk`` (the call at :204, body ``_kernel`` :47-67,
``_sortable`` :41-44), selected by ``knn_backend="pallas_v1"``. Both are
one template in ``csrc/knn_topk.cu`` (bf16 ``wgmma`` on the tensor cores,
TMA-fed, 256 cells a block), whose header says what bounds them on the
card and how the design answers that.

The folded bf16 operands make one product carry the whole squared
distance (see :func:`knn_prep2` and :func:`fold_cells`); per cell and
512-tile bucket the kernel keeps the smallest and second-smallest key
``(f32 bits of max(d, 0) & ~0x1FF) | lane``, and :func:`knn_bucket_topk2`
merges the 2 * nb keys of each cell into its top-k with a stable sort,
which reproduces ``lax.top_k(-keys)``'s lowest-index-first ties.

v1 multiplies the plain bf16 features by the transposed corpus and ranks
on ``d = |ds|^2 - 2 <f, ds>`` in f32 (no ``|f|^2``, so ``d`` is often
negative); its key is ``(sortable(f32 bits of d) & ~0x1FF) | lane``,
compared signed (:func:`sortable`).

:func:`knn_bucket_top2` and :func:`knn_bucket_top2_v1` dispatch on the
device of their inputs: CPU tensors go to the plain version, CUDA tensors
to the kernel. There is no fallback from one to the other.
"""
from __future__ import annotations

import torch

from . import _build

TB = 512  # corpus tiles per bucket (recall and tie order depend on it)
KD = 192  # feature dims
KDA = 208  # folded depth: 192 features + 4 fold terms + zero pad
CELL_BLOCK = 256  # cells per kernel block (the wrapper pads to it)
TP_ALIGN = 4096  # corpus padding granularity, as in the JAX package
INT_MAX = 2**31 - 1


def split_bf16(x: torch.Tensor):
    """Two-limb bf16 split: hi + lo == x to ~16 mantissa bits."""
    hi = x.to(torch.bfloat16)
    lo = (x - hi.float()).to(torch.bfloat16)
    return hi, lo


def knn_prep2(ds: torch.Tensor, Tp: int) -> torch.Tensor:
    """Once-per-encode corpus operand [KDA, Tp] bf16: rows ds^T, 1, 1,
    |ds|^2 hi, |ds|^2 lo, zeros. Padded corpus columns carry |ds|^2 = 1e30
    so they rank last."""
    T = ds.shape[0]
    dsp = torch.nn.functional.pad(ds.float(), (0, 0, 0, Tp - T))
    pad = torch.where(torch.arange(Tp, device=ds.device) < T, 0.0, 1e30)
    hi, lo = split_bf16((dsp * dsp).sum(dim=1) + pad)
    one = torch.ones(1, Tp, dtype=torch.bfloat16, device=ds.device)
    return torch.cat([
        dsp.to(torch.bfloat16).T, one, one, hi[None], lo[None],
        torch.zeros(KDA - KD - 4, Tp, dtype=torch.bfloat16, device=ds.device),
    ]).contiguous()


def fold_cells(feats: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Cell operand [n_rows, KDA] bf16: rows [-2f, |f|^2 hi, |f|^2 lo, 1,
    1, zeros], zero rows past the N real cells."""
    N = feats.shape[0]
    f32 = feats.float()
    hi, lo = split_bf16((f32 * f32).sum(dim=1))
    one = torch.ones(N, 1, dtype=torch.bfloat16, device=feats.device)
    fa = torch.cat([
        (-2.0 * f32).to(torch.bfloat16), hi[:, None], lo[:, None], one, one,
        torch.zeros(N, KDA - KD - 4, dtype=torch.bfloat16, device=feats.device),
    ], dim=1)
    return torch.nn.functional.pad(fa, (0, 0, 0, n_rows - N)).contiguous()


def knn_bucket_top2_plain(fa: torch.Tensor, dsTa: torch.Tensor,
                          cell_chunk: int = 2048):
    """Plain PyTorch version of the kernel: fa [Np, KDA] bf16, dsTa [KDA,
    Tp] bf16 -> (k1, k2) int32 [nb, Np]. The fp32 product of bf16 values
    is exact, as in the kernel; only the summation order differs."""
    Np, Tp = fa.shape[0], dsTa.shape[1]
    nb = Tp // TB
    dsf = dsTa.float()
    lane = torch.arange(TB, dtype=torch.int32, device=fa.device)
    k1 = torch.empty(nb, Np, dtype=torch.int32, device=fa.device)
    k2 = torch.empty_like(k1)
    for c0 in range(0, Np, cell_chunk):
        d = torch.clamp_min(fa[c0:c0 + cell_chunk].float() @ dsf, 0.0)
        key = (d.view(torch.int32).reshape(-1, nb, TB) & ~0x1FF) | lane
        m1 = key.min(dim=-1).values
        m2 = torch.where(key == m1[..., None], INT_MAX, key).min(dim=-1).values
        k1[:, c0:c0 + cell_chunk] = m1.T
        k2[:, c0:c0 + cell_chunk] = m2.T
    return k1, k2


def _check(fa, dsTa):
    if fa.device != dsTa.device:
        raise ValueError(f"knn_bucket_top2: fa on {fa.device}, dsTa on {dsTa.device}")
    for name, t in (("fa", fa), ("dsTa", dsTa)):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"knn_bucket_top2: {name} must be bfloat16, got {t.dtype}")
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"knn_bucket_top2: {name} must be a contiguous matrix")
    if fa.shape[1] != KDA or dsTa.shape[0] != KDA:
        raise ValueError(f"knn_bucket_top2: depth must be {KDA}, got "
                         f"{fa.shape[1]} and {dsTa.shape[0]}")
    if fa.shape[0] % CELL_BLOCK or dsTa.shape[1] % TB:
        raise ValueError(f"knn_bucket_top2: {fa.shape[0]} cells must be a "
                         f"multiple of {CELL_BLOCK}, {dsTa.shape[1]} tiles of {TB}")


def knn_bucket_top2(fa: torch.Tensor, dsTa: torch.Tensor):
    """Per-bucket (min, second-min) packed keys; see
    :func:`knn_bucket_top2_plain`. CPU tensors run the plain version,
    CUDA tensors the kernel."""
    if fa.device.type not in ("cpu", "cuda"):
        raise ValueError(f"knn_bucket_top2: no kernel for device {fa.device}")
    _check(fa, dsTa)
    if fa.device.type == "cpu":
        return knn_bucket_top2_plain(fa, dsTa)
    Np, Tp = fa.shape[0], dsTa.shape[1]
    k1 = torch.empty(Tp // TB, Np, dtype=torch.int32, device=fa.device)
    k2 = torch.empty_like(k1)
    lib = _build.lib()
    code = lib.knn_bucket_top2_launch(
        fa.data_ptr(), dsTa.data_ptr(), k1.data_ptr(), k2.data_ptr(), Np, Tp,
        _build.stream_ptr(fa.device))
    _build.check(code, "knn_bucket_top2_launch")
    knn_bucket_top2.launches += 1
    return k1, k2


knn_bucket_top2.launches = 0


def _merge_topk(k1: torch.Tensor, k2: torch.Tensor, N: int, k: int):
    """The k smallest of each cell's 2 * nb bucket keys, ties to the lower
    position (as ``lax.top_k(-keys)``) -> (idx [N, k] int32 corpus index,
    key [N, k] int32)."""
    nb = k1.shape[0]
    keys = torch.cat([k1, k2], dim=0).T[:N]  # [N, 2 nb]
    base = torch.arange(nb, dtype=torch.int32, device=k1.device) * TB
    bases = torch.cat([base, base])
    if k == 1:
        sel = torch.argmin(keys, dim=1, keepdim=True)
    else:
        sel = torch.sort(keys, dim=1, stable=True).indices[:, :k]
    key = keys.gather(1, sel)
    return bases[sel] + (key & 0x1FF), key


def knn_bucket_topk2(feats: torch.Tensor, dsTa: torch.Tensor, k: int):
    """feats [N, 192] f32, dsTa from :func:`knn_prep2` -> (idx [N, k]
    int32, err [N, k] f32 ascending true squared distance with a 15-bit
    ranking mantissa)."""
    N = feats.shape[0]
    Np = -(-N // CELL_BLOCK) * CELL_BLOCK
    k1, k2 = knn_bucket_top2(fold_cells(feats, Np), dsTa)
    idx, key = _merge_topk(k1, k2, N, k)
    return idx, (key & ~0x1FF).view(torch.float32)


# --- v1: plain features, |ds|^2 - 2 <f, ds> ranked on sortable keys -------

def sortable(u: torch.Tensor) -> torch.Tensor:
    """Monotone int32 image of float32 bits: ascending under a signed
    compare == ascending as floats; its own inverse."""
    return u ^ ((u >> 31) & 0x7FFFFFFF)


def knn_prep_v1(ds: torch.Tensor, Tp: int):
    """Once-per-encode corpus operands of v1: dsT [KD, Tp] bf16, the
    transposed corpus, and d2 [Tp] f32 = |ds|^2 with 1e30 on the padded
    columns so they rank last."""
    T = ds.shape[0]
    dsp = torch.nn.functional.pad(ds.float(), (0, 0, 0, Tp - T))
    d2 = (dsp * dsp).sum(dim=1) + torch.where(
        torch.arange(Tp, device=ds.device) < T, 0.0, 1e30)
    return dsp.to(torch.bfloat16).T.contiguous(), d2


def knn_bucket_top2_v1_plain(fb: torch.Tensor, dsT: torch.Tensor, d2: torch.Tensor,
                             cell_chunk: int = 2048):
    """Plain PyTorch version of the v1 kernel: fb [Np, KD] bf16, dsT [KD,
    Tp] bf16, d2 [Tp] f32 -> (k1, k2) int32 [nb, Np], the smallest and
    second-smallest key of each cell and 512-tile bucket. The products of
    bf16 values are exact in f32, as in the kernel; only the summation
    order differs."""
    Np, Tp = fb.shape[0], dsT.shape[1]
    nb = Tp // TB
    dsf = dsT.float()
    lane = torch.arange(TB, dtype=torch.int32, device=fb.device)
    k1 = torch.empty(nb, Np, dtype=torch.int32, device=fb.device)
    k2 = torch.empty_like(k1)
    for c0 in range(0, Np, cell_chunk):
        d = d2 - 2.0 * (fb[c0:c0 + cell_chunk].float() @ dsf)
        key = (sortable(d.view(torch.int32)).reshape(-1, nb, TB) & ~0x1FF) | lane
        m1 = key.min(dim=-1).values
        m2 = torch.where(key == m1[..., None], INT_MAX, key).min(dim=-1).values
        k1[:, c0:c0 + cell_chunk] = m1.T
        k2[:, c0:c0 + cell_chunk] = m2.T
    return k1, k2


def _check_v1(fb, dsT, d2):
    if fb.device.type not in ("cpu", "cuda"):
        raise ValueError(f"knn_bucket_top2_v1: no kernel for device {fb.device}")
    if not fb.device == dsT.device == d2.device:
        raise ValueError(f"knn_bucket_top2_v1: fb on {fb.device}, dsT on "
                         f"{dsT.device}, d2 on {d2.device}")
    for name, t, dtype, dim in (("fb", fb, torch.bfloat16, 2),
                                ("dsT", dsT, torch.bfloat16, 2),
                                ("d2", d2, torch.float32, 1)):
        if t.dtype != dtype:
            raise ValueError(f"knn_bucket_top2_v1: {name} must be {dtype}, got {t.dtype}")
        if t.dim() != dim or not t.is_contiguous():
            raise ValueError(f"knn_bucket_top2_v1: {name} must be a contiguous "
                             f"{dim}-d tensor")
    if fb.shape[1] != KD or dsT.shape[0] != KD:
        raise ValueError(f"knn_bucket_top2_v1: depth must be {KD}, got "
                         f"{fb.shape[1]} and {dsT.shape[0]}")
    if d2.shape[0] != dsT.shape[1]:
        raise ValueError(f"knn_bucket_top2_v1: d2 has {d2.shape[0]} entries "
                         f"for {dsT.shape[1]} tiles")
    if fb.shape[0] % CELL_BLOCK or dsT.shape[1] % TB:
        raise ValueError(f"knn_bucket_top2_v1: {fb.shape[0]} cells must be a "
                         f"multiple of {CELL_BLOCK}, {dsT.shape[1]} tiles of {TB}")


def knn_bucket_top2_v1(fb: torch.Tensor, dsT: torch.Tensor, d2: torch.Tensor):
    """Per-bucket (min, second-min) sortable keys; see
    :func:`knn_bucket_top2_v1_plain`. CPU tensors run the plain version,
    CUDA tensors the kernel."""
    _check_v1(fb, dsT, d2)
    if fb.device.type == "cpu":
        return knn_bucket_top2_v1_plain(fb, dsT, d2)
    Np, Tp = fb.shape[0], dsT.shape[1]
    k1 = torch.empty(Tp // TB, Np, dtype=torch.int32, device=fb.device)
    k2 = torch.empty_like(k1)
    code = _build.lib().knn_bucket_top2_v1_launch(
        fb.data_ptr(), dsT.data_ptr(), d2.data_ptr(), k1.data_ptr(), k2.data_ptr(),
        Np, Tp, _build.stream_ptr(fb.device))
    _build.check(code, "knn_bucket_top2_v1_launch")
    knn_bucket_top2_v1.launches += 1
    return k1, k2


knn_bucket_top2_v1.launches = 0


def knn_bucket_topk(feats: torch.Tensor, dsT: torch.Tensor, d2: torch.Tensor, k: int):
    """v1 entry: feats [N, 192] f32 or bf16, (dsT, d2) from
    :func:`knn_prep_v1` -> (idx [N, k] int32, err [N, k] f32 ascending
    ``|ds|^2 - 2 <f, ds>`` with a 14-bit ranking mantissa; no ``|f|^2``)."""
    N = feats.shape[0]
    if not 1 <= k <= 2 * (dsT.shape[1] // TB):
        raise ValueError(f"knn_bucket_topk: k={k} outside [1, 2 * buckets]")
    Np = -(-N // CELL_BLOCK) * CELL_BLOCK
    fb = torch.nn.functional.pad(feats.to(torch.bfloat16), (0, 0, 0, Np - N))
    k1, k2 = knn_bucket_top2_v1(fb, dsT, d2)
    idx, key = _merge_topk(k1, k2, N, k)
    return idx, sortable(key & ~0x1FF).view(torch.float32)
