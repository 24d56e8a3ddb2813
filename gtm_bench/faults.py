"""Faults planted under the timed path, to show that ``correct`` catches
them (``test_gtm_bench_faults.py``) and to read the numbers they give
(``control.py``). Each is a context manager that patches the program and
restores it on exit.

- ``state_unchanged``: reconstruct returns without touching the state.
- ``half_left_out``: reconstruct's work is kept for the first half of the
  frames only; the other half keep tile 0 through palette 0.
- ``token_altered``: the save step writes one cell of the middle frame with
  another tile than the state holds.
- ``slot_altered``: one pixel of the dither kernel's answer is moved to
  another palette slot.

The controls (``CONTROLS``) put a lower precision in the program's place,
the step that would tempt a later change:

- ``tk_bfloat16``: the dither kernel's answer is the reference's Thomas
  Knoll computed in bfloat16, not the kernel's exact integers.
- ``knn_fp8``: the top-k kernel's keys come from its operands taken
  through fp8 (e4m3), not bfloat16 (on a card: the kernel runs there only).
- ``epu_tf32``: the program with TF32 on for float32 matmuls (cuBLAS and
  cuDNN), which it runs with TF32 off; the EPU re-rank's float32 sums are
  the most of them (on a card: the CPU has no TF32).
- ``epu_bfloat16``: the EPU re-rank's pair errors from bfloat16 operands
  (on the CPU too: the re-rank then takes the card's path at every
  palette size).
"""
from __future__ import annotations

import contextlib
import copy


@contextlib.contextmanager
def _patched(obj, name, make):
    orig = getattr(obj, name)
    setattr(obj, name, make(orig))
    try:
        yield
    finally:
        setattr(obj, name, orig)


def state_unchanged():
    from tiler_tpu_torch.pipeline.encoder import Encoder

    return _patched(Encoder, "reconstruct", lambda orig: lambda self: self)


def half_left_out():
    from tiler_tpu_torch.pipeline.encoder import Encoder

    def make(orig):
        def reconstruct(self):
            orig(self)
            tm = self.state.tilemap
            half = tm.tile_idx.shape[0] // 2
            for name in ("tile_idx", "pal_idx", "pred_x", "pred_y", "predicted"):
                getattr(tm, name)[half:] = 0
            return self
        return reconstruct

    return _patched(Encoder, "reconstruct", make)


def token_altered():
    from tiler_tpu_torch.pipeline import save as save_mod

    def make(orig):
        def save(state, settings, path):
            state = copy.copy(state)
            tm = state.tilemap = copy.deepcopy(state.tilemap)
            f = tm.tile_idx.shape[0] // 2
            c = tm.tile_idx.shape[1] // 2
            tm.predicted[f, c] = False
            tm.tile_idx[f, c] = (max(0, tm.tile_idx[f, c]) + 1) % len(state.corpus_pal_pixels)
            return orig(state, settings, path)
        return save

    return _patched(save_mod, "save", make)


def slot_altered():
    from tiler_tpu_torch.pipeline import dither

    def make(orig):
        def tk_select(pix, mirror, pal_idx, table):
            out = orig(pix, mirror, pal_idx, table)
            out[len(out) // 2, 0] = (int(out[len(out) // 2, 0]) + 1) % table.shape[1]
            return out
        return tk_select

    return _patched(dither, "tk_select", make)


FAULTS = {"state_unchanged": state_unchanged, "half_left_out": half_left_out,
          "token_altered": token_altered, "slot_altered": slot_altered}


def tk_bfloat16():
    import torch

    from gtm_bench.reference import tk
    from tiler_tpu_torch.pipeline import dither

    return _patched(dither, "tk_select", lambda orig: lambda pix, mirror, pal_idx, table: (
        tk.select(pix, mirror, pal_idx, table, dtype=torch.bfloat16)))


def knn_fp8():
    from gtm_bench.reference import knn
    from tiler_tpu_torch.kernels import knn_topk

    def make(orig):
        def knn_bucket_top2(fa, dsTa):
            knn_bucket_top2.launches += 1
            return knn.keys_in(fa, dsTa)
        knn_bucket_top2.launches = getattr(orig, "launches", 0)
        return knn_bucket_top2

    return _patched(knn_topk, "knn_bucket_top2", make)


@contextlib.contextmanager
def epu_tf32():
    import torch

    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@contextlib.contextmanager
def epu_bfloat16():
    import torch

    from tiler_tpu_torch.pipeline import reconstruct

    def pair_err(Gi, Qi, ftw, Py, Rj):
        b, S = Gi.shape[0], Gi.shape[3]
        bf = torch.bfloat16
        C = torch.bmm(Gi.transpose(2, 3).reshape(b, -1, Gi.shape[2]).to(bf), ftw.to(bf))
        C = C.reshape(b, Gi.shape[1], S * 3)
        err = (torch.bmm(Qi.to(bf), Rj.to(bf).transpose(1, 2)).float()
               - 2.0 * torch.bmm(C, Py.reshape(b, -1, S * 3).to(bf).transpose(1, 2)).float())
        return err.reshape(b, -1)

    with _patched(reconstruct, "_pair_err", lambda orig: pair_err), \
            _patched(reconstruct, "_epu_ordered", lambda orig: lambda S, dev: False):
        yield


CONTROLS = {"tk_bfloat16": tk_bfloat16, "knn_fp8": knn_fp8, "epu_tf32": epu_tf32,
            "epu_bfloat16": epu_bfloat16}
CPU_CONTROLS = ("tk_bfloat16", "epu_bfloat16")
