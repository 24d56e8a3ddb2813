"""Yliluoma2 on the CPU: the benchmark's plain reference
(gtm_bench/reference/yliluoma2.py) against the yl2_select wrapper's CPU
path and pipeline/dither.yliluoma2_select; a numpy model of the CUDA
kernel's integer design (csrc/yl2_dither.cu) against the plain passes,
with the header's int32 ranges reached at their ends; and the dither
step's route and counters."""
import copy

import numpy as np
import pytest
import torch

from gtm_bench.reference import yliluoma2 as ref
from tiler_tpu_torch.config import EncoderSettings
from tiler_tpu_torch.kernels import tk_dither as t_tk
from tiler_tpu_torch.kernels import yl2_dither as t_yl
from tiler_tpu_torch.pipeline import dither as t_dither

LUMA = np.array([299, 587, 114])


def _case(S, seed, T=3, P=3):
    """Random tiles; palette 0 random with about a fifth of its slots
    invalid and a third holding colors of one luma, palette 1 with no
    valid slot, palette 2 random and full."""
    rng = np.random.default_rng(seed)
    pal = rng.integers(0, 256, (P, S, 3))
    # luma-neutral moves from grey 128: colors of equal luma
    moves = np.array([[0, 0, 0], [2, -1, 0], [-2, 1, 0], [4, -2, -1], [-4, 2, 1],
                      [6, -3, -1], [-6, 3, 1], [1, 0, -3], [-1, 0, 3]])
    moves = moves[(LUMA * moves).sum(1) == 0]
    same = 128 + moves[rng.integers(0, len(moves), S)] * rng.integers(1, 10, (S, 1))
    pick = rng.random(S) < 1 / 3
    pal[0][pick] = same[pick]
    valid = rng.random((P, S)) < 0.8
    valid[0, rng.integers(S)] = True
    valid[1] = False
    valid[2] = True
    pidx = np.arange(T) % P
    return (torch.as_tensor(rng.integers(0, 256, (T, 64, 3), dtype=np.uint8)),
            torch.as_tensor(rng.integers(0, 4, T, dtype=np.uint8)),
            torch.as_tensor(pidx.astype(np.int32)), torch.as_tensor(pal.astype(np.int32)),
            torch.as_tensor(valid))


@pytest.mark.parametrize("mixed", [1, 4, 16])
@pytest.mark.parametrize("S", [1, 2, 16, 33, 256])
def test_reference_equals_the_wrapper_and_the_plain_passes(S, mixed):
    pix, mirror, pidx, pal, valid = _case(S, 10 * S + mixed)
    want = ref.select(pix, mirror, pidx, pal, valid, mixed)
    got, trials = t_yl.yl2_select(pix, mirror, pidx, t_yl.pal4_table(pal), valid, mixed)
    assert torch.equal(got, want)
    T = len(pix)
    assert torch.equal(t_dither.yliluoma2_select(pix.reshape(T, 8, 8, 3), mirror, pidx, pal,
                                                 valid, mixed).reshape(T, 64), want)
    assert int(trials) == _model(pix, mirror, pidx, pal, valid, mixed)[1]
    assert (got[pidx == 1] == 0).all()  # no valid color: slot 0


def test_reference_in_bfloat16_is_not_the_reference():
    """The control's precision moves slots: the reference in bfloat16
    differs from the exact one on random tiles."""
    pix, mirror, pidx, pal, valid = _case(256, 3, T=2)
    exact = ref.select(pix, mirror, pidx, pal, valid, 4)
    assert (ref.select(pix, mirror, pidx, pal, valid, 4, torch.bfloat16) != exact).any()


def _model(pix, mirror, pidx, pal_rgb, valid, mixed, seen=None):
    """The kernel's design in numpy int32/uint32 (csrc/yl2_dither.cu,
    points 1-7): valid colors compacted in slot order and padded to groups
    of 32 with the last one; a key 512 pen + 16 j + (k - 1) a trial, its
    least per group; a group's least replaces the best on a strictly lower
    pen; the plan as runs; the pick by run ranks. Returns (slots [T, 64]
    uint8, trials); ``seen`` collects the extremes of the values formed."""
    pix, mirror, pidx = pix.numpy(), mirror.numpy(), pidx.numpy()
    pal4 = t_yl.pal4_table(pal_rgb).numpy()
    valid = valid.numpy()
    bayer = t_tk.BAYER8
    T = len(pix)
    out = np.zeros((T, 64), np.uint8)
    trials = 0
    for tile in range(T):
        p = pidx[tile]
        slots = np.flatnonzero(valid[p])
        nv = len(slots)
        if nv == 0:
            continue
        padded = -(-nv // 32) * 32
        pos_slot = np.concatenate([slots, np.full(padded - nv, slots[-1])])
        rows = pal4[p][pos_slot].astype(np.int32)  # [padded, 4]
        lum = (rows[:, :3].astype(np.int64) * LUMA).sum(1)
        px = pix[tile].astype(np.int32)
        tgt = np.concatenate([px, ((px.astype(np.int64) * LUMA).sum(1) // 1000)[:, None]],
                             axis=1).astype(np.int32)
        so = np.zeros((64, 4), np.int32)
        count = np.zeros(64, np.int32)
        runs = []
        while (count < mixed).any():
            live = count < mixed
            mt = np.maximum(count, 1)
            best = np.full(64, 0xFFFFFFFF, np.uint32)
            best_g = np.zeros(64, np.int64)
            for g in range(padded // 32):
                gmin = np.full(64, 0xFFFFFFFF, np.uint32)
                c = rows[g * 32:(g + 1) * 32]
                for k in range(1, int(mt[live].max()) + 1):
                    inv = (65536 // (count + k)).astype(np.int32)
                    kinv = np.int32(k) * inv
                    base = (so + np.int32(k * (k - 1) >> 1)) * inv[:, None] - (tgt << 16)
                    x = c[None, :, :] * kinv[:, None, None] + base[:, None, :]  # [64, 32, 4]
                    d = x >> 16
                    rgb = (d[..., :3] * d[..., :3]).sum(-1).astype(np.uint32)
                    key = (rgb * np.uint32(13 << 9) + (d[..., 3] * d[..., 3]).astype(np.uint32)
                           * np.uint32(32 << 9) + ((np.arange(32, dtype=np.uint32) << 4)
                                                   | np.uint32(k - 1)))
                    if seen is not None:
                        seen["x"] = (min(seen.get("x", (0, 0))[0], int(x.min())),
                                     max(seen.get("x", (0, 0))[1], int(x.max())))
                        seen["d"] = max(seen.get("d", 0), int(np.abs(d).max()))
                        seen["key"] = max(seen.get("key", 0), int(key.max()))
                    gmin = np.where(k <= mt, np.minimum(gmin, key.min(1)), gmin)
                lt = gmin < (best & np.uint32(~511 & 0xFFFFFFFF))
                best = np.where(lt, gmin, best)
                best_g = np.where(lt, g, best_g)
            pos = best_g * 32 + ((best >> 4) & 31)
            amount = (best & 15).astype(np.int32) + 1
            amount = np.where(live, amount, 0)
            so = so + rows[pos] * amount[:, None]
            runs.append((pos, amount))
            trials += int((nv * mt)[live].sum())
            count = count + amount
        y = np.arange(64) >> 3
        x = np.arange(64) & 7
        m = int(mirror[tile])
        y = 7 - y if m & 2 else y
        x = 7 - x if m & 1 else x
        rank = (bayer[y, x] * count) >> 6
        for i, (pos_i, amt_i) in enumerate(runs):
            start = sum(np.where((lum[pos_j] < lum[pos_i])
                                 | ((lum[pos_j] == lum[pos_i]) & (j < i)), amt_j, 0)
                        for j, (pos_j, amt_j) in enumerate(runs))
            hit = (amt_i > 0) & (start <= rank) & (rank < start + amt_i)
            out[tile][hit] = pos_slot[pos_i[hit]]
    return out, trials


@pytest.mark.parametrize("S,mixed", [(16, 4), (33, 16), (256, 4)])
def test_numpy_model_of_the_kernel_equals_the_plain_passes(S, mixed):
    for case in (_case(S, S + mixed, T=4),
                 [torch.as_tensor(a) for a in t_tk.adversarial_case(S, seed=S, reps=1)]):
        pix, mirror, pidx, pal, valid = case
        want, trials = t_yl.yl2_select_plain(pix, mirror, pidx, t_yl.pal4_table(pal), valid,
                                              mixed)
        got, model_trials = _model(pix, mirror, pidx, pal, valid, mixed)
        assert np.array_equal(got, want.numpy())
        assert model_trials == int(trials)


def test_numpy_model_reaches_the_headers_int32_ranges():
    """A white palette against black pixels at mixed = 16 reaches the
    header's ends: |mix - tgt| = 258 on every lane, the key's 512 pen at
    258^2 * 71, every value of a trial in (-2^24, 2^25); the model still
    equals the plain passes there."""
    pix, mirror, pidx, pal, valid = (torch.as_tensor(a) for a in t_yl.range_case(33))
    seen = {}
    got, _ = _model(pix, mirror, pidx, pal, valid, 16, seen)
    want, _ = t_yl.yl2_select_plain(pix, mirror, pidx, t_yl.pal4_table(pal), valid, 16)
    assert np.array_equal(got, want.numpy())
    assert seen["d"] == 258
    assert seen["key"] >> 9 == 258 * 258 * (3 * 13 + 32)
    assert seen["key"] < 2 ** 32
    assert -2 ** 24 < seen["x"][0] and seen["x"][1] < 2 ** 25


def test_yl2_select_checks_its_arguments():
    pix, mirror, pidx, pal, valid = _case(16, 0)
    pal4 = t_yl.pal4_table(pal)
    with pytest.raises(ValueError, match="mixed"):
        t_yl.yl2_select(pix, mirror, pidx, pal4, valid, 17)
    with pytest.raises(ValueError, match="pal_idx"):
        t_yl.yl2_select(pix, mirror, pidx.long(), pal4, valid, 4)
    with pytest.raises(ValueError, match="outside"):
        t_yl.yl2_select(pix, mirror, pidx + 3, pal4, valid, 4)
    with pytest.raises(ValueError, match="no kernel"):
        t_yl.yl2_select(pix.to("meta"), mirror.to("meta"), pidx.to("meta"),
                        pal4.to("meta"), valid.to("meta"), 4)


@pytest.mark.parametrize("use_tk", [False, True])
def test_dither_step_route_and_counters_on_the_cpu(use_tk):
    """On the CPU Yliluoma2 takes the plain chunk loop (no launch) and the
    step counts its pixels' palettes' valid colors and the trials; Thomas
    Knoll counts neither."""
    from tiler_tpu_torch.pipeline.encoder import Encoder
    from tiler_tpu_torch.utils.clips import synthetic_clip

    settings = EncoderSettings(palette_count=4, palette_size=16, motion_predict_radius=2,
                               epu_knn_k=8, kmeans_iters=2, dithering_use_thomas_knoll=use_tk)
    enc = Encoder(settings, device="cpu", log=None)
    enc.load_frames(synthetic_clip(2, 32, 48), 25.0)
    enc.predict_motion().reduce().prepare_palettes()
    state = copy.copy(enc.state)
    before = t_yl.yl2_select.launches
    enc.dither()
    stats = enc.step_stats
    T = len(enc.state.corpus_rgb)
    assert t_yl.yl2_select.launches == before
    pal_valid = torch.as_tensor(enc.state.palettes_valid)
    if use_tk:
        assert "yl2_candidates" not in stats and "dither_colors" not in stats
        return
    valid = pal_valid.sum(1)[torch.as_tensor(state.corpus_pal_initial).long()]
    assert stats["dither_colors"] == 64 * int(valid.sum())
    pidx = torch.as_tensor(state.corpus_pal_initial).to(torch.int32)
    hm, vm = t_dither._corpus_initial_mirrors(state)
    mirror = torch.as_tensor((hm | (vm.astype(np.uint8) << 1)).astype(np.uint8))
    want, trials = t_yl.yl2_select(state.corpus_rgb.reshape(T, 64, 3).contiguous(), mirror,
                                   pidx, t_yl.pal4_table(torch.as_tensor(state.palettes_rgb)),
                                   pal_valid.contiguous(), 4)
    assert stats["yl2_candidates"] == int(trials) > 0
    assert torch.equal(enc.state.corpus_pal_pixels.reshape(T, 64), want)
