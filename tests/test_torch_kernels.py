"""The port's two kernels: plain versions against the Pallas kernels (in
interpret mode, as the JAX package's own tests run them on the CPU), the
wrappers' dispatch and argument checks. The CUDA kernels themselves are
held against these plain versions on the card by test_torch_cuda.py and
chip_smoke.py.

B1 tk_select (kernels/tk_dither.py) is all integer: bit-identical.
B2 knn_bucket_top2 (kernels/knn_topk.py) ranks on f32 sums of exact bf16
products in another order: idx equal apart from near-ties, err within
2^-14 relative, recall against a float64 brute force no worse than the
JAX kernel's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiler_tpu.kernels import knn_topk as j_knn
from tiler_tpu.kernels import tk_dither as j_tk
from tiler_tpu.pipeline import dither as j_dither
from tiler_tpu_torch.kernels import blockify as t_blk
from tiler_tpu_torch.kernels import knn_topk as t_knn
from tiler_tpu_torch.kernels import tk_dither as t_tk
from tiler_tpu_torch.kernels import yl2_dither as t_yl
from tiler_tpu_torch.kernels import launch_counts, reset_launch_counts


def _tk_case(T=40, P=5, S=16, seed=0):
    """tests/test_tk_kernel.py's shapes, plus random mirror flags."""
    rng = np.random.RandomState(seed)
    tiles = rng.randint(0, 256, (T, 8, 8, 3)).astype(np.uint8)
    pidx = rng.randint(0, P, T).astype(np.int32)
    pal = rng.randint(0, 256, (P, S, 3)).astype(np.int32)
    valid = np.ones((P, S), bool)
    valid[min(2, P - 1), -3:] = False
    hm = rng.rand(T) < 0.5
    vm = rng.rand(T) < 0.5
    return tiles, pidx, pal, valid, hm, vm


def _tk_port(tiles, pidx, pal, valid, hm, vm, device="cpu"):
    T = len(tiles)
    mirror = (hm.astype(np.uint8) | (vm.astype(np.uint8) << 1))
    args = [torch.from_numpy(tiles.reshape(T, 64, 3)), torch.from_numpy(mirror),
            torch.from_numpy(pidx),
            t_tk.pal_table(torch.from_numpy(pal), torch.from_numpy(valid))]
    return [a.to(device) for a in args]


@pytest.mark.parametrize("seed", [0, 1])
def test_tk_plain_matches_pallas_and_xla(seed):
    tiles, pidx, pal, valid, hm, vm = _tk_case(seed=seed)
    T = len(tiles)
    bay = np.broadcast_to(j_dither.BAYER8, (T, 8, 8))
    bay = np.where(hm[:, None, None], bay[:, :, ::-1], bay)
    bay = np.where(vm[:, None, None], bay[:, ::-1, :], bay)
    with jax.enable_x64(False):
        pallas = np.asarray(j_tk.tk_dither_pallas(
            jnp.asarray(tiles), jnp.asarray(pidx), jnp.asarray(pal),
            jnp.asarray(valid), jnp.asarray(bay), interpret=True))
        xla = np.asarray(j_dither._dither_chunk(
            jnp.asarray(tiles), jnp.asarray(pidx), jnp.asarray(hm), jnp.asarray(vm),
            jnp.asarray(pal), jnp.asarray(valid), pal.shape[1], True, 4))
    got = t_tk.tk_select(*_tk_port(tiles, pidx, pal, valid, hm, vm)).numpy().reshape(T, 8, 8)
    assert np.array_equal(got, pallas)
    assert np.array_equal(got, xla)


def _jax_tk(pix, mirror, pidx, pal, valid, pallas):
    """The JAX package's TK dither of the port's arguments: the Pallas
    kernel in interpret mode, or the XLA path."""
    T = len(pix)
    hm, vm = (mirror & 1) != 0, (mirror & 2) != 0
    tiles = pix.reshape(T, 8, 8, 3)
    with jax.enable_x64(False):
        if not pallas:
            return np.asarray(j_dither._dither_chunk(
                jnp.asarray(tiles), jnp.asarray(pidx), jnp.asarray(hm), jnp.asarray(vm),
                jnp.asarray(pal), jnp.asarray(valid), pal.shape[1], True, 4)).reshape(T, 64)
        bay = np.broadcast_to(j_dither.BAYER8, (T, 8, 8))
        bay = np.where(hm[:, None, None], bay[:, :, ::-1], bay)
        bay = np.where(vm[:, None, None], bay[:, ::-1, :], bay)
        return np.asarray(j_tk.tk_dither_pallas(
            jnp.asarray(tiles), jnp.asarray(pidx), jnp.asarray(pal), jnp.asarray(valid),
            jnp.asarray(bay), interpret=True)).reshape(T, 64)


@pytest.mark.parametrize("S", [1, 16, 17, 32])
def test_tk_adversarial_cases_match_pallas_and_xla(S):
    """Worst-case error growth (all-0 pixels against a one-color 255
    palette and the reverse), duplicate colors (the first minimum), colors
    of equal luma (ties go by step), a single valid slot, none: the plain
    version, the XLA path and the Pallas kernel agree bit for bit."""
    pix, mirror, pidx, pal, valid = t_tk.adversarial_case(S, seed=S, reps=1)
    got = t_tk.tk_select(torch.from_numpy(pix), torch.from_numpy(mirror),
                         torch.from_numpy(pidx),
                         t_tk.pal_table(torch.from_numpy(pal), torch.from_numpy(valid))).numpy()
    assert np.array_equal(got, _jax_tk(pix, mirror, pidx, pal, valid, pallas=False))
    assert np.array_equal(got, _jax_tk(pix, mirror, pidx, pal, valid, pallas=True))
    # the one-color palettes: every slot is a duplicate, slot 0 wins
    assert int(got[pidx == 0].max()) == 0 and int(got[pidx == 1].max()) == 0
    # a single valid slot is the only pick
    assert np.all(got[pidx == 5] == S - 1) and np.all(got[pidx == 6] == 0)


def _tk_kernel_model(pix, mirror, pal_idx, table, stats):
    """csrc/tk_dither.cu's arithmetic in numpy, step for step: the fp32
    dot product whose bit pattern is 0x4B400000 + d, floor(|dluma| / 1000)
    from one multiply-add rounding toward zero, the key
    208 * bits + ((B * B + bias) << 9 | slot) modulo 2^32, invalid rows as
    copies of the first valid row, and the rank found by walking the
    slots in luma order over per-slot counts. ``stats`` collects the
    ranges that the source's header proves."""
    M = 1 << 32
    c001, c009 = float(np.float32(0.001)), float(np.float32(0.09))
    S = table.shape[1]
    NS = 16 if S <= 16 else 32
    wide = NS > 16
    out = np.zeros((len(pix), 64), np.uint8)
    for t in range(len(pix)):
        pal = table[pal_idx[t]].astype(np.int64)
        valid = pal[:, 4] > 0
        first = int(np.flatnonzero(valid)[0]) if valid.any() else -1
        rows = np.zeros((NS, 6), np.int64)  # |p|^2, r, g, b, luma, slot
        fed = np.zeros((NS, 3), np.int64)
        luma_key = (1 << 30) + np.arange(NS, dtype=np.int64)
        for s in range(NS):
            ok = s < S and valid[s]
            src = s if ok else first
            if src >= 0:
                r, g, b, lum = pal[src, :4]
                rows[s] = (r * r + g * g + b * b, r, g, b, lum, src)
            if ok:
                fed[s] = pal[s, :3]
                luma_key[s] = pal[s, 3]
        order = sorted(range(NS), key=lambda s: (luma_key[s], s))
        equal_lumas = len(set(luma_key.tolist())) < NS
        src_px = pix[t].astype(np.int64)
        err = np.zeros((64, 3), np.int64)
        count = np.zeros((NS, 64), np.int64)
        picks = np.zeros((64, 64), np.int64)
        for c in range(64):
            fb = np.floor(np.abs(err) * c009).astype(np.int64)  # fma_rz(|err|, 0.09f, 2^23)
            assert np.array_equal(fb, np.abs(err * 9) // 100)
            tgt = src_px + np.sign(err) * fb
            lum_t = tgt @ np.array([299, 587, 114])
            t2 = (tgt * tgt).sum(1)
            stats["t"] = (min(stats["t"][0], int(tgt.min())), max(stats["t"][1], int(tgt.max())))
            assert t2.max() < (1 << 24) and np.abs(lum_t).max() < (1 << 24)
            bias = ((208 * t2 - 0x24000000 + 511) % M) >> 9
            best = None
            for s in range(NS):
                d = rows[s, 0] - 2 * (tgt @ rows[s, 1:4])
                assert np.abs(d).max() < (1 << 22)  # 1.5 * 2^23 + d stays in [2^23, 2^24)
                bits = 0x4B400000 + d
                n = np.abs(lum_t - rows[s, 4])
                q = np.floor(n * c001).astype(np.int64)  # fma_rz(|dluma|, 0.001f, 2^23)
                assert np.array_equal(q, n // 1000)
                B = 0x4B000000 + q
                lo = 0 if wide else int(rows[s, 5])
                key = (208 * bits + ((((B * B + bias) << 9) % M) | lo)) % M
                dd = tgt - rows[s, 1:4]
                pen = 13 * (dd * dd).sum(1) + 32 * q * q
                stats["pen"] = max(stats["pen"], int(pen.max()))
                slack = key - 16 * pen - lo
                assert (slack >= 0).all() and (slack < 512).all() and (slack % 16 == 0).all()
                if wide:
                    key = key * 32 + int(rows[s, 5])
                best = key if best is None else np.minimum(best, key)
            pick = best % (32 if wide else 16)
            err += src_px - fed[pick]
            count[pick, np.arange(64)] += 1
            picks[c] = pick
        m = int(mirror[t])
        for px in range(64):
            y, x = px >> 3, px & 7
            mapv = int(t_tk.BAYER8[7 - y if m & 2 else y, 7 - x if m & 1 else x])
            seen = below = 0
            last, sel, luma, rest = -1, -1, 0, 0
            for s in order:
                if luma_key[s] != last:
                    below = seen
                last = luma_key[s]
                seen += count[s, px]
                if sel < 0 and seen > mapv:
                    sel, luma, rest = s, luma_key[s], mapv - below
            if equal_lumas:
                for c in range(64):
                    if luma_key[picks[c, px]] == luma:
                        if rest == 0:
                            sel = picks[c, px]
                        rest -= 1
            out[t, px] = sel
    return out


@pytest.mark.parametrize("S", [16, 17])
def test_tk_kernel_arithmetic_and_range_proof(S):
    """The CUDA kernel's arithmetic, modelled in numpy, picks what the
    plain version picks on the adversarial cases, and the ranges its
    header proves hold and are reached: targets in [-1445, 1700],
    pen <= 205,190,000 < 2^28, every key 16 * pen + slot plus a slack below
    512 that is a multiple of 16, no wrap of 32 bits."""
    pix, mirror, pidx, pal, valid = t_tk.adversarial_case(S, seed=S, reps=1)
    keep = slice(None) if S == 16 else slice(0, 16)  # the growth, duplicate, equal-luma tiles
    pix, mirror, pidx = pix[keep], mirror[keep], pidx[keep]
    table = t_tk.pal_table(torch.from_numpy(pal), torch.from_numpy(valid))
    want = t_tk.tk_select_plain(torch.from_numpy(pix), torch.from_numpy(mirror),
                                torch.from_numpy(pidx), table).numpy()
    stats = {"t": (0, 0), "pen": 0}
    got = _tk_kernel_model(pix, mirror, pidx, table.numpy(), stats)
    assert np.array_equal(got, want)
    assert stats["t"] == (-1445, 1700)
    assert stats["pen"] == 13 * 3 * 1700 ** 2 + 32 * 1700 ** 2 == 205190000 < 2 ** 28
    assert 16 * stats["pen"] + 15 + 511 < 2 ** 32


def test_tk_truncations_in_fp32_are_exact():
    """The kernel's two divisions as one fp32 multiply-add rounding toward
    zero: the product with the fp32 constant is exact in float64, so its
    floor is what fma_rz(|n|, c, 2^23) leaves above 2^23."""
    n = np.arange(0, 2_100_001, dtype=np.float64)
    assert np.array_equal(np.floor(n * float(np.float32(0.001))), n // 1000)
    e = np.arange(0, 16_321, dtype=np.float64)
    assert np.array_equal(np.floor(e * float(np.float32(0.09))), (e * 9) // 100)
    assert float(np.float32(0.001)) > 0.001 and float(np.float32(0.09)) > 0.09


def test_tk_pal_idx_is_checked_on_the_host():
    with pytest.raises(ValueError, match="pal_idx outside"):
        t_tk.check_pal_idx(np.array([0, 5], np.int32), 5)
    t_tk.check_pal_idx(np.array([0, 4], np.int32), 5)
    t_tk.check_pal_idx(np.zeros(0, np.int32), 5)


def test_tk_all_invalid_palette_keeps_slot_zero():
    """A palette with no valid color: the TPU kernel keeps slot 0 and a
    black pick for every step."""
    tiles, pidx, pal, valid, hm, vm = _tk_case(T=4, P=2, S=4)
    valid[:] = False
    got = t_tk.tk_select(*_tk_port(tiles, pidx, pal, valid, hm, vm))
    assert int(got.max()) == 0


def test_tk_wrapper_rejects_bad_arguments():
    tiles, pidx, pal, valid, hm, vm = _tk_case(T=4, P=2, S=4)
    pix, mirror, pal_idx, table = _tk_port(tiles, pidx, pal, valid, hm, vm)
    with pytest.raises(ValueError, match="pal_idx"):
        t_tk.tk_select(pix, mirror, pal_idx.long(), table)
    with pytest.raises(ValueError, match="pal_idx outside"):
        t_tk.tk_select(pix, mirror, pal_idx + 7, table)
    # GTM writes a slot as a byte: S = 33..256 runs the wide kernel, 257 none
    with pytest.raises(ValueError, match="palette size"):
        t_tk.tk_select(pix, mirror, pal_idx, torch.zeros(2, 257, 8, dtype=torch.int32))
    with pytest.raises(ValueError, match="no kernel"):
        t_tk.tk_select(*(a.to("meta") for a in (pix, mirror, pal_idx, table)))


def _knn_case(N, T, Tp, seed):
    rng = np.random.default_rng(seed)
    feats = rng.normal(0, 50, (N, 192)).astype(np.float32)
    ds = rng.normal(0, 50, (T, 192)).astype(np.float32)
    return feats, ds


def _recall(idx, feats, ds, k):
    f, d = feats.astype(np.float64), ds.astype(np.float64)
    dist = (f * f).sum(1)[:, None] - 2 * f @ d.T + (d * d).sum(1)[None, :]
    want = np.argsort(dist, axis=1)[:, :k]
    return np.mean([len(set(idx[i]) & set(want[i])) / k for i in range(len(idx))])


# tests/test_knn_topk.py's v2 cases: (N, T, padded Tp, k, seed)
KNN_CASES = [(64, 4096, 4096, 1, 3), (16, 8092, 8192, 4, 4)]


@pytest.mark.parametrize("N,T,Tp,k,seed", KNN_CASES)
def test_knn_plain_matches_pallas(N, T, Tp, k, seed):
    feats, ds = _knn_case(N, T, Tp, seed)
    with jax.enable_x64(False):
        jidx, jerr = j_knn.knn_bucket_topk2(
            jnp.asarray(feats), j_knn.knn_prep2(jnp.asarray(ds), Tp), k)
    jidx, jerr = np.asarray(jidx), np.asarray(jerr)
    idx, err = t_knn.knn_bucket_topk2(torch.from_numpy(feats),
                                      t_knn.knn_prep2(torch.from_numpy(ds), Tp), k)
    idx, err = idx.numpy(), err.numpy()
    assert idx.max() < T  # padded corpus columns never rank
    # err: the same 15-bit ranking mantissa; one key step is 2^-14 relative
    np.testing.assert_allclose(err, jerr, rtol=2.0 ** -14)
    # idx: equal apart from near-ties (keys within one key step)
    differ = idx != jidx
    assert np.all(np.abs(err[differ] - jerr[differ]) <= 2.0 ** -14 * np.abs(jerr[differ]))
    assert differ.mean() <= 0.05
    assert _recall(idx, feats, ds, k) >= _recall(jidx, feats, ds, k) - 1e-9


def test_knn_prep_and_fold_layout():
    feats, ds = _knn_case(5, 100, 512, 0)
    dsTa = t_knn.knn_prep2(torch.from_numpy(ds), 512)
    fa = t_knn.fold_cells(torch.from_numpy(feats), 64)
    assert dsTa.shape == (t_knn.KDA, 512) and fa.shape == (64, t_knn.KDA)
    d = (fa.float() @ dsTa.float()).numpy()
    true = ((feats[:, None, :].astype(np.float64) - ds[None]) ** 2).sum(-1)
    np.testing.assert_allclose(d[:5, :100], true, rtol=2e-2, atol=100.0)
    assert np.all(d[:5, 100:] > 1e29)  # padded corpus columns
    assert np.all(d[5:] == 0)  # zero rows past the real cells


def test_knn_wrapper_rejects_bad_arguments():
    fa = torch.zeros(t_knn.CELL_BLOCK, t_knn.KDA, dtype=torch.bfloat16)
    dsTa = torch.zeros(t_knn.KDA, 512, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple"):
        t_knn.knn_bucket_top2(fa[:10], dsTa)
    with pytest.raises(ValueError, match="bfloat16"):
        t_knn.knn_bucket_top2(fa.float(), dsTa)
    with pytest.raises(ValueError, match="no kernel"):
        t_knn.knn_bucket_top2(fa.to("meta"), dsTa.to("meta"))


def test_plain_versions_count_no_launches():
    reset_launch_counts()
    for S in (4, 40):  # the narrow and the wide kernel's plain version
        tiles, pidx, pal, valid, hm, vm = _tk_case(T=4, P=2, S=S)
        t_tk.tk_select(*_tk_port(tiles, pidx, pal, valid, hm, vm))
    t_knn.knn_bucket_top2(torch.zeros(t_knn.CELL_BLOCK, t_knn.KDA, dtype=torch.bfloat16),
                          torch.zeros(t_knn.KDA, 512, dtype=torch.bfloat16))
    t_knn.knn_bucket_top2_v1(torch.zeros(t_knn.CELL_BLOCK, t_knn.KD, dtype=torch.bfloat16),
                             torch.zeros(t_knn.KD, 512, dtype=torch.bfloat16),
                             torch.zeros(512))
    t_blk.blockify_field(torch.zeros(16, 16, 8, dtype=torch.bfloat16))
    t_yl.yl2_select(torch.zeros(2, 64, 3, dtype=torch.uint8), torch.zeros(2, dtype=torch.uint8),
                    torch.zeros(2, dtype=torch.int32), torch.zeros(1, 40, 4, dtype=torch.int32),
                    torch.ones(1, 40, dtype=torch.bool), 4)
    assert launch_counts() == {"tk_select": 0, "tk_select_wide": 0, "yl2_select": 0,
                               "knn_bucket_top2": 0, "knn_bucket_top2_v1": 0,
                               "blockify_field": 0}
