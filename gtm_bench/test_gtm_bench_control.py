"""The controls (a lower precision in the program's place) fail the
numbers that the kernels and the EPU re-rank are held to, where the
program passes them; at a size the CPU holds. On the card, control.py
reads the same at each cell's own size."""
import pytest
import torch

from gtm_bench import control, faults
from gtm_bench.reference import epu, knn, tk
from tiler_tpu_torch.kernels import knn_topk, tk_dither
from tiler_tpu_torch.ops.color import rgb_to_yuv
from tiler_tpu_torch.pipeline import reconstruct

from gtm_bench.test_gtm_bench_faults import small_cell


def test_control_readings_on_a_small_cell():
    recs = list(control.readings(small_cell(), [2**31 + 3], 1, 0, "cpu"))
    sound, low = recs[0]["sound"], recs[0]["control"]
    assert sound["tk_slots_off"] == 0 and recs[0]["failed"] == 0
    assert low["tk_bfloat16"]["numbers"]["tk_slots_off"] > 0
    assert sound["epu_gap"] < low["epu_bfloat16"]["numbers"]["epu_gap"]
    assert set(low) == {"tk_bfloat16", "epu_bfloat16"}


@pytest.mark.parametrize("S", [16, 64])
def test_thomas_knoll_reference_equals_the_program_plain_version(S):
    g = torch.Generator().manual_seed(S)
    T, P = 300, 5
    pix = torch.randint(0, 256, (T, 64, 3), generator=g, dtype=torch.uint8)
    mirror = torch.randint(0, 4, (T,), generator=g, dtype=torch.uint8)
    pal_idx = torch.randint(0, P, (T,), generator=g, dtype=torch.int32)
    valid = torch.rand(P, S, generator=g) < 0.8
    valid[0] = False
    table = tk_dither.pal_table(torch.randint(0, 256, (P, S, 3), generator=g), valid)
    want = tk_dither.tk_select_plain(pix, mirror, pal_idx, table)
    assert torch.equal(tk.select(pix, mirror, pal_idx, table), want)
    assert (tk.select(pix, mirror, pal_idx, table, dtype=torch.bfloat16) != want).any()


def test_knn_gap_small_for_float32_sums_large_for_fp8():
    g = torch.Generator().manual_seed(1)
    feats = torch.randn(256, 192, generator=g) * 50
    ds = torch.randn(3000, 192, generator=g) * 50
    dsTa = knn_topk.knn_prep2(ds, 4096)
    fa = knn_topk.fold_cells(feats, 256)
    sound = knn.gap(fa, dsTa, *knn_topk.knn_bucket_top2_plain(fa, dsTa))
    low = knn.gap(fa, dsTa, *knn.keys_in(fa, dsTa))
    assert sound < 2e-4 < 1e-2 < low
    k1, k2 = knn_topk.knn_bucket_top2_plain(fa, dsTa)
    k1 = k1.clone()
    k1[0, 0] ^= 1  # one lane altered
    assert knn.gap(fa, dsTa, k1, k2) > 1e-3


@pytest.mark.parametrize("S", [16, 64])
def test_epu_gap_small_for_the_program_picks_large_for_others(S):
    g = torch.Generator().manual_seed(S)
    T, P, B, kk = 200, 6, 40, 8
    pp = torch.randint(0, S, (T, 8, 8), generator=g, dtype=torch.uint8)
    palettes = torch.randint(0, 256, (P, S, 3), generator=g, dtype=torch.uint8)
    pal_initial = torch.randint(0, P, (T,), generator=g)
    cells = torch.randint(0, 256, (B, 8, 8, 3), generator=g).float()
    _, feats = reconstruct._features(cells, False)
    idx = torch.stack([torch.randperm(T, generator=g)[:kk] for _ in range(B)])
    cand_pal = pal_initial[idx]
    G, Q = reconstruct._epu_tables(pp, S)
    t, p = reconstruct._epu_rank_all(feats, idx, cand_pal, G, Q,
                                     rgb_to_yuv(palettes.float()), S, 16)
    sound = epu.gap(feats, idx, cand_pal, t, p, pp, palettes)
    assert sound < 1e-5
    worst = torch.randint(0, kk, (B,), generator=g)
    t2 = idx[torch.arange(B), worst]
    p2 = cand_pal[torch.arange(B), worst]
    assert epu.gap(feats, idx, cand_pal, t2, p2, pp, palettes) > 1e-3
    assert epu.gap(feats, idx, cand_pal, torch.full_like(t, T + 1), p, pp, palettes) == 1.0


def test_epu_bfloat16_control_on_the_table_path():
    # the card's path where P <= X: Rj is None and the pairs' Q . R entries
    # come in Qi; the control rounds them to bfloat16 instead of raising
    S, T, P, B, kk = 16, 200, 6, 40, 8
    g = torch.Generator().manual_seed(5)
    pp = torch.randint(0, S, (T, 8, 8), generator=g, dtype=torch.uint8)
    palettes = torch.randint(0, 256, (P, S, 3), generator=g, dtype=torch.uint8)
    pal_initial = torch.randint(0, P, (T,), generator=g)
    cells = torch.randint(0, 256, (B, 8, 8, 3), generator=g).float()
    _, feats = reconstruct._features(cells, False)
    idx = torch.stack([torch.randperm(T, generator=g)[:kk] for _ in range(B)])
    cand_pal = pal_initial[idx]
    pal_yuv = rgb_to_yuv(palettes.float())
    G, QR = reconstruct._epu_tables(pp, S, rall=reconstruct._rall(pal_yuv, S))
    assert QR.shape == (T, P)
    t, p = reconstruct._epu_rank_all(feats, idx, cand_pal, G, QR, pal_yuv, S, 16, table=True)
    with faults.CONTROLS["epu_bfloat16"]():
        t2, p2 = reconstruct._epu_rank_all(feats, idx, cand_pal, G, QR, pal_yuv, S, 16,
                                           table=True)
    sound = epu.gap(feats, idx, cand_pal, t, p, pp, palettes)
    low = epu.gap(feats, idx, cand_pal, t2, p2, pp, palettes)
    assert sound < 1e-5 < low


def test_kmeans_gap_zero_for_the_nearest_large_for_others():
    g = torch.Generator().manual_seed(7)
    points, cents = torch.randn(300, 12, generator=g), torch.randn(20, 12, generator=g)
    near = torch.cdist(points.double(), cents.double()).argmin(dim=1).to(torch.int32)
    assert knn.kmeans_gap(points, cents, near, rows_at_once=64) == 0.0
    far = torch.cdist(points.double(), cents.double()).argmax(dim=1).to(torch.int32)
    assert knn.kmeans_gap(points, cents, far, rows_at_once=64) > 1e-2
    assert knn.kmeans_gap(points, cents, torch.full_like(near, 20)) == 1.0
