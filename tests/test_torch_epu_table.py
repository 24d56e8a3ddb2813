"""The EPU's [T, P] table of Q . R (``pipeline/reconstruct.py``): on a card
where a palette count P is no more than Q's row length X = 3 S(S+1)/2,
each pair's Q_i . R_j comes from a table built once a reconstruct, not
from a per-cell product of gathered Q and R rows. Torch only; the card's
own checks are in ``tests/test_torch_cuda.py``.

Bounds, each with its reason: a table entry lies within gamma(X) sum |Q|
|R| of the float64 product of the same float32 rows (a float32 dot of X
terms, any order); a pair error through the table within twice that of
the per-cell one (two such dots of the same terms) plus the last
subtraction's rounding; picks equal in the cells whose best pair leads
every other by more than twice the widest difference of the two paths'
errors there (at least 90% of this case's cells).
"""
import numpy as np
import pytest
import torch

from tiler_tpu_torch.config import EncoderSettings
from tiler_tpu_torch.ops.color import rgb_to_yuv
from tiler_tpu_torch.ops.ordered import U32, gamma
from tiler_tpu_torch.pipeline import reconstruct as t_rec
from tiler_tpu_torch.pipeline.encoder import Encoder

S, P, T, CELLS, KK = 64, 4, 300, 96, 8
X = 3 * S * (S + 1) // 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors in many steps: one intra-op thread each, so that the
    suite's parallel workers do not oversubscribe the cores (restored
    after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def case():
    """A seeded corpus of T tiles at S colours, P palettes, and CELLS cells
    each with KK candidate tiles and every palette as candidates."""
    g = torch.Generator().manual_seed(17)
    pp = torch.randint(0, S, (T, 8, 8), generator=g, dtype=torch.uint8)
    palettes = torch.randint(0, 256, (P, S, 3), generator=g, dtype=torch.uint8)
    pal_yuv = rgb_to_yuv(palettes.float())
    rall = t_rec._rall(pal_yuv, S)
    G, QR = t_rec._epu_tables(pp, S, rall=rall)
    G2, Q = t_rec._epu_tables(pp, S)
    assert torch.equal(G, G2)  # the table path's G is the per-cell path's
    _, feats = t_rec._features(torch.randint(0, 256, (CELLS, 8, 8, 3), generator=g).float(),
                               False)
    idx = torch.stack([torch.randperm(T, generator=g)[:KK] for _ in range(CELLS)])
    cand_pal = torch.stack([torch.randperm(P, generator=g) for _ in range(CELLS)])
    return dict(pp=pp, palettes=palettes, pal_yuv=pal_yuv, rall=rall, G=G, Q=Q, QR=QR,
                feats=feats, idx=idx, cand_pal=cand_pal)


def _pair_terms(c, table: bool):
    """_pair_err's arguments for every cell, as _epu_rank_all gathers them."""
    ci, cp = c["idx"], c["cand_pal"]
    w = torch.as_tensor(t_rec.DCT_WEIGHTS, dtype=torch.float32)
    ftw = t_rec._ftw(c["feats"], w.permute(1, 2, 0).reshape(64, 3)).to(torch.bfloat16).float()
    Gi = c["G"][ci].float()
    if table:
        return Gi, c["QR"][ci[:, :, None], cp[:, None, :]], ftw, c["pal_yuv"][cp], None
    return Gi, c["Q"][ci], ftw, c["pal_yuv"][cp], c["rall"][cp]


def _abs_qr(c):
    """sum |Q| |R| of every (candidate tile, candidate palette) pair of
    every cell, [CELLS, KK * P] float64: the scale of a dot's rounding."""
    A = c["Q"].abs().double() @ c["rall"].abs().double().T
    return A[c["idx"][:, :, None], c["cand_pal"][:, None, :]].reshape(CELLS, -1)


def test_table_entries_equal_float64_q_dot_r(case):
    assert case["QR"].shape == (T, P) and case["QR"].dtype == torch.float32
    want = case["Q"].double() @ case["rall"].double().T
    scale = case["Q"].abs().double() @ case["rall"].abs().double().T
    assert ((case["QR"].double() - want).abs() <= gamma(X) * scale).all()


def test_pair_errors_through_the_table_equal_the_per_cell_ones(case):
    got = t_rec._pair_err(*_pair_terms(case, table=True)).double()
    want = t_rec._pair_err(*_pair_terms(case, table=False)).double()
    assert got.shape == want.shape == (CELLS, KK * P)
    bound = 2 * gamma(X) * _abs_qr(case) + 2 * U32 * (got.abs() + want.abs())
    assert ((got - want).abs() <= bound).all()


def test_picks_equal_on_a_case_without_near_ties(case):
    c = case
    args = (c["feats"], c["idx"], c["cand_pal"])
    got = t_rec._epu_rank_all(*args, c["G"], c["QR"], c["pal_yuv"], S, 16, table=True)
    want = t_rec._epu_rank_all(*args, c["G"], c["Q"], c["pal_yuv"], S, 16)
    # the cells whose best pair leads every other by more than twice the
    # widest difference of the two paths' errors: there they must pick alike
    err = t_rec._pair_err(*_pair_terms(c, table=False)).double()
    moved = (t_rec._pair_err(*_pair_terms(c, table=True)).double() - err).abs()
    top2 = err.topk(2, dim=1, largest=False).values
    clear = top2[:, 1] - top2[:, 0] > 2 * moved.max(dim=1).values
    assert clear.float().mean() >= 0.9  # the case has few near ties
    for g, w in zip(got, want):
        assert g.dtype == torch.int64 and torch.equal(g[clear], w[clear])


@pytest.mark.parametrize("device,P,S,takes", [
    ("cuda", 16, 256, True),     # gtm_wide256: a 16-value row against 98,688
    ("cuda", 408, 16, True),     # P = X: a table row as long as the Q row
    ("cuda", 409, 16, False),
    ("cuda", 1024, 16, False),   # gtm_default: a 475 MB table against a 189 MB Q
    ("cpu", 16, 256, False),     # the CPU sums Q . R per cell, in XLA's order
    ("cpu", 4, 64, False),
])
def test_dispatch_takes_the_table_on_a_card_where_p_is_at_most_x(device, P, S, takes):
    assert t_rec._epu_table(torch.device(device), P, S) is takes


def _clip(frames=4, h=64, w=96, seed=5):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h + 4 * frames, w + 4 * frames, 3), dtype=np.uint8)
    return np.stack([base[2 * f:2 * f + h, 3 * f:3 * f + w] for f in range(frames)])


def test_a_default_settings_cpu_encode_takes_no_table(tmp_path):
    logs = []
    enc = Encoder(EncoderSettings(), log=logs.append, device="cpu")
    enc.run_all(_clip(), fps=25.0, out_path=str(tmp_path / "default.gtm"))
    assert enc.step_stats["epu_table_cells"] == 0
    assert any("0 cells ranked through the Q.R table" in line for line in logs)


def test_the_table_path_counts_every_cell_it_ranks(monkeypatch, tmp_path):
    """The table path of a whole phase A on the CPU (the card's dispatch
    forced): every re-ranked cell counted, each re-rank given the [T, P]
    table and a chunk within 3e8 bytes of G rows, their f32 copy and the
    table's entries, and the encode as good as the per-cell path's."""
    settings = EncoderSettings(palette_count=P, palette_size=S, motion_predict_radius=4,
                               epu_knn_k=KK, kmeans_iters=4)
    plain = Encoder(settings, log=None, device="cpu")
    plain.run_all(_clip(), fps=25.0, out_path=str(tmp_path / "plain.gtm"))
    assert plain.step_stats["epu_table_cells"] == 0
    seen = []
    rank = t_rec._epu_rank_all

    def spy(feats, cand_idx, cand_pal, G, Q, pal_yuv, S_, cell_chunk, counts=None, **kw):
        assert kw == {"table": True} and Q.shape == (G.shape[0], P)
        kk, kp = cand_idx.shape[1], cand_pal.shape[1]
        assert cell_chunk * kk * (64 * S_ * (2 + 4) + kp * 4) <= 3e8
        seen.append(feats.shape[0])
        return rank(feats, cand_idx, cand_pal, G, Q, pal_yuv, S_, cell_chunk, counts, **kw)

    monkeypatch.setattr(t_rec, "_epu_table", lambda dev, P_, S_: P_ <= 3 * S_ * (S_ + 1) // 2)
    monkeypatch.setattr(t_rec, "_epu_rank_all", spy)
    enc = Encoder(settings, log=None, device="cpu")
    enc.run_all(_clip(), fps=25.0, out_path=str(tmp_path / "table.gtm"))
    assert seen and enc.step_stats["epu_table_cells"] == sum(seen)
    assert abs(enc.state.total_psnr - plain.state.total_psnr) <= 0.01
