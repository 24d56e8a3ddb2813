"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA card and skips without one; this file
imports neither jax nor the JAX package, so it runs on the card's
machine:

    python -m pytest tests/test_torch_cuda.py -m cuda
"""
import numpy as np
import pytest
import torch

from tiler_tpu_torch.kernels import blockify as t_blk
from tiler_tpu_torch.kernels import knn_topk as t_knn
from tiler_tpu_torch.kernels import tk_dither as t_tk


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _tk_args(T, P, S, seed, device):
    rng = np.random.default_rng(seed)
    args = (
        torch.as_tensor(rng.integers(0, 256, (T, 64, 3), dtype=np.uint8)),
        torch.as_tensor(rng.integers(0, 4, T, dtype=np.uint8)),
        torch.as_tensor(rng.integers(0, P, T, dtype=np.int32)),
        t_tk.pal_table(torch.as_tensor(rng.integers(0, 256, (P, S, 3), dtype=np.int32)),
                       torch.as_tensor(rng.random((P, S)) < 0.8)),
    )
    return [a.to(device) for a in args]


@pytest.mark.cuda
@pytest.mark.parametrize("T,P,S", [(777, 37, 16), (64, 3, 4), (130, 5, 32)])
def test_tk_kernel_matches_plain(cuda, T, P, S):
    want = t_tk.tk_select(*_tk_args(T, P, S, T, "cpu"))
    before = t_tk.tk_select.launches
    got = t_tk.tk_select(*_tk_args(T, P, S, T, cuda))
    torch.cuda.synchronize()
    assert t_tk.tk_select.launches == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 2, 15, 16, 17, 31, 32])
def test_tk_kernel_adversarial_cases(cuda, S):
    """Worst-case error growth, duplicate colors, equal lumas, a single
    valid slot, none (kernels/tk_dither.py adversarial_case): bit-identical
    to the plain version, in both instantiations (S <= 16, S <= 32)."""
    pix, mirror, pidx, pal, valid = t_tk.adversarial_case(S, seed=S)
    args = [torch.as_tensor(a) for a in (pix, mirror, pidx)]
    table = t_tk.pal_table(torch.as_tensor(pal), torch.as_tensor(valid))
    want = t_tk.tk_select_plain(*args, table)
    got = t_tk.tk_select(*(a.to(cuda) for a in args), table.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 2, 3, 5, 4 * 33 + 1])
def test_tk_kernel_ragged_tile_counts(cuda, T):
    """A block covers four tiles: tile counts that leave its last block
    partly empty, and a single tile."""
    want = t_tk.tk_select(*_tk_args(T, 3, 16, T, "cpu"))
    got = t_tk.tk_select(*_tk_args(T, 3, 16, T, cuda))
    torch.cuda.synchronize()
    assert got.shape == (T, 64) and torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_tk_kernel_truncations_are_exact(cuda):
    """The kernel's floor(|n| / 1000) over every integer of +-2.1e6 (the
    scan's luma differences stay within +-1.7e6), multiples of 1000 and
    their neighbours included, and its trunc(n * 9 / 100) over +-20,000
    (the errors stay within +-16,320)."""
    lo, count = -2_100_000, 4_200_001
    n = torch.arange(lo, lo + count, dtype=torch.int64)
    got = t_tk.trunc_probe(lo, count, 0, cuda).cpu().long()
    assert torch.equal(got, torch.div(n.abs(), 1000, rounding_mode="floor"))
    lo, count = -20_000, 40_001
    n = torch.arange(lo, lo + count, dtype=torch.int64)
    got = t_tk.trunc_probe(lo, count, 1, cuda).cpu().long()
    assert torch.equal(got, torch.div(n * 9, 100, rounding_mode="trunc"))


@pytest.mark.cuda
@pytest.mark.parametrize("S", [33, 64, 128, 256, 48, 200])
@pytest.mark.parametrize("T", [1, 3, 4 * 33 + 1])
def test_tk_wide_kernel_matches_plain(cuda, S, T):
    """The wide kernel (S = 33..256) on random tiles, in tile counts that
    leave a block partly empty, one palette without a valid color:
    bit-identical, one launch of tk_select_wide and none of tk_select."""
    args = _tk_args(T, 3, S, S + T, "cpu")
    table = args[3].clone()
    table[1, :, 4] = 0  # palette 1 has no valid color
    args[2][0] = 1
    want = t_tk.tk_select_plain(*args[:3], table)
    before = (t_tk.tk_select.launches, t_tk.tk_select_wide.launches)
    got = t_tk.tk_select(*(a.to(cuda) for a in args[:3]), table.to(cuda))
    torch.cuda.synchronize()
    assert (t_tk.tk_select.launches, t_tk.tk_select_wide.launches) == (before[0],
                                                                       before[1] + 1)
    assert torch.equal(got.cpu(), want)
    assert (want[0] == 0).all()  # the palette without a valid color gives slot 0


@pytest.mark.cuda
@pytest.mark.parametrize("S", [33, 64, 128, 256])
def test_tk_wide_kernel_adversarial_cases(cuda, S):
    """Equal lumas across every slot (98 distinct colors), duplicates,
    one or no valid slot, worst-case error growth: bit-identical."""
    pix, mirror, pidx, pal, valid = t_tk.adversarial_case(S, seed=S)
    args = [torch.as_tensor(a) for a in (pix, mirror, pidx)]
    table = t_tk.pal_table(torch.as_tensor(pal), torch.as_tensor(valid))
    want = t_tk.tk_select_plain(*args, table)
    got = t_tk.tk_select_wide(*(a.to(cuda) for a in args), table.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


# the palettes of kernels/tk_dither.py slot_edge_case, in its order
SLOT_EDGES = ("invalid_below_first", "one_color_upper_half", "no_valid", "single_valid_last",
              "groups_16k_1", "groups_16k_15", "half_valid", "ties_across_groups")


@pytest.mark.cuda
@pytest.mark.parametrize("palette", range(len(SLOT_EDGES)), ids=SLOT_EDGES)
@pytest.mark.parametrize("S", [33, 48, 64, 200, 256])
def test_tk_wide_kernel_slot_edges(cuda, S, palette):
    """The wide kernel scans the valid rows only, in slot order, padded to
    groups of 16: invalid slots below the first valid one that hold its
    colors, no valid color (slot 0), a single valid slot at S - 1 (255 at
    S = 256), partly padded groups, ties across a group boundary; each
    palette against its four kinds of tiles, bit-identical."""
    pix, mirror, pidx, pal, valid = t_tk.slot_edge_case(S, seed=S)
    keep = pidx == palette
    args = [torch.as_tensor(a[keep]) for a in (pix, mirror, np.zeros_like(pidx))]
    table = t_tk.pal_table(torch.as_tensor(pal[palette:palette + 1]),
                           torch.as_tensor(valid[palette:palette + 1]))
    want = t_tk.tk_select_plain(*args, table)
    got = t_tk.tk_select_wide(*(a.to(cuda) for a in args), table.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    if SLOT_EDGES[palette] == "no_valid":
        assert (want == 0).all()
    if SLOT_EDGES[palette] == "single_valid_last":
        assert (want == S - 1).all()
    if SLOT_EDGES[palette] == "invalid_below_first":
        assert (want >= S // 3).all()


@pytest.mark.cuda
@pytest.mark.parametrize("S", [16, 64])
def test_plain_thomas_knoll_path_on_the_card_matches_the_kernel(cuda, S):
    """use_pallas_tk=False on the card (plain tensor passes, no launch)
    gives the kernel's slots on one small clip's corpus."""
    import copy
    import dataclasses

    from tiler_tpu_torch.config import EncoderSettings
    from tiler_tpu_torch.models.convert import state_from_numpy, state_to_numpy
    from tiler_tpu_torch.pipeline import dither as t_dither
    from tiler_tpu_torch.pipeline.encoder import Encoder
    from tiler_tpu_torch.utils.clips import synthetic_clip

    settings = EncoderSettings(palette_count=8, palette_size=S, motion_predict_radius=4,
                               epu_knn_k=8, kmeans_iters=4)
    enc = Encoder(settings, device="cpu", log=None)
    enc.load_frames(synthetic_clip(4, 64, 96), 25.0)
    enc.predict_motion().reduce().prepare_palettes()
    snap = state_to_numpy(copy.copy(enc.state))
    got = {}
    for use_kernel in (True, False):
        before = t_tk.tk_select.launches + t_tk.tk_select_wide.launches
        st = t_dither.dither(state_from_numpy(copy.copy(snap), cuda),
                             dataclasses.replace(settings, use_pallas_tk=use_kernel))
        torch.cuda.synchronize()
        assert t_tk.tk_select.launches + t_tk.tk_select_wide.launches == before + use_kernel
        got[use_kernel] = st.corpus_pal_pixels.cpu()
    assert torch.equal(got[True], got[False])


@pytest.mark.cuda
@pytest.mark.parametrize("mixed", [1, 4])
def test_yliluoma2_on_the_card_matches_the_cpu(cuda, mixed):
    """All int32: the selected slots of a small chunk are bit-identical."""
    from tiler_tpu_torch.pipeline import dither as t_dither

    rng = np.random.default_rng(mixed)
    T, P, S = 37, 5, 16
    args = (torch.as_tensor(rng.integers(0, 256, (T, 8, 8, 3), dtype=np.uint8)),
            torch.as_tensor(rng.integers(0, 4, T, dtype=np.uint8)),
            torch.as_tensor(rng.integers(0, P, T, dtype=np.int32)),
            torch.as_tensor(rng.integers(0, 256, (P, S, 3), dtype=np.int32)),
            torch.as_tensor(rng.random((P, S)) < 0.8))
    want = t_dither.yliluoma2_select(*args, mixed, chunk=16)
    got = t_dither.yliluoma2_select(*(a.to(cuda) for a in args), mixed, chunk=16)
    assert torch.equal(got.cpu(), want)


def _yl_cases(S, seed, device):
    """Random tiles (a fifth of the slots invalid), Thomas Knoll's
    adversarial tiles (equal lumas, duplicates, no valid color, one valid
    slot), yl2_dither.range_case and, above 32 colors, the slot-edge tiles
    (valid counts that leave a group of 32 partly padded), each as (pix,
    mirror, pal_idx, pal4, valid) on ``device``."""
    from tiler_tpu_torch.kernels import yl2_dither as t_yl

    rng = np.random.default_rng(seed)
    T, P = 301, 7
    cases = [(rng.integers(0, 256, (T, 64, 3), dtype=np.uint8),
              rng.integers(0, 4, T, dtype=np.uint8), rng.integers(0, P, T, dtype=np.int32),
              rng.integers(0, 256, (P, S, 3), dtype=np.int32), rng.random((P, S)) < 0.8),
             t_tk.adversarial_case(S, seed=S, reps=1), t_yl.range_case(S, seed=S)]
    if S > 32:  # the wide palettes' edge cases
        cases.append(t_tk.slot_edge_case(S, seed=S))
    for pix, mirror, pidx, pal, valid in cases:
        yield (torch.as_tensor(pix, device=device), torch.as_tensor(mirror, device=device),
               torch.as_tensor(pidx, device=device),
               t_yl.pal4_table(torch.as_tensor(pal, device=device)),
               torch.as_tensor(valid, device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("mixed", [1, 4, 16])
@pytest.mark.parametrize("S", [16, 33, 256])
def test_yl2_kernel_matches_the_plain_passes(cuda, S, mixed):
    """yl2_select's slots and trial count equal the plain passes' on the
    card (random, adversarial, slot-edge and range tiles), one launch a
    call."""
    from tiler_tpu_torch.kernels import yl2_dither as t_yl

    for args in _yl_cases(S, S * 100 + mixed, cuda):
        want, want_trials = t_yl.yl2_select_plain(*args, mixed)
        before = t_yl.yl2_select.launches
        got, trials = t_yl.yl2_select(*args, mixed)
        torch.cuda.synchronize()
        assert t_yl.yl2_select.launches == before + 1
        assert torch.equal(got, want)
        assert int(trials) == int(want_trials)


@pytest.mark.cuda
def test_yliluoma2_encode_at_256_colors_writes_the_plain_passes_stream(cuda, tmp_path,
                                                                      monkeypatch):
    """An encode with Yliluoma2 at S = 256 on the card launches yl2_select
    once and no Thomas Knoll kernel, and writes the stream that the plain
    passes, put in the kernel's place on the card, write."""
    from tiler_tpu_torch.config import EncoderSettings
    from tiler_tpu_torch.kernels import yl2_dither as t_yl
    from tiler_tpu_torch.pipeline import dither as t_dither
    from tiler_tpu_torch.pipeline.encoder import Encoder
    from tiler_tpu_torch.utils.clips import synthetic_clip

    settings = EncoderSettings(palette_count=4, palette_size=256, motion_predict_radius=4,
                               epu_knn_k=8, kmeans_iters=4, dithering_use_thomas_knoll=False)
    clip = synthetic_clip(4, 64, 96)
    streams = {}
    for kernel in (True, False):
        if not kernel:
            monkeypatch.setattr(t_dither, "yl2_select", t_yl.yl2_select_plain)
        before = (t_yl.yl2_select.launches, t_tk.tk_select.launches,
                  t_tk.tk_select_wide.launches)
        path = str(tmp_path / f"{kernel}.gtm")
        enc = Encoder(settings, device=cuda, log=None).run_all(clip, 25.0, out_path=path)
        assert (t_yl.yl2_select.launches - before[0], t_tk.tk_select.launches - before[1],
                t_tk.tk_select_wide.launches - before[2]) == (int(kernel), 0, 0)
        assert enc.step_stats["yl2_candidates"] > 0
        streams[kernel] = open(path, "rb").read()
    assert streams[True] == streams[False]


@pytest.mark.cuda
def test_device_ingest_on_the_card_matches_the_cpu(cuda):
    """planar_to_rgb is bit-identical (fp32 passes without fused
    multiply-adds); resize_rgb within one code value (cuBLAS sums in
    another order)."""
    from tiler_tpu_torch.ops import resample as t_resample

    rng = np.random.default_rng(9)
    y = torch.as_tensor(rng.integers(0, 256, (3, 48, 72), dtype=np.uint8))
    u = torch.as_tensor(rng.integers(0, 256, (3, 24, 36), dtype=np.uint8))
    v = torch.as_tensor(rng.integers(0, 256, (3, 24, 36), dtype=np.uint8))
    lh = torch.from_numpy(t_resample.lanczos_matrix(48, 100))
    lw = torch.from_numpy(t_resample.lanczos_matrix(72, 150))
    want = t_resample.planar_to_rgb(y, u, v, None, None, out_h=48, out_w=72, resize=False)
    got = t_resample.planar_to_rgb(y.to(cuda), u.to(cuda), v.to(cuda), None, None,
                                   out_h=48, out_w=72, resize=False)
    assert torch.equal(got.cpu(), want)
    want = t_resample.planar_to_rgb(y, u, v, lh, lw, out_h=100, out_w=150, resize=True)
    got = t_resample.planar_to_rgb(y.to(cuda), u.to(cuda), v.to(cuda), lh.to(cuda),
                                   lw.to(cuda), out_h=100, out_w=150, resize=True)
    diff = (got.cpu().int() - want.int()).abs()
    assert got.shape == (3, 104, 152, 3) and int(diff.max()) <= 1
    assert float((diff != 0).float().mean()) <= 0.001


@pytest.mark.cuda
def test_knn_kernel_matches_plain(cuda):
    gen = torch.Generator().manual_seed(6)
    feats = torch.randn(1000, 192, generator=gen) * 50
    ds = torch.randn(8000, 192, generator=gen) * 50
    fa = t_knn.fold_cells(feats, 1024).to(cuda)
    dsTa = t_knn.knn_prep2(ds, 8192).to(cuda)
    before = t_knn.knn_bucket_top2.launches
    k1, k2 = t_knn.knn_bucket_top2(fa, dsTa)
    p1, p2 = t_knn.knn_bucket_top2_plain(fa, dsTa)
    torch.cuda.synchronize()
    assert t_knn.knn_bucket_top2.launches == before + 1
    # the same key up to f32 summation order: within a few key steps
    for a, b in ((k1, p1), (k2, p2)):
        ea = (a & ~0x1FF).view(torch.float32)
        eb = (b & ~0x1FF).view(torch.float32)
        assert torch.allclose(ea, eb, rtol=2.0 ** -12)
        assert (a == b).float().mean() >= 0.95


@pytest.mark.cuda
@pytest.mark.parametrize("mh,mw,K", [(3, 5, 192), (13, 21, 64)])
def test_blockify_kernel_matches_plain(cuda, mh, mw, K):
    F = torch.randn(8 * mh, 8 * mw, K, generator=torch.Generator().manual_seed(mh))
    F = F.to(torch.bfloat16)
    before = t_blk.blockify_field.launches
    got = t_blk.blockify_field(F.to(cuda))
    torch.cuda.synchronize()
    assert t_blk.blockify_field.launches == before + 1
    assert torch.equal(got.cpu().view(torch.int16), t_blk.blockify_field(F).view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("K", [3, 12, 27, 48, 75, 108, 147, 192])
def test_blockify_kernel_every_depth(cuda, K):
    """Every depth 3 r^2 the motion ranking reaches, on a field whose
    block counts are not powers of two: bit-identical."""
    F = torch.randn(8 * 13, 8 * 21, K, generator=torch.Generator().manual_seed(K))
    F = F.to(torch.bfloat16)
    before = t_blk.blockify_field.launches
    got = t_blk.blockify_field(F.to(cuda))
    torch.cuda.synchronize()
    assert t_blk.blockify_field.launches == before + 1
    assert torch.equal(got.cpu().view(torch.int16), t_blk.blockify_field(F).view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("hot", [False, True], ids=["clustered", "hot_block"])
@pytest.mark.parametrize("kk", [1, 16])
def test_ivf_topk_on_the_card_matches_the_cpu(cuda, kk, hot):
    """The IVF search (plain tensor passes) on the card against the CPU, on
    one layout, for clustered queries and for queries that all probe one
    cluster's blocks, over their capacity (2,362 of 8,192 probes drop):
    the same drops, ids equal on >= 98% of the entries, distances within
    one bf16 ulp plus 2^-18 of the largest |f|^2 (f32 sums in another
    order, then bf16)."""
    from tiler_tpu_torch.pipeline import ivf

    rng = np.random.RandomState(3)
    centers = rng.randn(40, 192).astype(np.float32) * 20
    label = rng.randint(0, 40, 4096)
    ds = torch.as_tensor(centers[label] + rng.randn(4096, 192).astype(np.float32))
    q = (ds[:1] + torch.as_tensor(rng.randn(1024, 192).astype(np.float32)) if hot
         else ds[rng.randint(0, 4096, 1024)] + 0.5)
    lay = ivf.ivf_layout(ds, label, 64)
    want = ivf.ivf_search(q, lay, kk)
    got = ivf.ivf_search(q.to(cuda), ivf.IVFState(*(x.to(cuda) for x in lay)), kk)
    idx, err, dropped = (x.cpu() for x in got)
    assert int(dropped.sum()) == int(want[2].sum()) and bool(dropped.any()) == hot
    assert float((dropped == want[2]).float().mean()) >= 0.98
    assert float((idx == want[0]).float().mean()) >= 0.98
    ulp = 2.0 ** (torch.floor(torch.log2(torch.maximum(err.abs(), want[1].abs()) + 1e-30)) - 7)
    scale = 2.0 ** -18 * float((q * q).sum(1).max())
    assert bool(((err - want[1]).abs() <= ulp + scale).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dims,field", [(48, "passes"), (27, "im2row"), (3, "im2row")])
def test_rank_dims_motion_on_the_card_matches_the_cpu(cuda, dims, field):
    """motion_rank_dims < 192 on the card (the im2row field through the
    blockify kernel at K = dims) against the CPU: vectors agree except on
    near-ties, the exact errors within 1e-5 relative where they agree."""
    from tiler_tpu_torch.ops.metrics import euclidean_to_psnr
    from tiler_tpu_torch.pipeline import motion
    from tiler_tpu_torch.utils.clips import synthetic_clip

    clip = torch.as_tensor(synthetic_clip(2, 72, 128, seed=4))
    before = t_blk.blockify_field.launches
    gy, gx, ge = (v.cpu() for v in motion.motion_search(
        clip[1].to(cuda), clip[0].to(cuda), 16, field_impl=field, rank_dims=dims))
    assert t_blk.blockify_field.launches == before + (field == "im2row")
    wy, wx, we = motion.motion_search(clip[1], clip[0], 16, field_impl=field, rank_dims=dims)
    same = (gy == wy) & (gx == wx)
    tie = (euclidean_to_psnr(ge) >= 51.0) & (euclidean_to_psnr(we) >= 51.0)
    assert float((same | tie).float().mean()) >= 0.99
    assert torch.allclose(ge[same], we[same], rtol=1e-5)


@pytest.mark.cuda
def test_knn_v1_kernel_matches_plain(cuda):
    gen = torch.Generator().manual_seed(8)
    feats = torch.randn(1000, 192, generator=gen) * 50
    dsT, d2 = t_knn.knn_prep_v1(torch.randn(8000, 192, generator=gen) * 50, 8192)
    fb = torch.nn.functional.pad(feats.to(torch.bfloat16), (0, 0, 0, 24))
    before = t_knn.knn_bucket_top2_v1.launches
    k1, k2 = t_knn.knn_bucket_top2_v1(fb.to(cuda), dsT.to(cuda), d2.to(cuda))
    p1, p2 = t_knn.knn_bucket_top2_v1_plain(fb, dsT, d2)
    torch.cuda.synchronize()
    assert t_knn.knn_bucket_top2_v1.launches == before + 1
    # the same signed key up to f32 summation order: within a few key steps
    for a, b in ((k1.cpu(), p1), (k2.cpu(), p2)):
        ea = t_knn.sortable(a & ~0x1FF).view(torch.float32)
        eb = t_knn.sortable(b & ~0x1FF).view(torch.float32)
        assert torch.allclose(ea, eb, rtol=2.0 ** -12)
        assert (a == b).float().mean() >= 0.95


def _exact_knn_case(N, T, seed):
    """Small integer features in [-4, 4]: every product, partial sum and
    |f|^2 split (< 2^12, so hi + lo is exact in bf16) is an exact f32
    integer, so any summation order gives the same bits. A third of the
    cells copy corpus tiles and every seventh tile repeats the one before,
    so B2's zero distances tie and must go to the lowest lane."""
    rng = np.random.default_rng(seed)
    ds = rng.integers(-4, 5, (T, 192)).astype(np.float32)
    ds[1::7] = ds[0::7][:len(ds[1::7])]
    feats = rng.integers(-4, 5, (N, 192)).astype(np.float32)
    feats[:N // 3] = ds[rng.integers(0, T, N // 3)]
    return torch.from_numpy(feats), torch.from_numpy(ds)


# (N cells, T tiles, padded Tp): several cell blocks over 16 buckets; one
# bucket; an odd bucket count; Np of one cell block. Every bucket holds at
# least two real tiles, so the padded columns (whose 1e30 norm rounds
# with the order of the sum) never reach a top-2.
KNN_SHAPES = [(1000, 8000, 8192), (200, 512, 512), (700, 4600, 4608),
              (t_knn.CELL_BLOCK, 4608, 4608)]


def _v1_operands(feats, ds, Tp):
    Np = -(-feats.shape[0] // t_knn.CELL_BLOCK) * t_knn.CELL_BLOCK
    fb = torch.nn.functional.pad(feats.to(torch.bfloat16), (0, 0, 0, Np - feats.shape[0]))
    return (fb, *t_knn.knn_prep_v1(ds, Tp))


@pytest.mark.cuda
@pytest.mark.parametrize("N,T,Tp", KNN_SHAPES)
def test_knn_kernel_exact(cuda, N, T, Tp):
    feats, ds = _exact_knn_case(N, T, N + T)
    fa = t_knn.fold_cells(feats, -(-N // t_knn.CELL_BLOCK) * t_knn.CELL_BLOCK)
    dsTa = t_knn.knn_prep2(ds, Tp)
    want = t_knn.knn_bucket_top2_plain(fa, dsTa)
    got = t_knn.knn_bucket_top2(fa.to(cuda), dsTa.to(cuda))
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    # each copied cell finds a zero distance (tied where its tile repeats)
    assert bool(((want[0][:, :N // 3] & ~0x1FF) == 0).any(dim=0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("N,T,Tp", KNN_SHAPES)
def test_knn_v1_kernel_exact(cuda, N, T, Tp):
    fb, dsT, d2 = _v1_operands(*_exact_knn_case(N, T, N + T + 1), Tp)
    want = t_knn.knn_bucket_top2_v1_plain(fb, dsT, d2)
    got = t_knn.knn_bucket_top2_v1(fb.to(cuda), dsT.to(cuda), d2.to(cuda))
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("v1", [False, True])
@pytest.mark.parametrize("N,T,Tp", KNN_SHAPES[1:])
def test_knn_kernels_ragged_shapes(cuda, v1, N, T, Tp):
    """Random features at the ragged shapes, to today's tolerance: keys
    within 2^-12 relative and >= 95% identical."""
    gen = torch.Generator().manual_seed(N + T)
    feats = torch.randn(N, 192, generator=gen) * 50
    ds = torch.randn(T, 192, generator=gen) * 50
    if v1:
        args = _v1_operands(feats, ds, Tp)
        plain, kernel = t_knn.knn_bucket_top2_v1_plain, t_knn.knn_bucket_top2_v1
        decode = lambda key: t_knn.sortable(key & ~0x1FF).view(torch.float32)  # noqa: E731
    else:
        args = (t_knn.fold_cells(feats, -(-N // t_knn.CELL_BLOCK) * t_knn.CELL_BLOCK),
                t_knn.knn_prep2(ds, Tp))
        plain, kernel = t_knn.knn_bucket_top2_plain, t_knn.knn_bucket_top2
        decode = lambda key: (key & ~0x1FF).view(torch.float32)  # noqa: E731
    want = plain(*args)
    got = kernel(*(a.to(cuda) for a in args))
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        a = a.cpu()
        assert torch.allclose(decode(a), decode(b), rtol=2.0 ** -12)
        assert (a == b).float().mean() >= 0.95


@pytest.mark.cuda
def test_im2row_motion_on_the_card_matches_the_cpu(cuda):
    """The im2row field and motion search on the card (cuBLAS f32 product,
    blockify kernel) against the CPU (plain versions): vectors agree
    except on near-ties, as in the CPU tests against the JAX package."""
    from tiler_tpu_torch.ops.metrics import euclidean_to_psnr
    from tiler_tpu_torch.pipeline import motion
    from tiler_tpu_torch.utils.clips import synthetic_clip

    clip = torch.as_tensor(synthetic_clip(2, 72, 128, seed=4))
    before = t_blk.blockify_field.launches
    gy, gx, ge = (v.cpu() for v in motion.motion_search(clip[1].to(cuda), clip[0].to(cuda),
                                                         16, field_impl="im2row"))
    assert t_blk.blockify_field.launches == before + 1
    wy, wx, we = motion.motion_search(clip[1], clip[0], 16, field_impl="im2row")
    same = (gy == wy) & (gx == wx)
    tie = (euclidean_to_psnr(ge) >= 51.0) & (euclidean_to_psnr(we) >= 51.0)
    assert float((same | tie).float().mean()) >= 0.99
    assert torch.allclose(ge[same], we[same], rtol=1e-5)


def _write_y4m(path, frames, fps):
    """C444 y4m of RGB frames (the JAX package's io/export.py layout)."""
    H, W = frames[0].shape[:2]
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{W} H{H} F{round(fps * 1000000)}:1000000 Ip C444\n".encode())
        for fr in frames:
            rgb = fr.astype(np.float32)
            y = rgb[..., 0] * 0.299 + rgb[..., 1] * 0.587 + rgb[..., 2] * 0.114
            planes = (y, (rgb[..., 2] - y) * 0.492 + 128, (rgb[..., 0] - y) * 0.877 + 128)
            f.write(b"FRAME \n" + b"".join(
                np.clip(np.round(p), 0, 255).astype(np.uint8).tobytes() for p in planes))


@pytest.mark.cuda
def test_cli_settings_file_encodes_on_the_card(cuda, tmp_path):
    """The reference's single-argument form: python -m tiler_tpu_torch
    settings.ini runs the whole encode on the card."""
    import subprocess
    import sys
    from pathlib import Path

    from tiler_tpu_torch.bitstream.gtm import GTMDecoder

    rng = np.random.default_rng(7)
    frames = np.clip(np.cumsum(rng.integers(-8, 9, (4, 48, 64, 3)), axis=0) + 128,
                     0, 255).astype(np.uint8)
    src, out, ini = tmp_path / "clip.y4m", tmp_path / "out.gtm", tmp_path / "s.ini"
    _write_y4m(str(src), list(frames), 25.0)
    ini.write_text(f"[Load]\nInputFileName={src}\nOutputFileName={out}\n"
                   "[Dither]\nPaletteCount=8\n[MotionPredict]\nMotionPredictRadius=4\n")
    subprocess.run([sys.executable, "-m", "tiler_tpu_torch", str(ini)], check=True,
                   capture_output=True, timeout=600, cwd=Path(__file__).resolve().parents[1])
    assert len(GTMDecoder(str(out)).decode_frames()) == len(frames)


@pytest.mark.cuda
def test_cli_settings_file_yliluoma2_and_scaling_on_the_card(cuda, tmp_path):
    """DitheringUseThomasKnoll=0 and Scaling=2 in the settings file: the
    y4m goes up as planes, is resampled on the card, and encodes."""
    import subprocess
    import sys
    from pathlib import Path

    from tiler_tpu_torch.bitstream.gtm import GTMDecoder

    rng = np.random.default_rng(7)
    frames = np.clip(np.cumsum(rng.integers(-8, 9, (4, 24, 32, 3)), axis=0) + 128,
                     0, 255).astype(np.uint8)
    src, out, ini = tmp_path / "clip.y4m", tmp_path / "out.gtm", tmp_path / "s.ini"
    _write_y4m(str(src), list(frames), 25.0)
    ini.write_text(f"[Load]\nInputFileName={src}\nOutputFileName={out}\nScaling=2\n"
                   "[Dither]\nPaletteCount=8\nDitheringUseThomasKnoll=0\n"
                   "[MotionPredict]\nMotionPredictRadius=4\n")
    subprocess.run([sys.executable, "-m", "tiler_tpu_torch", str(ini)], check=True,
                   capture_output=True, timeout=600, cwd=Path(__file__).resolve().parents[1])
    decoded = GTMDecoder(str(out)).decode_frames()
    assert len(decoded) == len(frames) and decoded[0].shape[:2] == (48, 64)


def _mesh_cases(device_type, out_path):
    """sharded_topk, sharded_kmeans and a small (1, 1)-mesh encode in a
    group of one rank (NCCL for cuda, gloo for cpu), results on the host."""
    import torch.distributed as dist

    from tiler_tpu_torch.bitstream.gtm import GTMDecoder
    from tiler_tpu_torch.config import EncoderSettings
    from tiler_tpu_torch.parallel import mesh as t_mesh
    from tiler_tpu_torch.parallel.kmeans import sharded_kmeans
    from tiler_tpu_torch.parallel.knn import sharded_topk
    from tiler_tpu_torch.pipeline.encoder import Encoder
    from tiler_tpu_torch.utils.clips import synthetic_clip

    dist.init_process_group(t_mesh.BACKENDS[device_type], world_size=1, rank=0,
                            init_method=f"tcp://127.0.0.1:{t_mesh.free_port()}")
    try:
        mesh = t_mesh.make_mesh(1, ("data", "corpus"), device_type=device_type)
        dev = t_mesh.rank_device(mesh.device_type)
        rng = np.random.default_rng(11)
        feats = torch.as_tensor(rng.standard_normal((2048, 192)).astype(np.float32), device=dev)
        ds = torch.as_tensor(rng.standard_normal((20000, 192)).astype(np.float32), device=dev)
        idx, err = sharded_topk(feats, ds, 64, mesh)
        pts = torch.as_tensor(rng.standard_normal((5001, 24)).astype(np.float32) * 3,
                              device=dev)
        w = torch.as_tensor(rng.integers(0, 4, 5001).astype(np.float32), device=dev)
        cents, assign, _ = sharded_kmeans(pts, 64, weights=w, iters=30, seed=2, mesh=mesh)
        enc = Encoder(EncoderSettings(palette_count=8, motion_predict_radius=4, epu_knn_k=8,
                                      kmeans_iters=4), log=None, mesh=mesh)
        enc.run_all(synthetic_clip(6, 64, 96), fps=25.0, out_path=out_path)
        frames = np.stack(GTMDecoder(out_path).decode_frames())[..., :3]
        mse = np.mean((frames.astype(np.float64) - synthetic_clip(6, 64, 96)) ** 2)
        return {"idx": idx.cpu().numpy(), "err": err.cpu().numpy(),
                "cents": cents.cpu().numpy(), "assign": assign.cpu().numpy(),
                "d64": _d64(feats.cpu().numpy(), ds.cpu().numpy()),
                "psnr": 10 * np.log10(255 * 255 / mse), "bytes": enc.stats.total_bytes,
                "frames": len(frames), "device": enc.device.type,
                "knn_kernel_cells": enc.step_stats["knn_kernel_cells"]}
    finally:
        dist.destroy_process_group()


def _d64(feats, ds):
    f, d = feats.astype(np.float64), ds.astype(np.float64)
    return (f * f).sum(1)[:, None] - 2 * f @ d.T + (d * d).sum(1)[None]


@pytest.mark.cuda
def test_mesh_of_one_card_matches_the_cpu(cuda, tmp_path):
    """sharded_topk, sharded_kmeans and a mesh encode in an NCCL group of
    one rank on the card, against the same in a gloo group on the CPU:
    top-k indices equal but at float32 near-ties and errors within 1e-4
    relative (the card sums the product in another order), centroids
    within 1e-5 relative, the encodes within docs/DETERMINISM.md's 0.1 dB
    and 2% bytes. The group is destroyed after each run."""
    got = _mesh_cases("cuda", str(tmp_path / "card.gtm"))
    want = _mesh_cases("cpu", str(tmp_path / "cpu.gtm"))
    assert got["device"] == "cuda" and want["device"] == "cpu"
    np.testing.assert_allclose(got["err"], want["err"], rtol=1e-4, atol=1e-3)
    rows, cols = np.nonzero(got["idx"] != want["idx"])
    d64 = want["d64"]
    gap = np.abs(d64[rows, got["idx"][rows, cols]] - d64[rows, want["idx"][rows, cols]])
    assert np.all(gap <= 1e-4 * np.abs(d64[rows]).max(axis=1))
    np.testing.assert_allclose(got["cents"], want["cents"], rtol=1e-5,
                               atol=1e-5 * np.abs(want["cents"]).max())
    assert got["knn_kernel_cells"] == 0 and got["frames"] == 6
    assert abs(got["psnr"] - want["psnr"]) <= 0.1
    assert abs(got["bytes"] - want["bytes"]) <= 0.02 * want["bytes"]


def _epu_case(T, P, S, cells, kk, kp, seed, device):
    """A seeded corpus of T tiles at S colours, P palettes, and cells each
    with kk candidate tiles and their first kp tiles' own palettes, as
    phase A hands them to the EPU re-rank."""
    from tiler_tpu_torch.ops.color import rgb_to_yuv
    from tiler_tpu_torch.pipeline import reconstruct as t_rec

    g = torch.Generator().manual_seed(seed)
    pp = torch.randint(0, S, (T, 8, 8), generator=g, dtype=torch.uint8)
    palettes = torch.randint(0, 256, (P, S, 3), generator=g, dtype=torch.uint8)
    pal_initial = torch.randint(0, P, (T,), generator=g)
    _, feats = t_rec._features(torch.randint(0, 256, (cells, 8, 8, 3), generator=g).float(),
                               False)
    idx = torch.stack([torch.randperm(T, generator=g)[:kk] for _ in range(cells)])
    return [a.to(device) for a in (pp, palettes, rgb_to_yuv(palettes.float()), feats, idx,
                                   pal_initial[idx[:, :kp]])]


@pytest.mark.cuda
def test_epu_table_picks_lie_within_the_gap_at_s256(cuda):
    """The wide shape (S = 256, P = 16: the card takes the [T, P] Q . R
    table): the picks of 512 cells among 64 x 16 candidate pairs lie
    within epu_gap 1e-6 of the float64 best pair, as the benchmark's
    reference measures it, at the chunk phase A gives them."""
    from gtm_bench.reference import epu
    from tiler_tpu_torch.pipeline import reconstruct as t_rec

    S, P, kk, kp = 256, 16, 64, 16
    pp, palettes, pal_yuv, feats, idx, cand_pal = _epu_case(2000, P, S, 512, kk, kp, 256, cuda)
    assert t_rec._epu_table(cuda, P, S)
    G, QR = t_rec._epu_tables(pp, S, rall=t_rec._rall(pal_yuv, S))
    assert QR.shape == (2000, P) and QR.dtype == torch.float32
    chunk = max(1, min(4096, int(3e8 / (kk * (64 * S * (2 + 4) + kp * 4)))))
    t, p = t_rec._epu_rank_all(feats, idx, cand_pal, G, QR, pal_yuv, S, chunk, table=True)
    assert epu.gap(feats, idx, cand_pal, t, p, pp, palettes) <= 1e-6


@pytest.mark.cuda
def test_epu_table_cells_count_the_cells_re_ranked(cuda, tmp_path):
    """A wide-palette encode on the card: phase A builds the table, every
    re-rank is given it, and ``epu_table_cells`` is the count of cells
    re-ranked."""
    from tiler_tpu_torch.config import EncoderSettings
    from tiler_tpu_torch.pipeline import reconstruct as t_rec
    from tiler_tpu_torch.pipeline.encoder import Encoder
    from tiler_tpu_torch.utils.clips import synthetic_clip

    seen = []
    rank = t_rec._epu_rank_all

    def spy(feats, cand_idx, cand_pal, G, Q, *args, **kw):
        assert kw.get("table") and Q.shape == (G.shape[0], 16)
        seen.append(feats.shape[0])
        return rank(feats, cand_idx, cand_pal, G, Q, *args, **kw)

    t_rec._epu_rank_all = spy
    try:
        enc = Encoder(EncoderSettings(palette_count=16, palette_size=256, motion_predict_radius=4,
                                      epu_knn_k=16, kmeans_iters=4), log=None, device=cuda)
        enc.run_all(synthetic_clip(4, 64, 96), fps=25.0, out_path=str(tmp_path / "w.gtm"))
    finally:
        t_rec._epu_rank_all = rank
    assert seen and enc.step_stats["epu_table_cells"] == sum(seen)


@pytest.mark.cuda
def test_epu_default_shape_keeps_the_per_cell_product(cuda):
    """At the default's shape (S = 16, P = 1,024 > X = 408) the card does
    not take the table: the re-rank as phase A calls it picks bit for bit
    as the per-cell product of the gathered Q and R rows."""
    from tiler_tpu_torch.pipeline import reconstruct as t_rec

    S, P, kk, kp = 16, 1024, 64, 16
    pp, _, pal_yuv, feats, idx, cand_pal = _epu_case(4000, P, S, 1024, kk, kp, 16, cuda)
    table = t_rec._epu_table(cuda, P, S)
    assert not table
    G, Q = t_rec._epu_tables(pp, S)
    got = t_rec._epu_rank_all(feats, idx, cand_pal, G, Q, pal_yuv, S, 256, table=table)
    w = torch.as_tensor(t_rec.DCT_WEIGHTS, dtype=torch.float32, device=cuda)
    wf = w.permute(1, 2, 0).reshape(64, 3)
    Rall = t_rec._rall(pal_yuv, S)
    tiles, pals = [], []
    for i in range(0, len(feats), 256):
        ci, cp = idx[i:i + 256].long(), cand_pal[i:i + 256].long()
        b = len(ci)
        Gi = G[ci].float()
        ftw = t_rec._ftw(feats[i:i + 256], wf).to(torch.bfloat16).float()
        C = torch.bmm(Gi.transpose(2, 3).reshape(b, kk * S, 64), ftw).reshape(b, kk, S * 3)
        err = (torch.bmm(Q[ci], Rall[cp].transpose(1, 2))
               - 2.0 * torch.bmm(C, pal_yuv[cp].reshape(b, kp, S * 3).transpose(1, 2)))
        tile = ci[:, :, None].expand(b, kk, kp).reshape(b, -1)
        pal = cp[:, None, :].expand(b, kk, kp).reshape(b, -1)
        t, p, _ = t_rec._tie_break(err.reshape(b, -1), tile, pal, P)
        tiles.append(t)
        pals.append(p)
    assert torch.equal(got[0], torch.cat(tiles)) and torch.equal(got[1], torch.cat(pals))
