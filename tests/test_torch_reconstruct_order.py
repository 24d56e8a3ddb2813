"""The port's CPU reconstruct computes what the JAX package's computes, bit
for bit (ROADMAP C1).

Phase A ranks bf16 distances and EPU pair errors where neighbours lie a
unit in the last place apart, so the port's CPU reconstruct follows the
order of XLA's CPU build (``tiler_tpu_torch/ops/ordered.py``,
``ops/introsort.py``, ``pipeline/reconstruct.py``):

- the ordered sums against the XLA ops they copy: a batched float32 dot
  as four FMA lanes, a batched bf16 dot as the AVX-512 BF16 pair sum,
  the ranking product from k = 0, and the order of equal keys that the
  CPU's unstable sort leaves;
- the cell features, through the exact errors the reference's compiled
  ``_knn_all_frames`` returns for them;
- the corpus top-k with planted ties against ``_topk_oneshot``;
- the EPU pick of cells with planted near-ties against ``_epu_rank_all``;
- phase B's errors and decisions against ``_phase_b_scan`` on one
  keyframe, with KNN errors planted at both TOL comparisons;
- load's inter-frame correlations against ``_load_chunk``, at a tile
  count that is a multiple of 32 and at one that is not (XLA sums the
  first Pearson operand in other windows there).

The ``xla_rec_order`` fixture skips these, with the reason, on a host
whose XLA computes otherwise (another CPU, or one without AVX-512 BF16).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_motion_order import _jit, motion_order_skip_reason

from bench import synthetic_clip
from tiler_tpu.ops.color import rgb_to_yuv as j_yuv
from tiler_tpu.pipeline import reconstruct as j_rec
from tiler_tpu_torch.ops import ordered
from tiler_tpu_torch.ops.introsort import sorted_prefix
from tiler_tpu_torch.pipeline import reconstruct as t_rec


def _lanes_case(B, M, K, N, seed):
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal((B, M, K)) * rng.uniform(0.1, 300, (1, 1, K))).astype(np.float32)
    b = (rng.standard_normal((B, N, K)) * rng.uniform(0.1, 300, (1, 1, K))).astype(np.float32)
    return a, b


def _xla_sort_prefix(keys, k):
    """The first k indexes of each row of bf16 keys as the reference's CPU
    top-k (an unstable sort of -key, its values kept as _topk_oneshot
    keeps them: without them XLA sorts otherwise) leaves them."""
    with jax.enable_x64(False):
        return np.asarray(jax.jit(lambda d: jax.lax.approx_max_k(
            -d.astype(jnp.bfloat16), k, recall_target=0.95))(keys)[1])


def reconstruct_order_skip_reason():
    """Why the host's XLA does not compute reconstruct as the port's CPU
    path assumes, or None: the motion search's probes, then a batched
    float32 dot summed in four FMA lanes, a batched bf16 dot summed in
    the AVX-512 BF16 pair order, and the unstable sort's order of equal
    keys as libstdc++'s introsort leaves it."""
    reason = motion_order_skip_reason()
    if reason:
        return reason
    a, b = _lanes_case(4, 8, 48, 8, 0)
    got = _jit(lambda x, y: jnp.einsum("bmk,bnk->bmn", x, y), a, b)
    want = ordered.lanes4_sum(torch.from_numpy(a)[:, :, None], torch.from_numpy(b)[:, None])
    if not np.array_equal(got, want.numpy()):
        return f"this host's XLA (jax {jax.__version__}) sums a batched dot otherwise"
    ab, bb = (jnp.asarray(v, jnp.bfloat16) for v in _lanes_case(4, 8, 64, 3, 1))
    got = _jit(lambda x, y: jnp.einsum("bmk,bnk->bmn", x, y, preferred_element_type=jnp.float32),
               ab, bb)
    x, y = (torch.from_numpy(np.asarray(v, np.float32)) for v in (ab, bb))
    if not np.array_equal(got, ordered.bf16_pairs_sum(x[:, :, None], y[:, None]).numpy()):
        return (f"this host's XLA (jax {jax.__version__}) sums a batched bf16 dot otherwise "
                "(no AVX-512 BF16?)")
    keys = np.random.default_rng(2).integers(0, 6, (4, 256)).astype(np.float32)
    want = [sorted_prefix(r, [8])[8] for r in keys]
    if any(set(g) != set(w) for g, w in zip(_xla_sort_prefix(keys, 8), want)):
        return f"this host's XLA (jax {jax.__version__}) sorts equal keys otherwise"
    return None


@pytest.fixture(scope="module")
def xla_rec_order():
    """Skip unless the host's XLA computes as the port's ordered
    reconstruct assumes."""
    reason = reconstruct_order_skip_reason()
    if reason:
        pytest.skip(reason)


@pytest.mark.parametrize("form, K", [("bkx,bjx->bkj", 408), ("bkx,bxj->bkj", 48),
                                     ("bxk,bxj->bkj", 64)])
def test_batched_dots_are_xla_dots(form, K, xla_rec_order):
    """The EPU's Q . R (408 terms, both operands contracted over their
    last axis) and C . Py (48, the right one over its middle axis) in four
    FMA lanes; the quadratic table's form (both over their middle axis)
    in one FMA chain."""
    a, b = _lanes_case(64, 16, K, 16, seed=K)
    x, y = torch.from_numpy(a)[:, :, None], torch.from_numpy(b)[:, None]
    if form == "bkx,bjx->bkj":
        args, got = (a, b), ordered.lanes4_sum(x, y)
    elif form == "bkx,bxj->bkj":
        args, got = (a, b.transpose(0, 2, 1).copy()), ordered.lanes4_sum(x, y)
    else:
        args, got = (a.transpose(0, 2, 1).copy(), b.transpose(0, 2, 1).copy()), ordered.fma_dot(x, y)
    want = _jit(lambda u, v: jnp.einsum(form, u, v, precision=jax.lax.Precision.HIGH), *args)
    assert np.array_equal(got.numpy(), want)


def _chain_exact(x, y):
    """fma_dot's chain with every step the exact rounding of its sum."""
    xd, yd = x.double(), y.double()
    acc = x[..., 0] * y[..., 0]
    for k in range(1, x.shape[-1]):
        acc = ordered._fma32_exact(xd[..., k] * yd[..., k], acc.double())
    return acc


@pytest.mark.parametrize("case", ["random", "midpoint", "tiny"])
def test_fma_chain_flags_every_double_rounding(case):
    """The CPU chain's float64 steps, with the elements whose sum lands on
    a float32 midpoint or below the normal range summed again exactly,
    equal the exact chain; ``tiny`` takes the path without the coarse
    shortcut (products near 2^-140)."""
    rng = np.random.default_rng(7)
    x, y = (torch.from_numpy(rng.standard_normal((4096, 16)).astype(np.float32)) for _ in "xy")
    if case == "midpoint":  # step 1 is (2^13 + 2^-10)(2^13 - 2^-10) onto 2^50 + 2^27
        x[:64, 0], y[:64, 0] = 2.0 ** 50 + 2.0 ** 27, 1.0
        x[:64, 1], y[:64, 1] = 8192 + 2.0 ** -10, 8192 - 2.0 ** -10
    if case == "tiny":
        x[:2048] *= 2.0 ** -70
    assert ordered._coarse(x, y) == (case != "tiny")
    got = ordered.fma_dot(x, y)
    assert torch.equal(got.view(torch.int32), _chain_exact(x, y).view(torch.int32))
    if case == "midpoint":  # where float64 steps alone round twice
        naive = x[:64, 0] * y[:64, 0]
        for k in range(1, 16):
            naive = (naive.double() + x[:64, k].double() * y[:64, k].double()).float()
        assert not torch.equal(naive, got[:64])


@pytest.mark.parametrize("S", [8, 16, 32])
def test_quadratic_table_is_xla_tile_quad(S, xla_rec_order):
    """The EPU's quadratic table Q of a corpus: torch's bmm gives the
    reference's _tile_quad bits (one FMA chain over the 64 coefficients)."""
    pp, _, _ = _corpus(256, S, 4, seed=S)
    _, got = t_rec._epu_tables(torch.from_numpy(pp), S)
    G = j_rec._indicator_dcts(pp, S).astype(jnp.bfloat16)
    want = _jit(lambda g: j_rec._tile_quad(g, S), G)
    assert np.array_equal(got.numpy().view(np.int32), np.asarray(want).view(np.int32))


def test_bf16_pairs_sum_is_xla_bf16_dot(xla_rec_order):
    """The EPU's C = G_i ftw at its shape: [cells, kk S, 64] by [cells, 64, 3]."""
    rng = np.random.default_rng(5)
    g = jnp.asarray(rng.standard_normal((64, 1024, 64)), jnp.bfloat16)
    f = jnp.asarray(rng.standard_normal((64, 64, 3)) * 300, jnp.bfloat16)
    want = _jit(lambda x, y: jnp.einsum("bmv,bvc->bmc", x, y, preferred_element_type=jnp.float32),
                g, f)
    x, y = (torch.from_numpy(np.asarray(v, np.float32)) for v in (g, f))
    got = ordered.bf16_pairs_sum(x[:, :, None, :], y.transpose(1, 2)[:, None])
    assert np.array_equal(got.numpy(), want)


def test_ranking_product_sums_from_k0(xla_rec_order):
    """The top-k's product of bf16 cell and corpus features, [cells, T]:
    XLA adds the exact products from k = 0 in float32."""
    rng = np.random.default_rng(6)
    f, d = (torch.from_numpy(rng.standard_normal((n, 192)).astype(np.float32) * 300)
            .to(torch.bfloat16).float() for n in (64, 512))
    want = _jit(lambda a, b: jnp.matmul(a.astype(jnp.bfloat16), b.astype(jnp.bfloat16).T,
                                        preferred_element_type=jnp.float32), f.numpy(), d.numpy())
    got = ordered.seq_sum(f[:, None, :] * d[None, :, :])
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [256, 4096])
def test_sorted_prefix_is_xla_sort(n, xla_rec_order):
    """Rows of 3 to 40 distinct keys, sorted and reversed rows among them:
    the sets before the 16th and 64th places."""
    rng = np.random.default_rng(n)
    keys = np.stack([rng.integers(0, lev, n) for lev in (3, 7, 40, 40)]).astype(np.float32)
    keys = np.concatenate([keys, np.sort(keys[1:2]), np.sort(keys[2:3])[:, ::-1]])
    want = _xla_sort_prefix(keys, 64)
    for row, w in zip(keys, want):
        got = sorted_prefix(row, (16, 64))
        assert set(got[64]) == set(w) and set(got[16]) == set(w[:16])


def _corpus(T, S, P, seed):
    rng = np.random.default_rng(seed)
    pp = rng.integers(0, S, (T, 8, 8)).astype(np.uint8)
    palettes = rng.integers(0, 256, (P, S, 3)).astype(np.uint8)
    pal_initial = rng.integers(0, P, T).astype(np.int32)
    return pp, palettes, pal_initial


def test_features_through_knn_all_frames(xla_rec_order):
    """The compiled phase A (k = 1, no EPU) returns the exact error
    |feats - ds[t]|^2 of each cell's nearest tile; the port's ordered
    cell and corpus features give the same bits."""
    pp, palettes, pal_initial = _corpus(200, 16, 8, 0)
    tiles = synthetic_clip(1, 64, 128, seed=3)[0].reshape(8, 8, 16, 8, 3).swapaxes(1, 2)
    tiles = tiles.reshape(1, 128, 8, 8, 3)
    with jax.enable_x64(False):
        rendered = j_rec._render_corpus_dev(jnp.asarray(palettes), jnp.asarray(pal_initial),
                                            jnp.asarray(pp))
        dsj = j_rec.tile_features_raster(rendered.astype(jnp.float32))
        out = np.asarray(j_rec._knn_all_frames(
            jnp.asarray(tiles), dsj, jnp.zeros((1, 64, 16), jnp.bfloat16),
            jnp.zeros((1, 48), jnp.float32), jnp.asarray(pal_initial),
            j_yuv(jnp.asarray(palettes, jnp.float32)), jnp.asarray(pp), jnp.asarray(palettes),
            kk=1, pal_k=1, S=16, cell_chunk=64, epu=False, int16=False))
    z, feats = t_rec._features(torch.from_numpy(tiles[0]).float(), False, True)
    _, ds = t_rec._features(torch.from_numpy(np.array(rendered)).float(), False, True, False)
    t = torch.from_numpy((out[0, 0] >> 3).astype(np.int64))
    got = t_rec._sq_err(feats, ds[t], z)
    assert np.array_equal(got.numpy().view(np.int32), out[1, 0])


@pytest.mark.parametrize("k, pal_k", [(8, 8), (64, 16)])
def test_topk_with_planted_ties(k, pal_k, xla_rec_order):
    """Cells that copy corpus tiles, and a corpus with repeated tiles, so
    that equal keys straddle the k-th and pal_k-th places: the sets the
    reference's top-k puts before both places."""
    rng = np.random.default_rng(k)
    base = rng.integers(0, 256, (60, 8, 8, 3))
    corpus = np.concatenate([base, base[rng.integers(0, 60, 240)]]).astype(np.float32)
    cells = np.clip(corpus[rng.integers(0, 300, 64)] + rng.integers(-2, 3, (64, 8, 8, 3)), 0, 255)
    _, ds = t_rec._features(torch.from_numpy(corpus), False, True, False)
    _, feats = t_rec._features(torch.from_numpy(cells.astype(np.float32)), False, True)
    with jax.enable_x64(False):
        want = np.asarray(j_rec._topk_oneshot(jnp.asarray(feats.numpy()), jnp.asarray(ds.numpy()),
                                              k, 512)[0])
    got = t_rec._topk_ordered(feats, ds, ordered.row_sum(ds * ds), k, pal_k).numpy()
    for g, w in zip(got, want):
        assert set(g) == set(w) and set(g[:pal_k]) == set(w[:pal_k])


def test_epu_pick_with_near_ties(xla_rec_order):
    """Cells rendered from candidate pairs through palettes that repeat
    with a colour or two moved by one step, so that several pairs reach
    the least error or miss it by a unit in the last place."""
    S, P, T, kk, kp = 16, 12, 40, 8, 4
    pp, palettes, _ = _corpus(T, S, P // 2, 1)
    moved = palettes.copy()
    moved[:, 0] = np.clip(moved[:, 0].astype(int) + 1, 0, 255)
    palettes = np.concatenate([palettes, moved])
    rng = np.random.default_rng(7)
    cand_idx = np.sort(np.stack([rng.choice(T, kk, replace=False) for _ in range(96)]), axis=1)
    cand_pal = np.stack([rng.choice(P, kp, replace=False) for _ in range(96)])
    pick = rng.integers(0, kk, 96), rng.integers(0, kp, 96)
    cells = palettes[cand_pal[np.arange(96), pick[1]][:, None, None],
                     pp[cand_idx[np.arange(96), pick[0]]]].astype(np.float32)
    _, feats = t_rec._features(torch.from_numpy(cells), False, True)
    G, Q = t_rec._epu_tables(torch.from_numpy(pp), S)
    pal_yuv = t_rec.rgb_to_yuv(torch.from_numpy(palettes).float())
    with jax.enable_x64(False):
        jG = j_rec._indicator_dcts(pp, S).astype(jnp.bfloat16)
        jt, jp, _ = (np.asarray(a) for a in j_rec._epu_rank_all(
            jnp.asarray(feats.numpy()), jnp.asarray(cand_idx.astype(np.int32)),
            jnp.asarray(cand_pal.astype(np.int32)), jG,
            j_yuv(jnp.asarray(palettes, jnp.float32)), S, 32, Q=j_rec._tile_quad(jG, S)))
        assert np.array_equal(Q.numpy(), np.asarray(j_rec._tile_quad(jG, S)))
    t, p = t_rec._epu_rank_all(feats, torch.from_numpy(cand_idx), torch.from_numpy(cand_pal),
                               G, Q, pal_yuv, S, 32)
    assert np.array_equal(t.numpy(), jt) and np.array_equal(p.numpy(), jp)


def test_phase_b_reuse_bits(xla_rec_order):
    """One keyframe of five 64x96 frames through the reference's phase-B
    scan (reuse) and the port's: vectors, decisions and error bits, with
    the KNN errors of a third of the cells planted a unit in the last
    place around each TOL comparison."""
    clip = synthetic_clip(5, 64, 96, seed=4)
    F, th, tw = 5, 8, 12
    N = th * tw
    pp, palettes, _ = _corpus(50, 16, 4, 2)
    rng = np.random.default_rng(9)
    kt = rng.integers(0, 50, (F, N)).astype(np.int32)
    kp = rng.integers(0, 4, (F, N)).astype(np.int32)
    hm, vm = rng.random((F, N)) < 0.3, rng.random((F, N)) < 0.3
    pay, pax = rng.integers(-4, 5, (F, N)).astype(np.int32), rng.integers(-4, 5, (F, N)).astype(np.int32)
    args = [torch.from_numpy(a) for a in (clip, kt, kp, np.full((F, N), np.inf, np.float32),
                                          hm, vm, pay, pax)]
    # with no KNN error every cell predicts: the port's own motion errors,
    # which place the planted ones
    mperr = t_rec._phase_b_keyframe(*args, torch.from_numpy(pp), torch.from_numpy(palettes).long(),
                                    4, th, tw, "reuse", False, "passes", {})[3].numpy()
    ke = rng.uniform(0, 4e5, (F, N)).astype(np.float32)
    edge = mperr - np.float32(192)
    cell = np.arange(N)[None, :] % 9
    ke = np.where(cell == 0, np.nextafter(edge, -np.inf), ke)
    ke = np.where(cell == 3, edge, ke)
    ke = np.where(cell == 6, np.nextafter(edge, np.inf), ke).astype(np.float32)
    ke[0] = rng.uniform(0, 4e5, N)  # a keyframe's first frame never predicts
    args[3] = torch.from_numpy(ke)
    with jax.enable_x64(False):
        want = [np.asarray(a) for a in j_rec._phase_b_scan(
            *(jnp.asarray(a) for a in (clip, kt, kp, ke, hm, vm)),
            jnp.asarray(np.arange(F) == 0), jnp.asarray(pay), jnp.asarray(pax), jnp.asarray(pp),
            jnp.asarray(palettes), 4, th, tw, False, 192, "reuse")]
    got = [a.numpy() for a in t_rec._phase_b_keyframe(
        *args, torch.from_numpy(pp), torch.from_numpy(palettes).long(), 4, th, tw, "reuse",
        False, "passes", {})]
    for g, w in zip(got, want):
        assert np.array_equal(g.view(np.int32) if g.dtype == np.float32 else g,
                              w.view(np.int32) if w.dtype == np.float32 else w)
    assert got[2][1:].any() and not got[2][1:].all()  # both decisions taken


@pytest.mark.parametrize("shape, seed", [((6, 64, 96), 0), ((5, 48, 64), 2), ((8, 176, 320), 1)])
def test_load_correlations_bit_identical(shape, seed, xla_rec_order):
    """The mean LAB of each tile and the Pearson chain over consecutive
    frames, the bits the keyframes are decided on (at 176x320, seed 1,
    a float32 sqrt that is not correctly rounded moves one of them)."""
    from tiler_tpu.pipeline import load as j_load
    from tiler_tpu_torch.pipeline import load as t_load

    clip = synthetic_clip(*shape, seed=seed)
    want = _jit(lambda f: j_load._load_chunk(f)[2], clip)
    got = t_load._load_chunk(torch.from_numpy(clip))[2].numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
