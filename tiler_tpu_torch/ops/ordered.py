"""Float arithmetic in a fixed order, for the palettization, the motion
search, reconstruct and the load's correlations.

The palettization's k-means is chaotic: one feature that differs by a
unit in the last place can move a point to another centroid, and a few
iterations later most of the palettes differ. The motion search ranks
its candidates on bf16-rounded distances, so one feature a unit off can
pick another window, and reconstruct's top-k and EPU rank the same way.
So the port computes them in one fixed order, and in the order in which
the JAX package's CPU build evaluates them (XLA on x86-64; read from its
optimized HLO and its machine code, and held bit for bit by
``tests/test_torch_parity_gap.py``, ``tests/test_torch_motion_order.py``
and ``tests/test_torch_reconstruct_order.py``):

- :func:`row_sum`: XLA's tree reduction. A row longer than 32 is summed
  in windows of 32 (zero-padded, the padding split between both ends),
  each from left to right, then the window sums the same way. A
  reduction over another axis (``dim``; the motion search's mean tile
  feature sums over the leading axis) takes the same windows.
- :func:`segment_sum`: each row added to its segment in row order, as
  ``jax.ops.segment_sum`` and ``np.add.at`` add.
- :func:`fma32`: a float32 multiply-add rounded once, as the FMA that
  XLA's code generator emits for ``a * b + c``.
- :func:`lanes4_sum`: a small or batched float32 product whose left
  operand is contracted over its last axis, as XLA's CPU dot computes it
  (reconstruct's EPU pair errors, and :func:`dot8` for K = 8): four FMA
  accumulators over k mod 4, then (0 + 1) + (2 + 3).
- :func:`bf16_pairs_sum`: a batched bf16 product as XLA's CPU dot
  computes it on a CPU with AVX-512 BF16 (the EPU's per-candidate
  products): the exact products added in the order 1, 0, 3, 2, ...
- :func:`fold_lanes`: the fold of a vector's lanes into one sum (the
  load's mean LAB and Pearson sums): halves added until one is left.
- :func:`fma_dot`, :func:`dot_fma`: a product over any K as XLA's CPU
  dot library (Eigen) computes it for the K = 64 basis product of the
  motion search's and reconstruct's features: one FMA chain over k from
  left to right.
- :func:`fma_sum`: a fused sum of products ``a0 b0 + a1 b1 + ...`` as
  XLA's code generator contracts it: the second product rounded, the
  first fused with it, then each further product fused in order.
- :func:`powf`: glibc's ``powf`` (the ARM optimized-routines algorithm,
  glibc 2.28 and later), which XLA's CPU ``pow`` calls.
- :func:`log32`: XLA's own float32 ``log`` (Cephes' polynomial, as
  XLA's CPU code generator inlines it with its FMAs), which is not
  correctly rounded.

Each function is a chain of elementwise float32, float64 and integer
tensor operations, each rounded once, so it gives the same bits on the
CPU and on CUDA, at any thread count.

The order was read from one build: jax 0.9.0 on x86-64 with AVX-512 (and
AVX-512 BF16, which its batched bf16 dots run on) and glibc 2.36. Which
products XLA's code generator fuses into FMAs depends on how it
vectorizes, so another ISA, another jax or another libm can give the
reference other bits; the bit-equality tests probe the host's XLA first
and skip with the reason when it computes otherwise.

On a card these functions give one fixed order, not the reference's
bits for the whole palettization: there the k-means sums its squared
norms in one reduction and takes its products from cuBLAS, each in the
card's own fixed order. What they buy on a card is determinism.
"""
from __future__ import annotations

import torch

WINDOW = 32  # XLA's CPU tree-reduction window
WARP = 32
U32 = 2.0 ** -24  # float32's unit roundoff


def gamma(k: int) -> float:
    """gamma_k = k u / (1 - k u): a k-term float32 sum of products, in any
    order, lies within gamma_k sum |a_i b_i| of the exact sum."""
    return k * U32 / (1 - k * U32)


def seq_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis from left to right."""
    acc = x[..., 0]
    for j in range(1, x.shape[-1]):
        acc = acc + x[..., j]
    return acc


def row_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sum over ``dim`` (default the last axis) in XLA's CPU order: rows
    longer than ``WINDOW`` in windows of ``WINDOW``, recursively."""
    if dim not in (-1, x.dim() - 1):
        x = torch.movedim(x, dim, -1)
    n = x.shape[-1]
    if n <= WINDOW:
        return seq_sum(x)
    pad = -n % WINDOW
    x = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2))
    return row_sum(seq_sum(x.reshape(*x.shape[:-1], -1, WINDOW)))


def segment_sum(values: torch.Tensor, ids: torch.Tensor, k: int) -> torch.Tensor:
    """out[s] = the sum of values[i] over ids[i] == s, added in row order.

    On the CPU ``index_add_`` adds row after row at any thread count. On
    CUDA ``index_add_`` adds by atomics in no fixed order, so the rows go
    through ``index_put_(accumulate=True)``, which sorts the ids stably
    and adds each segment's rows in order; rows narrower than a warp are
    zero-padded past it first, because that kernel's variants for narrow
    rows reduce the duplicates across a warp."""
    out_shape = (k,) + tuple(values.shape[1:])
    if values.device.type == "cpu":
        return torch.zeros(out_shape, dtype=values.dtype).index_add_(0, ids.long(), values)
    v = values.reshape(values.shape[0], -1)
    width = v.shape[1]
    if width <= WARP:
        v = torch.nn.functional.pad(v, (0, WARP + 1 - width))
    out = torch.zeros((k, v.shape[1]), dtype=v.dtype, device=v.device)
    out.index_put_((ids.long(),), v, accumulate=True)
    return out[:, :width].reshape(out_shape)


def _two_sum(a, b):
    """s + t == a + b exactly, s the rounded sum."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


_HALF_ULP32 = 1 << 28  # a float32 midpoint's low 29 bits as a float64
_LOW29 = (1 << 29) - 1


def _double_rounds(s: torch.Tensor, p: torch.Tensor, c) -> torch.Tensor:
    """Where the float64 sum s = p + c of a float32 FMA can round to
    float32 other than the exact sum: where s lies on a float32 midpoint
    and is not exact, or below float32's normal range (but not 0: a float
    sum is 0 only when it is exactly 0)."""
    odd = (s.abs() < 2.0 ** -125) & (s != 0)
    mid = (s.view(torch.int64) & _LOW29) == _HALF_ULP32
    if bool(mid.any()):
        idx = mid.nonzero(as_tuple=True)
        odd[idx] = _two_sum(p.expand(s.shape)[idx], c.expand(s.shape)[idx])[1] != 0
    return odd


def fma32(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once (``b``, ``c``: tensors or
    Python floats that are float32 values). The product is exact in
    float64; the sum s + t is exact, and its float32 rounding is that of
    s except where s lies on a float32 midpoint (or below float32's
    normal range), where t decides. Only those few take the slow path."""
    p = a.double() * (b.double() if torch.is_tensor(b) else b)
    c = c.double() if torch.is_tensor(c) else torch.full_like(p, c)
    p, c = torch.broadcast_tensors(p, c)
    if p.device.type != "cpu":  # no host sync on a card: every element exactly
        return _fma32_exact(p, c)
    s = p + c
    r = s.float()
    odd = _double_rounds(s, p, c)
    if bool(odd.any()):
        idx = odd.nonzero(as_tuple=True)
        r[idx] = _fma32_exact(p[idx], c[idx])
    return r


def _fma32_exact(p: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 rounding of p + c (float64, p exact) by the exact sum."""
    s, t = _two_sum(p, c)
    r = s.float()
    lo = r.double()
    up = torch.nextafter(r, torch.full_like(r, torch.inf))
    dn = torch.nextafter(r, torch.full_like(r, -torch.inf))
    r = torch.where((t > 0) & (s == lo + (up.double() - lo) * 0.5), up, r)
    return torch.where((t < 0) & (s == lo + (dn.double() - lo) * 0.5), dn, r)


def _as64(v):
    return v.double() if torch.is_tensor(v) else v


def fma_chain(acc: torch.Tensor, pairs, normal: bool = False) -> torch.Tensor:
    """acc = fma(a, b, acc) for each (a, b) of ``pairs`` in order, each
    rounded once to float32 (tensors broadcast against acc; ``b`` may be
    a Python float32 value). On the CPU one float64 multiply-add a step;
    the few elements whose float64 sum lands on a float32 midpoint, or
    below float32's normal range, at some step run the whole chain again
    by exact sums. ``normal``: the caller knows that no nonzero sum can
    fall below the normal range (:func:`_coarse`), so that check is
    skipped."""
    if acc.device.type != "cpu":
        for a, b in pairs:
            acc = fma32(a, b, acc)
        return acc
    acc0, acc64, odd = acc, acc.double(), None
    for a, b in pairs:
        s = acc64 + _as64(a) * _as64(b)
        o = (s.view(torch.int64) & _LOW29) == _HALF_ULP32
        if not normal:
            o |= (s.abs() < 2.0 ** -125) & (s != 0)
        odd = o if odd is None else odd.logical_or_(o) if odd.shape == o.shape else odd | o
        acc64 = s.float().double()
    acc = acc64.float()
    if odd is not None and bool(odd.any()):
        idx = odd.nonzero(as_tuple=True)

        def pick(v):
            return v.expand(acc.shape)[idx].double() if torch.is_tensor(v) else v

        part = pick(acc0)
        for a, b in pairs:
            part = _fma32_exact(pick(a) * pick(b), part).double()
        acc[idx] = part.float()
    return acc


def _coarse(*ts: torch.Tensor) -> bool:
    """Whether every nonzero value of the float32 tensors ts is at least
    2^-40 in magnitude: then each product of two of them is a multiple of
    2^-126, and so is every sum of such products and of their float32
    roundings, so no nonzero sum falls below float32's normal range."""
    return all(bool((torch.where(t == 0, 1.0, t.abs()) >= 2.0 ** -40).all()) for t in ts)


def fma_sum(pairs) -> torch.Tensor:
    """``a0 * b0 + a1 * b1 + ...`` over (a, b) pairs of float32 tensors
    (or Python float32 values as b), as XLA contracts the chain: fma(a0,
    b0, a1 * b1), then fma(ak, bk, acc) for k = 2, 3, ..."""
    (a0, b0), (a1, b1) = pairs[0], pairs[1]
    return fma_chain(a1 * b1, [(a0, b0)] + list(pairs[2:]))


def fma_dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """sum over the last axis of x * y (float32, broadcast against each
    other) as one FMA chain over k from left to right: acc = x0 y0, then
    acc = fma(xk, yk, acc)."""
    xd, yd = x.double(), y.double()
    return fma_chain(x[..., 0] * y[..., 0], [(xd[..., k], yd[..., k]) for k in range(1, x.shape[-1])],
                     normal=x.device.type == "cpu" and _coarse(x, y))


def dot_fma(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ w [K, C] in float32, as one FMA chain over k from
    left to right (:func:`fma_dot`)."""
    return fma_dot(x[..., None, :], w.T)


def lanes4_sum(x: torch.Tensor, y) -> torch.Tensor:
    """sum over the last axis of x * y (float32, broadcast against each
    other) as XLA's CPU code sums a small or batched float32 dot: four
    accumulators over k mod 4, each an FMA chain from its first product,
    then (acc0 + acc1) + (acc2 + acc3). K a multiple of 4."""
    K = x.shape[-1]
    if K % 4:
        raise ValueError(f"lanes4_sum needs a multiple of 4 terms, got {K}")
    x4, y4 = x.unflatten(-1, (K // 4, 4)), y.unflatten(-1, (K // 4, 4))
    x64, y64 = x4.double(), y4.double()  # the four lanes side by side
    acc = fma_chain(x4[..., 0, :] * y4[..., 0, :],
                    [(x64[..., k, :], y64[..., k, :]) for k in range(1, K // 4)])
    return (acc[..., 0] + acc[..., 1]) + (acc[..., 2] + acc[..., 3])


def fold_lanes(v: torch.Tensor) -> torch.Tensor:
    """The sum of the vector lanes on the last axis (a power of 2) as XLA's
    CPU code folds them: lanes i + (i + n/2), then the same on the half,
    down to one."""
    while v.shape[-1] > 1:
        h = v.shape[-1] // 2
        v = v[..., :h] + v[..., h:]
    return v[..., 0]


def dot8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [R, 8] @ b [8, C] in float32, as XLA's CPU dot sums it."""
    return lanes4_sum(a[:, None, :], b.T)


def bf16_pairs_sum(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """sum over the last axis of x * y for bf16 values held in float32
    (exact products), as XLA's CPU batched bf16 dot sums it with the
    AVX-512 BF16 dot-product instruction: one float32 sum from +0 over
    the pairs of k, each pair's odd term added before its even one, every
    addition rounded. K even."""
    p = x * y
    acc = torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device)
    for k in range(0, p.shape[-1], 2):
        acc = (acc + p[..., k + 1]) + p[..., k]
    return acc


# glibc's powf tables: log2 by 16 intervals (1/c, log2 c) and a degree-5
# polynomial; exp2 by 32 table entries and a degree-3 polynomial
_LOG2_TAB = [(float.fromhex(a), float.fromhex(b)) for a, b in (
    ("0x1.661ec79f8f3bep+0", "-0x1.efec65b963019p-2"), ("0x1.571ed4aaf883dp+0", "-0x1.b0b6832d4fca4p-2"),
    ("0x1.49539f0f010b0p+0", "-0x1.7418b0a1fb77bp-2"), ("0x1.3c995b0b80385p+0", "-0x1.39de91a6dcf7bp-2"),
    ("0x1.30d190c8864a5p+0", "-0x1.01d9bf3f2b631p-2"), ("0x1.25e227b0b8ea0p+0", "-0x1.97c1d1b3b7af0p-3"),
    ("0x1.1bb4a4a1a343fp+0", "-0x1.2f9e393af3c9fp-3"), ("0x1.12358f08ae5bap+0", "-0x1.960cbbf788d5cp-4"),
    ("0x1.0953f419900a7p+0", "-0x1.a6f9db6475fcep-5"), ("0x1.0000000000000p+0", "0x0.0p+0"),
    ("0x1.e608cfd9a47acp-1", "0x1.338ca9f24f53dp-4"), ("0x1.ca4b31f026aa0p-1", "0x1.476a9543891bap-3"),
    ("0x1.b2036576afce6p-1", "0x1.e840b4ac4e4d2p-3"), ("0x1.9c2d163a1aa2dp-1", "0x1.40645f0c6651cp-2"),
    ("0x1.886e6037841edp-1", "0x1.88e9c2c1b9ff8p-2"), ("0x1.767dcf5534862p-1", "0x1.ce0a44eb17bccp-2"))]
_LOG2_POLY = [float.fromhex(v) for v in (
    "0x1.27616c9496e0bp-2", "-0x1.71969a075c67ap-2", "0x1.ec70a6ca7baddp-2",
    "-0x1.7154748bef6c8p-1", "0x1.71547652ab82bp+0")]
_EXP2_TAB = [
    0x3ff0000000000000, 0x3fefd9b0d3158574, 0x3fefb5586cf9890f, 0x3fef9301d0125b51,
    0x3fef72b83c7d517b, 0x3fef54873168b9aa, 0x3fef387a6e756238, 0x3fef1e9df51fdee1,
    0x3fef06fe0a31b715, 0x3feef1a7373aa9cb, 0x3feedea64c123422, 0x3feece086061892d,
    0x3feebfdad5362a27, 0x3feeb42b569d4f82, 0x3feeab07dd485429, 0x3feea47eb03a5585,
    0x3feea09e667f3bcd, 0x3fee9f75e8ec5f74, 0x3feea11473eb0187, 0x3feea589994cce13,
    0x3feeace5422aa0db, 0x3feeb737b0cdc5e5, 0x3feec49182a3f090, 0x3feed503b23e255d,
    0x3feee89f995ad3ad, 0x3feeff76f2fb5e47, 0x3fef199bdd85529c, 0x3fef3720dcef9069,
    0x3fef5818dcfba487, 0x3fef7c97337b9b5f, 0x3fefa4afa2a490da, 0x3fefd0765b6e4540]
_EXP2_POLY = [float.fromhex(v) for v in (
    "0x1.c6af84b912394p-5", "0x1.ebfce50fac4f3p-3", "0x1.62e42ff0c52d6p-1")]
_EXP2_SHIFT = float.fromhex("0x1.8p+47")  # 1.5 * 2^52 / 32


def powf(x: torch.Tensor, y: float) -> torch.Tensor:
    """glibc's float32 ``powf(x, y)`` for positive normal x and results
    in the normal range: log2 x in float64 by a table and a polynomial,
    times y, then exp2 by a table and a polynomial, rounded once to
    float32. (glibc's FMA build fuses the polynomial steps; the last-bit
    difference that makes on the float64 value moves the float32 result
    on about one input in 2^29.)"""
    dev = x.device
    ix = x.float().contiguous().view(torch.int32).long()
    tmp = ix - 0x3F330000
    i = (tmp >> 19) & 15
    top = (tmp >> 23) << 23
    z = (ix - top).to(torch.int32).view(torch.float32).double()
    tab = torch.tensor(_LOG2_TAB, dtype=torch.float64, device=dev)
    invc, logc = tab[i, 0], tab[i, 1]
    a = _LOG2_POLY
    r = z * invc - 1.0
    y0 = logc + (top >> 23).double()
    r2 = r * r
    q = (a[4] * r + y0) + (a[2] * r + a[3]) * r2
    logx = (a[0] * r + a[1]) * (r2 * r2) + q
    xd = float(torch.tensor(y, dtype=torch.float32)) * logx
    kd = xd + _EXP2_SHIFT
    ki = kd.view(torch.int64)
    r = xd - (kd - _EXP2_SHIFT)
    t = torch.tensor(_EXP2_TAB, dtype=torch.int64, device=dev)[ki & 31] + (ki << 47)
    c = _EXP2_POLY
    out = ((c[0] * r + c[1]) * (r * r) + (c[2] * r + 1.0)) * t.view(torch.float64)
    return out.float()


# XLA's CPU float32 log: frexp into m in [sqrt(1/2), sqrt(2)), then
# Cephes' degree-8 polynomial in three FMA chains
_LOG_P = [float.fromhex(v) for v in (
    "0x1.2043760000000p-4", "-0x1.d7a3700000000p-4", "-0x1.fcba9e0000000p-4",
    "0x1.23d37e0000000p-3", "0x1.999d580000000p-3", "-0x1.fffff80000000p-3",
    "0x1.de4a340000000p-4", "-0x1.555ca00000000p-3", "0x1.5555540000000p-2")]
_LOG_Q1 = float.fromhex("-0x1.bd01060000000p-13")  # ln 2 - 0.693359375
_LOG_Q2 = 0.693359375
_SQRT_HALF = float.fromhex("0x1.6a09e60000000p-1")


def log32(x: torch.Tensor) -> torch.Tensor:
    """The float32 natural log of XLA's CPU code generator (its inlined
    Cephes ``logf``, with the FMAs the compiler forms), bit for bit:
    -inf at 0, NaN (all bits set) below 0, inf at inf; inputs below the
    normal range are taken as 0, as XLA's flush to zero takes them."""
    x = x.float()
    xc = torch.clamp_min(x, 2.0 ** -126)
    bits = xc.contiguous().view(torch.int32)
    e = ((bits >> 23) - 127).float() + 1.0
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)  # [0.5, 1)
    small = m < _SQRT_HALF
    xm = (m - 1.0) + torch.where(small, m, 0.0)
    e = e - small.float()
    p = _LOG_P
    x2 = xm * xm
    x3 = x2 * xm
    y1 = fma32(fma32(xm, p[0], p[1]), xm, p[6])
    y2 = fma32(fma32(xm, p[2], p[3]), xm, p[7])
    y3 = fma32(fma32(xm, p[4], p[5]), xm, p[8])
    y = fma32(fma32(y1, x3, y2), x3, y3)
    y = fma32(y, x3, e * _LOG_Q1)
    r = fma32(e, _LOG_Q2, (xm - 0.5 * x2) + y)
    r = torch.where(x == torch.inf, torch.inf, r)
    nan = torch.tensor(-1, dtype=torch.int32, device=x.device).view(torch.float32)  # XLA's NaN bits
    r = torch.where((x < 0) | torch.isnan(x), nan, r)
    return torch.where(x.abs() < 2.0 ** -126, -torch.inf, r)  # XLA flushes subnormals to 0
