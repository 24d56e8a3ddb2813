"""Float arithmetic in a fixed order, for the palettization.

The palettization's k-means is chaotic: one feature that differs by a
unit in the last place can move a point to another centroid, and a few
iterations later most of the palettes differ. So the port computes the
palettization's features and Lloyd steps in one fixed order, and in the
order in which the JAX package's CPU build evaluates them (XLA on
x86-64; read from its optimized HLO and its machine code, and held bit
for bit by ``tests/test_torch_parity_gap.py``):

- :func:`row_sum`: XLA's tree reduction. A row longer than 32 is summed
  in windows of 32 (zero-padded, the padding split between both ends),
  each from left to right, then the window sums the same way.
- :func:`segment_sum`: each row added to its segment in row order, as
  ``jax.ops.segment_sum`` and ``np.add.at`` add.
- :func:`fma32`: a float32 multiply-add rounded once, as the FMA that
  XLA's code generator emits for ``a * b + c``.
- :func:`dot8`: a product over K = 8 as XLA's CPU dot computes it: four
  FMA accumulators over k mod 4, then (0 + 1) + (2 + 3).
- :func:`powf`: glibc's ``powf`` (the ARM optimized-routines algorithm,
  glibc 2.28 and later), which XLA's CPU ``pow`` calls.

Each function is a chain of elementwise float32, float64 and integer
tensor operations, each rounded once, so it gives the same bits on the
CPU and on CUDA, at any thread count.

The order was read from one build: jax 0.9.0 on x86-64 with AVX-512 and
glibc 2.36. Which products XLA's code generator fuses into FMAs depends
on how it vectorizes, so another ISA, another jax or another libm can
give the reference other bits; the bit-equality tests probe the host's
XLA first and skip with the reason when it compiles otherwise.

On a card these functions give one fixed order, not the reference's
bits for the whole palettization: there the k-means sums its squared
norms in one reduction and takes its products from cuBLAS, each in the
card's own fixed order. What they buy on a card is determinism.
"""
from __future__ import annotations

import torch

WINDOW = 32  # XLA's CPU tree-reduction window
WARP = 32


def seq_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis from left to right."""
    acc = x[..., 0]
    for j in range(1, x.shape[-1]):
        acc = acc + x[..., j]
    return acc


def row_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in XLA's CPU order: rows longer than
    ``WINDOW`` in windows of ``WINDOW``, recursively."""
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


def fma32(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once. The product is exact in
    float64; the sum s + t is exact, and its float32 rounding is that of
    s except where s lies on a float32 midpoint, where t decides."""
    a = a.double()
    p = a * (b.double() if torch.is_tensor(b) else b)
    c = c.double() if torch.is_tensor(c) else torch.full_like(p, c)
    s, t = _two_sum(p, c)
    r = s.float()
    lo = r.double()
    up = torch.nextafter(r, torch.full_like(r, torch.inf))
    dn = torch.nextafter(r, torch.full_like(r, -torch.inf))
    r = torch.where((t > 0) & (s == lo + (up.double() - lo) * 0.5), up, r)
    return torch.where((t < 0) & (s == lo + (dn.double() - lo) * 0.5), dn, r)


def dot8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [R, 8] @ b [8, C] in float32, as XLA's CPU dot sums it."""
    acc = []
    for lane in range(4):
        first = a[:, lane, None] * b[lane]
        acc.append(fma32(a[:, lane + 4, None].expand_as(first), b[lane + 4].expand_as(first),
                         first))
    return (acc[0] + acc[1]) + (acc[2] + acc[3])


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
