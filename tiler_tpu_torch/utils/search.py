"""Scalar optimizers: golden-ratio objective search and Powell's method.

Component parity with the reference's math utilities:
  - GoldenRatioSearch (utils.pas:1044-1072): find x where f(x) hits an
    objective value, assuming monotone f. Used by SolveTileCount; the
    pipeline's esReduce replaces it with an exact quantile, but the
    general tool remains available (e.g. rate-control extensions).
  - PowellMinimize (powell.pas:27-387, a scipy-derived direction-set
    minimizer with Brent line search): used by OptimizePalettes in the
    reference; our palette optimizer uses exact 2-opt instead, but the
    optimizer is exposed for parity and experimentation.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import numpy as np

PHI = (1 + math.sqrt(5)) / 2
INV_PHI = 1 / PHI


def least_squares(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Least-squares solve min |a x - b| (capability parity with the
    reference's vestigial numlib slegls wrapper, sle.pas:64-321 — kept in
    its uses clause for a removed tile-blending feature)."""
    x, *_ = np.linalg.lstsq(np.asarray(a, np.float64), np.asarray(b, np.float64), rcond=None)
    return x


def golden_ratio_search(
    func: Callable[[float], float],
    lo: float,
    hi: float,
    objective: float,
    eps_x: float = 1e-6,
    eps_y: float = 0.5,
    max_iter: int = 200,
) -> float:
    """Find x in [lo, hi] with func(x) ~= objective (func monotone incr.)."""
    for _ in range(max_iter):
        if abs(hi - lo) <= eps_x:
            return lo
        x = lo + (hi - lo) * (1.0 - INV_PHI) if lo < hi else lo + (hi - lo) * INV_PHI
        y = func(x)
        if abs(y - objective) <= eps_y:
            return x
        if y < objective:
            lo = x
        else:
            hi = x
    return x


def _brent_line(f1d: Callable[[float], float], xa=0.0, xb=1.0, tol=1e-4, maxiter=100):
    """Brent minimization after a bracketing phase (scipy-style)."""
    # bracket
    grow = 2.0
    fa, fb = f1d(xa), f1d(xb)
    if fb > fa:
        xa, xb = xb, xa
        fa, fb = fb, fa
    xc = xb + PHI * (xb - xa)
    fc = f1d(xc)
    it = 0
    while fc < fb and it < 50:
        xa, xb, xc = xb, xc, xc + grow * (xc - xb)
        fa, fb, fc = fb, fc, f1d(xc)
        it += 1
    lo, hi = (xa, xc) if xa < xc else (xc, xa)

    # golden-section/Brent
    gr = INV_PHI
    a, b = lo, hi
    x = w = v = xb
    fx = fw = fv = fb
    d = e = 0.0
    for _ in range(maxiter):
        m = 0.5 * (a + b)
        tol1 = tol * abs(x) + 1e-10
        if abs(x - m) <= 2 * tol1 - 0.5 * (b - a):
            break
        use_golden = True
        if abs(e) > tol1:
            r = (x - w) * (fx - fv)
            q = (x - v) * (fx - fw)
            p = (x - v) * q - (x - w) * r
            q = 2 * (q - r)
            if q > 0:
                p = -p
            q = abs(q)
            if abs(p) < abs(0.5 * q * e) and q * (a - x) < p < q * (b - x):
                e = d
                d = p / q
                use_golden = False
        if use_golden:
            e = (b - x) if x < m else (a - x)
            d = (1 - gr) * e
        u = x + (d if abs(d) >= tol1 else math.copysign(tol1, d))
        fu = f1d(u)
        if fu <= fx:
            if u < x:
                b = x
            else:
                a = x
            v, w, x = w, x, u
            fv, fw, fx = fw, fx, fu
        else:
            if u < x:
                a = u
            else:
                b = u
            if fu <= fw or w == x:
                v, w = w, u
                fv, fw = fw, fu
            elif fu <= fv or v == x or v == w:
                v, fv = u, fu
    return x, fx


def powell_minimize(
    func: Callable[[np.ndarray], float],
    x0: Sequence[float],
    xtol: float = 1e-4,
    ftol: float = 1e-4,
    maxiter: Optional[int] = None,
) -> Tuple[np.ndarray, float]:
    """Powell's direction-set minimization (no derivatives).

    Returns (x_min, f_min)."""
    x = np.asarray(x0, dtype=np.float64).copy()
    n = len(x)
    directions = np.eye(n)
    fval = func(x)
    maxiter = maxiter or 100 * n
    for _ in range(maxiter):
        f_start = fval
        x_start = x.copy()
        biggest_dec = 0.0
        biggest_i = 0
        for i in range(n):
            d = directions[i]

            def f1d(t, d=d):
                return func(x + t * d)

            t, ft = _brent_line(f1d)
            dec = fval - ft
            if dec > biggest_dec:
                biggest_dec = dec
                biggest_i = i
            x = x + t * d
            fval = ft
        if 2.0 * (f_start - fval) <= ftol * (abs(f_start) + abs(fval)) + 1e-20:
            break
        # extrapolated point test (standard Powell update)
        x_ext = 2.0 * x - x_start
        f_ext = func(x_ext)
        if f_ext < f_start:
            t = 2.0 * (f_start - 2.0 * fval + f_ext) * (f_start - fval - biggest_dec) ** 2
            if t < biggest_dec * (f_start - f_ext) ** 2:
                new_dir = x - x_start
                nrm = np.linalg.norm(new_dir)
                if nrm > 1e-12:
                    directions[biggest_i] = directions[-1]
                    directions[-1] = new_dir / nrm
    return x, fval
