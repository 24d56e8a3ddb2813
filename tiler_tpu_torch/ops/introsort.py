"""The order in which XLA's CPU sort leaves equal keys.

The JAX package's corpus top-k (``lax.approx_max_k`` on the CPU) lowers to
an unstable sort of each row, which XLA's CPU runtime hands to
``std::sort`` of libstdc++: an introsort (median-of-three pivots, Hoare
partitions, ranges of at most 16 left to one final insertion sort). Where
equal keys straddle the k-th place, which of them make the top k is
decided by that algorithm's moves, not by their indexes. This module
replays those moves, for one row at a time, along the partitions that
contain a given place only: a range that does not contain it cannot
change which elements lie before it.

Comparisons are ``key[a] < key[b]`` (the reference sorts -d in
descending order; that is d in ascending order, equal d equal keys).
Each partition is a few numpy passes over its range; the depth limit's
heap sort, which median-of-three pivots make rare, runs element by
element.
"""
from __future__ import annotations

import numpy as np

THRESHOLD = 16  # libstdc++'s _S_threshold


def _median_to_first(key, idx, r, x, y, z):
    """libstdc++'s __move_median_to_first: the median of key[x], key[y],
    key[z] swapped into place r."""
    kx, ky, kz = key[x], key[y], key[z]
    if kx < ky:
        m = y if ky < kz else (z if kx < kz else x)
    else:
        m = x if kx < kz else (z if ky < kz else y)
    key[[r, m]] = key[[m, r]]
    idx[[r, m]] = idx[[m, r]]


def _partition(key, idx, first: int, last: int) -> int:
    """libstdc++'s __unguarded_partition_pivot on [first, last), in place;
    returns the cut. The left scan stops at keys >= the pivot, the right
    scan at keys <= it, and the i-th stops of each are swapped while the
    left one lies below the right one, so the swaps are the pairs
    (L[i], R[i]) of the two lists of stops until they cross."""
    _median_to_first(key, idx, first, first + 1, first + (last - first) // 2, last - 1)
    pv = key[first]
    seg = key[first + 1:last]
    lo = np.flatnonzero(seg >= pv) + first + 1
    hi = np.flatnonzero(seg <= pv)[::-1] + first + 1
    n = min(len(lo), len(hi))
    m = int(np.argmax(lo[:n] >= hi[:n])) if n and bool((lo[:n] >= hi[:n]).any()) else n
    left = lo[m] if m < len(lo) else np.iinfo(np.int64).max
    cut = int(left if m == 0 else min(left, hi[m - 1]))
    a, b = lo[:m], hi[:m]
    key[a], key[b] = key[b].copy(), key[a].copy()
    idx[a], idx[b] = idx[b].copy(), idx[a].copy()
    return cut


def _heap_sort(key, idx, first: int, last: int):
    """libstdc++'s __partial_sort(first, last, last): make_heap, then
    pop_heap down to one element."""
    items = list(zip(key[first:last].tolist(), idx[first:last].tolist()))
    n = len(items)

    def adjust(hole, length, value):
        top, child = hole, hole
        while child < (length - 1) // 2:
            child = 2 * (child + 1)
            if items[child][0] < items[child - 1][0]:
                child -= 1
            items[hole] = items[child]
            hole = child
        if length % 2 == 0 and child == (length - 2) // 2:
            child = 2 * (child + 1)
            items[hole] = items[child - 1]
            hole = child - 1
        parent = (hole - 1) // 2
        while hole > top and items[parent][0] < value[0]:
            items[hole] = items[parent]
            hole = parent
            parent = (hole - 1) // 2
        items[hole] = value

    for parent in range((n - 2) // 2, -1, -1):
        adjust(parent, n, items[parent])
    for end in range(n - 1, 0, -1):
        value = items[end]
        items[end] = items[0]
        adjust(0, end, value)
    key[first:last] = [k for k, _ in items]
    idx[first:last] = [i for _, i in items]


def sorted_prefix(key: np.ndarray, places) -> dict:
    """For a row of keys (float64, sorted ascending by ``std::sort``), the
    indexes of the elements that end up at positions [0, p) for each p of
    ``places``: {p: int64 array}."""
    key = np.array(key, dtype=np.float64)
    idx = np.arange(len(key))
    n = len(key)
    asked = places
    places = [p for p in places if 0 < p < n]
    chunks = {}  # place -> the range of at most THRESHOLD that holds it

    def walk(first, last, depth):
        while last - first > THRESHOLD:
            inside = [p for p in places if first < p < last]
            if not inside:
                return
            if depth == 0:
                _heap_sort(key, idx, first, last)
                for p in inside:
                    chunks[p] = None
                return
            depth -= 1
            cut = _partition(key, idx, first, last)
            walk(cut, last, depth)
            last = cut
        for p in places:
            if first < p < last:
                chunks[p] = (first, last)

    if n > 1:
        walk(0, n, 2 * (n.bit_length() - 1))
    out = {p: idx[:max(0, p)].copy() for p in asked if not 0 < p < n}
    for p in places:
        rng = chunks.get(p)
        if rng is None:  # at a cut, or sorted by the heap: in place
            out[p] = idx[:p].copy()
            continue
        first, last = rng
        # the final insertion sort moves no element past a range's ends
        # and leaves equal keys in order: a stable sort of the range
        order = np.argsort(key[first:last], kind="stable")
        out[p] = np.concatenate([idx[:first], idx[first:last][order[:p - first]]])
    return out
