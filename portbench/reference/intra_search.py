"""The intra mode decision that the configurations state, worked out again
in NumPy to judge the program's choices.

At --rd 0 kvazaar's intra search, and the program after it, gives each
intra prediction unit the mode of least SATD among all 35 luma modes,
the first such mode on a tie: the prediction of each mode (spec
8.4.4.2, [1 2 1] smoothing where 8.4.4.2.3 asks for it, never the strong
32x32 one) from the source picture's own neighbouring samples, clamped
to the picture (no availability substitution), against the source
block; the SATD sums, over the block's 8x8 tiles, (sum |H d H| + 2) >> 2
with H the 8x8 Hadamard matrix, or (sum |H4 d H4| + 1) >> 1 over a 4x4
block; a 64x64 unit sums its four 32x32 quarters, each predicted from
its own neighbours. Everything is exact in integers, so a unit whose
signalled mode has a larger SATD than another mode's was decided on
costs computed in another way, for example rounded to a lower precision.
"""
from __future__ import annotations

import numpy as np

from .ops.reference import intra_filter_refs, intra_predict


def _hadamard(n: int) -> np.ndarray:
    h = np.array([[1]], dtype=np.int64)
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return h


_H = {4: _hadamard(4), 8: _hadamard(8)}


def satd(diff: np.ndarray) -> np.ndarray:
    """SATD of each [.., n, n] difference block (n a multiple of 8, or 4)."""
    d = diff.astype(np.int64)
    n = d.shape[-1]
    if n == 4:
        t = _H[4] @ d @ _H[4]
        return (np.abs(t).sum(axis=(-1, -2)) + 1) >> 1
    k = n // 8
    tiles = d.reshape(*d.shape[:-2], k, 8, k, 8).swapaxes(-3, -2)
    t = _H[8] @ tiles @ _H[8]
    return ((np.abs(t).sum(axis=(-1, -2)) + 2) >> 2).sum(axis=(-1, -2))


def source_refs(src: np.ndarray, y0: int, x0: int, n: int):
    """(left [2n], top [2n], corner) of the n-block at (y0, x0), taken
    from the picture src with every coordinate clamped into it."""
    h, w = src.shape
    k = np.arange(2 * n)
    ty, lx = max(y0 - 1, 0), max(x0 - 1, 0)
    left = src[np.minimum(y0 + k, h - 1), lx].astype(np.int32)
    top = src[ty, np.minimum(x0 + k, w - 1)].astype(np.int32)
    return left, top, int(src[ty, lx])


def mode_satds(src: np.ndarray, y0: int, x0: int, n: int) -> np.ndarray:
    """The SATD of each of the 35 luma modes for the n-unit at (y0, x0)."""
    if n == 64:
        return sum(mode_satds(src, y0 + dy, x0 + dx, 32)
                   for dy in (0, 32) for dx in (0, 32))
    left, top, corner = source_refs(src, y0, x0, n)
    preds = np.empty((35, n, n), dtype=np.int64)
    for m in range(35):
        fl, ft, fc = intra_filter_refs(left, top, corner, n, m, False, 8)
        preds[m] = intra_predict(fl, ft, fc, n, m, False, 8)
    block = src[y0:y0 + n, x0:x0 + n].astype(np.int64)
    return satd(block[None] - preds)


def intra_units(pu_log2: np.ndarray) -> list[tuple[int, int, int]]:
    """(y, x, n) of every intra prediction unit of a picture's per-4x4 map
    of intra PU sizes (log2, 0 where the block is not intra)."""
    out = []
    for r, c in zip(*np.nonzero(pu_log2)):
        n = 1 << int(pu_log2[r, c])
        if (4 * r) % n == 0 and (4 * c) % n == 0:
            out.append((4 * int(r), 4 * int(c), n))
    return out


def check_modes(src: np.ndarray, pu_log2: np.ndarray,
                intra_mode: np.ndarray, rng, k: int) -> tuple[int, int]:
    """(units whose signalled mode is not of least SATD, units checked)
    over k intra units of a picture drawn with rng (all where fewer)."""
    units = intra_units(pu_log2)
    if len(units) > k:
        units = [units[i] for i in sorted(rng.choice(len(units), k,
                                                     replace=False))]
    bad = 0
    for y, x, n in units:
        s = mode_satds(src, y, x, n)
        bad += int(s[int(intra_mode[y >> 2, x >> 2])] > s.min())
    return bad, len(units)
