"""Motion compensation: HEVC sub-pel interpolation (spec 8.5.3.3.3).

NumPy reference used by the validation decoder and as the parity oracle for
the JAX MC kernels. 8-tap quarter-pel luma, 4-tap eighth-pel chroma,
separable with 14-bit intermediates.

Reference parity: kvazaar src/strategies/generic/ipol-generic.c
(kvz_sample_quarterpel_luma_generic etc.) and src/inter.c:55-334.
"""
from __future__ import annotations

import numpy as np

LUMA_FILTERS = np.array([
    [0, 0, 0, 64, 0, 0, 0, 0],
    [-1, 4, -10, 58, 17, -5, 1, 0],
    [-1, 4, -11, 40, 40, -11, 4, -1],
    [0, 1, -5, 17, 58, -10, 4, -1],
], dtype=np.int32)

CHROMA_FILTERS = np.array([
    [0, 64, 0, 0],
    [-2, 58, 10, -2],
    [-4, 54, 16, -2],
    [-6, 46, 28, -4],
    [-4, 36, 36, -4],
    [-4, 28, 46, -6],
    [-2, 16, 54, -4],
    [-2, 10, 58, -2],
], dtype=np.int32)


def _padded_fetch(plane: np.ndarray, x0: int, y0: int, w: int,
                  h: int) -> np.ndarray:
    """Fetch a w x h window at (x0, y0) with edge replication."""
    ph, pw = plane.shape
    ys = np.clip(np.arange(y0, y0 + h), 0, ph - 1)
    xs = np.clip(np.arange(x0, x0 + w), 0, pw - 1)
    return plane[np.ix_(ys, xs)]


def mc_luma_hi(ref: np.ndarray, x0: int, y0: int, w: int, h: int,
               mv_x: int, mv_y: int, bit_depth: int = 8) -> np.ndarray:
    """14-bit intermediate luma prediction (before final rounding)."""
    ix, fx = mv_x >> 2, mv_x & 3
    iy, fy = mv_y >> 2, mv_y & 3
    src = _padded_fetch(ref, x0 + ix - 3, y0 + iy - 3, w + 7,
                        h + 7).astype(np.int64)
    shift1 = bit_depth - 8
    if fx == 0 and fy == 0:
        return (src[3:3 + h, 3:3 + w] << (14 - bit_depth)).astype(np.int64)
    if fy == 0:
        f = LUMA_FILTERS[fx]
        acc = sum(int(f[k]) * src[3:3 + h, k:k + w] for k in range(8))
        return acc >> shift1
    if fx == 0:
        f = LUMA_FILTERS[fy]
        acc = sum(int(f[k]) * src[k:k + h, 3:3 + w] for k in range(8))
        return acc >> shift1
    fh = LUMA_FILTERS[fx]
    tmp = sum(int(fh[k]) * src[:, k:k + w] for k in range(8)) >> shift1
    fv = LUMA_FILTERS[fy]
    return sum(int(fv[k]) * tmp[k:k + h, :] for k in range(8)) >> 6


def mc_luma(ref, x0, y0, w, h, mv_x, mv_y, bit_depth: int = 8):
    """Uni-directional luma prediction block [h, w] (quarter-pel mv)."""
    hi = mc_luma_hi(ref, x0, y0, w, h, mv_x, mv_y, bit_depth)
    shift = 14 - bit_depth
    return np.clip((hi + (1 << (shift - 1))) >> shift, 0,
                   (1 << bit_depth) - 1).astype(np.int32)


def mc_chroma_hi(ref: np.ndarray, x0: int, y0: int, w: int, h: int,
                 mv_x: int, mv_y: int, bit_depth: int = 8) -> np.ndarray:
    """14-bit intermediate chroma prediction; mv in eighth-pel units."""
    ix, fx = mv_x >> 3, mv_x & 7
    iy, fy = mv_y >> 3, mv_y & 7
    src = _padded_fetch(ref, x0 + ix - 1, y0 + iy - 1, w + 3,
                        h + 3).astype(np.int64)
    shift1 = bit_depth - 8
    if fx == 0 and fy == 0:
        return (src[1:1 + h, 1:1 + w] << (14 - bit_depth)).astype(np.int64)
    if fy == 0:
        f = CHROMA_FILTERS[fx]
        acc = sum(int(f[k]) * src[1:1 + h, k:k + w] for k in range(4))
        return acc >> shift1
    if fx == 0:
        f = CHROMA_FILTERS[fy]
        acc = sum(int(f[k]) * src[k:k + h, 1:1 + w] for k in range(4))
        return acc >> shift1
    fh = CHROMA_FILTERS[fx]
    tmp = sum(int(fh[k]) * src[:, k:k + w] for k in range(4)) >> shift1
    fv = CHROMA_FILTERS[fy]
    return sum(int(fv[k]) * tmp[k:k + h, :] for k in range(4)) >> 6


def mc_chroma(ref, x0, y0, w, h, mv_x, mv_y, bit_depth: int = 8):
    """Uni-directional chroma prediction [h, w] (eighth-pel mv)."""
    hi = mc_chroma_hi(ref, x0, y0, w, h, mv_x, mv_y, bit_depth)
    shift = 14 - bit_depth
    return np.clip((hi + (1 << (shift - 1))) >> shift, 0,
                   (1 << bit_depth) - 1).astype(np.int32)


def bi_average(hi_a: np.ndarray, hi_b: np.ndarray,
               bit_depth: int = 8) -> np.ndarray:
    """Default bi-prediction averaging (spec 8.5.3.3.3.2)."""
    shift = 15 - bit_depth
    return np.clip((hi_a + hi_b + (1 << (shift - 1))) >> shift, 0,
                   (1 << bit_depth) - 1).astype(np.int32)
