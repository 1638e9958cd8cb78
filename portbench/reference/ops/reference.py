"""NumPy ground-truth implementations of the HEVC sample-level operations.

This is the equivalent of kvazaar's `strategies/generic/` layer
(src/strategies/generic/{intra,dct,quant,picture}-generic.c): a scalar,
obviously-correct implementation used as the parity oracle for the JAX/Pallas
kernels in kvazaar_tpu/ops/*.py, and by the validation decoder.

All arithmetic is exact integer per spec 8.4.4.2 (intra), 8.6 (transforms,
scaling).
"""
from __future__ import annotations

import numpy as np

from ..tables import (DCT_MATRICES, DST4, INV_QUANT_SCALES, intra_inv_angle,
                      intra_pred_angle)

# ---------------------------------------------------------------------------
# Intra prediction (spec 8.4.4.2)
# ---------------------------------------------------------------------------


def intra_ref_substitution(left: np.ndarray, top: np.ndarray,
                           corner: int, avail_left: np.ndarray,
                           avail_top: np.ndarray, avail_corner: bool,
                           bit_depth: int = 8) -> tuple[np.ndarray,
                                                        np.ndarray, int]:
    """Reference sample substitution (spec 8.4.4.2.2).

    left: 2N samples top-to-bottom, top: 2N samples left-to-right,
    corner: the top-left sample. avail_*: per-sample availability.
    Scan order: bottom-left -> up -> corner -> left-to-right.
    """
    n2 = len(left)
    seq = np.empty(2 * n2 + 1, dtype=np.int32)
    avail = np.empty(2 * n2 + 1, dtype=bool)
    seq[:n2] = left[::-1]
    avail[:n2] = avail_left[::-1]
    seq[n2] = corner
    avail[n2] = avail_corner
    seq[n2 + 1:] = top
    avail[n2 + 1:] = avail_top
    if not avail.any():
        fill = 1 << (bit_depth - 1)
        seq[:] = fill
    else:
        first = int(np.argmax(avail))
        seq[:first] = seq[first]
        for i in range(first + 1, len(seq)):
            if not avail[i]:
                seq[i] = seq[i - 1]
    return seq[:n2][::-1].copy(), seq[n2 + 1:].copy(), int(seq[n2])


def intra_filter_refs(left: np.ndarray, top: np.ndarray, corner: int,
                      size: int, mode: int, strong: bool,
                      bit_depth: int = 8) -> tuple[np.ndarray, np.ndarray,
                                                   int]:
    """Reference smoothing for luma (spec 8.4.4.2.3)."""
    if mode == 1 or size == 4:
        return left, top, corner
    dist = min(abs(mode - 26), abs(mode - 10))
    thresh = {8: 7, 16: 1, 32: 0}.get(size, 8)
    if mode != 0 and dist <= thresh:
        return left, top, corner
    if strong and size == 32:
        bd = bit_depth
        flat_top = abs(int(corner) + int(top[63]) - 2 * int(top[31])) < \
            (1 << (bd - 5))
        flat_left = abs(int(corner) + int(left[63]) - 2 * int(left[31])) < \
            (1 << (bd - 5))
        if flat_top and flat_left:
            i = np.arange(1, 64)
            new_top = np.empty_like(top)
            new_top[:63] = ((63 - i) * int(corner) + (i + 1) * int(top[63])
                            + 32) >> 6
            new_top[63] = top[63]
            new_left = np.empty_like(left)
            new_left[:63] = ((63 - i) * int(corner) + (i + 1) * int(left[63])
                             + 32) >> 6
            new_left[63] = left[63]
            return new_left, new_top, corner
    # [1 2 1] filter
    ext = np.concatenate(([corner], top))
    new_top = top.copy()
    new_top[:-1] = (ext[:-2] + 2 * ext[1:-1] + ext[2:] + 2) >> 2
    extl = np.concatenate(([corner], left))
    new_left = left.copy()
    new_left[:-1] = (extl[:-2] + 2 * extl[1:-1] + extl[2:] + 2) >> 2
    new_corner = (int(left[0]) + 2 * int(corner) + int(top[0]) + 2) >> 2
    return new_left, new_top, new_corner


def intra_predict(left: np.ndarray, top: np.ndarray, corner: int, size: int,
                  mode: int, is_chroma: bool,
                  bit_depth: int = 8) -> np.ndarray:
    """Predict one size x size block from (filtered) reference samples.

    left/top are 2*size long; corner is the top-left sample.
    Returns int32 block [y][x].
    """
    n = size
    left = left.astype(np.int32)
    top = top.astype(np.int32)
    if mode == 0:  # planar (8.4.4.2.4)
        x = np.arange(n)
        y = np.arange(n)[:, None]
        pred = ((n - 1 - x) * left[y] + (x + 1) * top[n]
                + (n - 1 - y) * top[x] + (y + 1) * left[n]
                + n) >> (int(np.log2(n)) + 1)
        return pred.astype(np.int32)
    if mode == 1:  # DC (8.4.4.2.5)
        dc = (int(top[:n].sum()) + int(left[:n].sum()) + n) >> \
            (int(np.log2(n)) + 1)
        pred = np.full((n, n), dc, dtype=np.int32)
        if not is_chroma and n < 32:
            pred[0, 0] = (left[0] + 2 * dc + top[0] + 2) >> 2
            pred[0, 1:] = (top[1:n] + 3 * dc + 2) >> 2
            pred[1:, 0] = (left[1:n] + 3 * dc + 2) >> 2
        return pred
    # angular (8.4.4.2.6)
    angle = intra_pred_angle(mode)
    max_val = (1 << bit_depth) - 1
    if mode >= 18:  # vertical-ish: main ref is the top row
        ref = np.zeros(3 * n + 2, dtype=np.int32)  # index n+1+k = top[k]
        ref[n] = corner
        ref[n + 1:n + 1 + 2 * n] = top
        if angle < 0:
            inv = intra_inv_angle(mode)
            kmin = (n * angle) >> 5
            if kmin < -1:
                for k in range(-1, kmin - 1, -1):
                    ref[n + k] = left[(((-k) * inv + 128) >> 8) - 1]
        y = np.arange(1, n + 1)[:, None]
        x = np.arange(n)
        idx = (y * angle) >> 5
        fact = (y * angle) & 31
        base = n + 1 + x + idx
        pred = ((32 - fact) * ref[base] + fact * ref[base + 1] + 16) >> 5
        if mode == 26 and not is_chroma and n < 32:
            col = top[0] + ((left[:n] - corner) >> 1)
            pred[:, 0] = np.clip(col, 0, max_val)
        return pred.astype(np.int32)
    # horizontal-ish: main ref is the left column; transpose of the above
    ref = np.zeros(3 * n + 2, dtype=np.int32)
    ref[n] = corner
    ref[n + 1:n + 1 + 2 * n] = left
    if angle < 0:
        inv = intra_inv_angle(mode)
        kmin = (n * angle) >> 5
        if kmin < -1:
            for k in range(-1, kmin - 1, -1):
                ref[n + k] = top[(((-k) * inv + 128) >> 8) - 1]
    xx = np.arange(1, n + 1)[:, None]  # column index+1
    yy = np.arange(n)
    idx = (xx * angle) >> 5
    fact = (xx * angle) & 31
    base = n + 1 + yy + idx
    pred_t = ((32 - fact) * ref[base] + fact * ref[base + 1] + 16) >> 5
    pred = pred_t.T.astype(np.int32).copy()
    if mode == 10 and not is_chroma and n < 32:
        row = left[0] + ((top[:n] - corner) >> 1)
        pred[0, :] = np.clip(row, 0, max_val)
    return pred


# ---------------------------------------------------------------------------
# Transforms (spec 8.6.4 inverse; forward per HM convention)
# ---------------------------------------------------------------------------


def _tmatrix(size: int, is_dst: bool) -> np.ndarray:
    return DST4 if is_dst else DCT_MATRICES[size]


def inverse_transform(coeffs: np.ndarray, is_dst: bool,
                      bit_depth: int = 8) -> np.ndarray:
    """Inverse 2D transform (spec 8.6.4.2): coeffs int32 -> residual int32."""
    n = coeffs.shape[0]
    t = _tmatrix(n, is_dst).astype(np.int64)
    shift1 = 7
    shift2 = 20 - bit_depth
    tmp = (t.T @ coeffs.astype(np.int64) + (1 << (shift1 - 1))) >> shift1
    tmp = np.clip(tmp, -32768, 32767)
    out = (tmp @ t + (1 << (shift2 - 1))) >> shift2
    return np.clip(out, -32768, 32767).astype(np.int32)


# ---------------------------------------------------------------------------
# Quantization (forward per HM; dequant spec 8.6.3)
# ---------------------------------------------------------------------------


def dequantize(levels: np.ndarray, qp: int, bit_depth: int = 8,
               m: np.ndarray | None = None) -> np.ndarray:
    # spec 8.6.3; with a flat scaling matrix (m=16, the None fast path)
    # the 16 folds into the shift: shift = BitDepth + Log2(nTbS) - 5 - 4
    n = levels.shape[0]
    log2n = int(np.log2(n))
    scale = int(INV_QUANT_SCALES[qp % 6]) << (qp // 6)
    if m is None:
        shift = bit_depth + log2n - 9
        d = (levels.astype(np.int64) * scale
             + (1 << (shift - 1))) >> shift
    else:
        shift = bit_depth + log2n - 5      # bdShift
        d = (levels.astype(np.int64) * m.astype(np.int64) * scale
             + (1 << (shift - 1))) >> shift
    return np.clip(d, -32768, 32767).astype(np.int32)


# ---------------------------------------------------------------------------
# Cost functions (encoder side; kvazaar strategies-picture equivalents)
# ---------------------------------------------------------------------------
