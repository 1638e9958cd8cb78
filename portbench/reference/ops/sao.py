"""Sample adaptive offset reconstruction (spec 8.7.3), NumPy reference.

SAO reads the deblocked picture (neighbours included, across CTB borders)
and writes offsets; it is therefore a pure frame-level map — applied here
per-CTB vectorized.

Reference parity: kvazaar src/sao.c (kvz_sao_reconstruct) and
src/strategies/generic/sao-generic.c.
"""
from __future__ import annotations

import numpy as np

SAO_OFF, SAO_BAND, SAO_EDGE = 0, 1, 2

# eo class -> (neighbour a dy,dx ; neighbour b dy,dx)
EO_DIRS = {
    0: ((0, -1), (0, 1)),
    1: ((-1, 0), (1, 0)),
    2: ((-1, -1), (1, 1)),
    3: ((1, -1), (-1, 1)),
}


def apply_sao_plane(pre: np.ndarray, params, ctb_size: int,
                    bit_depth: int = 8) -> np.ndarray:
    """Apply SAO to one plane.

    pre: deblocked plane (int). params: dict (ctb_y, ctb_x) ->
    (type, offsets[4], band_pos_or_eo_class). ctb_size in THIS plane's
    sample units. Returns the filtered plane (new array).
    """
    h, w = pre.shape
    out = pre.copy()
    max_val = (1 << bit_depth) - 1
    for (cy, cx), (typ, offsets, aux) in params.items():
        if typ == SAO_OFF:
            continue
        y0, x0 = cy * ctb_size, cx * ctb_size
        if y0 >= h or x0 >= w:
            continue
        y1, x1 = min(y0 + ctb_size, h), min(x0 + ctb_size, w)
        blk = pre[y0:y1, x0:x1].astype(np.int32)
        if typ == SAO_BAND:
            shift = bit_depth - 5
            band = blk >> shift
            res = blk.copy()
            for i in range(4):
                res = np.where(band == ((aux + i) & 31), blk + offsets[i],
                               res)
            out[y0:y1, x0:x1] = np.clip(res, 0, max_val)
        else:
            (ady, adx), (bdy, bdx) = EO_DIRS[aux]
            # neighbour fetch from the pre-SAO plane, clipped at picture
            # borders (border samples keep their value: spec skips samples
            # whose neighbours fall outside the picture)
            ys = np.arange(y0, y1)
            xs = np.arange(x0, x1)
            ay = ys[:, None] + ady
            ax = xs[None, :] + adx
            by = ys[:, None] + bdy
            bx = xs[None, :] + bdx
            valid = ((ay >= 0) & (ay < h) & (by >= 0) & (by < h)
                     & (ax >= 0) & (ax < w) & (bx >= 0) & (bx < w))
            ayc = np.clip(ay, 0, h - 1)
            byc = np.clip(by, 0, h - 1)
            axc = np.clip(ax, 0, w - 1)
            bxc = np.clip(bx, 0, w - 1)
            na = pre[ayc, axc].astype(np.int32)
            nb = pre[byc, bxc].astype(np.int32)
            idx = np.sign(blk - na) + np.sign(blk - nb)
            res = blk.copy()
            for cat, off in ((-2, offsets[0]), (-1, offsets[1]),
                             (1, offsets[2]), (2, offsets[3])):
                res = np.where(idx == cat, blk + off, res)
            res = np.where(valid, np.clip(res, 0, max_val), blk)
            out[y0:y1, x0:x1] = res
    return out
