"""HEVC deblocking filter (spec 8.7.2), NumPy reference.

Whole-picture formulation: the vertical-edge pass runs over every 8-aligned
column edge (segments are independent — adjacent edges are 8 apart and the
filter reach is 4), then the horizontal pass runs on the vertically-filtered
picture. Intra prediction uses unfiltered reconstruction, so the filter is
applied once per frame after reconstruction — this replaces the reference's
LCU-lagged scheme (kvazaar src/filter.c, DEBLOCK_DELAY_PX) with a batched
full-frame pass that produces identical output.

This module is the scalar oracle; the JAX version (deblock_jax) must match
it bit-exactly. All-intra: boundary strength is 2 on every CU/TU edge.
"""
from __future__ import annotations

import numpy as np

# spec tables (8.7.2.5.3)
BETA_TABLE = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
     6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 20, 22, 24,
     26, 28, 30, 32, 34, 36, 38, 40, 42, 44, 46, 48, 50, 52, 54, 56,
     58, 60, 62, 64], dtype=np.int32)
TC_TABLE = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
     1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3,
     3, 4, 4, 4, 5, 5, 6, 6, 7, 8, 9, 10, 11, 13, 14, 16,
     18, 20, 22, 24], dtype=np.int32)


def _clip3(lo, hi, v):
    return np.minimum(np.maximum(v, lo), hi)


def _filter_luma_edge_cols(rec: np.ndarray, x: int, ys: np.ndarray,
                           beta: int, tc: int, bit_depth: int) -> None:
    """Filter the vertical luma edge at column x for the 4-row segments
    starting at rows `ys` (all with the same beta/tc)."""
    if tc == 0 or len(ys) == 0:
        return
    # p side: columns x-4..x-1 ; q side: x..x+3
    seg = np.arange(4)
    rows = ys[:, None] + seg[None, :]  # [S, 4]
    p = rec[rows[:, :, None], x - 1 - np.arange(4)[None, None, :]]  # [S,4,4]
    q = rec[rows[:, :, None], x + np.arange(4)[None, None, :]]
    p0, p1, p2, p3 = (p[:, :, i].astype(np.int64) for i in range(4))
    q0, q1, q2, q3 = (q[:, :, i].astype(np.int64) for i in range(4))

    dp0 = np.abs(p2[:, 0] - 2 * p1[:, 0] + p0[:, 0])
    dp3 = np.abs(p2[:, 3] - 2 * p1[:, 3] + p0[:, 3])
    dq0 = np.abs(q2[:, 0] - 2 * q1[:, 0] + q0[:, 0])
    dq3 = np.abs(q2[:, 3] - 2 * q1[:, 3] + q0[:, 3])
    dpq0 = dp0 + dq0
    dpq3 = dp3 + dq3
    dp = dp0 + dp3
    dq = dq0 + dq3
    d = dpq0 + dpq3
    filter_on = d < beta  # [S]

    # strong/weak decision per segment (lines 0 and 3)
    def strong_line(i):
        return ((2 * (np.abs(p2[:, i] - 2 * p1[:, i] + p0[:, i])
                      + np.abs(q2[:, i] - 2 * q1[:, i] + q0[:, i]))
                 < (beta >> 2))
                & ((np.abs(p3[:, i] - p0[:, i])
                    + np.abs(q0[:, i] - q3[:, i])) < (beta >> 3))
                & (np.abs(p0[:, i] - q0[:, i]) < ((tc * 5 + 1) >> 1)))
    strong = strong_line(0) & strong_line(3) & filter_on

    max_val = (1 << bit_depth) - 1
    # strong filter
    sp0 = _clip3(p0 - 2 * tc, p0 + 2 * tc,
                 (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3)
    sp1 = _clip3(p1 - 2 * tc, p1 + 2 * tc, (p2 + p1 + p0 + q0 + 2) >> 2)
    sp2 = _clip3(p2 - 2 * tc, p2 + 2 * tc,
                 (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3)
    sq0 = _clip3(q0 - 2 * tc, q0 + 2 * tc,
                 (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3)
    sq1 = _clip3(q1 - 2 * tc, q1 + 2 * tc, (q2 + q1 + q0 + p0 + 2) >> 2)
    sq2 = _clip3(q2 - 2 * tc, q2 + 2 * tc,
                 (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3)

    # weak filter
    delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
    weak_on = (np.abs(delta) < tc * 10) & filter_on[:, None] & ~strong[:, None]
    delta = _clip3(-tc, tc, delta)
    wp0 = _clip3(0, max_val, p0 + delta)
    wq0 = _clip3(0, max_val, q0 - delta)
    side_p = (dp < ((beta + (beta >> 1)) >> 3))[:, None]
    side_q = (dq < ((beta + (beta >> 1)) >> 3))[:, None]
    dp1 = _clip3(-(tc >> 1), tc >> 1,
                 (((p2 + p0 + 1) >> 1) - p1 + delta) >> 1)
    wp1 = _clip3(0, max_val, p1 + dp1)
    dq1 = _clip3(-(tc >> 1), tc >> 1,
                 (((q2 + q0 + 1) >> 1) - q1 - delta) >> 1)
    wq1 = _clip3(0, max_val, q1 + dq1)

    sm = strong[:, None]
    out_p0 = np.where(sm, sp0, np.where(weak_on, wp0, p0))
    out_p1 = np.where(sm, sp1, np.where(weak_on & side_p, wp1, p1))
    out_p2 = np.where(sm, sp2, p2)
    out_q0 = np.where(sm, sq0, np.where(weak_on, wq0, q0))
    out_q1 = np.where(sm, sq1, np.where(weak_on & side_q, wq1, q1))
    out_q2 = np.where(sm, sq2, q2)

    rec[rows, x - 1] = np.clip(out_p0, 0, max_val)
    rec[rows, x - 2] = np.clip(out_p1, 0, max_val)
    rec[rows, x - 3] = np.clip(out_p2, 0, max_val)
    rec[rows, x] = np.clip(out_q0, 0, max_val)
    rec[rows, x + 1] = np.clip(out_q1, 0, max_val)
    rec[rows, x + 2] = np.clip(out_q2, 0, max_val)


def _filter_chroma_edge_cols(rec: np.ndarray, x: int, ys: np.ndarray,
                             tc: int, bit_depth: int,
                             seg_h: int = 4) -> None:
    if tc == 0 or len(ys) == 0:
        return
    seg = np.arange(seg_h)
    rows = ys[:, None] + seg[None, :]
    p0 = rec[rows, x - 1].astype(np.int64)
    p1 = rec[rows, x - 2].astype(np.int64)
    q0 = rec[rows, x].astype(np.int64)
    q1 = rec[rows, x + 1].astype(np.int64)
    delta = _clip3(-tc, tc, ((((q0 - p0) << 2) + p1 - q1 + 4) >> 3))
    max_val = (1 << bit_depth) - 1
    rec[rows, x - 1] = np.clip(p0 + delta, 0, max_val)
    rec[rows, x] = np.clip(q0 - delta, 0, max_val)


def deblock_frame(rec_y, rec_cb, rec_cr, bs_ver, bs_hor, qp,
                  qp_cb, qp_cr, beta_off, tc_off, bit_depth=8,
                  qp4=None, cb_qp_off=0, cr_qp_off=0):
    """Deblock a 4:2:0 picture in place.

    bs_ver [H/4, W/8] / bs_hor [H/8, W/4]: luma-grid boundary strengths
    (bool maps mean BS 2 everywhere flagged). Chroma edges/strengths are
    derived from the luma maps (4:2:0; chroma filtered where BS == 2 at
    16-aligned luma columns/rows, 2 chroma rows per luma segment).

    qp4: optional per-4x4 luma QP map [H/4, W/4] (delta-QP streams) —
    each edge then uses qpL = (QpQ + QpP + 1) >> 1 of its two sides
    (spec 8.7.2.5.3); qp_cb/qp_cr are ignored and chroma QPs derive from
    qpL via the chroma table with cb_qp_off/cr_qp_off.
    """
    if bs_ver.dtype == bool:
        bs_ver = bs_ver.astype(np.int8) * 2
    if bs_hor.dtype == bool:
        bs_hor = bs_hor.astype(np.int8) * 2
    rec_y = rec_y.astype(np.int32, copy=False)
    h, w = rec_y.shape

    def beta_for(q):
        idx = int(np.clip(q + (beta_off << 1), 0, 51))
        return int(BETA_TABLE[idx]) << (bit_depth - 8)

    def tc_for(q, bs):
        idx = int(np.clip(q + 2 * (bs - 1) + (tc_off << 1), 0, 53))
        return int(TC_TABLE[idx]) << (bit_depth - 8)

    def seg_groups_ver(bsmap, xe, bs, px, py_scale, qoff):
        """Group segment rows of one edge column by their edge QP.
        Yields (qpl, rows_array)."""
        rows = np.nonzero(bsmap[:, xe] == bs)[0]
        if len(rows) == 0:
            return
        if qp4 is None:
            yield qp, rows * py_scale
            return
        # luma-grid 4x4 indices of the q/p sides of this edge
        y4 = rows * py_scale // 4
        qx4 = px // 4
        px4 = (px - 1) // 4
        qps = (qp4[y4, qx4].astype(int) + qp4[y4, px4] + 1) >> 1
        for val in np.unique(qps):
            yield int(val) + qoff, rows[qps == val] * py_scale

    # ---- luma: vertical edges ----
    for bs in (1, 2):
        for xe in range(1, w // 8):
            for qpl, ys in seg_groups_ver(bs_ver, xe, bs, xe * 8, 4, 0):
                _filter_luma_edge_cols(rec_y, xe * 8, ys, beta_for(qpl),
                                       tc_for(qpl, bs), bit_depth)
    # horizontal edges on the transposed plane
    rec_t = np.ascontiguousarray(rec_y.T)
    qp4_t = qp4.T if qp4 is not None else None
    for bs in (1, 2):
        for ye in range(1, h // 8):
            rows = np.nonzero(bs_hor[ye, :] == bs)[0]
            if len(rows) == 0:
                continue
            if qp4 is None:
                groups = [(qp, rows * 4)]
            else:
                x4 = rows
                qy4 = (ye * 8) // 4
                py4 = (ye * 8 - 1) // 4
                qps = (qp4[qy4, x4].astype(int) + qp4[py4, x4] + 1) >> 1
                groups = [(int(v), rows[qps == v] * 4)
                          for v in np.unique(qps)]
            for qpl, xs in groups:
                _filter_luma_edge_cols(rec_t, ye * 8, xs, beta_for(qpl),
                                       tc_for(qpl, bs), bit_depth)
    rec_y[:] = rec_t.T

    # ---- chroma (BS == 2 only) ----
    from ..tables import chroma_qp as _cqp
    for plane, q_scalar, qoff in ((rec_cb, qp_cb, cb_qp_off),
                                  (rec_cr, qp_cr, cr_qp_off)):
        plane = plane.astype(np.int32, copy=False)
        hc, wc = plane.shape
        # ceil bounds: an 8-aligned chroma edge exists wherever the
        # 16-aligned LUMA edge is inside the picture, even when the
        # chroma dimension is not a multiple of 8 (e.g. hc = 20)
        for xec in range(1, -(-wc // 8)):
            rows = np.nonzero(bs_ver[:, 2 * xec] == 2)[0]
            if len(rows) == 0:
                continue
            if qp4 is None:
                groups = [(q_scalar, rows * 2)]
            else:
                y4 = rows
                qx4 = (xec * 16) // 4
                px4 = (xec * 16 - 1) // 4
                qpl = (qp4[y4, qx4].astype(int) + qp4[y4, px4] + 1) >> 1
                groups = [(_cqp(int(v), qoff), rows[qpl == v] * 2)
                          for v in np.unique(qpl)]
            for qc, ys in groups:
                _filter_chroma_edge_cols(plane, xec * 8, ys,
                                         tc_for(qc, 2), bit_depth,
                                         seg_h=2)
        pt = np.ascontiguousarray(plane.T)
        for yec in range(1, -(-hc // 8)):
            rows = np.nonzero(bs_hor[2 * yec, :] == 2)[0]
            if len(rows) == 0:
                continue
            if qp4 is None:
                groups = [(q_scalar, rows * 2)]
            else:
                x4 = rows
                qy4 = (yec * 16) // 4
                py4 = (yec * 16 - 1) // 4
                qpl = (qp4[qy4, x4].astype(int) + qp4[py4, x4] + 1) >> 1
                groups = [(_cqp(int(v), qoff), rows[qpl == v] * 2)
                          for v in np.unique(qpl)]
            for qc, xs in groups:
                _filter_chroma_edge_cols(pt, yec * 8, xs, tc_for(qc, 2),
                                         bit_depth, seg_h=2)
        plane[:] = pt.T
    return rec_y, rec_cb, rec_cr


def compute_bs(edge_flags: np.ndarray, vertical: bool, is_intra4: np.ndarray,
               nonzero4: np.ndarray, mv4: np.ndarray,
               ref_poc4: np.ndarray, no_ref: int) -> np.ndarray:
    """Boundary strengths (spec 8.7.2.4) for luma-grid edges.

    edge_flags: bool [H/4, W/8] (vertical) or [H/8, W/4] (horizontal).
    is_intra4/nonzero4: per-4x4 maps; mv4 [mh, mw, 2, 2]; ref_poc4
    [mh, mw, 2] with `no_ref` marking an unused list.
    """
    out = np.zeros(edge_flags.shape, dtype=np.int8)
    eh, ew = edge_flags.shape
    for a in range(eh):
        for b in range(ew):
            if not edge_flags[a, b]:
                continue
            if vertical:
                qy, qx = a, b * 2          # 4x4 indices (x8 -> x4*2)
                py, px = a, b * 2 - 1
            else:
                qy, qx = a * 2, b
                py, px = a * 2 - 1, b
            if is_intra4[py, px] or is_intra4[qy, qx]:
                out[a, b] = 2
                continue
            if nonzero4[py, px] or nonzero4[qy, qx]:
                out[a, b] = 1
                continue
            rp = ref_poc4[py, px]
            rq = ref_poc4[qy, qx]
            used_p = [int(rp[i]) for i in range(2) if rp[i] > no_ref]
            used_q = [int(rq[i]) for i in range(2) if rq[i] > no_ref]
            if len(used_p) != len(used_q) or                     sorted(used_p) != sorted(used_q):
                out[a, b] = 1
                continue
            mp = mv4[py, px]
            mq = mv4[qy, qx]

            def far(u, v):
                return (abs(int(u[0]) - int(v[0])) >= 4
                        or abs(int(u[1]) - int(v[1])) >= 4)

            if len(used_p) == 1:
                lp = 0 if rp[0] > no_ref else 1
                lq = 0 if rq[0] > no_ref else 1
                out[a, b] = 1 if far(mp[lp], mq[lq]) else 0
            else:
                if used_p[0] != used_p[1]:
                    # distinct refs: match lists by reference picture
                    if rp[0] == rq[0]:
                        d = far(mp[0], mq[0]) or far(mp[1], mq[1])
                    else:
                        d = far(mp[0], mq[1]) or far(mp[1], mq[0])
                    out[a, b] = 1 if d else 0
                else:
                    d = ((far(mp[0], mq[0]) or far(mp[1], mq[1])) and
                         (far(mp[0], mq[1]) or far(mp[1], mq[0])))
                    out[a, b] = 1 if d else 0
    return out
