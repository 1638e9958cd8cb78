"""HEVC deblocking filter (spec 8.7.2) on device, whole-picture vectorized.

Matches ops/deblock.py (the NumPy oracle) bit-exactly: one pass filters
every 8-aligned vertical edge of the picture in parallel (edges are 8
apart, the filter reach is 4), the horizontal pass runs on the transposed
result. BS == 0 segments fall out naturally (tc == 0 makes every clip a
no-op). One QP a picture, or (delta QP) a QP a 4x4 block, from which each
edge segment takes the rounded mean of its two sides (spec 8.7.2.5.3).
"""
from __future__ import annotations

import numpy as np
import torch

from .deblock import BETA_TABLE, TC_TABLE

# chroma QP mapping (spec table 8-10, 8-bit), indexed by QpY + offset
_CQP = np.arange(58)
_CQP[30:44] = [29, 30, 31, 32, 33, 33, 34, 34, 35, 35, 36, 36, 37, 37]
_CQP[44:] = _CQP[44:] - 6


def _clip3(lo, hi, v):
    return torch.minimum(torch.maximum(v, lo), hi) \
        if isinstance(lo, torch.Tensor) or isinstance(hi, torch.Tensor) \
        else v.clamp(lo, hi)


def _luma_pass_ver(rec, bs_ver, qp, beta_off: int, tc_off: int,
                   bit_depth: int):
    """Filter all 8-aligned vertical luma edges. rec [H, W] int32;
    bs_ver [H/4, W/8] int (0/1/2); qp an int or a per-segment [H/4, E]
    map. Returns the filtered picture."""
    h, w = rec.shape
    n_e = w // 8 - 1
    if n_e <= 0:
        return rec
    dev = rec.device
    s = h // 4
    xe = (torch.arange(n_e, device=dev) + 1) * 8
    colwin = xe[:, None] - 4 + torch.arange(8, device=dev)[None, :]
    win = rec[:, colwin].reshape(s, 4, n_e, 8)
    p3, p2, p1, p0 = (win[..., k] for k in range(4))
    q0, q1, q2, q3 = (win[..., 4 + k] for k in range(4))

    if isinstance(qp, torch.Tensor):
        bt = torch.as_tensor(BETA_TABLE, dtype=torch.int32, device=dev)
        beta = bt[(qp + (beta_off << 1)).clamp(0, 51)] << (bit_depth - 8)
    else:
        beta_idx = min(max(qp + (beta_off << 1), 0), 51)
        beta = int(BETA_TABLE[beta_idx]) << (bit_depth - 8)
    bs = bs_ver[:, 1:n_e + 1]
    tc_idx = (qp + 2 * (bs - 1) + (tc_off << 1)).clamp(0, 53)
    tct = torch.as_tensor(TC_TABLE, dtype=torch.int32, device=dev)
    tc = torch.where(bs > 0, tct[tc_idx], 0) << (bit_depth - 8)

    def d2(a, b, c, i):
        return (a[:, i] - 2 * b[:, i] + c[:, i]).abs()

    dp0 = d2(p2, p1, p0, 0)
    dp3 = d2(p2, p1, p0, 3)
    dq0 = d2(q2, q1, q0, 0)
    dq3 = d2(q2, q1, q0, 3)
    dp = dp0 + dp3
    dq = dq0 + dq3
    d = dp0 + dq0 + dp3 + dq3
    filter_on = d < beta

    def strong_line(i):
        return ((2 * (d2(p2, p1, p0, i) + d2(q2, q1, q0, i)) < (beta >> 2))
                & (((p3[:, i] - p0[:, i]).abs()
                    + (q0[:, i] - q3[:, i]).abs()) < (beta >> 3))
                & ((p0[:, i] - q0[:, i]).abs() < ((tc * 5 + 1) >> 1)))
    strong = strong_line(0) & strong_line(3) & filter_on

    max_val = (1 << bit_depth) - 1
    tc4 = tc[:, None, :]
    sp0 = _clip3(p0 - 2 * tc4, p0 + 2 * tc4,
                 (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3)
    sp1 = _clip3(p1 - 2 * tc4, p1 + 2 * tc4, (p2 + p1 + p0 + q0 + 2) >> 2)
    sp2 = _clip3(p2 - 2 * tc4, p2 + 2 * tc4,
                 (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3)
    sq0 = _clip3(q0 - 2 * tc4, q0 + 2 * tc4,
                 (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3)
    sq1 = _clip3(q1 - 2 * tc4, q1 + 2 * tc4, (q2 + q1 + q0 + p0 + 2) >> 2)
    sq2 = _clip3(q2 - 2 * tc4, q2 + 2 * tc4,
                 (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3)

    delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
    weak_on = (delta.abs() < tc4 * 10) \
        & filter_on[:, None, :] & ~strong[:, None, :]
    delta = _clip3(-tc4, tc4, delta)
    wp0 = (p0 + delta).clamp(0, max_val)
    wq0 = (q0 - delta).clamp(0, max_val)
    side_p = (dp < ((beta + (beta >> 1)) >> 3))[:, None, :]
    side_q = (dq < ((beta + (beta >> 1)) >> 3))[:, None, :]
    dp1 = _clip3(-(tc4 >> 1), tc4 >> 1,
                 (((p2 + p0 + 1) >> 1) - p1 + delta) >> 1)
    wp1 = (p1 + dp1).clamp(0, max_val)
    dq1 = _clip3(-(tc4 >> 1), tc4 >> 1,
                 (((q2 + q0 + 1) >> 1) - q1 - delta) >> 1)
    wq1 = (q1 + dq1).clamp(0, max_val)

    sm = strong[:, None, :]
    out_p0 = torch.where(sm, sp0, torch.where(weak_on, wp0, p0))
    out_p1 = torch.where(sm, sp1, torch.where(weak_on & side_p, wp1, p1))
    out_p2 = torch.where(sm, sp2, p2)
    out_q0 = torch.where(sm, sq0, torch.where(weak_on, wq0, q0))
    out_q1 = torch.where(sm, sq1, torch.where(weak_on & side_q, wq1, q1))
    out_q2 = torch.where(sm, sq2, q2)

    vals = torch.stack([out_p2, out_p1, out_p0, out_q0, out_q1, out_q2],
                       dim=-1)
    vals = vals.clamp(0, max_val).reshape(h, n_e, 6)
    cols = (xe[:, None] - 3 + torch.arange(6, device=dev)[None, :]) \
        .reshape(-1)
    out = rec.clone()
    out[:, cols] = vals.reshape(h, -1)
    return out


def _chroma_pass_ver(rec, bs2_rows, qp_c, tc_off: int, bit_depth: int):
    """Filter all 8-aligned vertical chroma edges. rec [Hc, Wc];
    bs2_rows [Hc/2, Wc/8] bool: BS == 2 per 2-row chroma segment; qp_c an
    int or a per-segment [Hc/2, E] map."""
    hc, wc = rec.shape
    n_e = wc // 8 - 1
    if n_e <= 0:
        return rec
    dev = rec.device
    s = hc // 2
    xe = (torch.arange(n_e, device=dev) + 1) * 8
    colwin = xe[:, None] - 2 + torch.arange(4, device=dev)[None, :]
    win = rec[:, colwin].reshape(s, 2, n_e, 4)
    p1, p0, q0, q1 = (win[..., k] for k in range(4))
    if isinstance(qp_c, torch.Tensor):
        tct = torch.as_tensor(TC_TABLE, dtype=torch.int32, device=dev)
        tc = (tct[(qp_c + 2 + (tc_off << 1)).clamp(0, 53)]
              << (bit_depth - 8))[:, None, :]
    else:
        tc_idx = min(max(qp_c + 2 + (tc_off << 1), 0), 53)
        tc = int(TC_TABLE[tc_idx]) << (bit_depth - 8)
    on = bs2_rows[:, 1:n_e + 1][:, None, :]
    delta = _clip3(-tc, tc, (((q0 - p0) << 2) + p1 - q1 + 4) >> 3)
    delta = torch.where(on, delta, 0)
    max_val = (1 << bit_depth) - 1
    out_p0 = (p0 + delta).clamp(0, max_val)
    out_q0 = (q0 - delta).clamp(0, max_val)
    vals = torch.stack([out_p0, out_q0], dim=-1).reshape(hc, n_e, 2)
    cols = (xe[:, None] - 1 + torch.arange(2, device=dev)[None, :]) \
        .reshape(-1)
    out = rec.clone()
    out[:, cols] = vals.reshape(hc, -1)
    return out


def _edge_qp_ver(qp4, n_e: int):
    """Per-segment luma QP of the vertical edges [H/4, E] from the per-4x4
    QP map: (QpQ + QpP + 1) >> 1."""
    xe4 = (torch.arange(n_e, device=qp4.device) + 1) * 2
    return (qp4[:, xe4] + qp4[:, xe4 - 1] + 1) >> 1


def deblock_frame_torch(rec_y, rec_cb, rec_cr, bs_ver, bs_hor, qp: int,
                        qp_cb: int, qp_cr: int, beta_off: int = 0,
                        tc_off: int = 0, bit_depth: int = 8, qp4=None):
    """Device deblock of a 4:2:0 picture. bs_ver [H/4, W/8] / bs_hor
    [H/8, W/4] int 0/1/2 on the luma grid. qp4: the luma QP of each 4x4
    block [H/4, W/4] (delta QP); every edge then filters at its two
    sides' rounded mean, both chroma QPs from that through the chroma
    table (the PPS carries no chroma QP offsets), and qp, qp_cb, qp_cr
    are unused. Returns int32 planes."""
    h, w = rec_y.shape
    if qp4 is not None:
        qp4 = qp4.to(torch.int32)
        qp_v = _edge_qp_ver(qp4, w // 8 - 1)
        qp_h = _edge_qp_ver(qp4.t(), h // 8 - 1)
        ctab = torch.as_tensor(_CQP, dtype=torch.int32, device=qp4.device)
        # chroma edges sit at the 16-aligned luma edges (odd edge index),
        # their 2-row segments on the luma 4-row segments (4:2:0)
        qcb_v = qcr_v = ctab[qp_v[:, 1::2].clamp(0, 57)]
        qcb_h = qcr_h = ctab[qp_h[:, 1::2].clamp(0, 57)]
    else:
        qp_v = qp_h = qp
        qcb_v = qcb_h = qp_cb
        qcr_v = qcr_h = qp_cr
    rec_y = rec_y.to(torch.int32)
    bs_ver = bs_ver.to(torch.int32)
    bs_hor = bs_hor.to(torch.int32)
    rec_y = _luma_pass_ver(rec_y, bs_ver, qp_v, beta_off, tc_off, bit_depth)
    rec_y = _luma_pass_ver(rec_y.t(), bs_hor.t(), qp_h, beta_off, tc_off,
                           bit_depth).t()
    # chroma: BS == 2 at 16-aligned luma edges only; the chroma 2-row
    # segment grid coincides with the luma 4-row segment grid (4:2:0)
    bsv_c = (bs_ver == 2)[:, ::2]
    bsh_c = (bs_hor == 2)[::2, :].t()
    out_cb = _chroma_pass_ver(rec_cb.to(torch.int32), bsv_c, qcb_v, tc_off,
                              bit_depth)
    out_cr = _chroma_pass_ver(rec_cr.to(torch.int32), bsv_c, qcr_v, tc_off,
                              bit_depth)
    out_cb = _chroma_pass_ver(out_cb.t(), bsh_c, qcb_h, tc_off,
                              bit_depth).t()
    out_cr = _chroma_pass_ver(out_cr.t(), bsh_c, qcr_h, tc_off,
                              bit_depth).t()
    return rec_y.contiguous(), out_cb.contiguous(), out_cr.contiguous()
