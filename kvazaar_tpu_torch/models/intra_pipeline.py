"""All-intra pipeline over a fixed 16x16 CTB grid (--ctu 16) in PyTorch.

Device port of kvazaar_tpu/models/intra_pipeline.py (frame dimensions
multiples of 16; the API pads with a conformance window). Two stages:

1. search: all 35 intra modes of every 16x16 block in one batch, from
   clamped source references (one constant-matrix float32 product, exact
   because TF32 is off), costed by 8x8 Hadamard SATD, argmin per block;
2. wavefront reconstruction in 2 (rows - 1) + cols static anti-diagonal
   waves (d = 2r + c): every block of a wave predicts from the
   reconstructed neighbours (with the spec's reference substitution),
   then exact integer transform, quantisation (the deadzone rule or this
   grid's own RDOQ, then the sign-hiding parity fix), dequantisation and
   inverse transform; the block's recon and levels are written back.

Each wave's block list is a static index tensor of its own length, so no
padded wave slot is ever gathered or written. `submit_many` runs B frames
through one pass of the waves, the blocks of all frames side by side.
Then deblocking (ops/deblock_torch.py, BS 2 on every 16-aligned edge of
an intra frame), SAO at 16 luma / 8 chroma (ops/sao_torch.py), the
decoded-picture checksum (int64, reduced mod 2^32) and the SSE.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.intra_matrices import build_filter_matrix, build_pred_matrices
from ..ops.me import satd_tiles
from ..tables import (DCT_MATRICES, INV_QUANT_SCALES, QUANT_SCALES,
                      SCAN_DIAG, chroma_qp, scan_order)
from .intra_md import F32, F64, I32, MdIntraPipeline, _hash_mask, ts_lambda

LUMA_N = 16
CHROMA_N = 8


def _wave_structure(rows: int, cols: int) -> tuple[np.ndarray, np.ndarray,
                                                   int]:
    """Anti-diagonal (d = 2r + c) wave schedule over the block grid.
    Returns (wave_blocks [n_waves, wlen] flat block ids, wave_mask, wlen),
    as the reference lays it out."""
    n_waves = 2 * (rows - 1) + cols
    waves = [[] for _ in range(n_waves)]
    for r in range(rows):
        for c in range(cols):
            waves[2 * r + c].append(r * cols + c)
    wlen = max(len(w) for w in waves)
    blocks = np.zeros((n_waves, wlen), dtype=np.int32)
    mask = np.zeros((n_waves, wlen), dtype=bool)
    for i, w in enumerate(waves):
        blocks[i, :len(w)] = w
        mask[i, :len(w)] = True
    return blocks, mask, wlen


def rdoq_k(qp: int, scale: int, log2n: int) -> float:
    """The float32 rate weight of the grid's RDOQ, 1.5 * lambda * scale^2
    * 4^(7 - log2n), as the reference's compiled program forms it: lambda
    as ts_lambda, scale^2 rounded to float32, the products left to right."""
    sf = np.float32(scale)
    k = np.float32(IntraPipeline.RDOQ_LAMBDA_SCALE) \
        * np.float32(ts_lambda(qp))
    k = np.float32(k * np.float32(sf * sf))
    return float(np.float32(k * np.float32(4.0 ** (7 - log2n))))


class IntraPipeline:
    """All-intra 16x16-grid encoder compute path for one frame size."""

    # the context-free rate model underestimates real CABAC bin costs;
    # the reference's tuned factor
    RDOQ_LAMBDA_SCALE = 1.5

    # shared with the quadtree pipeline: identical functions. _block_pred
    # predicts each block with its own mode, DC's and the 10/26 luma edge
    # filters included; _golomb_log2 is floor(log2) as the reference's
    # compiled log2 gives it
    _filt_refs = MdIntraPipeline._filt_refs
    _dc_pred = MdIntraPipeline._dc_pred
    _fix_1026 = MdIntraPipeline._fix_1026
    _pred_one = _block_pred = MdIntraPipeline._pred_one
    _golomb_log2 = MdIntraPipeline._golomb_log2
    _arange = MdIntraPipeline._arange

    def __init__(self, height: int, width: int, qp: int,
                 deblock: bool = False, deblock_beta: int = 0,
                 deblock_tc: int = 0, sao: str = "off",
                 sign_hiding: bool = False, rdoq: bool = False,
                 device="cuda") -> None:
        assert height % LUMA_N == 0 and width % LUMA_N == 0
        self.device = torch.device(device)
        self.bd, self.maxv = 8, 255
        self.sign_hiding = sign_hiding
        self.rdoq = rdoq
        self.h, self.w, self.qp = height, width, qp
        self.deblock = deblock
        self.deblock_beta = deblock_beta
        self.deblock_tc = deblock_tc
        if sao not in ("off", "full", "band", "edge"):
            raise ValueError(f"sao must be off, full, band or edge: {sao!r}")
        self.sao = None if sao == "off" else sao
        self.rows, self.cols = height // LUMA_N, width // LUMA_N
        self.n_blocks = self.rows * self.cols
        dev = self.device

        def tens(a, dt):
            return torch.as_tensor(np.asarray(a), dtype=dt, device=dev)
        # constant matrices: predictions in float32 (exact), transforms
        # in float64 (exact; CUDA has no int32 matmul)
        self.g16 = tens(build_pred_matrices(LUMA_N), F32)
        self.f16 = tens(build_filter_matrix(LUMA_N), F32)
        self.g8c = tens(build_pred_matrices(CHROMA_N, chroma=True), F32)
        self.t16 = tens(DCT_MATRICES[16], F64)
        self.t8 = tens(DCT_MATRICES[8], F64)
        self.hash_mask_y = tens(_hash_mask(height, width), torch.int64)
        self.hash_mask_c = tens(_hash_mask(height // 2, width // 2),
                                torch.int64)
        blocks, mask, _ = _wave_structure(self.rows, self.cols)
        self.n_waves = blocks.shape[0]
        self._wave_bids = [blocks[i, mask[i]].astype(np.int64)
                           for i in range(self.n_waves)]
        self._wave_cache: dict = {}
        order = np.asarray([y * 4 + x for x, y in scan_order(SCAN_DIAG, 2)],
                           np.int64)
        inv = np.empty(16, np.int64)
        inv[order] = np.arange(16)
        self._diag4 = (tens(order, torch.int64), tens(inv, torch.int64))
        self.set_qp(qp)

    # ------------------------------------------------------------------
    # per-frame QP (rate control changes it without a rebuild)
    # ------------------------------------------------------------------

    def set_qp(self, qp: int | None) -> None:
        qp = self.qp if qp is None else qp
        self.qp_y, self.qp_c = qp, chroma_qp(qp)
        # SAO's float32 lambda 0.57 * 2^((qp - 12) / 3)
        self.lam = torch.tensor(ts_lambda(qp), dtype=F32, device=self.device)

    # ------------------------------------------------------------------
    # stage 1: batched mode search
    # ------------------------------------------------------------------

    def _gather_search_refs(self, src: torch.Tensor) -> torch.Tensor:
        """Clamped source references of every block of src [..., H, W]:
        [..., B, rlen(16)]."""
        n = LUMA_N
        bid = self._arange(self.n_blocks)
        y0 = (bid // self.cols) * n
        x0 = (bid % self.cols) * n
        h, w = self.h, self.w
        ar = self._arange(2 * n)
        iy = (y0[:, None] + ar[None, :]).clamp(0, h - 1)
        ix = (x0[:, None] - 1).clamp(0, w - 1).expand_as(iy)
        left = src[..., iy, ix]
        ty = (y0[:, None] - 1).clamp(0, h - 1)
        tx = (x0[:, None] + ar[None, :]).clamp(0, w - 1)
        top = src[..., ty.expand_as(tx), tx]
        corner = src[..., (y0 - 1).clamp(0, h - 1), (x0 - 1).clamp(0, w - 1)]
        pad = torch.zeros_like(corner)
        return torch.cat([left, corner[..., None], top, pad[..., None]],
                         dim=-1)

    def _preds_all_modes(self, refs, g, f, n: int) -> torch.Tensor:
        """refs [B, rlen] -> predictions [B, 35, n*n] of the matrix rule
        (the DC slot and the 10/26 edges not yet fixed)."""
        both = torch.cat([refs, self._filt_refs(refs, f)], dim=1).to(F32)
        gm = g.reshape(-1, g.shape[-1])
        return torch.floor((both @ gm.t() + 16.0) / 32.0).to(I32) \
            .reshape(-1, 35, n * n)

    def _blocks(self, plane: torch.Tensor, n: int) -> torch.Tensor:
        """[..., rows*n, cols*n] -> [..., n_blocks, n, n] raster blocks."""
        lead = plane.shape[:-2]
        return plane.reshape(*lead, self.rows, n, self.cols, n) \
            .transpose(-3, -2).reshape(*lead, self.n_blocks, n, n)

    def _search(self, src: torch.Tensor):
        """(modes, refs, unfixed predictions) of every block of src
        [..., H, W] int32, blocks flattened over the leading dims."""
        n = LUMA_N
        refs = self._gather_search_refs(src).reshape(-1, 4 * n + 2)
        raw = self._preds_all_modes(refs, self.g16, self.f16, n)
        preds = self._fix_1026(raw, refs, n)
        preds[:, 1, :] = self._dc_pred(refs, n, True)
        blocks = self._blocks(src, n).reshape(-1, 1, n, n)
        cost = satd_tiles(blocks - preds.reshape(-1, 35, n, n))
        return torch.argmin(cost, dim=1).to(I32), refs, raw

    def _search_impl(self, src: torch.Tensor) -> torch.Tensor:
        """Best SATD mode of every block: src [H, W] or [B, H, W] int32 ->
        int32 [n_blocks] or [B, n_blocks] (ties to the lowest mode)."""
        modes = self._search(src)[0]
        return modes.reshape(*src.shape[:-2], self.n_blocks)

    # ------------------------------------------------------------------
    # quantisation: RDOQ and the sign-hiding parity fix of this grid
    # ------------------------------------------------------------------

    def _sdh_fix(self, levels, n: int, err, qbits) -> torch.Tensor:
        """Sign-data-hiding parity fix (spec 7.4.9.11) over the diagonal
        in-CG scan: where a 4x4 group's nonzero span covers >= 4 scan
        positions and the parity of its level sum disagrees with its first
        coefficient's sign, apply the distortion-cheapest |level| +-1: +1
        where the quantiser rounded down hardest (max err), -1 where it
        rounded up hardest (min err; only on |level| >= 2)."""
        order, inv = self._diag4
        L = levels.shape[0]
        g = n // 4
        big = 1 << 30
        q1 = 1 << qbits

        def reorder(x):
            x = x.reshape(L, g, 4, g, 4).transpose(2, 3).reshape(L, g * g,
                                                                 16)
            return x[:, :, order]

        s = reorder(levels)
        e = reorder(err)
        nz = s != 0
        any_nz = nz.any(dim=-1)
        first = torch.argmax(nz.to(torch.uint8), dim=-1)
        last = 15 - torch.argmax(nz.flip(-1).to(torch.uint8), dim=-1)
        total = s.abs().sum(dim=-1)
        sfirst = torch.gather(s, 2, first[..., None])[..., 0]
        need = any_nz & ((last - first) >= 4) \
            & (((total & 1) == 1) != (sfirst < 0))
        e_up = torch.where(nz, e, -big)
        pos_up = torch.argmax(e_up, dim=-1)
        cost_up = q1 - 2 * torch.gather(e_up, 2, pos_up[..., None])[..., 0]
        ok_dn = s.abs() >= 2
        e_dn = torch.where(ok_dn, e, big)
        pos_dn = torch.argmin(e_dn, dim=-1)
        cost_dn = q1 + 2 * torch.gather(e_dn, 2, pos_dn[..., None])[..., 0]
        use_dn = ok_dn.any(dim=-1) & (cost_dn < cost_up)
        pos = torch.where(use_dn, pos_dn, pos_up)
        step = torch.where(use_dn, -1, 1)
        sel = torch.gather(s, 2, pos[..., None])[..., 0]
        bump = torch.where(need, torch.sign(sel) * step, 0)
        s = s + F.one_hot(pos, 16).to(s.dtype) * bump[..., None]
        out = s[:, :, inv].reshape(L, g, g, 4, 4)
        return out.transpose(2, 3).reshape(L, n, n).to(I32)

    def _rdoq_levels(self, co, scale: int, qbits: int, qp: int, log2n: int,
                     offset=None) -> torch.Tensor:
        """This grid's batched RDOQ: per coefficient the |level| among
        {0, l-1, l} (l the nearest) with the least e^2 + k * R, R a
        context-free CABAC-bin count, e the scaled-domain error, in the
        reference's float32 arithmetic (its products fused into one
        rounding where its compiled program fuses them). Non-normative:
        any level choice stays conformant."""
        absco = co.abs()
        lf = (absco * scale + (1 << (qbits - 1))) >> qbits
        k = rdoq_k(qp, scale, log2n)

        def rate(lv):
            r3 = 5.0 + 2.0 * self._golomb_log2(
                (lv.to(F32) - 1.0).clamp(min=1.0))
            return torch.where(lv == 0, 1.0, torch.where(
                lv == 1, 3.0, torch.where(lv == 2, 4.0, r3)))

        def cost(lv):
            e = (absco * scale - (lv << qbits)).to(F32)
            return e * e + k * rate(lv)

        best = torch.zeros_like(lf)
        best_c = cost(best)
        for cand in ((lf - 1).clamp(min=0), lf):
            c = cost(cand)
            take = c < best_c
            best = torch.where(take, cand, best)
            best_c = torch.where(take, c, best_c)
        return (torch.sign(co) * best).to(I32)

    def _quant_levels(self, co, scale: int, qbits: int, offset, qp: int,
                      log2n: int) -> torch.Tensor:
        """Quantise: RDOQ when on, else the deadzone rule with `offset`
        (an int, or [L, 1, 1] per block); then the sign-hiding fix."""
        if self.rdoq:
            levels = self._rdoq_levels(co, scale, qbits, qp, log2n, offset)
        else:
            levels = (torch.sign(co) * ((co.abs() * scale + offset)
                                        >> qbits)).to(I32)
        if self.sign_hiding:
            err = co.abs() * scale - (levels.abs() << qbits)
            levels = self._sdh_fix(levels, 1 << log2n, err, qbits)
        return levels

    def _transform_quant(self, resi, t, qp: int, n: int, inter_w=None):
        """Forward transform, quantisation, dequantisation and inverse
        transform in exact integer arithmetic (the products in float64).
        resi [L, n, n] int32 -> (levels, recon residual). inter_w [L]
        bool: the inter blocks' rounding offset (85 instead of 171)."""
        log2n = int(np.log2(n))
        shift1, shift2 = log2n - 1, log2n + 6
        tmp = (t @ resi.to(F64).transpose(1, 2)).to(I32)
        tmp = (tmp + (1 << (shift1 - 1))) >> shift1
        co = (t @ tmp.to(F64).transpose(1, 2)).to(I32)
        co = (co + (1 << (shift2 - 1))) >> shift2
        qbits = 14 + qp // 6 + (7 - log2n)
        scale = int(QUANT_SCALES[qp % 6])
        offset = 171 << (qbits - 9)
        if inter_w is not None:
            offset = torch.where(inter_w[:, None, None], 85 << (qbits - 9),
                                 offset)
        levels = self._quant_levels(co, scale, qbits, offset, qp, log2n)
        dshift = log2n - 1
        dscale = int(INV_QUANT_SCALES[qp % 6]) << (qp // 6)
        deq = ((levels * dscale + (1 << (dshift - 1))) >> dshift) \
            .clamp(-32768, 32767)
        tmp2 = (t.t() @ deq.to(F64)).to(I32)
        tmp2 = ((tmp2 + 64) >> 7).clamp(-32768, 32767)
        r2 = (tmp2.to(F64) @ t).to(I32)
        return levels, ((r2 + 2048) >> 12).clamp(-32768, 32767)

    # ------------------------------------------------------------------
    # stage 2: wavefront reconstruction
    # ------------------------------------------------------------------

    def _gather_recon_refs(self, rec, bids, n: int, cols: int,
                           frame=None) -> torch.Tensor:
        """Normative references with substitution from padded recon
        planes rec [B, 1 + H + n, 1 + W + n] (or one plane [1 + H + n,
        1 + W + n]), the picture at offset (1, 1); frame [L]: each block's
        plane (0 by default). Every gather lies inside the padding.
        Returns [L, 4n + 2]."""
        if rec.dim() == 2:
            rec = rec[None]
        if frame is None:
            frame = torch.zeros_like(bids)
        r = bids // cols
        c = bids % cols
        y0 = r * n + 1
        x0 = c * n + 1
        ar = self._arange(2 * n)
        fr = frame[:, None]
        left = rec[fr, y0[:, None] + ar[None, :], (x0 - 1)[:, None]]
        top = rec[fr, (y0 - 1)[:, None], x0[:, None] + ar[None, :]]
        corner = rec[frame, y0 - 1, x0 - 1]
        has_top = (r > 0)[:, None]
        has_left = (c > 0)[:, None]
        has_tr = ((r > 0) & (c < cols - 1))[:, None]
        # bottom-left is never available in a flat CTB grid; substitution
        # (spec 8.4.4.2.2) at segment granularity
        lu = torch.where(has_left, left[:, :n],
                         torch.where(has_top, top[:, :1], 128))
        bl = lu[:, n - 1:n].expand(-1, n)
        ht, hl = has_top[:, 0], has_left[:, 0]
        corner_sub = torch.where(ht & hl, corner, torch.where(
            hl, lu[:, 0], torch.where(ht, top[:, 0], 128)))
        tmain = torch.where(has_top, top[:, :n], corner_sub[:, None])
        tr = torch.where(has_tr, top[:, n:], tmain[:, n - 1:n])
        pad = torch.zeros_like(corner_sub)[:, None]
        return torch.cat([lu, bl, corner_sub[:, None], tmain, tr, pad],
                         dim=1).to(I32)

    def _wave_plan(self, nf: int) -> list:
        """Per wave (global block ids, frame, block id) of nf frames whose
        blocks lie side by side: frame b's block i is b * n_blocks + i."""
        plan = self._wave_cache.get(nf)
        if plan is None:
            plan = []
            for bids in self._wave_bids:
                g = (np.arange(nf)[:, None] * self.n_blocks
                     + bids[None, :]).reshape(-1)
                gt = torch.as_tensor(g, device=self.device)
                plan.append((gt, gt // self.n_blocks, gt % self.n_blocks))
            self._wave_cache[nf] = plan
        return plan

    def _wave_loop(self, src_y, src_cb, src_cr, modes, is_inter=None,
                   ipreds=None):
        """The static wavefront over nf frames: src planes [nf, H(/2),
        W(/2)] int32, modes [nf, n_blocks]; is_inter [nf, n_blocks] bool
        and ipreds (y, cb, cr) [nf * n_blocks, n, n]: the inter blocks'
        predictions. Returns (padded recon planes, levels) per plane."""
        n, nc = LUMA_N, CHROMA_N
        nf, h, w = src_y.shape
        nb = self.n_blocks
        planes = []
        for src, size, g, f, t, qp in (
                (src_y, n, self.g16, self.f16, self.t16, self.qp_y),
                (src_cb, nc, self.g8c, self.g8c, self.t8, self.qp_c),
                (src_cr, nc, self.g8c, self.g8c, self.t8, self.qp_c)):
            rec = torch.zeros((nf, 1 + src.shape[1] + size,
                               1 + src.shape[2] + size), dtype=I32,
                              device=self.device)
            lv = torch.zeros((nf * nb, size, size), dtype=I32,
                             device=self.device)
            planes.append([rec, lv, self._blocks(src, size).reshape(
                nf * nb, size, size), size, g, f, t, qp])
        modes = modes.reshape(-1)
        inter = None if is_inter is None else is_inter.reshape(-1)
        ar = {s: self._arange(s) for s in (n, nc)}
        for gids, fr, bids in self._wave_plan(nf):
            modes_w = modes[gids]
            inter_w = None if inter is None else inter[gids]
            r, c = bids // self.cols, bids % self.cols
            for k, st in enumerate(planes):
                rec, lv, srcb, size, g, f, t, qp = st
                refs = self._gather_recon_refs(rec, bids, size, self.cols,
                                               fr)
                pred = self._block_pred(refs, modes_w, g, f, size,
                                        k == 0).reshape(-1, size, size)
                if inter_w is not None:
                    pred = torch.where(inter_w[:, None, None],
                                       ipreds[k][gids], pred)
                levels, r2 = self._transform_quant(srcb[gids] - pred, t, qp,
                                                   size, inter_w)
                cbf = (levels != 0).any(dim=2).any(dim=1)[:, None, None]
                rec_blk = (pred + torch.where(cbf, r2, 0)).clamp(0, 255)
                yy = (r * size + 1)[:, None, None] + ar[size][None, :, None]
                xx = (c * size + 1)[:, None, None] + ar[size][None, None, :]
                rec[fr[:, None, None], yy, xx] = rec_blk
                lv[gids] = torch.where(cbf, levels, 0)
        return [(st[0], st[1]) for st in planes]

    def _waves_impl(self, src_y, src_cb, src_cr, modes_flat):
        """Wavefront reconstruction of intra frames: planes [H(/2), W(/2)]
        with modes [n_blocks] -> the output dict; or [B, ...] planes with
        modes [B, n_blocks] -> a list of B output dicts."""
        one = src_y.dim() == 2
        if one:
            src_y, src_cb, src_cr = src_y[None], src_cb[None], src_cr[None]
            modes_flat = modes_flat[None]
        loop = self._wave_loop(src_y, src_cb, src_cr, modes_flat)
        outs = [self._outputs(*self._frame_planes(loop, b), src_y[b],
                              src_cb[b], src_cr[b])
                for b in range(src_y.shape[0])]
        return outs[0] if one else outs

    def _frame_planes(self, loop, b: int) -> tuple:
        """Frame b's padded recon planes and levels out of _wave_loop."""
        nb = self.n_blocks
        (ry, ly), (rcb, lcb), (rcr, lcr) = loop
        sl = slice(b * nb, (b + 1) * nb)
        return ry[b], rcb[b], rcr[b], ly[sl], lcb[sl], lcr[sl]

    def _expand_bs(self, bs_blk_v, bs_blk_h):
        """Per-block-edge BS [R, C] (vertical: the edge left of block
        (r, c); horizontal: the edge above) -> the segment maps [H/4, W/8]
        and [H/8, W/4] (16-aligned edges only, picture borders excluded)."""
        h, w = self.h, self.w
        bs_ver = torch.zeros((h // 4, w // 8), dtype=I32, device=self.device)
        bs_ver[:, 2::2] = bs_blk_v[:, 1:].repeat_interleave(4, 0)
        bs_hor = torch.zeros((h // 8, w // 4), dtype=I32, device=self.device)
        bs_hor[2::2, :] = bs_blk_h[1:, :].repeat_interleave(4, 1)
        return bs_ver, bs_hor

    def _apply_deblock(self, ry, rcb, rcr, bs_blk_v=None, bs_blk_h=None):
        """In-loop deblocking (the checksum, the SSE and the reference
        picture see the filtered planes); BS 2 everywhere by default (an
        intra frame)."""
        from ..ops.deblock_torch import deblock_frame_torch
        if bs_blk_v is None:
            bs_blk_v = torch.full((self.rows, self.cols), 2, dtype=I32,
                                  device=self.device)
            bs_blk_h = bs_blk_v
        bs_ver, bs_hor = self._expand_bs(bs_blk_v, bs_blk_h)
        return deblock_frame_torch(ry, rcb, rcr, bs_ver, bs_hor, self.qp_y,
                                   self.qp_c, self.qp_c, self.deblock_beta,
                                   self.deblock_tc)

    def _outputs(self, rec_y, rec_cb, rec_cr, ly, lcb, lcr, src_y, src_cb,
                 src_cr, bs_blk=None) -> dict:
        """One frame's outputs from its padded recon planes: deblocking and
        SAO when on, the final planes, levels (int16), the checksum and
        the SSE."""
        h, w = self.h, self.w
        ry = rec_y[1:1 + h, 1:1 + w]
        rcb = rec_cb[1:1 + h // 2, 1:1 + w // 2]
        rcr = rec_cr[1:1 + h // 2, 1:1 + w // 2]
        if self.deblock:
            bv, bh = bs_blk if bs_blk is not None else (None, None)
            ry, rcb, rcr = self._apply_deblock(ry, rcb, rcr, bv, bh)
        out = {}
        if self.sao:
            from ..ops.sao_torch import sao_chroma, sao_luma
            ab = self.sao in ("full", "band")
            ae = self.sao in ("full", "edge")
            ry, py = sao_luma(src_y, ry, LUMA_N, self.lam, ab, ae)
            rcb, rcr, pc = sao_chroma(src_cb, src_cr, rcb, rcr, CHROMA_N,
                                      self.lam, ab, ae)
            out.update({"sao_y_" + k: v.to(torch.int8)
                        for k, v in py.items()})
            out.update({"sao_c_" + k: v.to(torch.int8)
                        for k, v in pc.items()})

        def cksum(plane, mask):
            return ((plane.to(torch.int64) ^ mask).sum()) & 0xFFFFFFFF

        def sse(a, b):
            d = (a - b).to(torch.int64)
            return (d * d).sum()

        out.update({
            "rec_y": ry.to(torch.uint8), "rec_cb": rcb.to(torch.uint8),
            "rec_cr": rcr.to(torch.uint8),
            "levels_y": ly.to(torch.int16), "levels_cb": lcb.to(torch.int16),
            "levels_cr": lcr.to(torch.int16),
            "hash": torch.stack([cksum(ry, self.hash_mask_y),
                                 cksum(rcb, self.hash_mask_c),
                                 cksum(rcr, self.hash_mask_c)]),
            "sse": torch.stack([sse(ry, src_y), sse(rcb, src_cb),
                                sse(rcr, src_cr)]),
            "n_waves": self.n_waves})
        return out

    def _full_impl(self, src_y, src_cb, src_cr) -> list[dict]:
        """Search and reconstruct nf frames [nf, H(/2), W(/2)] uint8."""
        src_y, src_cb, src_cr = (p.to(I32) for p in (src_y, src_cb, src_cr))
        modes = self._search_impl(src_y)
        outs = self._waves_impl(src_y, src_cb, src_cr, modes)
        for o, m in zip(outs, modes):
            o["modes_flat"] = m
        return outs

    # ------------------------------------------------------------------
    # host interface
    # ------------------------------------------------------------------

    def _to_dev(self, a) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a.to(self.device)
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _stack_frames(self, planes) -> torch.Tensor:
        return torch.stack([self._to_dev(p) for p in planes])

    @torch.inference_mode()
    def submit(self, src_y, src_cb, src_cr, qp: int | None = None) -> dict:
        """Run one frame's device work; returns its device outputs. qp
        overrides the constructor's QP for this frame (rate control)."""
        return self.submit_many([src_y], [src_cb], [src_cr], qp=qp)[0]

    @torch.inference_mode()
    def submit_many(self, ys, cbs, crs, qp: int | None = None) -> list:
        """B independent intra frames through one search and one pass of
        the waves (every wave holds the blocks of all B frames); returns
        the per-frame output dicts."""
        self.set_qp(qp)
        return self._full_impl(self._stack_frames(ys), self._stack_frames(cbs),
                               self._stack_frames(crs))

    def materialize(self, out: dict) -> dict:
        """Pull the decisions the writers read to the host as numpy (the
        reference's names and shapes); the recon planes stay on the
        device."""
        res = {}
        for k, v in out.items():
            if k in ("rec_y", "rec_cb", "rec_cr"):
                res[k] = v
            elif k == "n_waves":
                res[k] = int(v)
            else:
                res[k] = v.cpu().numpy()
        for p in ("y", "cb", "cr"):
            res["levels_" + p] = res["levels_" + p].astype(np.int32)
        res["hash"] = res["hash"].astype(np.uint32)
        shape = (self.rows, self.cols)
        res["modes"] = res.pop("modes_flat").reshape(shape)
        if "mv" in res:
            res["mv"] = res["mv"].reshape(*shape, 2)
        if "is_inter" in res:
            res["is_inter"] = res["is_inter"].reshape(shape)
        if "ref_idx" in res:
            res["ref_idx"] = res["ref_idx"].reshape(shape)
        if "mv2" in res:
            res["mv2"] = res["mv2"].reshape(*shape, 2, 2)
            res["ref2"] = res["ref2"].reshape(*shape, 2)
            res["inter_dir"] = res["inter_dir"].reshape(shape)
        return res
