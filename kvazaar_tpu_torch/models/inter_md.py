"""Quadtree (CTB 64) inter pipeline in PyTorch: generalized-B slices.

Device port of the B program of kvazaar_tpu/models/inter_md.py with one
or two reference pictures a list (--ref 1-4; the stacks are padded to
n_refs_b = min(2, n_refs) by repeating their last picture), bi-prediction
on, --subme 4, inter CU depths 0-3, no SMP/AMP:

1. hierarchical ME, per list and reference picture: an exhaustive +-24
   coarse sweep at 1/4 resolution gives a 16x16-block motion field; every
   aligned block of every size (8..64) refines the field candidates to
   quarter-pel with the `me_refine` kernel (ops/me.py);
2. decision: per size, each list's best reference and MV, their exact
   bi-average, the cross-reference bi candidate (list 0 on picture 0,
   list 1 on picture 1) and the merge candidates (uni and bi SATDs of
   exact MV pairs, each pair on its own references, one `me_eval` launch
   for all four candidates) compete; the winner gets an exact RD cost
   against the intra leaf cost, then the bottom-up DP picks the quadtree
   (8..64);
3. reconstruction: inter leaves reconstruct in one batch, then the intra
   wavefront (models/intra_md.py) fills the intra leaves;
4. deblocking with the two-list boundary-strength rule, checksum, SSE.
"""
from __future__ import annotations

import torch

from ..ops.mc import CHROMA_FILTERS
from ..ops.me import me_eval, me_refine, satd_tiles
from .intra_md import F32, I32, MdIntraPipeline, rep2, unsupported

NO_REF_POC = -(1 << 30)


class MdInterPipeline(MdIntraPipeline):
    """B-slice quadtree encoder compute path for one frame size."""

    COARSE = 4          # downsample factor of the wide sweep
    COARSE_RANGE = 24   # coarse integer range (=> +-96 full-res)
    INIT_TYPE = 1       # P/B-slice context init for the DP bit costs
    DPC_SKIP = 13
    DPC_MERGE = 14
    DPC_AMVP = 15
    DPC_RQT0, DPC_RQT1 = 16, 17
    DPC_REF0, DPC_REF_STEP = 18, 19
    DPC_MVD_G0_0, DPC_MVD_G0_1 = 20, 21
    DPC_MVD_G1_0, DPC_MVD_G1_1 = 22, 23
    DPC_IDC_UNI, DPC_IDC_BI = 24, 25
    DPC_INTRA_PM = 26
    DPC_PART0_0 = 27
    DPC_PART1_0, DPC_PART1_1 = 28, 29
    DPC_PART3_0, DPC_PART3_1 = 30, 31
    DPC_PU_EXTRA = 32
    # merge_idx estimate deltas (bits) of the left/top/CTB-corner/zero
    # candidates
    MERGE_DELTAS = (0.0, 0.8, 1.2, 1.6)

    def __init__(self, height: int, width: int, qp: int,
                 n_refs: int = 1, b_slices: bool = True,
                 pu_depth_inter: tuple[int, int] = (0, 3),
                 subme: int = 4, bipred: bool = True,
                 smp: bool = False, amp: bool = False, **kw) -> None:
        for bad, what, entry in (
                (not bipred or not b_slices, "--no-bipred (the P program)",
                 "the P program and SMP/AMP"),
                (smp or amp, "--smp/--amp", "the P program and SMP/AMP"),
                (tuple(pu_depth_inter) != (0, 3),
                 "--pu-depth-inter other than 0-3",
                 "the remaining intra variants"),
                (subme != 4, "--subme other than 4",
                 "the remaining intra variants")):
            if bad:
                raise unsupported(what, entry)
        super().__init__(height, width, qp, **kw)
        # fixed per-list stack depth (padded by repeating the last picture)
        self.n_refs_b = min(2, max(1, n_refs))

    def _dpc_vec(self, qp: int) -> list[float]:
        from ..engine.bit_cost import inter_dp_costs
        c = inter_dp_costs(qp, self.INIT_TYPE)
        return super()._dpc_vec(qp) + [
            c["skip"], c["merge"], c["amvp"], c["rqt0"], c["rqt1"],
            c["ref0"], c["ref_step"], c["mvd_g0_0"], c["mvd_g0_1"],
            c["mvd_g1_0"], c["mvd_g1_1"], c["idc_uni"], c["idc_bi"],
            c["intra_pm"], c["part0_0"], c["part1_0"], c["part1_1"],
            c["part3_0"], c["part3_1"], c["pu_extra"]]

    # ------------------------------------------------------------------
    # motion compensation (exact qpel luma / eighth-pel chroma)
    # ------------------------------------------------------------------

    def _mc_chroma_sel(self, planes, ref, mv, cy0, cx0, nc: int,
                       hi: bool = False):
        """Chroma MC from a reference stack [K, Hc, Wc] with per-block
        ref index; clamped indices equal edge padding."""
        _, hc, wc = planes.shape
        ar = self._arange(nc + 3)
        wy = (cy0 + (mv[:, 1] >> 3) - 1)[:, None] + ar[None, :]
        wx = (cx0 + (mv[:, 0] >> 3) - 1)[:, None] + ar[None, :]
        wy = wy.clamp(0, hc - 1)
        wx = wx.clamp(0, wc - 1)
        win = planes[ref.long()[:, None, None], wy[:, :, None],
                     wx[:, None, :]]
        fmat = torch.as_tensor(CHROMA_FILTERS, dtype=I32,
                               device=self.device)
        cxf = fmat[(mv[:, 0] & 7).long()]
        cyf = fmat[(mv[:, 1] & 7).long()]
        h14 = sum(cxf[:, k, None, None] * win[:, :, k:k + nc]
                  for k in range(4))
        v = sum(cyf[:, k, None, None] * h14[:, k:k + nc, :]
                for k in range(4)) >> 6
        if hi:
            return v
        return ((v + 32) >> 6).clamp(0, self.maxv)

    def _bi_avg(self, a, b):
        """Exact bi-prediction average of two 14-bit signals."""
        return ((a + b + 64) >> 7).clamp(0, self.maxv)

    def _uni_round(self, v):
        return ((v + 32) >> 6).clamp(0, self.maxv)

    @staticmethod
    def _left_of(g, fill=None):
        """Value of the left same-size neighbour per grid cell."""
        first = g[:, :1] if fill is None else torch.full_like(g[:, :1],
                                                              fill)
        return torch.cat([first, g[:, :-1]], dim=1)

    @staticmethod
    def _top_of(g, fill=None):
        first = g[:1] if fill is None else torch.full_like(g[:1], fill)
        return torch.cat([first, g[:-1]], dim=0)

    # ------------------------------------------------------------------
    # hierarchical motion estimation
    # ------------------------------------------------------------------

    def _coarse_field(self, src_y, ref_y):
        """Dense 16x16-block integer motion field from an exhaustive
        sweep at 1/4 resolution: mv16 [r16, c16, 2] full-res pels. Ties
        keep the first minimum in (dy, dx) scan order."""
        C, R = self.COARSE, self.COARSE_RANGE
        h, w = self.h // C, self.w // C
        sc = src_y.reshape(h, C, w, C).sum(dim=(1, 3), dtype=I32)
        rc = ref_y.reshape(h, C, w, C).sum(dim=(1, 3), dtype=I32)
        n = 16 // C
        rows, cols = h // n, w // n
        iy = torch.arange(-R, h + R, device=self.device).clamp(0, h - 1)
        ix = torch.arange(-R, w + R, device=self.device).clamp(0, w - 1)
        rpad = rc[iy][:, ix]
        ndx = 2 * R + 1
        best_sad = torch.full((rows, cols), 1 << 30, dtype=I32,
                              device=self.device)
        best_code = torch.zeros((rows, cols), dtype=I32, device=self.device)
        for dy in range(ndx):
            strip = rpad[dy:dy + h]
            cands = torch.stack([strip[:, dx:dx + w] for dx in range(ndx)])
            d = (cands - sc[None]).abs()
            sads = d.reshape(ndx, rows, n, cols, n).sum(dim=(2, 4),
                                                        dtype=I32)
            sad_best, dx_best = torch.min(sads, dim=0)
            better = sad_best < best_sad
            best_code = torch.where(better, dy * 64 + dx_best.to(I32),
                                    best_code)
            best_sad = torch.where(better, sad_best, best_sad)
        mv = torch.stack([(best_code % 64) - R, (best_code // 64) - R],
                         dim=-1)
        return (mv * C).to(I32)

    def _field_for(self, mv16, n: int):
        """Candidate integer MV(s) per aligned n-block from the 16-field."""
        if n == 16:
            return mv16.reshape(-1, 2)
        if n == 8:
            return rep2(mv16, 2).reshape(-1, 2)
        s2 = n // 16
        h = s2 // 2
        return torch.stack(
            [mv16[::s2, ::s2], mv16[::s2, h::s2],
             mv16[h::s2, ::s2], mv16[h::s2, h::s2]], dim=2).reshape(-1, 4, 2)

    def _lam64(self):
        """Integer sqrt-lambda scale for the refine MV-cost prior [1]."""
        return torch.floor(torch.sqrt(self.c["lam2"]) * 64.0 + 0.5).to(I32)

    def _me_sizes(self, src_y, refs_y, fields):
        """Per-size, per-reference ME through the me_refine kernel:
        returns {n: [(mv_q [L,2], satd [L], pred [L,n,n], cand0 [L,2])
        per picture of the stack refs_y]}, fields being the pictures'
        16-fields. Candidates: own/parent 16-field MV + zero for 8/16,
        four spread field samples + zero for 32/64."""
        lam64 = self._lam64()
        out = {8: [], 16: [], 32: [], 64: []}
        for k in range(refs_y.shape[0]):
            ref = refs_y[k].contiguous()
            f16 = fields[k]
            for n in (8, 16, 32, 64):
                rows, cols = self.h // n, self.w // n
                if n in (8, 16):
                    c0 = self._field_for(f16, n)
                    cands = torch.stack([c0, torch.zeros_like(c0)], dim=1)
                else:
                    cands = torch.cat(
                        [self._field_for(f16, n),
                         torch.zeros((rows * cols, 1, 2), dtype=I32,
                                     device=self.device)], dim=1)
                    c0 = cands[:, 0, :]
                blocks = self._blocks(src_y, n).contiguous()
                mv_q, satd, pred = me_refine(ref, blocks, cands.contiguous(),
                                             lam64, n=n, cols=cols,
                                             maxv=self.maxv)
                out[n].append((mv_q, satd, pred, c0))
        return out

    def _mv_bins(self, mvd):
        """Fractional-bit cost of an MVD at context init states."""
        a = mvd.abs().to(F32)
        d = self.dpc
        eg1 = 2.0 * torch.floor(torch.log2(a.clamp(min=2.0) / 2.0)) + 2.0
        per = torch.where(
            a == 0, d[self.DPC_MVD_G0_0],
            d[self.DPC_MVD_G0_1] + 1.0
            + torch.where(a == 1, d[self.DPC_MVD_G1_0],
                          d[self.DPC_MVD_G1_1] + eg1))
        return per.sum(dim=-1)

    def _ref_cost(self, k: int, n_list: int):
        """ref_idx signalling bits of index k in a list of n_list
        pictures (0 when the list has one)."""
        if n_list <= 1:
            return torch.zeros((), dtype=F32, device=self.device)
        if k == 0:
            return self.dpc[self.DPC_REF0]
        return self.dpc[self.DPC_REF_STEP] + float(max(0, k - 1))

    def _pick_ref_me(self, me, lam_satd):
        """Best reference of one list from its per-picture ME results at
        one size (strict < in stack order, SATD + sqrt-lambda x (MVD +
        ref_idx bits)): (mv, ref index, satd, mvd bits)."""
        best = None
        for k, (mv_k, satd_k, _, cand0) in enumerate(me):
            bits_k = self._mv_bins(mv_k - cand0 * 4)
            cost_k = satd_k.to(F32) + lam_satd * (
                bits_k + self._ref_cost(k, len(me)))
            cur = (cost_k, mv_k, torch.full_like(satd_k, k), satd_k, bits_k)
            if best is None:
                best = cur
                continue
            better = cost_k < best[0]
            best = tuple(torch.where(
                better.reshape(-1, *([1] * (a.dim() - 1))), a, b)
                for a, b in zip(cur, best))
        return best[1:]

    def _eval_pairs(self, l0_y, l1_y, blocks, mv0, mv1, r0, r1, n: int,
                    want_satd: bool = True, want_pred: bool = False):
        """Exact evaluation of K candidate pairs per block in one me_eval
        launch: mv0/mv1 [L, K, 2] qpel on the pictures r0/r1 [L, K] of
        the list stacks l0_y/l1_y [R, H, W] (one tensor when list 1 is
        list 0). Returns ((satd0, satd1, satd_bi) [L, K] or None,
        (v0, v1) 14-bit [L, n, n] or None)."""
        return me_eval(l0_y.contiguous(), l1_y.contiguous(),
                       blocks.contiguous(), mv0.to(I32).contiguous(),
                       mv1.to(I32).contiguous(), r0.to(I32).contiguous(),
                       r1.to(I32).contiguous(), n=n, cols=self.w // n,
                       maxv=self.maxv, want_satd=want_satd,
                       want_pred=want_pred)

    def _merge_align_b(self, l0_y, l1_y, blocks, rows: int, cols: int,
                       n: int, mv0, r0, mv1, r1, dirn, acost, lam_satd):
        """Merge-aware alignment: neighbour full-motion tuples + the
        zero-L0 candidate, exact-SATD evaluated (exact 14-bit bi);
        chain-safe (a block adopts a neighbour's motion only when that
        neighbour keeps its own)."""
        nb = rows * cols

        def grid(a):
            return a.reshape(rows, cols, *a.shape[1:])
        fields = (mv0, r0, mv1, r1, dirn)
        candL = tuple(self._left_of(grid(f)).reshape(f.shape)
                      for f in fields)
        candT = tuple(self._top_of(grid(f)).reshape(f.shape)
                      for f in fields)
        k = max(1, self.CTB // n)
        rS = (self._arange(rows) // k) * k
        cS = (self._arange(cols) // k) * k
        candS = tuple(grid(f)[rS[:, None], cS[None, :]].reshape(f.shape)
                      for f in fields)
        cand0 = (torch.zeros_like(mv0), torch.zeros_like(r0),
                 torch.zeros_like(mv1), torch.zeros_like(r1),
                 torch.ones_like(dirn))
        ci = self._arange(cols)[None, :].expand(rows, cols).reshape(-1)
        ri = self._arange(rows)[:, None].expand(rows, cols).reshape(-1)
        ones = torch.ones((nb,), dtype=torch.bool, device=self.device)
        valids = (ci > 0, ri > 0, ones, ones)
        cands = (candL, candT, candS, cand0)
        (s0, s1, sbi), _ = self._eval_pairs(
            l0_y, l1_y, blocks, *(torch.stack([c[i] for c in cands], dim=1)
                                  for i in (0, 2, 1, 3)), n)
        best = None
        for c, (cand, valid) in enumerate(zip(cands, valids)):
            cdir = cand[4]
            s_c = torch.where(cdir == 3, sbi[:, c],
                              torch.where(cdir == 1, s0[:, c], s1[:, c]))
            cost_c = s_c.to(F32) + lam_satd * (
                self.dpc[self.DPC_MERGE] + self.MERGE_DELTAS[c])
            cost_c = torch.where(valid, cost_c, 1e18)
            cur = (cost_c,) + cand + (torch.full((nb,), c, dtype=I32,
                                                 device=self.device),)
            if best is None:
                best = cur
            else:
                better = cost_c < best[0]
                best = tuple(torch.where(
                    better.reshape(-1, *([1] * (a.dim() - 1))), a, b)
                    for a, b in zip(cur, best))
        mcost, bm0, br0, bm1, br1, bdir, mpick = best
        use = mcost < acost
        same = ((bm0 == mv0).all(dim=-1) & (br0 == r0)
                & (bm1 == mv1).all(dim=-1) & (br1 == r1) & (bdir == dirn))
        chg = (use & ~same).reshape(rows, cols)
        srcL = self._left_of(chg, fill=False).reshape(-1)
        srcT = self._top_of(chg, fill=False).reshape(-1)
        srcC = chg[rS[:, None], cS[None, :]].reshape(-1)
        use = use & ~(((mpick == 0) & srcL) | ((mpick == 1) & srcT)
                      | ((mpick == 2) & srcC))

        def pick(a, b):
            return torch.where(use.reshape(-1, *([1] * (a.dim() - 1))),
                               a, b)
        delta = sum(torch.where(mpick == c, self.MERGE_DELTAS[c], 0.0)
                    .to(F32) for c in range(len(self.MERGE_DELTAS)))
        return (pick(bm0, mv0), pick(br0, r0), pick(bm1, mv1),
                pick(br1, r1), pick(bdir, dirn), use, delta)

    # ------------------------------------------------------------------
    # per-size inter candidate + cost
    # ------------------------------------------------------------------

    def _rd_zero_tu(self, resi, levels, r2, n: int, is_luma: bool,
                    depth1: bool = False):
        """RD choice between coding the quantized residual and zeroing
        the whole TU (cbf = 0); losing TUs come back zeroed."""
        lam = self.lam
        dist_c = self._sqsum(resi - r2)
        dist_z = self._sqsum(resi)
        if is_luma:
            rate = self._tu_rate_y(levels, n, depth1=depth1)
            zr = self.dpc[self.DPC_CBF_Y0_D1 if depth1 else self.DPC_CBF_Y0]
        else:
            rate = self._tu_rate_c(levels, n, depth1=depth1)
            zr = self.dpc[self.DPC_CBF_C0_D1 if depth1 else self.DPC_CBF_C0]
        drop = (dist_z + lam * zr <= dist_c + lam * rate)[:, None, None]
        return torch.where(drop, 0, levels), torch.where(drop, 0, r2)

    def _tq_quad(self, resi, qp: int, is_luma: bool, tools: bool):
        """T/Q a [B, n, n] residual as four n/2 TUs (the forced transform
        split of 64-luma / 32-chroma blocks), each with the zero-cbf RD
        competition. tools: as in _transform_quant. Returns (levels,
        recon residual) [B, n, n]."""
        B, n, _ = resi.shape
        hn = n // 2
        q = resi.reshape(B, 2, hn, 2, hn).transpose(2, 3) \
            .reshape(B * 4, hn, hn)
        lev, r2 = self._transform_quant(q, hn, qp, is_luma=is_luma,
                                        tools=tools)
        lev, r2 = self._rd_zero_tu(q, lev, r2, hn, is_luma, depth1=True)
        cbf = (lev != 0).any(dim=-1).any(dim=-1)[:, None, None]
        r2 = torch.where(cbf, r2, 0)
        lev = torch.where(cbf, lev, 0)

        def back(x):
            return x.reshape(B, 2, 2, hn, hn).transpose(2, 3) \
                .reshape(B, n, n)
        return back(lev), back(r2)

    def _code_residual(self, resi, n: int, qp: int, is_luma: bool,
                       tools: bool):
        """(levels, recon residual, rate) of a leaf's luma or chroma
        residual: four forced-split TUs at 64 luma / 32 chroma, else one
        TU, each with the zero-cbf competition. tools: as in
        _transform_quant (the search quantises plainly, the
        reconstruction with the configured tools)."""
        rate_fn = self._tu_rate_y if is_luma else self._tu_rate_c
        if n == 32 + 32 * is_luma:
            levels, r2 = self._tq_quad(resi, qp, is_luma, tools)
            L, hn = levels.shape[0], n // 2
            lv4 = levels.reshape(L, 2, hn, 2, hn).transpose(2, 3) \
                .reshape(L * 4, hn, hn)
            rate = rate_fn(lv4, hn, depth1=True).reshape(L, 4).sum(dim=1)
            return levels, r2, rate
        levels, r2 = self._transform_quant(resi, n, qp, is_luma=is_luma,
                                           tools=tools)
        levels, r2 = self._rd_zero_tu(resi, levels, r2, n, is_luma)
        return levels, r2, rate_fn(levels, n)

    def _inter_leaf_b(self, src_y, src_cb, src_cr, l0, l1, n: int, me0,
                      me1):
        """Best B-slice inter candidate per aligned n-block: per-list
        SATD-best uni candidates + their exact bi-prediction, merge
        alignment, then one exact RD cost of the winner for the DP.
        Returns (mv0, r0, mv1, r1, dir, cost, pred_y, pred_cb, pred_cr)."""
        lam = self.lam
        (l0_y, l0_cb, l0_cr), (l1_y, l1_cb, l1_cr) = l0, l1
        blocks = self._blocks(src_y, n)
        rows, cols = self.h // n, self.w // n
        nb = rows * cols
        bid = self._arange(nb)
        lam_satd = torch.sqrt(lam)
        mv0, r0, satd0, bits0 = self._pick_ref_me(me0, lam_satd)
        mv1, r1, satd1, bits1 = self._pick_ref_me(me1, lam_satd)
        (_, _, satd_bi), _ = self._eval_pairs(
            l0_y, l1_y, blocks, mv0[:, None], mv1[:, None], r0[:, None],
            r1[:, None], n)
        satd_bi = satd_bi[:, 0]
        nl0, nl1 = l0_y.shape[0], l1_y.shape[0]

        def refb(r, nl):
            return sum(torch.where(r == k, self._ref_cost(k, nl), 0.0)
                       for k in range(nl))

        idc_u = self.dpc[self.DPC_IDC_UNI]
        idc_b = self.dpc[self.DPC_IDC_BI]
        c0 = satd0.to(F32) + lam_satd * (bits0 + refb(r0, nl0) + idc_u)
        c1 = satd1.to(F32) + lam_satd * (bits1 + refb(r1, nl1) + idc_u)
        cbi = satd_bi.to(F32) + lam_satd * (
            bits0 + bits1 + refb(r0, nl0) + refb(r1, nl1) + idc_b)
        uni = torch.where(c0 <= c1, 1, 2)
        dirn = torch.where((cbi <= c0) & (cbi <= c1), 3, uni).to(I32)
        acost = torch.minimum(torch.minimum(c0, c1), cbi)
        if len(me0) >= 2 and len(me1) >= 2:
            # cross-reference bi candidate: list 0's winner on picture 0
            # and list 1's on picture 1 (the lists' own picks coincide
            # when both hold the same pictures), priced on the average of
            # me_refine's rounded predictions
            mvA, _, predA, candA = me0[0]
            mvB, _, predB, candB = me1[1]
            satd_x = satd_tiles(blocks - ((predA + predB + 1) >> 1))
            cx = satd_x.to(F32) + lam_satd * (
                self._mv_bins(mvA - candA * 4)
                + self._mv_bins(mvB - candB * 4)
                + self._ref_cost(0, nl0) + self._ref_cost(1, nl1) + idc_b)
            cur = torch.where(dirn == 3, cbi,
                              torch.where(dirn == 1, c0, c1))
            take = cx < cur
            dirn = torch.where(take, 3, dirn)
            mv0 = torch.where(take[:, None], mvA, mv0)
            r0 = torch.where(take, 0, r0)
            mv1 = torch.where(take[:, None], mvB, mv1)
            r1 = torch.where(take, 1, r1)
            acost = torch.minimum(acost, cx)
        acost = acost + lam_satd * self.dpc[self.DPC_AMVP]
        (mv0, r0, mv1, r1, dirn, use_merge,
         merge_delta) = self._merge_align_b(
            l0_y, l1_y, blocks, rows, cols, n, mv0, r0, mv1, r1, dirn,
            acost, lam_satd)
        _, (v0, v1) = self._eval_pairs(l0_y, l1_y, blocks, mv0[:, None],
                                       mv1[:, None], r0[:, None],
                                       r1[:, None], n, want_satd=False,
                                       want_pred=True)
        pred_bi = self._bi_avg(v0, v1)
        sel = dirn[:, None, None]
        pred_y = torch.where(sel == 3, pred_bi,
                             torch.where(sel == 1, self._uni_round(v0),
                                         self._uni_round(v1)))
        # exact RD of the chosen candidate (same currency as intra)
        resi = blocks - pred_y
        levels, r2, rate = self._code_residual(resi, n, self.qp_y, True,
                                               tools=False)
        dist = self._sqsum(resi - r2)
        cbf_any = (levels != 0).any(dim=-1).any(dim=-1)
        nc = n // 2
        cy0 = (bid // cols) * nc
        cx0 = (bid % cols) * nc
        ccost = torch.zeros_like(dist)
        cpreds = []
        for srcp, p0, p1 in ((src_cb, l0_cb, l1_cb),
                             (src_cr, l0_cr, l1_cr)):
            w0 = self._mc_chroma_sel(p0, r0, mv0, cy0, cx0, nc, hi=True)
            w1 = self._mc_chroma_sel(p1, r1, mv1, cy0, cx0, nc, hi=True)
            cpred = torch.where(sel == 3, self._bi_avg(w0, w1),
                                torch.where(sel == 1, self._uni_round(w0),
                                            self._uni_round(w1)))
            cpreds.append(cpred)
            cresi = self._blocks(srcp, nc) - cpred
            clev, cr2, crate = self._code_residual(cresi, nc, self.qp_c,
                                                   False, tools=False)
            cdist = self._sqsum(cresi - cr2)
            cbf_any = cbf_any | (clev != 0).any(dim=-1).any(dim=-1)
            ccost = ccost + cdist + lam * crate
        mv_bits = torch.where(dirn == 3, bits0 + bits1,
                              torch.where(dirn == 1, bits0, bits1))
        ref_bits = torch.where(
            dirn == 3, refb(r0, nl0) + refb(r1, nl1) + idc_b,
            torch.where(dirn == 1, refb(r0, nl0) + idc_u,
                        refb(r1, nl1) + idc_u))
        d = self.dpc
        amvp_bits = (d[self.DPC_AMVP] + mv_bits + ref_bits
                     + torch.where(cbf_any, d[self.DPC_RQT1],
                                   d[self.DPC_RQT0]))
        mode_bits = torch.where(
            use_merge,
            torch.where(cbf_any,
                        d[self.DPC_MERGE] + merge_delta + d[self.DPC_RQT1],
                        d[self.DPC_SKIP] + merge_delta),
            amvp_bits)
        cost = dist + lam * (rate + mode_bits) + ccost
        # with no residual anywhere the writer codes no cbf flags at all:
        # refund the cbf-0 prices the TU rates charged
        if n == 64:
            refund = (4.0 * d[self.DPC_CBF_Y0_D1]
                      + 8.0 * d[self.DPC_CBF_C0_D1])
        else:
            refund = d[self.DPC_CBF_Y0] + 2.0 * d[self.DPC_CBF_C0]
        cost = cost - lam * torch.where(cbf_any, 0.0, refund)
        return (mv0, r0, mv1, r1, dirn, cost, pred_y, cpreds[0],
                cpreds[1])

    def _partition_inter_b(self, src_y, src_cb, src_cr, l0, l1):
        """B-slice quadtree DP: per-size inter-B vs intra competition,
        then the bottom-up split DP. Returns (size_map8, mode_map8,
        inter8, dir8, mv8, ref8, mv8b, ref8b, leaf_preds)."""
        lam = self.lam
        me_l0, me_l1 = (
            self._me_sizes(src_y, lst[0],
                           [self._coarse_field(src_y, r) for r in lst[0]])
            for lst in (l0, l1))
        leaf_preds = {}
        per_size = {}
        for n in (8, 16, 32):
            imodes, icost = self._leaf_rd(src_y, src_cb, src_cr, n)
            # intra CUs in B slices also code cu_skip=0 + pred_mode=1,
            # and part_mode at min CB size
            icost = icost + lam * self.dpc[self.DPC_INTRA_PM]
            if n == 8:
                icost = icost + lam * self.dpc[self.DPC_PART_2NX2N]
            (mv0, r0, mv1, r1, dirn, ecost, p_y, p_cb,
             p_cr) = self._inter_leaf_b(src_y, src_cb, src_cr, l0, l1, n,
                                        me_l0[n], me_l1[n])
            leaf_preds[n] = (p_y, p_cb, p_cr)
            use_inter = ecost < icost
            per_size[n] = dict(modes=imodes, mv=mv0, ref=r0, mvb=mv1,
                               refb=r1, dir=dirn, inter=use_inter,
                               cost=torch.where(use_inter, ecost, icost))
        (mv64, r64_, mv64b, r64b, dir64, ecost64, p_y, p_cb,
         p_cr) = self._inter_leaf_b(src_y, src_cb, src_cr, l0, l1, 64,
                                    me_l0[64], me_l1[64])
        leaf_preds[64] = (p_y, p_cb, p_cr)
        n64 = (self.h // 64) * (self.w // 64)
        per_size[64] = dict(
            modes=torch.ones((n64,), dtype=I32, device=self.device),
            mv=mv64, ref=r64_, mvb=mv64b, refb=r64b, dir=dir64,
            inter=torch.ones((n64,), dtype=torch.bool, device=self.device),
            cost=ecost64)
        size_map8 = self._dp_merge(per_size)
        sel8 = self._sel8_fn(per_size, size_map8)
        return (size_map8, sel8("modes").to(I32), sel8("inter"),
                sel8("dir").to(I32), sel8("mv", 2).to(I32),
                sel8("ref").to(I32), sel8("mvb", 2).to(I32),
                sel8("refb").to(I32), leaf_preds)

    def _dp_merge(self, per_size):
        """Bottom-up split DP over per-size leaf costs -> size_map8."""
        lam = self.lam
        r16, c16n = self.h // 16, self.w // 16
        r32, c32n = self.h // 32, self.w // 32
        r64, c64n = self.h // 64, self.w // 64

        def sum4(c, rows, cols):
            return c.reshape(rows, 2, cols, 2).sum(dim=(1, 3))

        sp0 = self.dpc[self.DPC_SPLIT0]
        sp1 = self.dpc[self.DPC_SPLIT1]
        sum8 = sum4(per_size[8]["cost"].reshape(self.r8, self.c8), r16,
                    c16n)
        leaf16 = per_size[16]["cost"].reshape(r16, c16n)
        split16 = sum8 + lam * sp1 < leaf16 + lam * sp0
        best16 = torch.where(split16, sum8 + lam * sp1, leaf16 + lam * sp0)
        sum16 = sum4(best16, r32, c32n)
        leaf32 = per_size[32]["cost"].reshape(r32, c32n)
        split32 = sum16 + lam * sp1 < leaf32 + lam * sp0
        best32 = torch.where(split32, sum16 + lam * sp1, leaf32 + lam * sp0)
        sum32 = sum4(best32, r64, c64n)
        leaf64 = per_size[64]["cost"].reshape(r64, c64n)
        split64 = sum32 + lam * sp1 < leaf64 + lam * sp0
        e64 = rep2(split64, 4)
        e32 = rep2(split32, 2)
        sz16 = torch.where(~e64, 64,
                           torch.where(~e32, 32,
                                       torch.where(split16, 8, 16)))
        return rep2(sz16, 2).to(I32)

    def _sel8_fn(self, per_size, size_map8):
        def to8(a, n, chan=None):
            rows, cols = self.h // n, self.w // n
            m = a.reshape(rows, cols) if chan is None \
                else a.reshape(rows, cols, chan)
            return rep2(m, n // 8)

        def sel8(key, chan=None):
            v = [to8(per_size[n][key], n, chan) for n in (8, 16, 32, 64)]
            cond = [size_map8 == n for n in (8, 16, 32)]
            if chan is not None:
                cond = [c[..., None] for c in cond]
            return torch.where(cond[0], v[0],
                               torch.where(cond[1], v[1],
                                           torch.where(cond[2], v[2],
                                                       v[3])))
        return sel8

    # ------------------------------------------------------------------
    # reconstruction: batched inter leaves (the wavefront does intra)
    # ------------------------------------------------------------------

    def _inter_recon_batch(self, src_y, src_cb, src_cr, size_map8, inter8,
                           preds):
        """Reconstruct every inter leaf of every size in one batch from
        the DP leaves' final predictions. Returns (luma [2,Hp,Wp],
        chroma [4,Hc,Wc], written8)."""
        luma, chroma, written = self._new_planes()
        for n in (8, 16, 32, 64):
            k = n // 8
            rows, cols = self.h // n, self.w // n
            is_leaf = (size_map8[::k, ::k] == n) & inter8[::k, ::k]
            mask = is_leaf.reshape(-1)
            bid = self._arange(rows * cols)
            y0, x0 = (bid // cols) * n, (bid % cols) * n
            pred_y = preds[n][0]
            resi = self._blocks(src_y, n) - pred_y
            levels, r2, _ = self._code_residual(resi, n, self.qp_y, True,
                                                tools=True)
            cbf = (levels != 0).any(dim=-1).any(dim=-1)[:, None, None]
            rec = (pred_y + torch.where(cbf, r2, 0)).clamp(0, self.maxv)
            self._put(luma[0], y0, x0, n, rec, mask)
            self._put(luma[1], y0, x0, n, torch.where(cbf, levels, 0), mask)
            nc = n // 2
            for ci, srcp in enumerate((src_cb, src_cr)):
                cpred = preds[n][1 + ci]
                cresi = self._blocks(srcp, nc) - cpred
                clev, cr2, _ = self._code_residual(cresi, nc, self.qp_c,
                                                   False, tools=True)
                ccbf = (clev != 0).any(dim=-1).any(dim=-1)[:, None, None]
                crec = (cpred + torch.where(ccbf, cr2, 0)) \
                    .clamp(0, self.maxv)
                self._put(chroma[ci], y0 // 2, x0 // 2, nc, crec, mask)
                self._put(chroma[2 + ci], y0 // 2, x0 // 2, nc,
                          torch.where(ccbf, clev, 0), mask)
            written |= rep2(is_leaf, k)
        return luma, chroma, written

    # ------------------------------------------------------------------
    # deblocking boundary strengths from decision maps (spec 8.7.2.4)
    # ------------------------------------------------------------------

    def _edge_maps_inter_b(self, size_map8, inter8, dir8, mv8, mv8b,
                           poc8_0, poc8_1, nz8):
        """Deblocking BS for B slices (the full two-list rule)."""
        k = size_map8 >> 3
        c = self._arange(self.c8)[None, :]
        r = self._arange(self.r8)[:, None]
        ver_edge = ((c & (k - 1)) == 0) & (c > 0)
        hor_edge = ((r & (k - 1)) == 0) & (r > 0)
        ver_edge = ver_edge | ((size_map8 == 64) & ((c & 7) == 4))
        hor_edge = hor_edge | ((size_map8 == 64) & ((r & 7) == 4))
        use0 = inter8 & ((dir8 & 1) != 0)
        use1 = inter8 & ((dir8 & 2) != 0)
        maps = dict(
            intra=~inter8, nz=nz8,
            p0=torch.where(use0, poc8_0, NO_REF_POC),
            p1=torch.where(use1, poc8_1, NO_REF_POC),
            m0x=torch.where(use0, mv8[:, :, 0], 0),
            m0y=torch.where(use0, mv8[:, :, 1], 0),
            m1x=torch.where(use1, mv8b[:, :, 0], 0),
            m1y=torch.where(use1, mv8b[:, :, 1], 0),
            cnt=use0.to(I32) + use1.to(I32))

        def shift_left(v):
            return torch.cat([torch.zeros_like(v[:, :1]), v[:, :-1]], dim=1)

        def shift_up(v):
            return torch.cat([torch.zeros_like(v[:1]), v[:-1]], dim=0)

        def bs(cur, nb):
            def far(ax, ay, bx, by):
                return ((ax - bx).abs() >= 4) | ((ay - by).abs() >= 4)
            eq_s = (cur["p0"] == nb["p0"]) & (cur["p1"] == nb["p1"])
            eq_c = (cur["p0"] == nb["p1"]) & (cur["p1"] == nb["p0"])
            d_s = far(cur["m0x"], cur["m0y"], nb["m0x"], nb["m0y"]) | \
                far(cur["m1x"], cur["m1y"], nb["m1x"], nb["m1y"])
            d_c = far(cur["m0x"], cur["m0y"], nb["m1x"], nb["m1y"]) | \
                far(cur["m1x"], cur["m1y"], nb["m0x"], nb["m0y"])
            ok = (eq_s & ~d_s) | (eq_c & ~d_c)
            one = cur["nz"] | nb["nz"] | (cur["cnt"] != nb["cnt"]) | ~ok
            return torch.where(cur["intra"] | nb["intra"], 2,
                               torch.where(one, 1, 0))

        left = {kk: shift_left(v) for kk, v in maps.items()}
        up = {kk: shift_up(v) for kk, v in maps.items()}
        bs_v8 = torch.where(ver_edge, bs(maps, left), 0)
        bs_h8 = torch.where(hor_edge, bs(maps, up), 0)
        return (bs_v8.repeat_interleave(2, 0).to(I32),
                bs_h8.repeat_interleave(2, 1).to(I32))

    def _nz8(self, lvl_y, size_map8):
        """Per-8-cell luma-TU cbf map (any nonzero level in the TU)."""
        nz8 = torch.zeros((self.r8, self.c8), dtype=torch.bool,
                          device=self.device)
        cell_any = (lvl_y.reshape(self.r8, 8, self.c8, 8) != 0) \
            .any(dim=3).any(dim=1)
        # a 64 CU carries four 32x32 TUs: its cbf is at 32 granularity
        for s, kk in ((8, 1), (16, 2), (32, 4), (64, 4)):
            blk = cell_any.reshape(self.r8 // kk, kk, self.c8 // kk, kk) \
                .any(dim=3).any(dim=1)
            nz8 = torch.where(size_map8 == s, rep2(blk, kk), nz8)
        return nz8

    # ------------------------------------------------------------------
    # full frame
    # ------------------------------------------------------------------

    def _inter_full_b_impl(self, src_y_u8, src_cb_u8, src_cr_u8, l0, l1,
                           l0_pocs, l1_pocs) -> dict:
        src_y = src_y_u8.to(I32)
        src_cb = src_cb_u8.to(I32)
        src_cr = src_cr_u8.to(I32)
        # list 1 is list 0 on the generalized-B low-delay path: one set of
        # planes serves both
        same = l1 is l0
        l0 = tuple(p.to(I32) for p in l0)
        l1 = l0 if same else tuple(p.to(I32) for p in l1)
        (size_map8, mode_map8, inter8, dir8, mv8, ref8, mv8b, ref8b,
         leaf_preds) = self._partition_inter_b(src_y, src_cb, src_cr, l0, l1)
        init = self._inter_recon_batch(src_y, src_cb, src_cr, size_map8,
                                       inter8, leaf_preds)
        luma, chroma, _, n_waves = self._recon_md(
            src_y, src_cb, src_cr, size_map8, mode_map8, init_state=init,
            exclude8=init[2])
        ry, rcb, rcr, lvl_y, lvl_cb, lvl_cr = self._unpack_planes(luma,
                                                                  chroma)
        if self.deblock:
            nz8 = self._nz8(lvl_y, size_map8)
            bs = self._edge_maps_inter_b(
                size_map8, inter8, dir8, mv8, mv8b,
                l0_pocs[ref8.long()], l1_pocs[ref8b.long()], nz8)
            ry, rcb, rcr = self._deblock(ry, rcb, rcr, *bs)
        out = self._frame_outputs(ry, rcb, rcr, lvl_y, lvl_cb, lvl_cr,
                                  src_y, src_cb, src_cr)
        out.update(size_map8=size_map8.to(torch.int8),
                   mode_map8=mode_map8.to(torch.int8), inter8=inter8,
                   dir8=dir8.to(torch.int8), mv8=mv8.to(torch.int16),
                   ref8=ref8.to(torch.int8), mv8b=mv8b.to(torch.int16),
                   ref8b=ref8b.to(torch.int8), n_waves=n_waves)
        return out

    @torch.inference_mode()
    def submit_inter_b(self, src_y, src_cb, src_cr, l0, l1, l0_pocs,
                       l1_pocs, qp: int | None = None) -> dict:
        """B frame: l0/l1 = ([y..], [cb..], [cr..]) per-list reference
        stacks (device tensors or numpy), newest first, truncated or
        padded to n_refs_b by repeating the last entry (their POCs
        alike)."""
        self.set_consts(self._consts_for(qp))
        K = self.n_refs_b

        def pad(vals):
            vs = list(vals)[:K]
            return vs + vs[-1:] * (K - len(vs))

        def stack(planes):
            return torch.stack([self._to_dev(p) for p in pad(planes)])

        def pocs(vals):
            return torch.as_tensor(pad(vals), dtype=I32, device=self.device)
        s0 = tuple(stack(p) for p in l0)
        s1 = s0 if l1 is l0 else tuple(stack(p) for p in l1)
        return self._inter_full_b_impl(
            self._to_dev(src_y), self._to_dev(src_cb), self._to_dev(src_cr),
            s0, s1, pocs(l0_pocs), pocs(l1_pocs))
