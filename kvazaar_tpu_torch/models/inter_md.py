"""Quadtree (CTB 64) inter pipeline in PyTorch: P and generalized-B slices.

Device port of the P and B programs of kvazaar_tpu/models/inter_md.py,
with any inter CU depth range (--pu-depth-inter) and --subme 0-4.

P slices (--no-bipred; submit_inter): one reference stack of n_refs
pictures (--ref 1-4, padded by repeating the last); per size the
SATD-best picture and MV of the me_refine results, a merge alignment over
five candidates (left, top, CTB corner, the global MV, zero; one me_eval
launch in its one-list mode), the exact RD cost against intra, and with
--smp/--amp rectangular PUs (2NxN/Nx2N at 16 and 32, the four asymmetric
modes at 32) searched per PU in plain PyTorch (integer +-3 SAD sweep,
half- then quarter-pel SATD steps) competing in the DP; the SMP CUs
reconstruct cell by cell with their PUs' motion.

B slices (submit_inter_b), with one or two reference pictures a list
(the stacks are padded to n_refs_b = min(2, n_refs) by repeating their
last picture); list 1 is list 0 on the low-delay path and holds the
future pictures in a B pyramid; with --no-bipred (B pictures of a
pyramid) every block predicts from one list; no SMP/AMP (the reference's
B program has none):

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
from ..ops.me import (MV_CLAMP, REFINE, clamped_window, mc_luma_plain,
                      me_eval, me_refine, satd_tiles)
from .intra_md import F32, I32, MdIntraPipeline, rep2, sum4

NO_REF_POC = -(1 << 30)


class MdInterPipeline(MdIntraPipeline):
    """P/B-slice quadtree encoder compute path for one frame size."""

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
    # merge_idx estimate deltas (bits) of the B merge candidates left, top,
    # CTB corner and zero
    MERGE_DELTAS = (0.0, 0.8, 1.2, 1.6)
    # and of the P merge candidates left, top, CTB corner, global MV and
    # zero
    MERGE_DELTAS_P = (0.0, 0.8, 1.2, 1.2, 1.6)
    # SMP/AMP part ids (the decoder's part_mode order): the PUs (dy, dx,
    # height, width) of an n-CU
    PART_GEOM = {
        1: lambda n: ((0, 0, n // 2, n), (n // 2, 0, n // 2, n)),  # 2NxN
        2: lambda n: ((0, 0, n, n // 2), (0, n // 2, n, n // 2)),  # Nx2N
        3: lambda n: ((0, 0, n // 4, n),
                      (n // 4, 0, 3 * n // 4, n)),                 # 2NxnU
        4: lambda n: ((0, 0, 3 * n // 4, n),
                      (3 * n // 4, 0, n // 4, n)),                 # 2NxnD
        5: lambda n: ((0, 0, n, n // 4),
                      (0, n // 4, n, 3 * n // 4)),                 # nLx2N
        6: lambda n: ((0, 0, n, 3 * n // 4),
                      (0, 3 * n // 4, n, n // 4)),                 # nRx2N
    }

    def __init__(self, height: int, width: int, qp: int,
                 n_refs: int = 1, pu_depth_inter: tuple[int, int] = (0, 3),
                 subme: int = 4, smp: bool = False, amp: bool = False,
                 bipred: bool = True, **kw) -> None:
        super().__init__(height, width, qp, **kw)
        # P stack depth; B stacks: fixed per-list depth (both padded by
        # repeating the last picture)
        self.n_refs = max(1, n_refs)
        self.n_refs_b = min(2, self.n_refs)
        # --bipred: the B program's bi-prediction candidates (the exact
        # bi-average of the lists' winners and the cross-reference pair)
        self.bipred = bool(bipred)
        # --smp/--amp: rectangular PUs in P slices (the B program has none)
        self.smp = bool(smp or amp)
        self.amp = bool(amp)
        # --subme: the SMP search's sub-pel steps (0 none, 1-2 half, 3-4
        # half then quarter); me_refine's quarter-pel sweep ignores it
        self.subme = max(0, min(int(subme), 4))
        # inter CU sizes from --pu-depth-inter (0 = 64 .. 3 = 8); sizes
        # outside the range leave the intra candidate
        lo, hi = pu_depth_inter
        self.allow_inter = {64: lo <= 0, 32: lo <= 1 <= hi,
                            16: lo <= 2 <= hi, 8: hi >= 3}

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
                       hi: bool = False, nch: int | None = None):
        """Chroma MC of [L, nch, nc] blocks (nch = nc when None) from a
        reference stack [K, Hc, Wc] with per-block ref index; clamped
        indices equal edge padding."""
        nch = nc if nch is None else nch
        win = clamped_window(planes, cy0 + (mv[:, 1] >> 3) - 1,
                             cx0 + (mv[:, 0] >> 3) - 1, nch + 3, nc + 3,
                             ref)
        fmat = torch.as_tensor(CHROMA_FILTERS, dtype=I32,
                               device=self.device)
        cxf = fmat[(mv[:, 0] & 7).long()]
        cyf = fmat[(mv[:, 1] & 7).long()]
        h14 = sum(cxf[:, k, None, None] * win[:, :, k:k + nc]
                  for k in range(4))
        v = sum(cyf[:, k, None, None] * h14[:, k:k + nch, :]
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
            for n in (8, 16, 32, 64):
                cands = self._me_cands(fields[k], n)
                blocks = self._blocks(src_y, n).contiguous()
                mv_q, satd, pred = me_refine(ref, blocks, cands.contiguous(),
                                             lam64, n=n, cols=self.w // n,
                                             maxv=self.maxv)
                out[n].append((mv_q, satd, pred, cands[:, 0]))
        return out

    def _me_cands(self, f16, n: int):
        """Integer candidates [L, K, 2] of every aligned n-block from a
        16-field: the own/parent field MV + zero at 8/16, four spread
        field samples + zero at 32/64."""
        c = self._field_for(f16, n)
        if n in (8, 16):
            return torch.stack([c, torch.zeros_like(c)], dim=1)
        return torch.cat([c, torch.zeros_like(c[:, :1])], dim=1)

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

    def _ref_bits(self, r, n_list: int):
        """ref_idx signalling bits of the per-block indices r in a list of
        n_list pictures."""
        return sum(torch.where(r == k, self._ref_cost(k, n_list), 0.0)
                   for k in range(n_list))

    def _pick_ref_me(self, me, lam_satd):
        """Best reference of one list from its per-picture ME results at
        one size (strict < in stack order, SATD + sqrt-lambda x (MVD +
        ref_idx bits)): (mv, ref index, satd, mvd bits, me_refine's
        prediction)."""
        best = None
        for k, (mv_k, satd_k, pred_k, cand0) in enumerate(me):
            bits_k = self._mv_bins(mv_k - cand0 * 4)
            cost_k = satd_k.to(F32) + lam_satd * (
                bits_k + self._ref_cost(k, len(me)))
            cur = (cost_k, mv_k, torch.full_like(satd_k, k), satd_k, bits_k,
                   pred_k)
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
                       tools: bool, quad: bool = False):
        """(levels, recon residual, rate) of a leaf's luma or chroma
        residual: four forced-split TUs at 64 luma / 32 chroma and with
        quad (the SMP CUs' interSplitFlag), else one TU, each with the
        zero-cbf competition. tools: as in _transform_quant (the search
        quantises plainly, the reconstruction with the configured
        tools)."""
        rate_fn = self._tu_rate_y if is_luma else self._tu_rate_c
        if quad or n == 32 + 32 * is_luma:
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
        mv0, r0, satd0, bits0, _ = self._pick_ref_me(me0, lam_satd)
        mv1, r1, satd1, bits1, _ = self._pick_ref_me(me1, lam_satd)
        (_, _, satd_bi), _ = self._eval_pairs(
            l0_y, l1_y, blocks, mv0[:, None], mv1[:, None], r0[:, None],
            r1[:, None], n)
        satd_bi = satd_bi[:, 0]
        nl0, nl1 = l0_y.shape[0], l1_y.shape[0]
        refb = self._ref_bits
        idc_u = self.dpc[self.DPC_IDC_UNI]
        idc_b = self.dpc[self.DPC_IDC_BI]
        c0 = satd0.to(F32) + lam_satd * (bits0 + refb(r0, nl0) + idc_u)
        c1 = satd1.to(F32) + lam_satd * (bits1 + refb(r1, nl1) + idc_u)
        cbi = satd_bi.to(F32) + lam_satd * (
            bits0 + bits1 + refb(r0, nl0) + refb(r1, nl1) + idc_b)
        uni = torch.where(c0 <= c1, 1, 2)
        dirn = (torch.where((cbi <= c0) & (cbi <= c1), 3, uni)
                if self.bipred else uni).to(I32)
        # the AMVP cost the merge candidates must beat counts the bi
        # candidate even with --no-bipred, as the reference does
        acost = torch.minimum(torch.minimum(c0, c1), cbi)
        if self.bipred and len(me0) >= 2 and len(me1) >= 2:
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
        return (mv0, r0, mv1, r1, dirn,
                cost - lam * self._cbf_refund(cbf_any, n), pred_y,
                cpreds[0], cpreds[1])

    def _partition_inter_b(self, src_y, src_cb, src_cr, l0, l1):
        """B-slice quadtree DP: per-size inter-B vs intra competition,
        then the bottom-up split DP. Returns (size_map8, mode_map8,
        inter8, dir8, mv8, ref8, mv8b, ref8b, leaf_preds)."""
        lam = self.lam
        big = 1e18
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
            if not self.allow_inter[n]:
                ecost = ecost + big
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
            cost=ecost64 if self.allow_inter[64] else ecost64 + big)
        size_map8 = self._dp_merge(per_size)
        sel8 = self._sel8_fn(per_size, size_map8)
        return (size_map8, sel8("modes").to(I32), sel8("inter"),
                sel8("dir").to(I32), sel8("mv", 2).to(I32),
                sel8("ref").to(I32), sel8("mvb", 2).to(I32),
                sel8("refb").to(I32), leaf_preds)

    # ------------------------------------------------------------------
    # P slices: one reference stack, merge alignment, SMP/AMP
    # ------------------------------------------------------------------

    def _eval_p(self, refs_y, blocks, mvs, refsel, n: int,
                want_satd: bool = True, want_pred: bool = False):
        """Exact evaluation of K single-list candidates per block in one
        me_eval launch (its one-list mode): mvs [L, K, 2] qpel on the
        pictures refsel [L, K] of the stack refs_y [R, H, W]. Returns
        (satd [L, K] or None, 14-bit prediction [L, n, n] of candidate 0
        or None)."""
        satd, pred = me_eval(refs_y.contiguous(), None, blocks.contiguous(),
                             mvs.to(I32).contiguous(), None,
                             refsel.to(I32).contiguous(), None, n=n,
                             cols=self.w // n, maxv=self.maxv,
                             want_satd=want_satd, want_pred=want_pred)
        return (None if satd is None else satd[0],
                None if pred is None else pred[0])

    def _region_cand(self, mvg, refg, rows: int, cols: int, n: int):
        """Per-CTB broadcast candidate: every block of a CTB offers the
        motion of the CTB's top-left block. Returns (mvs, refs, (rows of
        the corners, their columns))."""
        k = max(1, self.CTB // n)
        ri = (self._arange(rows) // k) * k
        ci = (self._arange(cols) // k) * k
        return (mvg[ri[:, None], ci[None, :]], refg[ri[:, None], ci[None, :]],
                (ri, ci))

    @staticmethod
    def _global_mv(field):
        """Dominant full-pel MV of a coarse field: the per-component
        median, an even count taking the mean of the two middle values in
        float32 truncated toward zero (jnp.median, then astype int32)."""
        f = field.reshape(-1, 2).sort(dim=0).values
        m = f.shape[0]
        mid = (f[(m - 1) // 2] + f[m // 2]).to(F32) * 0.5
        return mid.to(I32)

    def _merge_align_p(self, refs_y, blocks, rows: int, cols: int, n: int,
                       mv_q, ref, satd, mv_bits, pred_y, lam_satd):
        """Merge-aware alignment: adopt a neighbour / CTB-corner / global
        / zero merge candidate when its SATD plus bins beat the AMVP
        winner. Chain-safe: a block adopts a neighbour's motion only when
        that neighbour keeps its own. Returns (mv_q, ref, mv_bits,
        pred_y, use_merge, merge_delta)."""
        nb = rows * cols
        mvg = mv_q.reshape(rows, cols, 2)
        refg = ref.reshape(rows, cols)
        ci = self._arange(cols)[None, :].expand(rows, cols).reshape(-1)
        ri = self._arange(rows)[:, None].expand(rows, cols).reshape(-1)
        mvS, refS, (rS, cS) = self._region_cand(mvg, refg, rows, cols, n)
        gmv = self._global_mv(self._merge_field0) * 4
        ones = torch.ones((nb,), dtype=torch.bool, device=self.device)
        zref = torch.zeros((nb,), dtype=I32, device=self.device)
        cands = (
            (self._left_of(mvg).reshape(-1, 2),
             self._left_of(refg).reshape(-1), ci > 0),
            (self._top_of(mvg).reshape(-1, 2),
             self._top_of(refg).reshape(-1), ri > 0),
            (mvS.reshape(-1, 2), refS.reshape(-1), ones),
            (gmv.expand(nb, 2), zref, ones),
            (torch.zeros((nb, 2), dtype=I32, device=self.device), zref,
             ones))
        s_all, _ = self._eval_p(
            refs_y, blocks, torch.stack([c[0] for c in cands], dim=1),
            torch.stack([c[1] for c in cands], dim=1), n)
        best = None
        for c, (cmv, cref, valid) in enumerate(cands):
            cost_c = s_all[:, c].to(F32) + lam_satd * (
                self.dpc[self.DPC_MERGE] + self.MERGE_DELTAS_P[c])
            cost_c = torch.where(valid, cost_c, 1e18)
            cur = (cost_c, cmv, cref,
                   torch.full((nb,), c, dtype=I32, device=self.device))
            if best is None:
                best = cur
                continue
            better = cost_c < best[0]
            best = tuple(torch.where(
                better.reshape(-1, *([1] * (a.dim() - 1))), a, b)
                for a, b in zip(cur, best))
        mcost, mmv, mref, mpick = best
        acost = satd.to(F32) + lam_satd * (
            self.dpc[self.DPC_AMVP] + mv_bits
            + self._ref_bits(ref, self.n_refs))
        use = mcost < acost

        def changed_by(use):
            return use & ((mmv != mv_q).any(dim=-1) | (mref != ref))
        chg = changed_by(use).reshape(rows, cols)
        srcL = self._left_of(chg, fill=False).reshape(-1)
        srcT = self._top_of(chg, fill=False).reshape(-1)
        srcC = chg[rS[:, None], cS[None, :]].reshape(-1)
        use = use & ~(((mpick == 0) & srcL) | ((mpick == 1) & srcT)
                      | ((mpick == 2) & srcC))
        changed = changed_by(use)
        mv_f = torch.where(use[:, None], mmv, mv_q)
        ref_f = torch.where(use, mref, ref)
        delta = sum(torch.where(mpick == c, d, 0.0).to(F32)
                    for c, d in enumerate(self.MERGE_DELTAS_P))
        _, v = self._eval_p(refs_y, blocks, mv_f[:, None], ref_f[:, None],
                            n, want_satd=False, want_pred=True)
        pred_f = torch.where(changed[:, None, None], self._uni_round(v),
                             pred_y)
        return (mv_f, ref_f, torch.where(use, 0.0, mv_bits), pred_f, use,
                delta)

    def _inter_leaf_p(self, src_y, src_cb, src_cr, refs, n: int, me):
        """Best P-slice inter candidate per aligned n-block across the
        stack refs = (y, cb, cr) [R, ...]: the SATD-best picture and MV of
        the me_refine results, merge alignment, then one exact RD cost of
        the winner (three-tier skip / merge / AMVP price) for the DP.
        Returns (mv, ref, cost, pred_y, pred_cb, pred_cr)."""
        lam = self.lam
        refs_y, refs_cb, refs_cr = refs
        blocks = self._blocks(src_y, n)
        rows, cols = self.h // n, self.w // n
        bid = self._arange(rows * cols)
        lam_satd = torch.sqrt(lam)
        mv_q, ref, satd, mv_bits, pred_y = self._pick_ref_me(me, lam_satd)
        (mv_q, ref, mv_bits, pred_y, use_merge,
         merge_delta) = self._merge_align_p(refs_y, blocks, rows, cols, n,
                                            mv_q, ref, satd, mv_bits,
                                            pred_y, lam_satd)
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
        for srcp, planes in ((src_cb, refs_cb), (src_cr, refs_cr)):
            cpred = self._mc_chroma_sel(planes, ref, mv_q, cy0, cx0, nc)
            cpreds.append(cpred)
            cresi = self._blocks(srcp, nc) - cpred
            clev, cr2, crate = self._code_residual(cresi, nc, self.qp_c,
                                                   False, tools=False)
            cdist = self._sqsum(cresi - cr2)
            cbf_any = cbf_any | (clev != 0).any(dim=-1).any(dim=-1)
            ccost = ccost + cdist + lam * crate
        d = self.dpc
        amvp_bits = (d[self.DPC_AMVP] + mv_bits
                     + self._ref_bits(ref, self.n_refs)
                     + torch.where(cbf_any, d[self.DPC_RQT1],
                                   d[self.DPC_RQT0]))
        mode_bits = torch.where(
            use_merge,
            torch.where(cbf_any,
                        d[self.DPC_MERGE] + merge_delta + d[self.DPC_RQT1],
                        d[self.DPC_SKIP] + merge_delta),
            amvp_bits)
        cost = dist + lam * (rate + mode_bits) + ccost
        return (mv_q, ref, cost - lam * self._cbf_refund(cbf_any, n),
                pred_y, cpreds[0], cpreds[1])

    def _cbf_refund(self, cbf_any, n: int):
        """With no residual anywhere the writer codes no cbf flags at all
        (skip, or AMVP with rqt_root_cbf 0): the cbf-0 prices that the TU
        rates of an n-leaf charged, where cbf_any is false."""
        d = self.dpc
        if n == 64:
            refund = (4.0 * d[self.DPC_CBF_Y0_D1]
                      + 8.0 * d[self.DPC_CBF_C0_D1])
        else:
            refund = d[self.DPC_CBF_Y0] + 2.0 * d[self.DPC_CBF_C0]
        return torch.where(cbf_any, 0.0, refund)

    # -- SMP/AMP: the per-PU search (plain PyTorch, as the reference's is
    #    outside any kernel) ---------------------------------------------

    def _refine_int(self, blocks, ref_y, y0, x0, cands):
        """+-REFINE integer SAD sweep around each candidate (clamped to
        +-MV_CLAMP) for [L, nh, nw] blocks at (y0, x0) on the plane ref_y:
        the first minimum in (candidate, dy, dx) order, which is the
        reference's strict-< scan (no MV-cost prior on this path).
        Returns (mv [L, 2], sad [L])."""
        W = REFINE
        L, nh, nw = blocks.shape
        sads, mvs = [], []
        for k in range(cands.shape[1]):
            mvk = cands[:, k].clamp(-MV_CLAMP, MV_CLAMP)
            win = clamped_window(ref_y, y0 + mvk[:, 1] - W,
                                 x0 + mvk[:, 0] - W, nh + 2 * W, nw + 2 * W)
            # [L, dy, dx, nh, nw] views of the 49 displaced blocks
            sh = win.unfold(1, nh, 1).unfold(2, nw, 1)
            sads.append((sh - blocks[:, None, None]).abs()
                        .sum(dim=(-1, -2), dtype=I32).reshape(L, -1))
            mvs.append(mvk)
        sad, pos = torch.cat(sads, dim=1).min(dim=1)
        k, o = pos // 49, pos % 49
        base = torch.stack(mvs, dim=1)[self._arange(L), k]
        return base + torch.stack([o % 7 - W, o // 7 - W], dim=1).to(I32), sad

    def _refine_subpel(self, blocks, ref_y, y0, x0, mv_int):
        """Half- then quarter-pel SATD refinement of [L, nh, nw] blocks
        around mv_int (clamped to +-MV_CLAMP): each step tries the eight
        neighbours of the current best in a fixed order, strict <; --subme
        takes both steps (3-4), the half-pel one (1-2) or none (0).
        Returns (mv qpel [L, 2], satd [L])."""
        nh, nw = blocks.shape[-2:]

        def cost(mv):
            return satd_tiles(blocks - mc_luma_plain(
                ref_y, mv, y0, x0, nw, maxv=self.maxv, nh=nh))
        mv = mv_int.clamp(-MV_CLAMP, MV_CLAMP) * 4
        best = cost(mv)
        steps = ((2, 1) if self.subme >= 3
                 else (2,) if self.subme >= 1 else ())
        for step in steps:
            for dx, dy in ((-1, 0), (1, 0), (0, -1), (0, 1), (-1, -1),
                           (1, -1), (-1, 1), (1, 1)):
                cand = mv + torch.tensor([dx * step, dy * step], dtype=I32,
                                         device=self.device)
                c = cost(cand)
                better = c < best
                mv = torch.where(better[:, None], cand, mv)
                best = torch.where(better, c, best)
        return mv, best

    def _best_uni_leaf(self, blocks, refs_y, y0, x0, cands_list):
        """SATD-best (mv qpel [L, 2], ref [L], satd [L], mv bits [L])
        across the stack refs_y for [L, nh, nw] blocks: per picture k the
        integer then sub-pel refinement around the candidates
        cands_list[k] [L, K, 2], priced with the MVD bins (candidate 0 as
        the predictor) and the ref_idx bits of a list of the stack's
        depth; strict < in stack order."""
        lam_satd = torch.sqrt(self.lam)
        R = refs_y.shape[0]
        best = None
        for k in range(R):
            cands = cands_list[k]
            mv_int, _ = self._refine_int(blocks, refs_y[k], y0, x0, cands)
            mv_q, satd = self._refine_subpel(blocks, refs_y[k], y0, x0,
                                             mv_int)
            bits = self._mv_bins(mv_q - cands[:, 0] * 4)
            cost = satd.to(F32) + lam_satd * (bits + self._ref_cost(k, R))
            cur = (cost, mv_q, torch.full_like(satd, k), bits, satd)
            if best is None:
                best = cur
                continue
            better = cost < best[0]
            best = tuple(torch.where(
                better.reshape(-1, *([1] * (a.dim() - 1))), a, b)
                for a, b in zip(cur, best))
        return best[1], best[2], best[4], best[3]

    def _part_mode_bits(self, part_id: int):
        """part_mode fractional bits of an inter CU above the minimum CB
        size (the decoder's binarization)."""
        d = self.dpc
        bits = d[self.DPC_PART0_0]
        bits = bits + (d[self.DPC_PART1_1] if part_id in (1, 3, 4)
                       else d[self.DPC_PART1_0])
        if self.amp:
            bits = bits + (d[self.DPC_PART3_1] if part_id in (1, 2)
                           else d[self.DPC_PART3_0] + 1.0)
        return bits

    def _smp_leaf(self, src_y, src_cb, src_cr, refs, fields, n: int):
        """Best rectangular-PU candidate per aligned n-block: for each
        part mode (2NxN, Nx2N, and at 32 with AMP the four asymmetric
        ones), per-PU ME from the CU's coarse-field candidates, the exact
        CU prediction, the forced four-TU split T/Q on all three planes
        (interSplitFlag) and the RD cost with the mode's price. Returns
        (part [L], mv_a, ref_a, mv_b, ref_b, cost [L])."""
        lam = self.lam
        refs_y, refs_cb, refs_cr = refs
        blocks = self._blocks(src_y, n)
        rows, cols = self.h // n, self.w // n
        nb = rows * cols
        bid = self._arange(nb)
        y0, x0 = (bid // cols) * n, (bid % cols) * n
        cands_list = [self._me_cands(f16, n) for f16 in fields]
        cb_blocks = self._blocks(src_cb, n // 2)
        cr_blocks = self._blocks(src_cr, n // 2)
        d = self.dpc
        hn = n // 2
        modes = [1, 2] + ([3, 4, 5, 6] if self.amp and n == 32 else [])
        best = None
        for pid in modes:
            pred_y = torch.zeros_like(blocks)
            pred_c = [torch.zeros_like(cb_blocks), torch.zeros_like(cr_blocks)]
            pu_bits = torch.zeros((nb,), dtype=F32, device=self.device)
            mvs, refsel = [], []
            for (dy, dx, ph, pw) in self.PART_GEOM[pid](n):
                mv_q, ref, _, mv_bits = self._best_uni_leaf(
                    blocks[:, dy:dy + ph, dx:dx + pw], refs_y, y0 + dy,
                    x0 + dx, cands_list)
                mvs.append(mv_q)
                refsel.append(ref)
                pu_bits = pu_bits + mv_bits + self._ref_bits(ref, self.n_refs)
                pred_y[:, dy:dy + ph, dx:dx + pw] = mc_luma_plain(
                    refs_y, mv_q, y0 + dy, x0 + dx, pw, maxv=self.maxv,
                    sel=ref, nh=ph)
                for pc, planes in zip(pred_c, (refs_cb, refs_cr)):
                    pc[:, dy // 2:(dy + ph) // 2, dx // 2:(dx + pw) // 2] = \
                        self._mc_chroma_sel(planes, ref, mv_q, (y0 + dy) // 2,
                                            (x0 + dx) // 2, pw // 2,
                                            nch=ph // 2)
            resi = blocks - pred_y
            levels, r2, rate = self._code_residual(resi, n, self.qp_y, True,
                                                   tools=False, quad=True)
            cost = self._sqsum(resi - r2) + lam * rate
            for cblocks, cpred in zip((cb_blocks, cr_blocks), pred_c):
                cresi = cblocks - cpred
                _, cr2, crate = self._code_residual(cresi, hn, self.qp_c,
                                                    False, tools=False,
                                                    quad=True)
                cost = cost + self._sqsum(cresi - cr2) + lam * crate
            mode_bits = (d[self.DPC_AMVP] - d[self.DPC_PART_2NX2N]
                         + self._part_mode_bits(pid) + d[self.DPC_PU_EXTRA]
                         + pu_bits + d[self.DPC_RQT1])
            cost = cost + lam * mode_bits
            cur = (torch.full((nb,), pid, dtype=I32, device=self.device),
                   mvs[0], refsel[0], mvs[1], refsel[1], cost)
            if best is None:
                best = cur
                continue
            better = cost < best[5]
            best = tuple(torch.where(
                better.reshape(-1, *([1] * (a.dim() - 1))), a, b)
                for a, b in zip(cur, best))
        return best

    def _partition_inter_p(self, src_y, src_cb, src_cr, refs):
        """P-slice quadtree DP: per size the inter leaf (and with SMP the
        rectangular PUs at 16 and 32) against intra, then the bottom-up
        split DP. Returns (size_map8, mode_map8, inter8, mv8, ref8, part8
        or None, leaf_preds); with SMP, mv8/ref8 carry each cell's own
        PU's motion."""
        lam = self.lam
        refs_y = refs[0]
        big = 1e18
        fields = [self._coarse_field(src_y, r) for r in refs_y]
        # the global-MV merge candidate's field
        self._merge_field0 = fields[0]
        me_all = self._me_sizes(src_y, refs_y, fields)
        leaf_preds = {}
        per_size = {}
        for n in (8, 16, 32, 64):
            mv_q, ref, ecost, p_y, p_cb, p_cr = self._inter_leaf_p(
                src_y, src_cb, src_cr, refs, n, me_all[n])
            leaf_preds[n] = (p_y, p_cb, p_cr)
            if not self.allow_inter[n]:
                ecost = ecost + big
            nb = ref.shape[0]
            if n == 64:
                # 64 leaves are inter only
                use_inter = torch.ones((nb,), dtype=torch.bool,
                                       device=self.device)
                per_size[n] = dict(modes=torch.ones((nb,), dtype=I32,
                                                    device=self.device),
                                   mv=mv_q, ref=ref, inter=use_inter,
                                   cost=ecost)
            else:
                imodes, icost = self._leaf_rd(src_y, src_cb, src_cr, n)
                # intra CUs in P slices also code cu_skip=0 +
                # pred_mode=1, and part_mode at min CB size
                icost = icost + lam * self.dpc[self.DPC_INTRA_PM]
                if n == 8:
                    icost = icost + lam * self.dpc[self.DPC_PART_2NX2N]
                use_inter = ecost < icost
                per_size[n] = dict(modes=imodes, mv=mv_q, ref=ref,
                                   inter=use_inter,
                                   cost=torch.where(use_inter, ecost, icost))
            if not self.smp:
                continue
            zero = torch.zeros((nb,), dtype=I32, device=self.device)
            per_size[n].update(part=zero, mv_pu1=torch.zeros_like(mv_q),
                               ref_pu1=zero)
            if n in (16, 32):
                # rectangular PUs compete with 2Nx2N and intra
                part, mva, refa, mvb, refb, scost = self._smp_leaf(
                    src_y, src_cb, src_cr, refs, fields, n)
                if not self.allow_inter[n]:
                    scost = scost + big
                ps = per_size[n]
                better = scost < ps["cost"]
                b2 = better[:, None]
                ps.update(part=torch.where(better, part, 0),
                          mv=torch.where(b2, mva, ps["mv"]),
                          ref=torch.where(better, refa, ps["ref"]),
                          mv_pu1=torch.where(b2, mvb, 0),
                          ref_pu1=torch.where(better, refb, 0),
                          inter=ps["inter"] | better,
                          cost=torch.where(better, scost, ps["cost"]))
        size_map8 = self._dp_merge(per_size)
        sel8 = self._sel8_fn(per_size, size_map8)
        inter8 = sel8("inter")
        mv8 = sel8("mv", 2).to(I32)
        ref8 = sel8("ref").to(I32)
        part8 = None
        if self.smp:
            part8 = torch.where(inter8, sel8("part").to(I32), 0)
            # cells of the second PU take its motion, by part geometry
            k8 = (size_map8 >> 3).clamp(min=1)
            rr = self._arange(self.r8)[:, None] % k8
            cc = self._arange(self.c8)[None, :] % k8
            h2, q4 = k8 >> 1, k8 >> 2
            pu1 = (((part8 == 1) & (rr >= h2)) | ((part8 == 2) & (cc >= h2))
                   | ((part8 == 3) & (rr >= q4))
                   | ((part8 == 4) & (rr >= k8 - q4))
                   | ((part8 == 5) & (cc >= q4))
                   | ((part8 == 6) & (cc >= k8 - q4)))
            mv8 = torch.where(pu1[..., None], sel8("mv_pu1", 2).to(I32), mv8)
            ref8 = torch.where(pu1, sel8("ref_pu1").to(I32), ref8)
        return (size_map8, sel8("modes").to(I32), inter8, mv8, ref8, part8,
                leaf_preds)

    def _dp_merge(self, per_size):
        """Bottom-up split DP over per-size leaf costs -> size_map8. As in
        the reference, the intra depth range forces or forbids the 8 / 16
        / 32 splits of the inter quadtree too, and --pu-depth-inter
        without depth 0 forbids 64 leaves."""
        lam = self.lam
        split16, split32, best32 = self._split_dp(
            *(per_size[n]["cost"].reshape(self.h // n, self.w // n)
              for n in (8, 16, 32)))
        leaf64 = per_size[64]["cost"].reshape(self.h // 64, self.w // 64)
        split64 = sum4(best32) + lam * self.dpc[self.DPC_SPLIT1] \
            < leaf64 + lam * self.dpc[self.DPC_SPLIT0]
        if not self.allow_inter[64]:
            split64 = torch.ones_like(split64)
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
                           preds, part8=None, refs=None, mv8=None,
                           ref8=None):
        """Reconstruct every inter leaf of every size in one batch from
        the DP leaves' final predictions; with part8 (P slices with SMP)
        the SMP CUs then reconstruct from the cell maps mv8/ref8 on the
        stack refs (_smp_recon). Returns (luma [2,Hp,Wp], chroma
        [4,Hc,Wc], written8)."""
        luma, chroma, written = self._new_planes()
        for n in (8, 16, 32, 64):
            k = n // 8
            rows, cols = self.h // n, self.w // n
            is_leaf = (size_map8[::k, ::k] == n) & inter8[::k, ::k]
            if part8 is not None:
                is_leaf = is_leaf & (part8[::k, ::k] == 0)
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
        if part8 is not None:
            written |= self._smp_recon(src_y, src_cb, src_cr, size_map8,
                                       inter8, part8, refs, mv8, ref8, luma,
                                       chroma)
        return luma, chroma, written

    def _smp_recon(self, src_y, src_cb, src_cr, size_map8, inter8, part8,
                   refs, mv8, ref8, luma, chroma):
        """Reconstruct the SMP/AMP CUs into the planes, in place: every
        8x8 luma / 4x4 chroma cell predicts with its own PU's motion
        (translation is pointwise, so this equals whole-PU MC), then the
        forced-split T/Q per CU. Returns the cells written."""
        refs_y, refs_cb, refs_cr = refs
        written = torch.zeros_like(inter8)
        for n in (16, 32):
            k = n // 8
            rows, cols = self.h // n, self.w // n
            nb = rows * cols
            is_smp = ((size_map8[::k, ::k] == n) & inter8[::k, ::k]
                      & (part8[::k, ::k] != 0))
            mask = is_smp.reshape(-1)
            bid = self._arange(nb)
            y0, x0 = (bid // cols) * n, (bid % cols) * n

            def cu_cells(m8):
                # [r8, c8, ...] -> per-CU cells in raster order [nb*k*k, ...]
                v = m8.reshape(rows, k, cols, k, *m8.shape[2:])
                return v.transpose(1, 2).reshape(nb * k * k, *m8.shape[2:])

            def cells_to_cu(p, cell):
                return p.reshape(nb, k, k, cell, cell).transpose(2, 3) \
                    .reshape(nb, k * cell, k * cell)
            mvc, refc = cu_cells(mv8), cu_cells(ref8)
            ar = self._arange(k * k)
            y0c = (y0[:, None] + (ar // k * 8)[None, :]).reshape(-1)
            x0c = (x0[:, None] + (ar % k * 8)[None, :]).reshape(-1)
            pred_y = cells_to_cu(mc_luma_plain(refs_y, mvc, y0c, x0c, 8,
                                               maxv=self.maxv, sel=refc), 8)
            resi = self._blocks(src_y, n) - pred_y
            levels, r2 = self._tq_quad(resi, self.qp_y, True, tools=True)
            self._put(luma[0], y0, x0, n,
                      (pred_y + r2).clamp(0, self.maxv), mask)
            self._put(luma[1], y0, x0, n, levels, mask)
            nc = n // 2
            for ci, (srcp, planes) in enumerate(((src_cb, refs_cb),
                                                 (src_cr, refs_cr))):
                cpred = cells_to_cu(self._mc_chroma_sel(
                    planes, refc, mvc, y0c // 2, x0c // 2, 4), 4)
                cresi = self._blocks(srcp, nc) - cpred
                clev, cr2 = self._tq_quad(cresi, self.qp_c, False,
                                          tools=True)
                self._put(chroma[ci], y0 // 2, x0 // 2, nc,
                          (cpred + cr2).clamp(0, self.maxv), mask)
                self._put(chroma[2 + ci], y0 // 2, x0 // 2, nc, clev, mask)
            written |= rep2(is_smp, k)
        return written

    # ------------------------------------------------------------------
    # deblocking boundary strengths from decision maps (spec 8.7.2.4)
    # ------------------------------------------------------------------

    def _cu_edges(self, size_map8, part8=None):
        """(vertical, horizontal) edge maps of the 8-cell grid: CU edges,
        the internal TU32 edges of 64 CUs (forced transform split) and,
        with part8, the SMP CUs' half-CU TU edges and the asymmetric PU
        edges at quarter offsets."""
        k = size_map8 >> 3
        c = self._arange(self.c8)[None, :]
        r = self._arange(self.r8)[:, None]
        ver_edge = ((c & (k - 1)) == 0) & (c > 0)
        hor_edge = ((r & (k - 1)) == 0) & (r > 0)
        ver_edge = ver_edge | ((size_map8 == 64) & ((c & 7) == 4))
        hor_edge = hor_edge | ((size_map8 == 64) & ((r & 7) == 4))
        if part8 is not None:
            smp = part8 != 0
            h2, q4 = k >> 1, k >> 2
            co, ro = c % k, r % k
            ver_edge = ver_edge | (smp & (co == h2) & (h2 > 0))
            hor_edge = hor_edge | (smp & (ro == h2) & (h2 > 0))
            hor_edge = hor_edge | ((part8 == 3) & (ro == q4) & (q4 > 0))
            hor_edge = hor_edge | ((part8 == 4) & (ro == k - q4))
            ver_edge = ver_edge | ((part8 == 5) & (co == q4) & (q4 > 0))
            ver_edge = ver_edge | ((part8 == 6) & (co == k - q4))
        return ver_edge, hor_edge

    @staticmethod
    def _bs_grid(ver_edge, hor_edge, maps, bs):
        """Boundary strengths of the edges from the per-cell maps: bs(cur,
        nb) of every cell and its left / top neighbour (zero-filled at
        the picture's border), expanded to the deblocking grid (ver
        [H/4, W/8], hor [H/8, W/4])."""
        def shift_left(v):
            return torch.cat([torch.zeros_like(v[:, :1]), v[:, :-1]], dim=1)

        def shift_up(v):
            return torch.cat([torch.zeros_like(v[:1]), v[:-1]], dim=0)

        left = {kk: shift_left(v) for kk, v in maps.items()}
        up = {kk: shift_up(v) for kk, v in maps.items()}
        bs_v8 = torch.where(ver_edge, bs(maps, left), 0)
        bs_h8 = torch.where(hor_edge, bs(maps, up), 0)
        return (bs_v8.repeat_interleave(2, 0).to(I32),
                bs_h8.repeat_interleave(2, 1).to(I32))

    def _edge_maps_inter(self, size_map8, inter8, mv8, ref_poc8, nz8,
                         part8=None):
        """Deblocking BS for P slices: 2 across intra, 1 across a coded
        TU, a change of reference picture or an MV step of a pel or
        more."""
        def bs(cur, nb):
            dmv = ((cur["mvx"] - nb["mvx"]).abs() >= 4) | \
                ((cur["mvy"] - nb["mvy"]).abs() >= 4)
            one = cur["nz"] | nb["nz"] | (cur["poc"] != nb["poc"]) | dmv
            return torch.where(cur["intra"] | nb["intra"], 2,
                               torch.where(one, 1, 0))
        maps = dict(intra=~inter8, nz=nz8, poc=ref_poc8, mvx=mv8[:, :, 0],
                    mvy=mv8[:, :, 1])
        return self._bs_grid(*self._cu_edges(size_map8, part8), maps, bs)

    def _edge_maps_inter_b(self, size_map8, inter8, dir8, mv8, mv8b,
                           poc8_0, poc8_1, nz8):
        """Deblocking BS for B slices (the full two-list rule)."""
        ver_edge, hor_edge = self._cu_edges(size_map8)
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
        return self._bs_grid(ver_edge, hor_edge, maps, bs)

    def _nz8(self, lvl_y, size_map8, part8=None):
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
        if part8 is not None:
            # SMP CUs carry four half-size TUs: cbf at TU granularity
            smp = part8 != 0
            nz8 = torch.where(smp & (size_map8 == 16), cell_any, nz8)
            blk2 = cell_any.reshape(self.r8 // 2, 2, self.c8 // 2, 2) \
                .any(dim=3).any(dim=1)
            nz8 = torch.where(smp & (size_map8 == 32), rep2(blk2, 2), nz8)
        return nz8

    # ------------------------------------------------------------------
    # full frame
    # ------------------------------------------------------------------

    def _inter_full_impl(self, src_y_u8, src_cb_u8, src_cr_u8, refs,
                         ref_pocs) -> dict:
        """P frame: refs = (y, cb, cr) stacks [R, ...], ref_pocs [R]."""
        src_y = src_y_u8.to(I32)
        src_cb = src_cb_u8.to(I32)
        src_cr = src_cr_u8.to(I32)
        refs = tuple(p.to(I32) for p in refs)
        (size_map8, mode_map8, inter8, mv8, ref8, part8,
         leaf_preds) = self._partition_inter_p(src_y, src_cb, src_cr, refs)
        init = self._inter_recon_batch(src_y, src_cb, src_cr, size_map8,
                                       inter8, leaf_preds, part8=part8,
                                       refs=refs, mv8=mv8, ref8=ref8)
        luma, chroma, _, n_waves = self._recon_md(
            src_y, src_cb, src_cr, size_map8, mode_map8, init_state=init,
            exclude8=init[2])
        ry, rcb, rcr, lvl_y, lvl_cb, lvl_cr = self._unpack_planes(luma,
                                                                  chroma)
        if self.deblock:
            nz8 = self._nz8(lvl_y, size_map8, part8)
            ref_poc8 = torch.where(inter8, ref_pocs[ref8.long()],
                                   NO_REF_POC)
            bs = self._edge_maps_inter(size_map8, inter8, mv8, ref_poc8,
                                       nz8, part8)
            ry, rcb, rcr = self._deblock(ry, rcb, rcr, *bs)
        out = self._frame_outputs(ry, rcb, rcr, lvl_y, lvl_cb, lvl_cr,
                                  src_y, src_cb, src_cr)
        out.update(size_map8=size_map8.to(torch.int8),
                   mode_map8=mode_map8.to(torch.int8), inter8=inter8,
                   mv8=mv8.to(torch.int16), ref8=ref8.to(torch.int8),
                   n_waves=n_waves[0])
        if part8 is not None:
            out["part8"] = part8.to(torch.int8)
        return out

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
                   ref8b=ref8b.to(torch.int8), n_waves=n_waves[0])
        return out

    def _stack(self, planes, depth: int):
        """The newest-first reference planes (device tensors or numpy)
        truncated or padded to depth by repeating the last, stacked on
        the device."""
        ps = list(planes)[:depth]
        ps += ps[-1:] * (depth - len(ps))
        return torch.stack([self._to_dev(p) for p in ps])

    def _pocs(self, vals, depth: int):
        vs = list(vals)[:depth]
        vs += vs[-1:] * (depth - len(vs))
        return torch.as_tensor(vs, dtype=I32, device=self.device)

    @torch.inference_mode()
    def submit_inter(self, src_y, src_cb, src_cr, refs_y, refs_cb, refs_cr,
                     ref_pocs, qp: int | None = None) -> dict:
        """P frame: refs_* lists of reference planes (device tensors or
        numpy), newest first, truncated or padded to n_refs by repeating
        the last (their POCs alike)."""
        self.set_consts(self._consts_for(qp))
        K = self.n_refs
        return self._inter_full_impl(
            self._to_dev(src_y), self._to_dev(src_cb), self._to_dev(src_cr),
            tuple(self._stack(p, K) for p in (refs_y, refs_cb, refs_cr)),
            self._pocs(ref_pocs, K))

    @torch.inference_mode()
    def submit_inter_b(self, src_y, src_cb, src_cr, l0, l1, l0_pocs,
                       l1_pocs, qp: int | None = None) -> dict:
        """B frame: l0/l1 = ([y..], [cb..], [cr..]) per-list reference
        stacks (device tensors or numpy), newest first, truncated or
        padded to n_refs_b by repeating the last entry (their POCs
        alike)."""
        self.set_consts(self._consts_for(qp))
        K = self.n_refs_b
        s0 = tuple(self._stack(p, K) for p in l0)
        s1 = s0 if l1 is l0 else tuple(self._stack(p, K) for p in l1)
        return self._inter_full_b_impl(
            self._to_dev(src_y), self._to_dev(src_cb), self._to_dev(src_cr),
            s0, s1, self._pocs(l0_pocs, K), self._pocs(l1_pocs, K))
