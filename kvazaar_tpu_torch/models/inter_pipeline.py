"""Inter frames on the 16x16 CTB grid (--ctu 16) in PyTorch: P frames and
the B pyramid's B frames.

Device port of kvazaar_tpu/models/inter_pipeline.py. On top of the intra
grid pipeline, for every 16x16 block of the frame at once:

- exhaustive integer motion search over +-8 pels on each reference
  picture (SAD, first minimum in (dy, dx) scan order), then a greedy
  half- then quarter-pel refinement by SATD (8 neighbours a step);
- the best (mv, reference) of a list with a reference-index penalty, so
  a duplicated padding reference is never chosen;
- exact quarter-pel luma (8-tap) and eighth-pel chroma (4-tap) motion
  compensation with edge clamping, the 14-bit intermediates for
  bi-prediction ((v0 + v1 + 64) >> 7);
- the inter/intra choice by SATD (inter when 8 * inter <= 9 * intra), and
  in B frames the list choice with a lambda-scaled penalty on the second
  motion vector;
- the wavefront reconstruction with each inter block's prediction and
  the inter rounding offset, and deblocking with boundary strengths from
  the blocks' motion (spec 8.7.2.4 on the uniform grid).

Integer products (the SAD and MC sums) stay int32; the intra candidate's
prediction is a float32 product, exact because TF32 is off.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.mc import CHROMA_FILTERS, LUMA_FILTERS
from ..ops.me import satd_tiles
from .intra_md import I32
from .intra_pipeline import CHROMA_N, LUMA_N, IntraPipeline

ME_RANGE = 8  # integer-pel exhaustive window [-R, R]
SUBPEL_PAD = ME_RANGE + 3  # integer range + 8-tap reach (3 left)


def bi_penalty(qp: int) -> int:
    """The B frame's second-list signalling cost in SATD units,
    int(12 * sqrt(0.57) * 2^((qp - 12) / 6)) in the reference's float32
    arithmetic."""
    e = np.float32(np.float32(qp) - np.float32(12.0)) * np.float32(1 / 6)
    lam = np.float32(np.sqrt(np.float32(0.57))) \
        * np.float32(2.0 ** float(e))
    return int(np.float32(np.float32(InterPipeline.BI_PEN_BINS) * lam))


def edge_pad(x: torch.Tensor, p: int) -> torch.Tensor:
    """Pad the last two dims by p samples of edge replication."""
    h, w = x.shape[-2:]
    iy = (torch.arange(-p, h + p, device=x.device)).clamp(0, h - 1)
    ix = (torch.arange(-p, w + p, device=x.device)).clamp(0, w - 1)
    return x[..., iy[:, None], ix[None, :]]


class InterPipeline(IntraPipeline):
    """Adds P and B frames to the intra grid pipeline (same block grid)."""

    REF_PENALTY = 8   # SATD units per ref index (ref_idx signalling cost)
    BI_PEN_BINS = 12.0  # second-list signalling cost in CABAC bins
    NO_REF_POC = -(1 << 30)
    N_LIST_REFS = 2  # fixed per-list stack size of the B path
    # the reference's name for _transform_quant with the per-block
    # intra/inter rounding offset
    _transform_quant_sel = IntraPipeline._transform_quant

    def __init__(self, height: int, width: int, qp: int,
                 n_refs: int = 1, deblock: bool = False,
                 deblock_beta: int = 0, deblock_tc: int = 0,
                 sao: str = "off", sign_hiding: bool = False,
                 rdoq: bool = False, device="cuda") -> None:
        super().__init__(height, width, qp, deblock=deblock,
                         deblock_beta=deblock_beta, deblock_tc=deblock_tc,
                         sao=sao, sign_hiding=sign_hiding, rdoq=rdoq,
                         device=device)
        self.n_refs = max(1, n_refs)
        bid = self._arange(self.n_blocks)
        self.b_r, self.b_c = bid // self.cols, bid % self.cols
        self.lf = torch.as_tensor(LUMA_FILTERS, dtype=I32, device=self.device)
        self.cf = torch.as_tensor(CHROMA_FILTERS, dtype=I32,
                                  device=self.device)
        # the refinement's neighbour order: half-pel steps, then quarter
        nbr = ((-1, 0), (1, 0), (0, -1), (0, 1), (-1, -1), (1, -1), (-1, 1),
               (1, 1))
        self._subpel_steps = torch.as_tensor(
            [(dx * s, dy * s) for s in (2, 1) for dx, dy in nbr], dtype=I32,
            device=self.device)

    # -- motion estimation ----------------------------------------------

    def _me_impl(self, src_blocks, prev_pad):
        """Full-search integer ME. src_blocks [B, 16, 16]; prev_pad the
        reference padded by ME_RANGE on all sides. Returns (mv [B, 2] in
        pels, best SAD [B]): the first minimum in (dy, dx) scan order."""
        n, R = LUMA_N, ME_RANGE
        y0 = self.b_r * n
        x0 = self.b_c * n
        ix = x0[:, None] + self._arange(n + 2 * R)[None, :]
        sads = []
        for dy in range(2 * R + 1):
            iy = (y0 + dy)[:, None] + self._arange(n)[None, :]
            strip = prev_pad[iy[:, :, None], ix[:, None, :]]  # [B, n, n+2R]
            win = strip.unfold(2, n, 1)                       # [B, n, 2R+1, n]
            sads.append((win - src_blocks[:, :, None, :]).abs()
                        .sum(dim=(1, 3), dtype=I32))
        sads = torch.stack(sads, dim=1).reshape(self.n_blocks, -1)
        best = torch.argmin(sads, dim=1)
        best_sad = torch.gather(sads, 1, best[:, None])[:, 0]
        mv = torch.stack([best % (2 * R + 1) - R, best // (2 * R + 1) - R],
                         dim=1).to(I32)
        return mv, best_sad

    # -- motion compensation -------------------------------------------

    def _mc_luma_qpel(self, ypad, mv, ridx=None, hi=False):
        """Exact quarter-pel luma MC of every block; mv [B, 2] in qpel.
        ypad: the reference padded by SUBPEL_PAD, one picture [H, W] or a
        stack [K, H, W] indexed per block by ridx. Returns [B, 16, 16];
        hi=True the 14-bit intermediate (spec 8.5.3.3.3)."""
        n, P = LUMA_N, SUBPEL_PAD
        y0 = self.b_r * n
        x0 = self.b_c * n
        ix, iy = mv[:, 0] >> 2, mv[:, 1] >> 2
        fx, fy = mv[:, 0] & 3, mv[:, 1] & 3
        ar = self._arange(n + 7)[None, :]
        # clamped: the spec's edge extension
        wy = ((y0 + iy + P - 3)[:, None] + ar).clamp(0, ypad.shape[-2] - 1)
        wx = ((x0 + ix + P - 3)[:, None] + ar).clamp(0, ypad.shape[-1] - 1)
        if ypad.dim() == 3:
            win = ypad[ridx[:, None, None], wy[:, :, None], wx[:, None, :]]
        else:
            win = ypad[wy[:, :, None], wx[:, None, :]]    # [B, n+7, n+7]
        cx = self.lf[fx.long()]
        cy = self.lf[fy.long()]
        h14 = sum(cx[:, k, None, None] * win[:, :, k:k + n]
                  for k in range(8))                      # [B, n+7, n]
        v = sum(cy[:, k, None, None] * h14[:, k:k + n, :]
                for k in range(8)) >> 6
        if hi:
            return v
        return ((v + 32) >> 6).clamp(0, 255)

    def _mc_chroma_qpel(self, cpad, mv, cy0, cx0, ridx=None, hi=False):
        """Exact eighth-pel chroma MC; mv in luma qpel (chroma eighth-pel)
        units; cpad padded by SUBPEL_PAD // 2 + 2, [H, W] or [K, H, W]
        with per-block ridx. hi=True: the 14-bit intermediate."""
        nc = CHROMA_N
        CP = (SUBPEL_PAD >> 1) + 2
        ix, iy = mv[:, 0] >> 3, mv[:, 1] >> 3
        fx, fy = mv[:, 0] & 7, mv[:, 1] & 7
        ar = self._arange(nc + 3)[None, :]
        wy = ((cy0 + iy + CP - 1)[:, None] + ar).clamp(0, cpad.shape[-2] - 1)
        wx = ((cx0 + ix + CP - 1)[:, None] + ar).clamp(0, cpad.shape[-1] - 1)
        if cpad.dim() == 3:
            win = cpad[ridx[:, None, None], wy[:, :, None], wx[:, None, :]]
        else:
            win = cpad[wy[:, :, None], wx[:, None, :]]
        cxf = self.cf[fx.long()]
        cyf = self.cf[fy.long()]
        h14 = sum(cxf[:, k, None, None] * win[:, :, k:k + nc]
                  for k in range(4))
        v = sum(cyf[:, k, None, None] * h14[:, k:k + nc, :]
                for k in range(4)) >> 6
        if hi:
            return v
        return ((v + 32) >> 6).clamp(0, 255)

    def _mc_blocks(self, prevs_y, prevs_cb, prevs_cr, mv_qpel, ridx,
                   hi=False):
        """Prediction blocks (y, cb, cr) for quarter-pel MVs from a
        reference stack [K, H, W] with a reference a block."""
        pred_y = self._mc_luma_qpel(edge_pad(prevs_y, SUBPEL_PAD), mv_qpel,
                                    ridx, hi=hi)
        CP = (SUBPEL_PAD >> 1) + 2
        cx0 = self.b_c * CHROMA_N
        cy0 = self.b_r * CHROMA_N
        pred_cb = self._mc_chroma_qpel(edge_pad(prevs_cb, CP), mv_qpel, cy0,
                                       cx0, ridx, hi=hi)
        pred_cr = self._mc_chroma_qpel(edge_pad(prevs_cr, CP), mv_qpel, cy0,
                                       cx0, ridx, hi=hi)
        return pred_y, pred_cb, pred_cr

    def _subpel_refine(self, src_blocks, ypad, mv_int):
        """Half- then quarter-pel refinement around the integer MV by SATD,
        greedy over the 8 neighbours in order (kvazaar search_frac analog,
        every block at once)."""
        mv = mv_int * 4
        best = satd_tiles(src_blocks - self._mc_luma_qpel(ypad, mv))
        for d in self._subpel_steps:
            # clamped so that the window stays inside the padding
            cand = (mv + d).clamp(-4 * ME_RANGE, 4 * ME_RANGE)
            cost = satd_tiles(src_blocks - self._mc_luma_qpel(ypad, cand))
            better = cost < best
            mv = torch.where(better[:, None], cand, mv)
            best = torch.where(better, cost, best)
        return mv, best

    # -- the frame step -------------------------------------------------

    def _best_uni(self, src_blocks, prevs_y, n_refs: int):
        """Best (mv qpel, ref_idx, satd) over a reference stack [K, H, W]:
        integer search and sub-pel refinement on each, a ref_idx penalty,
        the first reference on ties."""
        nb = self.n_blocks
        best_cost = torch.full((nb,), 1 << 30, dtype=I32, device=self.device)
        mv = torch.zeros((nb, 2), dtype=I32, device=self.device)
        ref_idx = torch.zeros((nb,), dtype=I32, device=self.device)
        satd_best = best_cost
        for k in range(n_refs):
            mv_int, _ = self._me_impl(src_blocks,
                                      edge_pad(prevs_y[k], ME_RANGE))
            mv_k, satd_k = self._subpel_refine(
                src_blocks, edge_pad(prevs_y[k], SUBPEL_PAD), mv_int)
            cost_k = satd_k + self.REF_PENALTY * k
            better = cost_k < best_cost
            best_cost = torch.where(better, cost_k, best_cost)
            satd_best = torch.where(better, satd_k, satd_best)
            mv = torch.where(better[:, None], mv_k, mv)
            ref_idx = torch.where(better, k, ref_idx)
        return mv, ref_idx, satd_best

    def _intra_candidate(self, src_y, src_blocks):
        """The intra candidate of every block: (modes, satd) of the
        search's mode, its prediction without the 10/26 edge filters."""
        n = LUMA_N
        modes, refs, raw = self._search(src_y)
        ipred = raw[torch.arange(self.n_blocks, device=self.device),
                    modes.long()]
        ipred = torch.where((modes == 1)[:, None],
                            self._dc_pred(refs, n, True), ipred)
        satd = satd_tiles(src_blocks - ipred.reshape(self.n_blocks, n, n))
        return modes, satd

    def _src(self, src_y, src_cb, src_cr):
        src_y, src_cb, src_cr = (p.to(I32) for p in (src_y, src_cb, src_cr))
        return src_y, src_cb, src_cr, self._blocks(src_y, LUMA_N)

    def _inter_impl(self, src_y, src_cb, src_cr, prevs_y, prevs_cb,
                    prevs_cr) -> dict:
        """A P frame; prevs_* reference stacks [K, H(/2), W(/2)], newest
        first."""
        src_y, src_cb, src_cr, src_blocks = self._src(src_y, src_cb, src_cr)
        prevs_y, prevs_cb, prevs_cr = (p.to(I32) for p in
                                       (prevs_y, prevs_cb, prevs_cr))
        mv, ref_idx, satd_inter = self._best_uni(src_blocks, prevs_y,
                                                 self.n_refs)
        preds = self._mc_blocks(prevs_y, prevs_cb, prevs_cr, mv, ref_idx)
        modes, satd_intra = self._intra_candidate(src_y, src_blocks)
        # inter is favoured slightly (cheaper to signal)
        is_inter = satd_inter.to(torch.int64) * 8 \
            <= satd_intra.to(torch.int64) * 9
        out = self._waves_inter(src_y, src_cb, src_cr, modes, is_inter,
                                *preds, mv=mv, ref_idx=ref_idx)
        out.update(mv=mv, ref_idx=ref_idx, is_inter=is_inter,
                   modes_flat=modes)
        return out

    def _inter_b_impl(self, src_y, src_cb, src_cr, l0_y, l0_cb, l0_cr,
                      l1_y, l1_cb, l1_cr, l0_pocs, l1_pocs) -> dict:
        """A B frame: the best uni candidate of each list, their 14-bit
        bi-prediction average, the list choice by SATD with the second
        list's signalling penalty, then the inter/intra choice."""
        src_y, src_cb, src_cr, src_blocks = self._src(src_y, src_cb, src_cr)
        l0_y, l0_cb, l0_cr, l1_y, l1_cb, l1_cr = (
            p.to(I32) for p in (l0_y, l0_cb, l0_cr, l1_y, l1_cb, l1_cr))
        mv0, r0, satd0 = self._best_uni(src_blocks, l0_y, l0_y.shape[0])
        mv1, r1, satd1 = self._best_uni(src_blocks, l1_y, l1_y.shape[0])
        v0 = self._mc_blocks(l0_y, l0_cb, l0_cr, mv0, r0, hi=True)
        v1 = self._mc_blocks(l1_y, l1_cb, l1_cr, mv1, r1, hi=True)

        def uni(v):
            return ((v + 32) >> 6).clamp(0, 255)

        def bi(a, b):
            return ((a + b + 64) >> 7).clamp(0, 255)

        satd_bi = satd_tiles(src_blocks - bi(v0[0], v1[0]))
        cbi = satd_bi + self._bi_pen
        inter_dir = torch.where((cbi <= satd0) & (cbi <= satd1), 3,
                                torch.where(satd0 <= satd1, 1, 2)).to(I32)
        satd_inter = torch.minimum(torch.minimum(satd0, satd1), cbi)
        sel = inter_dir[:, None, None]
        preds = [torch.where(sel == 3, bi(a, b),
                             torch.where(sel == 1, uni(a), uni(b)))
                 for a, b in zip(v0, v1)]
        modes, satd_intra = self._intra_candidate(src_y, src_blocks)
        is_inter = satd_inter.to(torch.int64) * 8 \
            <= satd_intra.to(torch.int64) * 9
        # each list slot's motion for the BS derivation and the writer:
        # an unused slot carries no reference and a zero MV
        use0 = inter_dir != 2
        use1 = inter_dir != 1
        mv2 = torch.stack([torch.where(use0[:, None], mv0, 0),
                           torch.where(use1[:, None], mv1, 0)], dim=1)
        ref2 = torch.stack([torch.where(use0, r0, -1),
                            torch.where(use1, r1, -1)], dim=1)
        poc2 = torch.stack(
            [torch.where(use0, l0_pocs[r0.long()], self.NO_REF_POC),
             torch.where(use1, l1_pocs[r1.long()], self.NO_REF_POC)], dim=1)
        out = self._waves_inter(src_y, src_cb, src_cr, modes, is_inter,
                                *preds, mv2=mv2, poc2=poc2)
        out.update(mv2=mv2, ref2=ref2, inter_dir=inter_dir,
                   is_inter=is_inter, modes_flat=modes)
        return out

    # -- deblocking strengths ---------------------------------------------

    def _bs_pairs(self, pair):
        """(bs_v, bs_h) [R, C] from a pair(p, q) rule over the vertical
        edges (left neighbour p) and the horizontal ones (upper p)."""
        R, C = self.rows, self.cols
        bs_v = torch.zeros((R, C), dtype=I32, device=self.device)
        bs_h = torch.zeros((R, C), dtype=I32, device=self.device)
        bs_v[:, 1:] = pair((slice(None), slice(None, -1)),
                           (slice(None), slice(1, None)))
        bs_h[1:, :] = pair((slice(None, -1), slice(None)),
                           (slice(1, None), slice(None)))
        return bs_v, bs_h

    def _bs_blocks(self, is_inter, nz_blk, mv, ref_idx):
        """Per-block-edge boundary strengths of the one-list grid (spec
        8.7.2.4): intra -> 2; a nonzero luma TU, another reference or an
        MV delta of at least one pel -> 1."""
        R, C = self.rows, self.cols
        intra = (~is_inter).reshape(R, C)
        nz = nz_blk.reshape(R, C)
        mvb = mv.reshape(R, C, 2)
        rib = torch.where(intra, -1, ref_idx.reshape(R, C))

        def pair(sp, sq):
            far = ((mvb[sp] - mvb[sq]).abs() >= 4).any(dim=-1)
            bs1 = nz[sp] | nz[sq] | (rib[sp] != rib[sq]) | far
            return torch.where(intra[sp] | intra[sq], 2, bs1.to(I32))
        return self._bs_pairs(pair)

    def _bs_blocks_bi(self, is_inter, nz_blk, mv2, poc2):
        """Boundary strengths of the two-list grid (spec 8.7.2.4, as
        ops/deblock.py compute_bs): list slots with NO_REF_POC unused and
        zero MVs; the same reference multiset compares the MVs under the
        matching assignment, two equal references need both assignments
        to differ by a pel."""
        R, C = self.rows, self.cols
        intra = (~is_inter).reshape(R, C)
        nz = nz_blk.reshape(R, C)
        mvb = mv2.reshape(R, C, 2, 2)
        pocb = poc2.reshape(R, C, 2)
        cnt = (pocb != self.NO_REF_POC).sum(dim=-1)

        def far(a, b):
            return ((a - b).abs() >= 4).any(dim=-1)

        def pair(sp, sq):
            mp, mq = mvb[sp], mvb[sq]
            pp, pq = pocb[sp], pocb[sq]
            eq_s = (pp[..., 0] == pq[..., 0]) & (pp[..., 1] == pq[..., 1])
            eq_c = (pp[..., 0] == pq[..., 1]) & (pp[..., 1] == pq[..., 0])
            d_s = far(mp[..., 0, :], mq[..., 0, :]) \
                | far(mp[..., 1, :], mq[..., 1, :])
            d_c = far(mp[..., 0, :], mq[..., 1, :]) \
                | far(mp[..., 1, :], mq[..., 0, :])
            ok = (eq_s & ~d_s) | (eq_c & ~d_c)
            bs1 = nz[sp] | nz[sq] | (cnt[sp] != cnt[sq]) | ~ok
            return torch.where(intra[sp] | intra[sq], 2, bs1.to(I32))
        return self._bs_pairs(pair)

    def _waves_inter(self, src_y, src_cb, src_cr, modes_flat, is_inter,
                     ipred_y, ipred_cb, ipred_cr, mv=None, ref_idx=None,
                     mv2=None, poc2=None) -> dict:
        """Wavefront recon of one frame with each block's intra or inter
        prediction; deblocking with the blocks' motion strengths."""
        loop = self._wave_loop(src_y[None], src_cb[None], src_cr[None],
                               modes_flat[None], is_inter[None],
                               (ipred_y, ipred_cb, ipred_cr))
        ry, rcb, rcr, ly, lcb, lcr = self._frame_planes(loop, 0)
        bs_blk = None
        if self.deblock:
            nz_blk = (ly != 0).any(dim=2).any(dim=1)
            if mv2 is not None:
                bs_blk = self._bs_blocks_bi(is_inter, nz_blk, mv2, poc2)
            elif mv is not None:
                bs_blk = self._bs_blocks(is_inter, nz_blk, mv, ref_idx)
        return self._outputs(ry, rcb, rcr, ly, lcb, lcr, src_y, src_cb,
                             src_cr, bs_blk=bs_blk)

    # -- host interface -----------------------------------------------------

    def set_qp(self, qp: int | None) -> None:
        super().set_qp(qp)
        self._bi_pen = bi_penalty(self.qp_y)

    def _stack(self, r, k: int) -> torch.Tensor:
        """A reference list as a stack of exactly k pictures (padded by
        repeating the last; the ref_idx penalty keeps the duplicates
        unselected); one [H, W] picture becomes a stack of one."""
        if isinstance(r, (list, tuple)):
            arrs = [self._to_dev(a) for a in r]
            while len(arrs) < k:
                arrs.append(arrs[-1])
            return torch.stack(arrs[:k])
        a = self._to_dev(r)
        return a[None] if a.dim() == 2 else a

    @torch.inference_mode()
    def submit_inter(self, src_y, src_cb, src_cr, refs_y, refs_cb, refs_cr,
                     qp: int | None = None) -> dict:
        """A P frame on reference stacks refs_* (lists are stacked to
        n_refs pictures)."""
        self.set_qp(qp)
        k = self.n_refs
        return self._inter_impl(
            self._to_dev(src_y), self._to_dev(src_cb), self._to_dev(src_cr),
            self._stack(refs_y, k), self._stack(refs_cb, k),
            self._stack(refs_cr, k))

    @torch.inference_mode()
    def submit_inter_b(self, src_y, src_cb, src_cr, l0, l1, l0_pocs,
                       l1_pocs, qp: int | None = None) -> dict:
        """A B frame. l0 / l1: ([y..], [cb..], [cr..]) reference plane
        lists; *_pocs their POCs (both padded to N_LIST_REFS by repeating
        the last)."""
        self.set_qp(qp)
        k = self.N_LIST_REFS

        def pocs(p):
            p = list(p)
            while len(p) < k:
                p.append(p[-1])
            return torch.as_tensor(p[:k], dtype=I32, device=self.device)

        return self._inter_b_impl(
            self._to_dev(src_y), self._to_dev(src_cb), self._to_dev(src_cr),
            self._stack(l0[0], k), self._stack(l0[1], k),
            self._stack(l0[2], k), self._stack(l1[0], k),
            self._stack(l1[1], k), self._stack(l1[2], k), pocs(l0_pocs),
            pocs(l1_pocs))
