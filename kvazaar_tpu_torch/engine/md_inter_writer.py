"""Quadtree P-slice syntax writer.

Consumes the multi-depth inter decisions of models/inter_md.py (per-8x8
cell size/inter/mode/mv/ref maps + full-frame coefficient planes) and
writes the coding tree with mixed inter/intra CUs at 8/16/32. Merge /
skip / AMVP are resolved at write time against the decoder's own
candidate derivation on a shared frame state (the symmetry-by-
construction trick of engine/inter_writer.py).

Reference parity: kvazaar src/encode_coding_tree.c:745 (tree) + :311
(inter PU) specialised to 2Nx2N PUs and TU == CU.
"""
from __future__ import annotations

import numpy as np

from ..cabac import CabacEncoder, ContextSet
from ..decoder.decoder import INTRA, SliceDecoder
from ..syntax.residual import encode_residual
from ..tables import intra_mode_scan_idx
from .inter_writer import NO_REF, PSliceWriter


class MdPSliceWriter(PSliceWriter):
    """Writes one P slice over the CTB-64 quadtree."""

    def __init__(self, sps, pps, sh, decisions, ref_entries, poc,
                 ref_entries_l1=(), union_pocs=None) -> None:
        super().__init__(sps, pps, sh, decisions, ref_entries, poc,
                         ref_entries_l1=ref_entries_l1,
                         union_pocs=union_pocs)
        self.size8 = np.asarray(decisions["size_map8"], np.int32)
        self.mode8 = np.asarray(decisions["mode_map8"], np.int32)
        self.inter8 = np.asarray(decisions["inter8"], bool)
        self.mv8 = np.asarray(decisions["mv8"], np.int32)
        self.ref8 = np.asarray(decisions["ref8"], np.int32)
        # SMP/AMP part ids per 8-cell (0 = 2Nx2N); per-PU motion rides
        # the per-cell mv8/ref8 maps (models/inter_md.py merges it)
        self.part8 = (np.asarray(decisions["part8"], np.int32)
                      if "part8" in decisions else None)
        # B slices: per-list slots + inter_dir (models/inter_md.py
        # _inter_full_b_impl); absent on the P path
        self.dir8 = (np.asarray(decisions["dir8"], np.int32)
                     if "dir8" in decisions else None)
        self.mv8b = (np.asarray(decisions["mv8b"], np.int32)
                     if "mv8b" in decisions else None)
        self.ref8b = (np.asarray(decisions["ref8b"], np.int32)
                      if "ref8b" in decisions else None)
        self.lvl = [np.asarray(decisions["levels_y"]),
                    np.asarray(decisions["levels_cb"]),
                    np.asarray(decisions["levels_cr"])]
        self.sdh = bool(pps.sign_data_hiding_enabled)

    # -- tree ------------------------------------------------------------------

    def write_ctu(self, r: int, c: int) -> None:
        if getattr(self, "sao_w", None) is not None:
            self.sao_w.write(self.cab, r, c, c > 0, r > 0)
        self.coding_quadtree(c * 64, r * 64, 6, 0)

    def coding_quadtree(self, x0: int, y0: int, log2_size: int,
                        depth: int) -> None:
        sps = self.sps
        size = 1 << log2_size
        inside = (x0 + size <= sps.width) and (y0 + size <= sps.height)
        leaf_size = int(self.size8[y0 >> 3, x0 >> 3]) if inside else 0
        h = self.helper
        fs = self.fs
        if inside and log2_size > sps.log2_min_cb_size:
            split = size > leaf_size
            ctx = 0
            if h._coded(x0 - 1, y0) and \
                    fs.depth[y0 >> 2, (x0 - 1) >> 2] > depth:
                ctx += 1
            if h._coded(x0, y0 - 1) and \
                    fs.depth[(y0 - 1) >> 2, x0 >> 2] > depth:
                ctx += 1
            self.cab.encode_bin(ContextSet.idx("split_cu_flag", ctx),
                                1 if split else 0)
        else:
            split = (not inside and log2_size > sps.log2_min_cb_size) or \
                (inside and size > leaf_size)
        if split:
            half = size >> 1
            for dx, dy in ((0, 0), (half, 0), (0, half), (half, half)):
                if x0 + dx < sps.width and y0 + dy < sps.height:
                    self.coding_quadtree(x0 + dx, y0 + dy, log2_size - 1,
                                         depth + 1)
            return
        fs.depth[y0 >> 2:(y0 + size) >> 2,
                 x0 >> 2:(x0 + size) >> 2] = depth
        if self.inter8[y0 >> 3, x0 >> 3]:
            self._inter_cu(x0, y0, size, log2_size)
        else:
            self._intra_cu(x0, y0, size, log2_size)

    # -- motion from the 8-cell maps -------------------------------------------

    def _motion_at(self, x0: int, y0: int):
        r8, c8 = y0 >> 3, x0 >> 3
        mv = np.zeros((2, 2), np.int32)
        if self.dir8 is not None:
            # B decisions: per-list (mv, ref) slots + inter_dir
            d = int(self.dir8[r8, c8])
            flags = (bool(d & 1), bool(d & 2))
            pocs = [NO_REF, NO_REF]
            ridx2 = [-1, -1]
            if flags[0]:
                ridx2[0] = min(int(self.ref8[r8, c8]),
                               len(self.ref_pocs) - 1)
                pocs[0] = self.ref_pocs[ridx2[0]]
                mv[0] = self.mv8[r8, c8]
            if flags[1]:
                ridx2[1] = min(int(self.ref8b[r8, c8]),
                               len(self.ref_pocs_l1) - 1)
                pocs[1] = self.ref_pocs_l1[ridx2[1]]
                mv[1] = self.mv8b[r8, c8]
            return ((flags, mv, tuple(pocs)), ridx2)
        k = min(int(self.ref8[r8, c8]), len(self.union_pocs) - 1)
        poc = self.union_pocs[k]
        if poc in self.ref_pocs:
            lx, ridx = 0, self.ref_pocs.index(poc)
        else:
            lx, ridx = 1, self.ref_pocs_l1.index(poc)
        mv[lx] = self.mv8[r8, c8]
        pocs = (poc, NO_REF) if lx == 0 else (NO_REF, poc)
        ridx2 = [ridx, -1] if lx == 0 else [-1, ridx]
        return (((lx == 0, lx == 1), mv, pocs), ridx2)

    def _levels_at(self, x0: int, y0: int, size: int):
        cs = size >> 1
        cy0, cx0 = y0 >> 1, x0 >> 1
        return (self.lvl[0][y0:y0 + size, x0:x0 + size],
                self.lvl[1][cy0:cy0 + cs, cx0:cx0 + cs],
                self.lvl[2][cy0:cy0 + cs, cx0:cx0 + cs])

    # -- CUs -------------------------------------------------------------------

    PART_NAMES = {1: "2NxN", 2: "Nx2N", 3: "2NxnU", 4: "2NxnD",
                  5: "nLx2N", 6: "nRx2N"}

    def _write_part_mode(self, part: str, log2_size: int) -> None:
        """part_mode binarization for inter CUs above min CB size
        (mirror of decoder _parse_part_mode_inter)."""
        cab = self.cab
        cab.encode_bin(ContextSet.idx("part_mode", 0),
                       1 if part == "2Nx2N" else 0)
        if part == "2Nx2N":
            return
        ver = part in ("2NxN", "2NxnU", "2NxnD")
        cab.encode_bin(ContextSet.idx("part_mode", 1), 1 if ver else 0)
        if self.sps.amp_enabled:
            smp = part in ("2NxN", "Nx2N")
            cab.encode_bin(ContextSet.idx("part_mode", 3),
                           1 if smp else 0)
            if not smp:
                cab.encode_bin_ep(
                    1 if part in ("2NxnD", "nRx2N") else 0)

    def _inter_cu_smp(self, x0: int, y0: int, size: int,
                      log2_size: int, part_id: int) -> None:
        """Inter CU with a rectangular PU partition: per-PU merge/AMVP
        resolution + the forced transform split (interSplitFlag).
        Mirrors the decoder's _coding_unit_p SMP branch exactly."""
        from ..decoder.decoder import SliceDecoder
        cab = self.cab
        h = self.helper
        part = self.PART_NAMES[part_id]
        cab.encode_bin(ContextSet.idx("cu_skip_flag",
                                      self._skip_ctx(x0, y0)), 0)
        cab.encode_bin(ContextSet.idx("pred_mode_flag", 0), 0)
        self._write_part_mode(part, log2_size)
        max_merge = 5 - self.sh.five_minus_max_num_merge_cand
        pus = SliceDecoder._pu_geometry(part, x0, y0, size)
        for i, (px, py, pw, ph) in enumerate(pus):
            # per-PU motion from the first cell of the PU
            r8, c8 = py >> 3, px >> 3
            k = min(int(self.ref8[r8, c8]), len(self.union_pocs) - 1)
            poc = self.union_pocs[k]
            mv = np.zeros((2, 2), np.int32)
            if poc in self.ref_pocs:
                lx, ridx = 0, self.ref_pocs.index(poc)
            else:
                lx, ridx = 1, self.ref_pocs_l1.index(poc)
            mv[lx] = self.mv8[r8, c8]
            pocs = (poc, NO_REF) if lx == 0 else (NO_REF, poc)
            motion = ((lx == 0, lx == 1), mv, pocs)
            excl_a1 = i == 1 and part in ("Nx2N", "nLx2N", "nRx2N")
            excl_b1 = i == 1 and part in ("2NxN", "2NxnU", "2NxnD")
            cands = h.merge_candidates(px, py, pw, ph, max_merge,
                                       excl_a1, excl_b1)
            merge_idx = None
            for kk, cand in enumerate(cands):
                if SliceDecoder._same_motion(cand, motion):
                    merge_idx = kk
                    break
            if merge_idx is not None:
                cab.encode_bin(ContextSet.idx("merge_flag", 0), 1)
                self._write_merge_idx(merge_idx, max_merge)
            else:
                cab.encode_bin(ContextSet.idx("merge_flag", 0), 0)
                if self.is_b:
                    cab.encode_bin(
                        ContextSet.idx("inter_pred_idc",
                                       int(self.fs.depth[py >> 2,
                                                         px >> 2])), 0)
                    cab.encode_bin(ContextSet.idx("inter_pred_idc", 4),
                                   1 if lx == 1 else 0)
                n_act = (self.sh.num_ref_idx_l0_active_minus1 + 1
                         if lx == 0
                         else self.sh.num_ref_idx_l1_active_minus1 + 1)
                self._write_ref_idx(ridx, n_act)
                mvps = h.amvp_candidates(px, py, pw, ph, lx, poc)
                mvv = motion[1][lx]
                costs = [abs(int(mvv[0] - m[0])) + abs(int(mvv[1] - m[1]))
                         for m in mvps]
                flag = 1 if costs[1] < costs[0] else 0
                mvd = (mvv - mvps[flag]).astype(np.int32)
                self._write_mvd(mvd)
                cab.encode_bin(ContextSet.idx("mvp_flag", 0), flag)
            h._mark_inter(px, py, pw, ph, motion, False)
        ly, lcb, lcr = self._levels_at(x0, y0, size)
        has_resi = 1 if (ly.any() or lcb.any() or lcr.any()) else 0
        cab.encode_bin(ContextSet.idx("rqt_root_cbf", 0), has_resi)
        if not has_resi:
            return
        # forced transform split once (interSplitFlag with
        # max_transform_hierarchy_depth_inter == 0): parent chroma cbfs
        # at depth 0, then four half-size TUs in z order at depth 1
        half = size >> 1
        cbf_cb = 1 if lcb.any() else 0
        cbf_cr = 1 if lcr.any() else 0
        cab.encode_bin(ContextSet.idx("cbf_chroma", 0), cbf_cb)
        cab.encode_bin(ContextSet.idx("cbf_chroma", 0), cbf_cr)
        c_log2 = log2_size - 2
        # a 4x4 chroma TU of an inter CU codes transform_skip_flag too
        # (spec 7.3.8.11; the JAX package's writer omits it)
        tse = bool(self.pps.transform_skip_enabled)
        for (dx, dy) in ((0, 0), (half, 0), (0, half), (half, half)):
            qly, qlcb, qlcr = self._levels_at(x0 + dx, y0 + dy, half)
            q_cb = 1 if qlcb.any() else 0
            q_cr = 1 if qlcr.any() else 0
            q_y = 1 if qly.any() else 0
            if cbf_cb:
                cab.encode_bin(ContextSet.idx("cbf_chroma", 1), q_cb)
            if cbf_cr:
                cab.encode_bin(ContextSet.idx("cbf_chroma", 1), q_cr)
            cab.encode_bin(ContextSet.idx("cbf_luma", 0), q_y)
            if q_y:
                encode_residual(cab, qly, log2_size - 1, 0, 0, self.sdh)
            if cbf_cb and q_cb:
                encode_residual(cab, qlcb, c_log2, 1, 0, self.sdh,
                                transform_skip_enabled=tse)
            if cbf_cr and q_cr:
                encode_residual(cab, qlcr, c_log2, 2, 0, self.sdh,
                                transform_skip_enabled=tse)

    def _inter_cu(self, x0: int, y0: int, size: int,
                  log2_size: int) -> None:
        if self.part8 is not None and \
                int(self.part8[y0 >> 3, x0 >> 3]) != 0:
            self._inter_cu_smp(x0, y0, size, log2_size,
                               int(self.part8[y0 >> 3, x0 >> 3]))
            return
        cab = self.cab
        h = self.helper
        motion, ridx2 = self._motion_at(x0, y0)
        ly, lcb, lcr = self._levels_at(x0, y0, size)
        cbf_y = 1 if ly.any() else 0
        cbf_cb = 1 if lcb.any() else 0
        cbf_cr = 1 if lcr.any() else 0
        has_resi = cbf_y or cbf_cb or cbf_cr
        max_merge = 5 - self.sh.five_minus_max_num_merge_cand
        cands = h.merge_candidates(x0, y0, size, size, max_merge)
        merge_idx = None
        for k, cand in enumerate(cands):
            if SliceDecoder._same_motion(cand, motion):
                merge_idx = k
                break
        skip_ctx = self._skip_ctx(x0, y0)
        if merge_idx is not None and not has_resi:
            cab.encode_bin(ContextSet.idx("cu_skip_flag", skip_ctx), 1)
            self._write_merge_idx(merge_idx, max_merge)
            h._mark_inter(x0, y0, size, size, motion, True)
            return
        cab.encode_bin(ContextSet.idx("cu_skip_flag", skip_ctx), 0)
        cab.encode_bin(ContextSet.idx("pred_mode_flag", 0), 0)
        cab.encode_bin(ContextSet.idx("part_mode", 0), 1)  # 2Nx2N
        if merge_idx is not None:
            cab.encode_bin(ContextSet.idx("merge_flag", 0), 1)
            self._write_merge_idx(merge_idx, max_merge)
        else:
            cab.encode_bin(ContextSet.idx("merge_flag", 0), 0)
            flags = motion[0]
            if self.is_b:
                bi = flags[0] and flags[1]
                cab.encode_bin(ContextSet.idx("inter_pred_idc",
                                              6 - log2_size),
                               1 if bi else 0)
                if not bi:
                    cab.encode_bin(ContextSet.idx("inter_pred_idc", 4),
                                   1 if flags[1] else 0)
            for lx in (0, 1):
                if not flags[lx]:
                    continue
                ridx = ridx2[lx]
                n_act = (self.sh.num_ref_idx_l0_active_minus1 + 1
                         if lx == 0
                         else self.sh.num_ref_idx_l1_active_minus1 + 1)
                self._write_ref_idx(ridx, n_act)
                ref_poc = (self.ref_pocs[ridx] if lx == 0
                           else self.ref_pocs_l1[ridx])
                mvps = h.amvp_candidates(x0, y0, size, size, lx, ref_poc)
                mv = motion[1][lx]
                costs = [abs(int(mv[0] - m[0])) + abs(int(mv[1] - m[1]))
                         for m in mvps]
                flag = 1 if costs[1] < costs[0] else 0
                mvd = (mv - mvps[flag]).astype(np.int32)
                self._write_mvd(mvd)
                cab.encode_bin(ContextSet.idx("mvp_flag", 0), flag)
        h._mark_inter(x0, y0, size, size, motion, False)
        if merge_idx is None:
            cab.encode_bin(ContextSet.idx("rqt_root_cbf", 0),
                           1 if has_resi else 0)
        if not has_resi:
            return
        if log2_size == 6:
            # forced transform split (64 > MaxTb 32, spec 7.4.9.8): four
            # 32x32 luma TUs with 16x16 chroma, parent chroma cbfs at
            # depth 0 then per-child cbfs at depth 1
            quads = ((0, 0), (32, 0), (0, 32), (32, 32))
            subs = [self._levels_at(x0 + dx, y0 + dy, 32)
                    for dx, dy in quads]
            cab.encode_bin(ContextSet.idx("cbf_chroma", 0), cbf_cb)
            cab.encode_bin(ContextSet.idx("cbf_chroma", 0), cbf_cr)
            for (qly, qlcb, qlcr) in subs:
                q_cb = 1 if qlcb.any() else 0
                q_cr = 1 if qlcr.any() else 0
                q_y = 1 if qly.any() else 0
                if cbf_cb:
                    cab.encode_bin(ContextSet.idx("cbf_chroma", 1), q_cb)
                if cbf_cr:
                    cab.encode_bin(ContextSet.idx("cbf_chroma", 1), q_cr)
                cab.encode_bin(ContextSet.idx("cbf_luma", 0), q_y)
                if q_y:
                    encode_residual(cab, qly, 5, 0, 0, self.sdh)
                if cbf_cb and q_cb:
                    encode_residual(cab, qlcb, 4, 1, 0, self.sdh)
                if cbf_cr and q_cr:
                    encode_residual(cab, qlcr, 4, 2, 0, self.sdh)
            return
        cab.encode_bin(ContextSet.idx("cbf_chroma", 0), cbf_cb)
        cab.encode_bin(ContextSet.idx("cbf_chroma", 0), cbf_cr)
        if cbf_cb or cbf_cr:
            cab.encode_bin(ContextSet.idx("cbf_luma", 1), cbf_y)
        c_log2 = log2_size - 1
        # an 8x8 CU's 4x4 chroma TUs code transform_skip_flag too (spec
        # 7.3.8.11; the JAX package's writer omits it)
        tse = bool(self.pps.transform_skip_enabled)
        if cbf_y:
            encode_residual(cab, ly, log2_size, 0, 0, self.sdh)
        if cbf_cb:
            encode_residual(cab, lcb, c_log2, 1, 0, self.sdh,
                            transform_skip_enabled=tse)
        if cbf_cr:
            encode_residual(cab, lcr, c_log2, 2, 0, self.sdh,
                            transform_skip_enabled=tse)

    def _intra_cu(self, x0: int, y0: int, size: int,
                  log2_size: int) -> None:
        cab = self.cab
        h = self.helper
        fs = self.fs
        cab.encode_bin(ContextSet.idx("cu_skip_flag",
                                      self._skip_ctx(x0, y0)), 0)
        cab.encode_bin(ContextSet.idx("pred_mode_flag", 0), 1)
        if log2_size == self.sps.log2_min_cb_size:
            cab.encode_bin(ContextSet.idx("part_mode", 0), 1)  # 2Nx2N
        true_mode = int(self.mode8[y0 >> 3, x0 >> 3])
        mode = true_mode
        crypto = getattr(cab, "crypto_res", None)
        if crypto is not None:
            from ..extras import crypto as _cr
            if crypto[1] & _cr.CRYPTO_INTRA_MODE:
                mode = _cr.encrypt_intra_mode(crypto[0], true_mode)
        mpm = h.mpm_list(x0, y0)
        if mode in mpm:
            cab.encode_bin(
                ContextSet.idx("prev_intra_luma_pred_flag", 0), 1)
            idx = mpm.index(mode)
            if idx == 0:
                cab.encode_bin_ep(0)
            else:
                cab.encode_bin_ep(1)
                cab.encode_bin_ep(idx - 1)
        else:
            cab.encode_bin(
                ContextSet.idx("prev_intra_luma_pred_flag", 0), 0)
            rem = mode
            for cand in sorted(mpm, reverse=True):
                if rem > cand:
                    rem -= 1
            cab.encode_bins_ep(rem, 5)
        cab.encode_bin(ContextSet.idx("intra_chroma_pred_mode", 0), 0)
        sl = (slice(y0 >> 2, (y0 + size) >> 2),
              slice(x0 >> 2, (x0 + size) >> 2))
        fs.intra_mode[sl] = mode
        fs.pred_mode[sl] = INTRA
        fs.coded[sl] = True
        fs.decoded[sl] = True
        fs.ref_poc[sl[0], sl[1], :] = NO_REF
        fs.skip[sl] = False
        ly, lcb, lcr = self._levels_at(x0, y0, size)
        cbf_y = 1 if ly.any() else 0
        cbf_cb = 1 if lcb.any() else 0
        cbf_cr = 1 if lcr.any() else 0
        cab.encode_bin(ContextSet.idx("cbf_chroma", 0), cbf_cb)
        cab.encode_bin(ContextSet.idx("cbf_chroma", 0), cbf_cr)
        cab.encode_bin(ContextSet.idx("cbf_luma", 1), cbf_y)
        c_log2 = log2_size - 1
        tse = bool(self.pps.transform_skip_enabled)
        if cbf_y:
            encode_residual(cab, ly, log2_size, 0,
                            intra_mode_scan_idx(mode, log2_size, False),
                            self.sdh)
        if cbf_cb:
            encode_residual(cab, lcb, c_log2, 1,
                            intra_mode_scan_idx(mode, c_log2, True),
                            self.sdh, transform_skip_enabled=tse)
        if cbf_cr:
            encode_residual(cab, lcr, c_log2, 2,
                            intra_mode_scan_idx(mode, c_log2, True),
                            self.sdh, transform_skip_enabled=tse)
