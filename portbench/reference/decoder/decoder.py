"""Validation HEVC decoder (intra profile subset).

Frozen copy of kvazaar_tpu_torch/decoder/decoder.py, with the host
modules it needs beside it (portbench/reference/: the constant tables
written from the specification, the encoder-side code left out), so that
the benchmark's reference imports nothing of the program; it also records
each picture's slice QP and slice type, and its intra prediction units
with their luma modes.

Decodes Annex-B HEVC streams produced by this framework and by the reference
encoder, reconstructs pictures exactly, and verifies decoded-picture-hash
SEIs. This is the project's conformance oracle complement (the other half is
ffmpeg via OpenCV): if this decoder — written independently from the spec —
reconstructs reference-encoder streams hash-exactly, the shared tables and
sample ops are proven; the encoder is then validated against both.

Reference parity: this subsumes what kvazaar relies on HM's TAppDecoder for
in tests/util.sh:19-55.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..bitstream import (BitReader, NAL_PPS, NAL_PREFIX_SEI, NAL_SPS,
                         NAL_SUFFIX_SEI, NAL_VPS, ebsp_to_rbsp, split_annexb)
from ..cabac import CabacDecoder, ContextSet
from ..hevc.headers import parse_pps, parse_slice_header, parse_sps
from ..hevc.params import PPS, SPS, SliceHeader
from ..hevc.sei import (SEI_DECODED_PICTURE_HASH, parse_hash_sei,
                        parse_sei_messages, plane_checksum, plane_md5)
from ..ops import reference as ops
from ..syntax.residual import decode_residual
from ..tables import chroma_qp, intra_mode_scan_idx

INTRA = 1
INTER = 0


def _clip8(v: int) -> int:
    return min(max(int(v), -128), 127)


@dataclass
class DecodedFrame:
    poc: int
    planes: list[np.ndarray]  # Y, Cb, Cr (cropped to conformance window)
    full_planes: list[np.ndarray] | None = None  # pre-crop (hash domain)
    hash_ok: bool | None = None


@dataclass
class _FrameState:
    sps: SPS
    pps: PPS
    sh: SliceHeader
    y: np.ndarray = field(init=False)
    cb: np.ndarray = field(init=False)
    cr: np.ndarray = field(init=False)
    # per-4x4-luma-block maps
    depth: np.ndarray = field(init=False)
    intra_mode: np.ndarray = field(init=False)
    pred_mode: np.ndarray = field(init=False)
    decoded: np.ndarray = field(init=False)
    coded: np.ndarray = field(init=False)  # z-scan parse precedence
    qp_map: np.ndarray = field(init=False)

    def __post_init__(self) -> None:
        sps = self.sps
        ctb = sps.ctb_size
        w = sps.width_in_ctbs * ctb
        h = sps.height_in_ctbs * ctb
        self.y = np.zeros((h, w), dtype=np.int32)
        self.cb = np.zeros((h // 2, w // 2), dtype=np.int32)
        self.cr = np.zeros((h // 2, w // 2), dtype=np.int32)
        mw, mh = w // 4, h // 4
        self.depth = np.zeros((mh, mw), dtype=np.int8)
        self.intra_mode = np.full((mh, mw), 1, dtype=np.int8)
        self.pred_mode = np.full((mh, mw), INTRA, dtype=np.int8)
        # log2 size of the intra prediction unit covering each 4x4 block
        # (0 where it is not intra), for the benchmark's mode check
        self.pu_log2 = np.zeros((mh, mw), dtype=np.int8)
        self.decoded = np.zeros((mh, mw), dtype=bool)
        self.coded = np.zeros((mh, mw), dtype=bool)
        # tile id per 4x4 block (all zero when tiles are off); prediction
        # and z-scan availability never cross tile boundaries (spec 6.4.1)
        self.tile4 = np.zeros((mh, mw), dtype=np.int32)
        self.tile_grid = None
        self.scaling = None  # ScalingLists when scaling_list_enabled
        # per-4x4 transquant-bypass map (lossless CUs): such samples are
        # exempt from deblocking and SAO (spec 8.7.2/8.7.3)
        self.bypass4 = np.zeros((mh, mw), dtype=bool)
        self.qp_map = np.full((mh, mw), self.sh.qp, dtype=np.int8)
        # motion field (per 4x4, per list): mv in qpel, ref poc
        # (-(1<<30) = unused/intra)
        self.mv = np.zeros((mh, mw, 2, 2), dtype=np.int32)
        self.ref_poc = np.full((mh, mw, 2), -(1 << 30), dtype=np.int64)
        self.skip = np.zeros((mh, mw), dtype=bool)
        self.nonzero = np.zeros((mh, mw), dtype=bool)  # luma TU has coeffs
        # SAO parameters per component: (ctb_y, ctb_x) -> (type, offs, aux)
        self.sao = [{}, {}, {}]
        # deblocking edge maps (8-aligned TU/CU edges; spec 8.7.2)
        self.edges_ver = np.zeros((h // 4, w // 8), dtype=bool)
        self.edges_hor = np.zeros((h // 8, w // 4), dtype=bool)
        self.c_edges_ver = np.zeros((h // 8, w // 16), dtype=bool)
        self.c_edges_hor = np.zeros((h // 16, w // 8), dtype=bool)


class SliceDecoder:
    """Decodes one independent slice segment's CTUs."""

    def __init__(self, fs: _FrameState, cab: CabacDecoder) -> None:
        self.fs = fs
        self.cab = cab
        self.sps = fs.sps
        self.pps = fs.pps
        self.sh = fs.sh
        self.cur_tile = 0
        # delta-QP state (spec 8.6.1): cur_qp doubles as qPY_PREV when a
        # new quantization group starts; a fresh SliceDecoder is made at
        # slice/tile/WPP-row starts, which resets it to SliceQpY
        self.cur_qp = fs.sh.qp
        self.qg_pred = fs.sh.qp
        self.qg_delta_coded = True
        self.qg_rect = None
        # optional per-frame mode statistics (tools/stream_stats.py):
        # filled only when the HEVCDecoder enables collection
        self.stats = getattr(fs, "stats", None)

    # -- helpers -------------------------------------------------------------

    def _avail(self, x: int, y: int) -> bool:
        """Sample availability at luma position (x, y) (spec 6.4.1)."""
        if x < 0 or y < 0 or x >= self.sps.width or y >= self.sps.height:
            return False
        if self.fs.tile4[y >> 2, x >> 2] != self.cur_tile:
            return False
        return bool(self.fs.decoded[y >> 2, x >> 2])

    def _coded(self, x: int, y: int) -> bool:
        """z-scan parse-order availability (spec 6.4.1)."""
        if x < 0 or y < 0 or x >= self.sps.width or y >= self.sps.height:
            return False
        if self.fs.tile4[y >> 2, x >> 2] != self.cur_tile:
            return False
        return bool(self.fs.coded[y >> 2, x >> 2])

    def _neighbor_intra_mode(self, x: int, y: int, cur_ctu_y: int,
                             is_above: bool) -> int:
        """candIntraPredMode from a neighbour PU (spec 8.4.2)."""
        if not self._coded(x, y):
            return 1  # DC
        if self.fs.pred_mode[y >> 2, x >> 2] != INTRA:
            return 1
        if is_above and (y >> self.sps.ctb_log2) != \
                (cur_ctu_y >> self.sps.ctb_log2):
            return 1
        return int(self.fs.intra_mode[y >> 2, x >> 2])

    def mpm_list(self, x0: int, y0: int) -> list[int]:
        a = self._neighbor_intra_mode(x0 - 1, y0, y0, False)
        b = self._neighbor_intra_mode(x0, y0 - 1, y0, True)
        if a == b:
            if a < 2:
                return [0, 1, 26]
            return [a, 2 + ((a + 29) % 32), 2 + ((a - 2 + 1) % 32)]
        lst = [a, b]
        if a != 0 and b != 0:
            lst.append(0)
        elif a + b < 2:
            lst.append(26)
        else:
            lst.append(1)
        return lst

    # -- intra reconstruction -------------------------------------------------

    def _build_refs(self, plane: np.ndarray, x: int, y: int, size: int,
                    c_idx: int) -> tuple[np.ndarray, np.ndarray, int]:
        """Gather and substitute reference samples for a TU at (x, y) in
        plane coords (chroma coords for c_idx>0)."""
        scale = 2 if c_idx else 1
        n2 = 2 * size
        left = np.zeros(n2, dtype=np.int32)
        top = np.zeros(n2, dtype=np.int32)
        avail_l = np.zeros(n2, dtype=bool)
        avail_t = np.zeros(n2, dtype=bool)
        ph, pw = plane.shape
        for i in range(n2):
            yy = y + i
            if x > 0 and yy < ph:
                avail_l[i] = self._avail((x - 1) * scale, yy * scale)
                if avail_l[i]:
                    left[i] = plane[yy, x - 1]
        for i in range(n2):
            xx = x + i
            if y > 0 and xx < pw:
                avail_t[i] = self._avail(xx * scale, (y - 1) * scale)
                if avail_t[i]:
                    top[i] = plane[y - 1, xx]
        avail_c = x > 0 and y > 0 and self._avail((x - 1) * scale,
                                                  (y - 1) * scale)
        corner = int(plane[y - 1, x - 1]) if avail_c else 0
        return ops.intra_ref_substitution(
            left, top, corner, avail_l, avail_t, avail_c,
            self.sps.bit_depth_luma)

    def _intra_recon_tu(self, x: int, y: int, log2_size: int, c_idx: int,
                        mode: int, coeffs: np.ndarray | None,
                        ts: bool = False) -> None:
        size = 1 << log2_size
        fs = self.fs
        plane = (fs.y, fs.cb, fs.cr)[c_idx]
        scale = 2 if c_idx else 1
        px, py = x // scale, y // scale
        left, top, corner = self._build_refs(plane, px, py, size, c_idx)
        if c_idx == 0:
            left, top, corner = ops.intra_filter_refs(
                left, top, corner, size, mode,
                bool(self.sps.strong_intra_smoothing),
                self.sps.bit_depth_luma)
        pred = ops.intra_predict(left, top, corner, size, mode, c_idx > 0,
                                 self.sps.bit_depth_luma)
        if coeffs is not None:
            if getattr(self, "cu_bypass", False):
                pred = pred + coeffs         # lossless: raw residual
            else:
                qp = int(fs.qp_map[y >> 2, x >> 2])
                if c_idx:
                    qp = chroma_qp(qp,
                                   self.pps.cb_qp_offset if c_idx == 1
                                   else self.pps.cr_qp_offset)
                # dequant runs at Qp' = Qp + QpBdOffset (spec 8.6.3)
                qp += 6 * (self.sps.bit_depth_luma - 8)
                m = (fs.scaling.matrix(size, c_idx)
                     if fs.scaling is not None else None)
                deq = ops.dequantize(coeffs, qp,
                                     self.sps.bit_depth_luma, m=m)
                if ts:
                    bd = self.sps.bit_depth_luma
                    resi = ((deq.astype(np.int64) << 7)
                            + (1 << (19 - bd))) >> (20 - bd)
                    resi = resi.astype(np.int32)
                else:
                    is_dst = (c_idx == 0 and log2_size == 2)
                    resi = ops.inverse_transform(
                        deq, is_dst, self.sps.bit_depth_luma)
                pred = pred + resi
        max_val = (1 << self.sps.bit_depth_luma) - 1
        plane[py:py + size, px:px + size] = np.clip(pred, 0, max_val)
        if c_idx == 0:
            fs.decoded[y >> 2:(y + size) >> 2, x >> 2:(x + size) >> 2] = True
            if coeffs is not None:
                fs.nonzero[y >> 2:(y + size) >> 2,
                           x >> 2:(x + size) >> 2] = True
            if x > 0 and x % 8 == 0:
                fs.edges_ver[y >> 2:(y + size) >> 2, x >> 3] = True
            if y > 0 and y % 8 == 0:
                fs.edges_hor[y >> 3, x >> 2:(x + size) >> 2] = True
        elif c_idx == 1:
            if px > 0 and px % 8 == 0:
                fs.c_edges_ver[py >> 2:(py + size) >> 2, px >> 3] = True
            if py > 0 and py % 8 == 0:
                fs.c_edges_hor[py >> 3, px >> 2:(px + size) >> 2] = True

    # -- syntax ---------------------------------------------------------------

    def decode_ctu(self, ctu_x: int, ctu_y: int) -> None:
        sps = self.sps
        x0 = ctu_x * sps.ctb_size
        y0 = ctu_y * sps.ctb_size
        if self.sh.sao_luma or self.sh.sao_chroma:
            self._decode_sao(ctu_x, ctu_y)
        self.coding_quadtree(x0, y0, sps.ctb_log2, 0)

    def _decode_sao(self, cx: int, cy: int) -> None:
        cab = self.cab
        fs = self.fs
        merge_left = merge_up = 0
        tg = fs.tile_grid
        left_ok = cx > 0 and (tg is None or
                              tg.tile_id_ctb[cy, cx - 1]
                              == tg.tile_id_ctb[cy, cx])
        up_ok = cy > 0 and (tg is None or
                            tg.tile_id_ctb[cy - 1, cx]
                            == tg.tile_id_ctb[cy, cx])
        if left_ok:
            merge_left = cab.decode_bin(ContextSet.idx("sao_merge_flag", 0))
        if not merge_left and up_ok:
            merge_up = cab.decode_bin(ContextSet.idx("sao_merge_flag", 0))
        if merge_left or merge_up:
            src = (cy, cx - 1) if merge_left else (cy - 1, cx)
            for c in range(3):
                if src in fs.sao[c]:
                    fs.sao[c][(cy, cx)] = fs.sao[c][src]
            return
        from ..ops.sao import SAO_BAND, SAO_EDGE, SAO_OFF
        typ_luma = typ_chroma = SAO_OFF
        eo_chroma = 0
        for c in range(3):
            if c == 0 and not self.sh.sao_luma:
                continue
            if c > 0 and not self.sh.sao_chroma:
                continue
            if c in (0, 1):
                if cab.decode_bin(ContextSet.idx("sao_type_idx", 0)):
                    typ = SAO_EDGE if cab.decode_bin_ep() else SAO_BAND
                else:
                    typ = SAO_OFF
                if c == 0:
                    typ_luma = typ
                else:
                    typ_chroma = typ
            else:
                typ = typ_chroma
            if typ == SAO_OFF:
                fs.sao[c][(cy, cx)] = (SAO_OFF, [0] * 4, 0)
                continue
            cmax = (1 << (min(self.sps.bit_depth_luma, 10) - 5)) - 1
            offs_abs = []
            for _ in range(4):
                v = 0
                while v < cmax and cab.decode_bin_ep():
                    v += 1
                offs_abs.append(v)
            if typ == SAO_BAND:
                offs = []
                for v in offs_abs:
                    if v and cab.decode_bin_ep():
                        v = -v
                    offs.append(v)
                aux = cab.decode_bins_ep(5)
            else:
                offs = [offs_abs[0], offs_abs[1], -offs_abs[2],
                        -offs_abs[3]]
                if c in (0, 1):
                    aux = cab.decode_bins_ep(2)
                    if c == 1:
                        eo_chroma = aux
                else:
                    aux = eo_chroma
            fs.sao[c][(cy, cx)] = (typ, offs, aux)

    # -- delta QP (spec 8.6.1, 7.3.8.10) -------------------------------------

    def _start_qg(self, x0: int, y0: int, log2_size: int) -> None:
        """Open a quantization group at (x0, y0): derive qPY_PRED and
        prefill the qp map (re-filled if a delta gets coded)."""
        fs = self.fs
        ctb_mask = ~((1 << self.sps.ctb_log2) - 1)
        qp_prev = self.cur_qp
        qp_a = qp_b = qp_prev
        # neighbours count only when inside the same CTB as this QG
        if x0 > 0 and ((x0 - 1) & ctb_mask) == (x0 & ctb_mask) and \
                self._coded(x0 - 1, y0):
            qp_a = int(fs.qp_map[y0 >> 2, (x0 - 1) >> 2])
        if y0 > 0 and ((y0 - 1) & ctb_mask) == (y0 & ctb_mask) and \
                self._coded(x0, y0 - 1):
            qp_b = int(fs.qp_map[(y0 - 1) >> 2, x0 >> 2])
        self.qg_pred = (qp_a + qp_b + 1) >> 1
        self.cur_qp = self.qg_pred
        self.qg_delta_coded = False
        size = 1 << log2_size
        self.qg_rect = (x0, y0, size)
        self._fill_qg_qp()

    def _fill_qg_qp(self) -> None:
        x0, y0, size = self.qg_rect
        x1 = min(x0 + size, self.sps.width)
        y1 = min(y0 + size, self.sps.height)
        self.fs.qp_map[y0 >> 2:(y1 + 3) >> 2,
                       x0 >> 2:(x1 + 3) >> 2] = self.cur_qp

    def _maybe_decode_qp_delta(self, any_cbf: bool) -> None:
        if not self.pps.cu_qp_delta_enabled or self.qg_delta_coded \
                or not any_cbf:
            return
        cab = self.cab
        # TR prefix cMax 5 (ctx 0 for the first bin, ctx 1 after) + EG0
        v = 0
        if cab.decode_bin(ContextSet.idx("cu_qp_delta_abs", 0)):
            v = 1
            while v < 5 and cab.decode_bin(
                    ContextSet.idx("cu_qp_delta_abs", 1)):
                v += 1
            if v == 5:
                k = 0
                while cab.decode_bin_ep():
                    k += 1
                    if k > 30:
                        raise ValueError("cu_qp_delta overflow")
                v = 5 + ((1 << k) - 1) + (cab.decode_bins_ep(k) if k
                                          else 0)
        if v:
            if cab.decode_bin_ep():
                v = -v
        self.qg_delta_coded = True
        # QpY wrap (spec 8.6.1): over [−QpBdOffsetY, 51] with
        # QpBdOffsetY = 6*(bit_depth−8), so 10-bit deltas wrap correctly
        off = 6 * (self.sps.bit_depth_luma - 8)
        self.cur_qp = ((self.qg_pred + v + 52 + 2 * off)
                       % (52 + off)) - off
        self._fill_qg_qp()

    def coding_quadtree(self, x0: int, y0: int, log2_size: int,
                        depth: int) -> None:
        sps = self.sps
        size = 1 << log2_size
        if self.pps.cu_qp_delta_enabled and log2_size >= \
                sps.ctb_log2 - self.pps.diff_cu_qp_delta_depth:
            self._start_qg(x0, y0, log2_size)
        inside = (x0 + size <= sps.width) and (y0 + size <= sps.height)
        if inside and log2_size > sps.log2_min_cb_size:
            ctx_off = 0
            if self._coded(x0 - 1, y0) and \
                    self.fs.depth[y0 >> 2, (x0 - 1) >> 2] > depth:
                ctx_off += 1
            if self._coded(x0, y0 - 1) and \
                    self.fs.depth[(y0 - 1) >> 2, x0 >> 2] > depth:
                ctx_off += 1
            split = self.cab.decode_bin(
                ContextSet.idx("split_cu_flag", ctx_off))
        else:
            split = 1 if (log2_size > sps.log2_min_cb_size) else 0
        if split:
            half = size >> 1
            for (dx, dy) in ((0, 0), (half, 0), (0, half), (half, half)):
                if x0 + dx < sps.width and y0 + dy < sps.height:
                    self.coding_quadtree(x0 + dx, y0 + dy, log2_size - 1,
                                         depth + 1)
            return
        self.fs.depth[y0 >> 2:(y0 + size) >> 2,
                      x0 >> 2:(x0 + size) >> 2] = depth
        self.coding_unit(x0, y0, log2_size)

    # -- inter: candidate derivation (two reference lists; spec 8.5.3) ----

    NO_REF = -(1 << 30)

    def _mv_at(self, x: int, y: int):
        """Motion of the 4x4 block at (x, y): (flags[2], mv[2,2], pocs[2])
        or None if not z-coded inter."""
        if not self._coded(x, y):
            return None
        if self.fs.pred_mode[y >> 2, x >> 2] != INTER:
            return None
        fs = self.fs
        pocs = fs.ref_poc[y >> 2, x >> 2]
        flags = (pocs[0] > self.NO_REF, pocs[1] > self.NO_REF)
        return (flags, fs.mv[y >> 2, x >> 2].copy(),
                (int(pocs[0]), int(pocs[1])))

    @staticmethod
    def _same_motion(a, b) -> bool:
        return (a[0] == b[0] and np.array_equal(a[1], b[1])
                and a[2] == b[2])

    def _scale_mv(self, mv, cur_diff: int, ref_diff: int) -> np.ndarray:
        """MV scaling (spec 8.5.3.2.8): scale by tb/td POC distances."""
        tb = _clip8(cur_diff)
        td = _clip8(ref_diff)
        if td == tb or td == 0:
            return mv.astype(np.int32)
        tx = (16384 + (abs(td) >> 1)) // td
        dsf = min(max((tb * tx + 32) >> 6, -4096), 4095)
        prod = dsf * mv.astype(np.int64)
        out = np.sign(prod) * ((np.abs(prod) + 127) >> 8)
        return np.clip(out, -32768, 32767).astype(np.int32)

    def _col_mv(self, x: int, y: int, w: int, h: int, lx: int,
                ref_poc: int):
        """Temporal MV for list lx scaled to ref_poc (spec 8.5.3.2.8/9)."""
        col = self.col_pic
        if col is None:
            return None
        sps = self.sps
        cands = []
        cx, cy = x + w, y + h
        if cx < sps.width and cy < sps.height and \
                (cy >> sps.ctb_log2) == (y >> sps.ctb_log2):
            cands.append((cx, cy))
        cands.append((x + (w >> 1), y + (h >> 1)))
        for (px, py) in cands:
            pxx, pyy = (px >> 4) << 4, (py >> 4) << 4
            pocs = col["ref_poc"][pyy >> 2, pxx >> 2]
            f0, f1 = pocs[0] > self.NO_REF, pocs[1] > self.NO_REF
            if not f0 and not f1:
                continue
            # choose the collocated list (spec 8.5.3.2.9)
            if not f0:
                use = 1
            elif not f1:
                use = 0
            elif getattr(self, "no_backward", True):
                use = lx
            else:
                use = 1 if self.sh.collocated_from_l0 else 0
            mv = col["mv"][pyy >> 2, pxx >> 2, use]
            col_ref = int(pocs[use])
            return self._scale_mv(mv, self.poc - ref_poc,
                                  col["poc"] - col_ref)
        return None

    def merge_candidates(self, x0: int, y0: int, w: int, h: int,
                         max_cand: int, excl_a1: bool = False,
                         excl_b1: bool = False) -> list:
        """Merge candidates; each is (flags, mv[2,2], pocs)."""
        is_b = self.sh.slice_type == 0
        a1 = None if excl_a1 else self._mv_at(x0 - 1, y0 + h - 1)
        b1 = None if excl_b1 else self._mv_at(x0 + w - 1, y0 - 1)
        b0 = self._mv_at(x0 + w, y0 - 1)
        a0 = self._mv_at(x0 - 1, y0 + h)
        cands = []
        if a1 is not None:
            cands.append(a1)
        if b1 is not None and not (a1 is not None
                                   and self._same_motion(b1, a1)):
            cands.append(b1)
        if b0 is not None and not (b1 is not None
                                   and self._same_motion(b0, b1)):
            cands.append(b0)
        if a0 is not None and not (a1 is not None
                                   and self._same_motion(a0, a1)):
            cands.append(a0)
        if len(cands) < 4:
            b2 = self._mv_at(x0 - 1, y0 - 1)
            if b2 is not None and not any(
                    e is not None and self._same_motion(b2, e)
                    for e in (a1, b1)):
                cands.append(b2)
        if self.sh.temporal_mvp_enabled and len(cands) < max_cand:
            mv = np.zeros((2, 2), np.int32)
            pocs = [self.NO_REF, self.NO_REF]
            t0 = self._col_mv(x0, y0, w, h, 0, self.ref_list[0]["poc"])
            f0 = t0 is not None
            if f0:
                mv[0] = t0
                pocs[0] = self.ref_list[0]["poc"]
            f1 = False
            if is_b and self.ref_list1:
                t1 = self._col_mv(x0, y0, w, h, 1, self.ref_list1[0]["poc"])
                f1 = t1 is not None
                if f1:
                    mv[1] = t1
                    pocs[1] = self.ref_list1[0]["poc"]
            if f0 or f1:
                cands.append(((f0, f1), mv, (pocs[0], pocs[1])))
        # combined bi-predictive candidates (B slices, spec 8.5.3.2.4)
        if is_b and 1 < len(cands) < max_cand:
            order = ((0, 1), (1, 0), (0, 2), (2, 0), (1, 2), (2, 1),
                     (0, 3), (3, 0), (1, 3), (3, 1), (2, 3), (3, 2))
            n = len(cands)
            for (i0c, i1c) in order:
                if len(cands) >= max_cand:
                    break
                if i0c >= n or i1c >= n:
                    continue
                c0, c1 = cands[i0c], cands[i1c]
                if not (c0[0][0] and c1[0][1]):
                    continue
                if c0[2][0] == c1[2][1] and \
                        np.array_equal(c0[1][0], c1[1][1]):
                    continue
                mv = np.zeros((2, 2), np.int32)
                mv[0] = c0[1][0]
                mv[1] = c1[1][1]
                cands.append(((True, True), mv, (c0[2][0], c1[2][1])))
        zi = 0
        while len(cands) < max_cand:
            mv = np.zeros((2, 2), np.int32)
            p0 = self.ref_list[min(zi, len(self.ref_list) - 1)]["poc"]
            if is_b and self.ref_list1:
                p1 = self.ref_list1[min(zi, len(self.ref_list1) - 1)]["poc"]
                cands.append(((True, True), mv, (p0, p1)))
            else:
                cands.append(((True, False), mv, (p0, self.NO_REF)))
            zi += 1
        return cands[:max_cand]

    def amvp_candidates(self, x0: int, y0: int, w: int, h: int, lx: int,
                        ref_poc: int) -> list:
        """Two AMVP candidates for list lx (spec 8.5.3.2.6)."""
        a0 = self._mv_at(x0 - 1, y0 + h)
        a1 = self._mv_at(x0 - 1, y0 + h - 1)
        b0 = self._mv_at(x0 + w, y0 - 1)
        b1 = self._mv_at(x0 + w - 1, y0 - 1)
        b2 = self._mv_at(x0 - 1, y0 - 1)

        def pick_same(cand_list):
            for c in cand_list:
                if c is None:
                    continue
                for l in (lx, 1 - lx):
                    if c[0][l] and c[2][l] == ref_poc:
                        return c[1][l].astype(np.int32)
            return None

        def pick_scaled(cand_list):
            for c in cand_list:
                if c is None:
                    continue
                for l in (lx, 1 - lx):
                    if c[0][l]:
                        return self._scale_mv(c[1][l], self.poc - ref_poc,
                                              self.poc - c[2][l])
            return None

        a_avail = a0 is not None or a1 is not None
        mva = pick_same((a0, a1))
        if mva is None and a_avail:
            mva = pick_scaled((a0, a1))
        mvb = pick_same((b0, b1, b2))
        if not a_avail:
            # spec 8.5.3.2.7: promote the unscaled B candidate to the A
            # slot and re-derive B with scaling allowed
            mva = mvb
            mvb = pick_scaled((b0, b1, b2))
        cands = []
        if mva is not None:
            cands.append(mva)
        if mvb is not None and not (mva is not None
                                    and np.array_equal(mvb, mva)):
            cands.append(mvb)
        if len(cands) < 2 and self.sh.temporal_mvp_enabled:
            tm = self._col_mv(x0, y0, w, h, lx, ref_poc)
            if tm is not None:
                cands.append(tm)
        while len(cands) < 2:
            cands.append(np.zeros(2, np.int32))
        return cands[:2]

    def _ref_by_poc(self, poc: int, lx: int):
        lst = self.ref_list if lx == 0 else self.ref_list1
        for r in lst:
            if r["poc"] == poc:
                return r
        for r in self.ref_list + self.ref_list1:
            if r["poc"] == poc:
                return r
        raise ValueError(f"reference poc {poc} not found")

    def _inter_pred(self, x0: int, y0: int, w: int, h: int, motion) -> None:
        """Motion-compensated prediction written into the rec planes."""
        from ..ops.mc import bi_average, mc_chroma, mc_chroma_hi, \
            mc_luma, mc_luma_hi
        flags, mv, pocs = motion
        fs = self.fs
        bd = self.sps.bit_depth_luma
        cx, cy, cw, ch = x0 >> 1, y0 >> 1, w >> 1, h >> 1
        if flags[0] and flags[1]:
            r0 = self._ref_by_poc(pocs[0], 0)
            r1 = self._ref_by_poc(pocs[1], 1)
            fs.y[y0:y0 + h, x0:x0 + w] = bi_average(
                mc_luma_hi(r0["y"], x0, y0, w, h, int(mv[0, 0]),
                           int(mv[0, 1]), bd),
                mc_luma_hi(r1["y"], x0, y0, w, h, int(mv[1, 0]),
                           int(mv[1, 1]), bd), bd)
            for pl, key in ((fs.cb, "cb"), (fs.cr, "cr")):
                pl[cy:cy + ch, cx:cx + cw] = bi_average(
                    mc_chroma_hi(r0[key], cx, cy, cw, ch, int(mv[0, 0]),
                                 int(mv[0, 1]), bd),
                    mc_chroma_hi(r1[key], cx, cy, cw, ch, int(mv[1, 0]),
                                 int(mv[1, 1]), bd), bd)
        else:
            lx = 0 if flags[0] else 1
            r = self._ref_by_poc(pocs[lx], lx)
            fs.y[y0:y0 + h, x0:x0 + w] = mc_luma(
                r["y"], x0, y0, w, h, int(mv[lx, 0]), int(mv[lx, 1]), bd)
            for pl, key in ((fs.cb, "cb"), (fs.cr, "cr")):
                pl[cy:cy + ch, cx:cx + cw] = mc_chroma(
                    r[key], cx, cy, cw, ch, int(mv[lx, 0]),
                    int(mv[lx, 1]), bd)

    def _mark_inter(self, x0: int, y0: int, w: int, h: int, motion,
                    skip: bool) -> None:
        flags, mv, pocs = motion
        fs = self.fs
        sl = (slice(y0 >> 2, (y0 + h) >> 2),
              slice(x0 >> 2, (x0 + w) >> 2))
        fs.pred_mode[sl] = INTER
        fs.intra_mode[sl] = 1
        fs.mv[sl[0], sl[1]] = mv
        fs.ref_poc[sl[0], sl[1], 0] = pocs[0] if flags[0] else self.NO_REF
        fs.ref_poc[sl[0], sl[1], 1] = pocs[1] if flags[1] else self.NO_REF
        fs.skip[sl] = skip
        fs.coded[sl] = True
        fs.decoded[sl] = True
        if x0 > 0 and x0 % 8 == 0:
            fs.edges_ver[y0 >> 2:(y0 + h) >> 2, x0 >> 3] = True
        if y0 > 0 and y0 % 8 == 0:
            fs.edges_hor[y0 >> 3, x0 >> 2:(x0 + w) >> 2] = True

    def coding_unit(self, x0: int, y0: int, log2_size: int) -> None:
        self.cu_bypass = False
        if self.pps.transquant_bypass_enabled:
            self.cu_bypass = bool(self.cab.decode_bin(
                ContextSet.idx("cu_transquant_bypass_flag", 0)))
            if self.cu_bypass:
                size = 1 << log2_size
                self.fs.bypass4[y0 >> 2:(y0 + size) >> 2,
                                x0 >> 2:(x0 + size) >> 2] = True
        if not self.sh.is_intra:
            self._coding_unit_p(x0, y0, log2_size)
            return
        self._coding_unit_intra(x0, y0, log2_size)

    def _decode_mvd(self) -> np.ndarray:
        cab = self.cab
        crypto = cab.crypto_res
        if crypto is not None:
            from ..extras import crypto as _cr
        g0x = cab.decode_bin(ContextSet.idx("mvd", 0))
        g0y = cab.decode_bin(ContextSet.idx("mvd", 0))
        g1x = cab.decode_bin(ContextSet.idx("mvd", 1)) if g0x else 0
        g1y = cab.decode_bin(ContextSet.idx("mvd", 1)) if g0y else 0
        out = []
        for g0, g1 in ((g0x, g1x), (g0y, g1y)):
            if not g0:
                out.append(0)
                continue
            v = 1
            if g1:
                q = 0
                while cab.decode_bin_ep():
                    q += 1
                    if q > 30:
                        raise ValueError("mvd overflow")
                suffix = cab.decode_bins_ep(q + 1)
                if crypto is not None and \
                        crypto[1] & _cr.CRYPTO_MVS:
                    suffix = _cr.decrypt_ep_suffix(crypto[0], suffix,
                                                   q + 1)
                v = 2 + (((1 << q) - 1) << 1) + suffix
            sign = cab.decode_bin_ep()
            if crypto is not None and crypto[1] & _cr.CRYPTO_MV_SIGNS:
                sign = _cr.xor_bits(crypto[0], sign, 1)
            out.append(-v if sign else v)
        return np.array(out, dtype=np.int32)

    def _decode_merge_idx(self, max_merge: int) -> int:
        if max_merge <= 1:
            return 0
        if not self.cab.decode_bin(ContextSet.idx("merge_idx", 0)):
            return 0
        v = 1
        while v < max_merge - 1 and self.cab.decode_bin_ep():
            v += 1
        return v

    def _decode_ref_idx(self, n_refs: int) -> int:
        if n_refs <= 1:
            return 0
        cab = self.cab
        if not cab.decode_bin(ContextSet.idx("ref_idx", 0)):
            return 0
        v = 1
        if n_refs > 2 and cab.decode_bin(ContextSet.idx("ref_idx", 1)):
            v = 2
            while v < n_refs - 1 and cab.decode_bin_ep():
                v += 1
        return v

    def _parse_part_mode_inter(self, log2_size: int) -> str:
        cab = self.cab
        sps = self.sps
        if cab.decode_bin(ContextSet.idx("part_mode", 0)):
            return "2Nx2N"
        ver = cab.decode_bin(ContextSet.idx("part_mode", 1))
        at_min = log2_size == sps.log2_min_cb_size
        if sps.amp_enabled and not at_min:
            if cab.decode_bin(ContextSet.idx("part_mode", 3)):
                return "2NxN" if ver else "Nx2N"
            second = cab.decode_bin_ep()
            if ver:
                return "2NxnD" if second else "2NxnU"
            return "nRx2N" if second else "nLx2N"
        if at_min and log2_size > 3 and not ver:
            # '001' = Nx2N, '000' = NxN
            if not cab.decode_bin(ContextSet.idx("part_mode", 2)):
                return "NxN"
        return "2NxN" if ver else "Nx2N"

    @staticmethod
    def _pu_geometry(part: str, x0: int, y0: int, s: int) -> list:
        q = s >> 2
        h = s >> 1
        return {
            "2Nx2N": [(x0, y0, s, s)],
            "2NxN": [(x0, y0, s, h), (x0, y0 + h, s, h)],
            "Nx2N": [(x0, y0, h, s), (x0 + h, y0, h, s)],
            "NxN": [(x0, y0, h, h), (x0 + h, y0, h, h),
                    (x0, y0 + h, h, h), (x0 + h, y0 + h, h, h)],
            "2NxnU": [(x0, y0, s, q), (x0, y0 + q, s, s - q)],
            "2NxnD": [(x0, y0, s, s - q), (x0, y0 + s - q, s, q)],
            "nLx2N": [(x0, y0, q, s), (x0 + q, y0, s - q, s)],
            "nRx2N": [(x0, y0, s - q, s), (x0 + s - q, y0, q, s)],
        }[part]

    def _parse_pu(self, px: int, py: int, pw: int, ph: int,
                  excl_a1: bool, excl_b1: bool):
        """Parse one prediction unit; returns its motion."""
        cab = self.cab
        sh = self.sh
        is_b = sh.slice_type == 0
        small = (pw + ph) == 12
        max_merge = 5 - sh.five_minus_max_num_merge_cand
        merge = cab.decode_bin(ContextSet.idx("merge_flag", 0))
        if merge:
            midx = self._decode_merge_idx(max_merge)
            motion = self.merge_candidates(px, py, pw, ph, max_merge,
                                           excl_a1, excl_b1)[midx]
            if small and motion[0][0] and motion[0][1]:
                # 8x4/4x8 PUs cannot be bi-predicted (spec 8.5.3.2.2)
                motion = ((True, False), motion[1],
                          (motion[2][0], self.NO_REF))
            return motion, True
        depth = int(self.fs.depth[py >> 2, px >> 2])
        if is_b:
            if small:
                idc = 1 if cab.decode_bin(
                    ContextSet.idx("inter_pred_idc", 4)) else 0
            elif cab.decode_bin(ContextSet.idx("inter_pred_idc", depth)):
                idc = 2
            else:
                idc = 1 if cab.decode_bin(
                    ContextSet.idx("inter_pred_idc", 4)) else 0
        else:
            idc = 0
        flags = [idc != 1, idc != 0]
        mv = np.zeros((2, 2), np.int32)
        pocs = [self.NO_REF, self.NO_REF]
        for lx in (0, 1):
            if not flags[lx]:
                continue
            lst = self.ref_list if lx == 0 else self.ref_list1
            n_refs = (sh.num_ref_idx_l0_active_minus1 + 1 if lx == 0
                      else sh.num_ref_idx_l1_active_minus1 + 1)
            ridx = self._decode_ref_idx(n_refs)
            pocs[lx] = lst[ridx]["poc"]
            if lx == 1 and sh.mvd_l1_zero and idc == 2:
                mvd = np.zeros(2, np.int32)
            else:
                mvd = self._decode_mvd()
            if self.stats is not None:
                self.stats["mvd_abs"] = (self.stats.get("mvd_abs", 0)
                                         + int(np.abs(mvd).sum()))
            mvp_flag = cab.decode_bin(ContextSet.idx("mvp_flag", 0))
            mvp = self.amvp_candidates(px, py, pw, ph, lx,
                                       pocs[lx])[mvp_flag]
            mv[lx] = ((mvp.astype(np.int64) + mvd + 32768) % 65536
                      - 32768).astype(np.int32)
        return ((flags[0], flags[1]), mv, (pocs[0], pocs[1])), False

    def _coding_unit_p(self, x0: int, y0: int, log2_size: int) -> None:
        cab = self.cab
        sh = self.sh
        size = 1 << log2_size
        ctx_off = 0
        if self._coded(x0 - 1, y0) and self.fs.skip[y0 >> 2, (x0 - 1) >> 2]:
            ctx_off += 1
        if self._coded(x0, y0 - 1) and self.fs.skip[(y0 - 1) >> 2, x0 >> 2]:
            ctx_off += 1
        skip = cab.decode_bin(ContextSet.idx("cu_skip_flag", ctx_off))
        max_merge = 5 - sh.five_minus_max_num_merge_cand
        st = self.stats
        if st is not None:
            px_cu = size * size
            st["px"] = st.get("px", 0) + px_cu
            if skip:
                st["px_skip"] = st.get("px_skip", 0) + px_cu
        if skip:
            midx = self._decode_merge_idx(max_merge)
            motion = self.merge_candidates(x0, y0, size, size,
                                           max_merge)[midx]
            self._inter_pred(x0, y0, size, size, motion)
            self._mark_inter(x0, y0, size, size, motion, True)
            return
        if cab.decode_bin(ContextSet.idx("pred_mode_flag", 0)):
            if st is not None:
                st["px_intra"] = st.get("px_intra", 0) + size * size
            self._coding_unit_intra(x0, y0, log2_size)
            return
        part = self._parse_part_mode_inter(log2_size)
        if part == "NxN":
            raise NotImplementedError("inter NxN partitions")
        pus = self._pu_geometry(part, x0, y0, size)
        all_merge = True
        for i, (px, py, pw, ph) in enumerate(pus):
            excl_a1 = i == 1 and part in ("Nx2N", "nLx2N", "nRx2N")
            excl_b1 = i == 1 and part in ("2NxN", "2NxnU", "2NxnD")
            motion, was_merge = self._parse_pu(px, py, pw, ph,
                                               excl_a1, excl_b1)
            if st is not None:
                k = "pu_merge" if was_merge else "pu_amvp"
                st[k] = st.get(k, 0) + 1
            all_merge = all_merge and was_merge
            self._inter_pred(px, py, pw, ph, motion)
            self._mark_inter(px, py, pw, ph, motion, False)
        root_cbf = 1
        if not (part == "2Nx2N" and all_merge):
            root_cbf = cab.decode_bin(ContextSet.idx("rqt_root_cbf", 0))
        if root_cbf:
            self.transform_tree_inter(x0, y0, x0, y0, log2_size, 0, 0, 1, 1,
                                      inter_split=(part != "2Nx2N"))

    def transform_tree_inter(self, x0: int, y0: int, x_base: int,
                             y_base: int, log2_size: int, depth: int,
                             blk_idx: int, parent_cbf_cb: int,
                             parent_cbf_cr: int,
                             inter_split: bool = False) -> None:
        sps = self.sps
        cab = self.cab
        max_depth = sps.max_transform_hierarchy_depth_inter + \
            (1 if inter_split else 0)
        max_tb = sps.log2_min_tb_size + sps.log2_diff_max_min_tb_size
        forced = inter_split and depth == 0 and \
            sps.max_transform_hierarchy_depth_inter == 0
        if sps.log2_min_tb_size < log2_size <= max_tb \
                and depth < max_depth and not forced:
            split = cab.decode_bin(
                ContextSet.idx("split_transform_flag", 5 - log2_size))
        else:
            split = 1 if (log2_size > max_tb or forced) else 0
        cbf_cb, cbf_cr = parent_cbf_cb, parent_cbf_cr
        if log2_size > 2:
            if depth == 0 or parent_cbf_cb:
                cbf_cb = cab.decode_bin(ContextSet.idx("cbf_chroma", depth))
            else:
                cbf_cb = 0
            if depth == 0 or parent_cbf_cr:
                cbf_cr = cab.decode_bin(ContextSet.idx("cbf_chroma", depth))
            else:
                cbf_cr = 0
        if split:
            half = 1 << (log2_size - 1)
            for i, (dx, dy) in enumerate(((0, 0), (half, 0), (0, half),
                                          (half, half))):
                self.transform_tree_inter(x0 + dx, y0 + dy, x0, y0,
                                          log2_size - 1, depth + 1, i,
                                          cbf_cb, cbf_cr,
                                          inter_split=inter_split)
            return
        if depth == 0 and not cbf_cb and not cbf_cr:
            cbf_luma = 1  # inferred (rqt_root_cbf was 1)
        else:
            cbf_luma = cab.decode_bin(
                ContextSet.idx("cbf_luma", 1 if depth == 0 else 0))
        # TU boundaries are deblocking edges regardless of cbf
        fs = self.fs
        size = 1 << log2_size
        if x0 > 0 and x0 % 8 == 0:
            fs.edges_ver[y0 >> 2:(y0 + size) >> 2, x0 >> 3] = True
        if y0 > 0 and y0 % 8 == 0:
            fs.edges_hor[y0 >> 3, x0 >> 2:(x0 + size) >> 2] = True
        self._transform_unit_inter(x0, y0, x_base, y_base, log2_size,
                                   depth, blk_idx, cbf_luma, cbf_cb, cbf_cr)

    def _add_residual(self, x: int, y: int, log2_size: int, c_idx: int,
                      coeffs: np.ndarray, ts: bool = False) -> None:
        fs = self.fs
        plane = (fs.y, fs.cb, fs.cr)[c_idx]
        scale = 2 if c_idx else 1
        px, py = x // scale, y // scale
        size = 1 << log2_size
        qp = int(fs.qp_map[y >> 2, x >> 2])
        if c_idx:
            qp = chroma_qp(qp, self.pps.cb_qp_offset if c_idx == 1
                           else self.pps.cr_qp_offset)
        qp += 6 * (self.sps.bit_depth_luma - 8)   # QpBdOffset (8.6.3)
        if getattr(self, "cu_bypass", False):
            resi = coeffs                    # lossless: raw residual
        else:
            m = (fs.scaling.matrix(size, 3 + c_idx)
                 if fs.scaling is not None else None)
            deq = ops.dequantize(coeffs, qp, self.sps.bit_depth_luma,
                                 m=m)
            if ts:
                bd = self.sps.bit_depth_luma
                resi = (((deq.astype(np.int64) << 7)
                         + (1 << (19 - bd))) >> (20 - bd)) \
                    .astype(np.int32)
            else:
                resi = ops.inverse_transform(deq, False,
                                             self.sps.bit_depth_luma)
        max_val = (1 << self.sps.bit_depth_luma) - 1
        plane[py:py + size, px:px + size] = np.clip(
            plane[py:py + size, px:px + size] + resi, 0, max_val)
        if c_idx == 0:
            fs.nonzero[y >> 2:(y + size) >> 2,
                       x >> 2:(x + size) >> 2] = True

    def _transform_unit_inter(self, x0: int, y0: int, x_base: int,
                              y_base: int, log2_size: int, depth: int,
                              blk_idx: int, cbf_luma: int, cbf_cb: int,
                              cbf_cr: int) -> None:
        pps = self.pps
        byp = getattr(self, "cu_bypass", False)
        sdh = bool(pps.sign_data_hiding_enabled) and not byp
        tse = bool(pps.transform_skip_enabled) and not byp
        # cu_qp_delta condition (spec 7.3.8.10): a 4x4 TU uses the
        # PARENT's cbf_cb/cbf_cr for ALL four children (blkIdx 0-3), so
        # the chroma cbfs count even when chroma is coded after blkIdx 3
        # (ref encode_coding_tree.c:282)
        self._maybe_decode_qp_delta(bool(cbf_luma or cbf_cb or cbf_cr))
        if cbf_luma:
            coeffs, ts = decode_residual(self.cab, log2_size, 0, 0, sdh,
                                         tse)
            self._add_residual(x0, y0, log2_size, 0, coeffs, ts)
        if log2_size > 2:
            c_log2, cx, cy = log2_size - 1, x0, y0
        elif blk_idx == 3:
            c_log2, cx, cy = 2, x_base, y_base
        else:
            return
        for c_idx, cbf in ((1, cbf_cb), (2, cbf_cr)):
            if cbf:
                coeffs, ts = decode_residual(self.cab, c_log2, c_idx, 0,
                                             sdh, tse)
                self._add_residual(cx, cy, c_log2, c_idx, coeffs, ts)

    def _coding_unit_intra(self, x0: int, y0: int, log2_size: int) -> None:
        sps = self.sps
        pps = self.pps
        size = 1 << log2_size
        part_nxn = False
        if log2_size == sps.log2_min_cb_size:
            part_nxn = not self.cab.decode_bin(ContextSet.idx("part_mode", 0))
        n_pu = 4 if part_nxn else 1
        pu_size = size >> 1 if part_nxn else size
        # luma intra modes
        prev_flags = [self.cab.decode_bin(
            ContextSet.idx("prev_intra_luma_pred_flag", 0))
            for _ in range(n_pu)]
        modes = []
        offs = [(0, 0)] if not part_nxn else [(0, 0), (pu_size, 0),
                                              (0, pu_size),
                                              (pu_size, pu_size)]
        for i in range(n_pu):
            px, py = x0 + offs[i][0], y0 + offs[i][1]
            mpm = self.mpm_list(px, py)
            if prev_flags[i]:
                idx = 0
                if self.cab.decode_bin_ep():
                    idx = 1 + self.cab.decode_bin_ep()
                mode = mpm[idx]
            else:
                rem = self.cab.decode_bins_ep(5)
                for cand in sorted(mpm):
                    if rem >= cand:
                        rem += 1
                mode = rem
            # record the signalled mode before the next PU's MPM
            # derivation (with selective encryption the MPM chain runs
            # on the encrypted modes, ref encode_coding_tree.c:545-560)
            self.fs.intra_mode[py >> 2:(py + pu_size) >> 2,
                               px >> 2:(px + pu_size) >> 2] = mode
            self.fs.coded[py >> 2:(py + pu_size) >> 2,
                          px >> 2:(px + pu_size) >> 2] = True
            self.fs.pu_log2[py >> 2:(py + pu_size) >> 2,
                            px >> 2:(px + pu_size) >> 2] = \
                pu_size.bit_length() - 1
            crypto = self.cab.crypto_res
            if crypto is not None:
                from ..extras import crypto as _cr
                if crypto[1] & _cr.CRYPTO_INTRA_MODE:
                    mode = _cr.decrypt_intra_mode(crypto[0], mode)
            modes.append(mode)
        # chroma mode
        if self.cab.decode_bin(ContextSet.idx("intra_chroma_pred_mode", 0)):
            idx = self.cab.decode_bins_ep(2)
            cand = [0, 26, 10, 1]
            if modes[0] in cand:
                cand[cand.index(modes[0])] = 34
            chroma_mode = cand[idx]
        else:
            chroma_mode = modes[0]
        self.fs.pred_mode[y0 >> 2:(y0 + size) >> 2,
                          x0 >> 2:(x0 + size) >> 2] = INTRA
        self.transform_tree(x0, y0, x0, y0, log2_size, 0, 0,
                            modes, chroma_mode, part_nxn,
                            parent_cbf_cb=1, parent_cbf_cr=1)

    def transform_tree(self, x0: int, y0: int, x_base: int, y_base: int,
                       log2_size: int, depth: int, blk_idx: int,
                       modes: list[int], chroma_mode: int, intra_split: bool,
                       parent_cbf_cb: int, parent_cbf_cr: int) -> None:
        sps = self.sps
        cab = self.cab
        max_depth = sps.max_transform_hierarchy_depth_intra + \
            (1 if intra_split else 0)
        max_tb = sps.log2_min_tb_size + sps.log2_diff_max_min_tb_size
        if log2_size <= max_tb and log2_size > sps.log2_min_tb_size and \
                depth < max_depth and not (intra_split and depth == 0):
            split = cab.decode_bin(
                ContextSet.idx("split_transform_flag", 5 - log2_size))
        else:
            split = 1 if (log2_size > max_tb or
                          (intra_split and depth == 0)) else 0
        cbf_cb, cbf_cr = parent_cbf_cb, parent_cbf_cr
        if log2_size > 2:
            if depth == 0 or parent_cbf_cb:
                cbf_cb = cab.decode_bin(
                    ContextSet.idx("cbf_chroma", depth))
            else:
                cbf_cb = 0
            if depth == 0 or parent_cbf_cr:
                cbf_cr = cab.decode_bin(
                    ContextSet.idx("cbf_chroma", depth))
            else:
                cbf_cr = 0
        if split:
            half = 1 << (log2_size - 1)
            for i, (dx, dy) in enumerate(((0, 0), (half, 0), (0, half),
                                          (half, half))):
                self.transform_tree(x0 + dx, y0 + dy, x0, y0,
                                    log2_size - 1, depth + 1, i, modes,
                                    chroma_mode, intra_split, cbf_cb, cbf_cr)
            return
        # leaf: cbf_luma
        cbf_luma = cab.decode_bin(
            ContextSet.idx("cbf_luma", 1 if depth == 0 else 0))
        self.transform_unit(x0, y0, x_base, y_base, log2_size, depth,
                            blk_idx, modes, chroma_mode, intra_split,
                            cbf_luma, cbf_cb, cbf_cr)

    def _luma_mode_at(self, x: int, y: int, x_cu: int, y_cu: int,
                      modes: list[int], intra_split: bool,
                      cu_log2: int) -> int:
        if not intra_split:
            return modes[0]
        half = 1 << (cu_log2 - 1)
        idx = (1 if (x - x_cu) >= half else 0) + \
            (2 if (y - y_cu) >= half else 0)
        return modes[idx]

    def transform_unit(self, x0: int, y0: int, x_base: int, y_base: int,
                       log2_size: int, depth: int, blk_idx: int,
                       modes: list[int], chroma_mode: int, intra_split: bool,
                       cbf_luma: int, cbf_cb: int, cbf_cr: int) -> None:
        pps = self.pps
        # luma mode: for NxN CUs each 4x4 TU is one PU (blk_idx selects it)
        mode = modes[blk_idx] if (intra_split and depth > 0) else modes[0]
        # spec 7.3.8.10: 4x4 TUs use the parent's cbf_cb/cbf_cr in the
        # cu_qp_delta condition for all four children (blkIdx 0-3)
        self._maybe_decode_qp_delta(bool(cbf_luma or cbf_cb or cbf_cr))
        byp = getattr(self, "cu_bypass", False)
        coeffs = None
        ts = False
        if cbf_luma:
            scan = intra_mode_scan_idx(mode, log2_size, False)
            coeffs, ts = decode_residual(
                self.cab, log2_size, 0, scan,
                bool(pps.sign_data_hiding_enabled) and not byp,
                bool(pps.transform_skip_enabled) and not byp)
        self._intra_recon_tu(x0, y0, log2_size, 0, mode, coeffs, ts)
        # chroma (4:2:0): at log2==2, only after the 4th luma TU
        if log2_size > 2:
            c_log2 = log2_size - 1
            cx, cy = x0, y0
        elif blk_idx == 3:
            c_log2 = 2
            cx, cy = x_base, y_base
        else:
            return
        for c_idx, cbf in ((1, cbf_cb), (2, cbf_cr)):
            ccoef = None
            cts = False
            if cbf:
                scan = intra_mode_scan_idx(chroma_mode, c_log2, True)
                ccoef, cts = decode_residual(
                    self.cab, c_log2, c_idx, scan,
                    bool(pps.sign_data_hiding_enabled) and not byp,
                    bool(pps.transform_skip_enabled) and not byp)
            self._intra_recon_tu(cx, cy, c_log2, c_idx, chroma_mode,
                                 ccoef, cts)


class HEVCDecoder:
    """Annex-B stream decoder for the intra subset."""

    def __init__(self, crypto: str = "off",
                 crypto_key: bytes | None = None) -> None:
        self.sps: SPS | None = None
        self.pps_map: dict[int, PPS] = {}
        self.frames: list[DecodedFrame] = []
        self._pending_frame: DecodedFrame | None = None
        self.dpb: list[dict] = []
        self.prev_poc = 0
        # selective-encryption decryption (extras/crypto.py): a fresh
        # keystream per picture, shared by all its substreams/segments
        from ..extras.crypto import parse_crypto_spec
        self.crypto_features = parse_crypto_spec(crypto)
        self.crypto_key = crypto_key

    def decode(self, stream: bytes) -> list[DecodedFrame]:
        # a picture may span several slice-segment NALs (dependent slice
        # segments, spec 7.4.7.1 — kvazaar --slices tiles|wpp); buffer
        # segments until the picture is complete, then decode it whole
        pending: list[tuple[int, bytes]] = []

        def flush():
            if pending:
                self._decode_slice(pending)
                pending.clear()

        for nal_type, _tid, ebsp in split_annexb(stream):
            if nal_type < 32:
                if ebsp[0] >> 7:        # first_slice_segment_in_pic_flag
                    flush()
                pending.append((nal_type, ebsp))
                continue
            flush()
            rbsp = ebsp_to_rbsp(ebsp)
            if nal_type == NAL_VPS:
                continue
            if nal_type == NAL_SPS:
                self.sps = parse_sps(rbsp)
            elif nal_type == NAL_PPS:
                pps = parse_pps(rbsp)
                self.pps_map[pps.pps_id] = pps
            elif nal_type == NAL_PREFIX_SEI:
                continue
            elif nal_type == NAL_SUFFIX_SEI:
                self._check_hash(rbsp)
        flush()
        return self.frames

    def _decode_slice(self, segments) -> None:
        from ..bitstream import ebsp_to_rbsp_ex
        nal_type, ebsp = segments[0]
        rbsp, rbsp_pos = ebsp_to_rbsp_ex(ebsp)
        br = BitReader(rbsp)
        sh, pps = parse_slice_header(br, self.sps, self.pps_map, nal_type)
        sps = self.sps
        # picture order count (spec 8.3.1)
        if nal_type in (19, 20):
            poc = 0
            self.dpb.clear()
        else:
            max_lsb = 1 << sps.log2_max_poc_lsb
            lsb = sh.pic_order_cnt_lsb
            prev_lsb = self.prev_poc & (max_lsb - 1)
            prev_msb = self.prev_poc - prev_lsb
            if lsb < prev_lsb and prev_lsb - lsb >= max_lsb // 2:
                msb = prev_msb + max_lsb
            elif lsb > prev_lsb and lsb - prev_lsb > max_lsb // 2:
                msb = prev_msb - max_lsb
            else:
                msb = prev_msb
            poc = msb + lsb
        self.prev_poc = poc
        # reference lists (spec 8.3.4)
        ref_list: list = []
        ref_list1: list = []
        if not sh.is_intra:
            rps = (sh.short_term_rps if not sh.short_term_rps_sps_flag
                   else sps.short_term_rps[sh.short_term_rps_idx])
            before = [poc + d for d, u in zip(rps.delta_pocs_s0, rps.used_s0)
                      if u]
            after = [poc + d for d, u in zip(rps.delta_pocs_s1, rps.used_s1)
                     if u]
            # spec 8.3.2: the RPS defines exactly the pictures that stay
            # in the DPB; everything else becomes unused for reference
            rps_pocs = {poc + d for d in (list(rps.delta_pocs_s0)
                                          + list(rps.delta_pocs_s1))}
            self.dpb = [e for e in self.dpb if e["poc"] in rps_pocs]
            by_poc = {e["poc"]: e for e in self.dpb}
            l0 = [by_poc[p] for p in before + after]
            l1 = [by_poc[p] for p in after + before]
            if not l0:
                raise ValueError("no reference pictures in DPB")
            n0 = sh.num_ref_idx_l0_active_minus1 + 1
            ref_list = [l0[i % len(l0)] for i in range(n0)]
            if sh.slice_type == 0:
                n1 = sh.num_ref_idx_l1_active_minus1 + 1
                ref_list1 = [l1[i % len(l1)] for i in range(n1)]
        fs = _FrameState(self.sps, pps, sh)
        if getattr(self, "collect_stats", False):
            fs.stats = {"slice_type": sh.slice_type}
        if sps.scaling_list_enabled:
            from ..hevc.scaling import ScalingLists
            fs.scaling = (pps.scaling_lists or sps.scaling_lists
                          or ScalingLists())
        wpp = bool(pps.entropy_coding_sync_enabled)
        tiles = bool(pps.tiles_enabled)
        n_ctu_x = sps.width_in_ctbs
        n_ctu_y = sps.height_in_ctbs
        grid = None
        if tiles:
            from ..hevc.tiles import TileGrid
            grid = TileGrid.from_pps(pps, n_ctu_x, n_ctu_y)
            fs.tile_grid = grid
            fs.tile4 = grid.tile4_map(sps.ctb_size)
        init_type = 0 if sh.is_intra else (2 - sh.slice_type)
        def seg_substreams(sh_seg, rbsp_seg, pos_seg, br_seg, ebsp_seg):
            """Split one slice segment's payload at its entry points
            (EBSP offsets -> RBSP positions)."""
            if not (wpp or tiles):
                return [rbsp_seg[br_seg.byte_pos:]]
            start_e = pos_seg.index(br_seg.byte_pos)
            bounds_e = [start_e]
            for off in sh_seg.entry_point_offsets:
                bounds_e.append(bounds_e[-1] + off)
            bounds_r = [pos_seg[min(b, len(ebsp_seg))] for b in bounds_e]
            bounds_r.append(len(rbsp_seg))
            return [rbsp_seg[bounds_r[i]:bounds_r[i + 1]]
                    for i in range(len(bounds_r) - 1)]

        sub_data = seg_substreams(sh, rbsp, rbsp_pos, br, ebsp)
        for _nt2, ebsp2 in segments[1:]:
            # dependent slice segments: short header, payload continues
            # the same picture as the next substream(s)
            rbsp2, pos2 = ebsp_to_rbsp_ex(ebsp2)
            br2 = BitReader(rbsp2)
            sh2, _pps2 = parse_slice_header(br2, self.sps, self.pps_map,
                                            _nt2)
            if not sh2.dependent_slice_segment:
                raise ValueError(
                    "independent mid-picture slices not supported")
            sub_data += seg_substreams(sh2, rbsp2, pos2, br2, ebsp2)

        crypto_hdl = None
        if self.crypto_features:
            from ..extras.crypto import CryptoHandle
            crypto_hdl = CryptoHandle(self.crypto_key)

        def make_sd(cab: CabacDecoder, tile_id: int = 0) -> SliceDecoder:
            if crypto_hdl is not None:
                cab.crypto_res = (crypto_hdl, self.crypto_features)
            sd = SliceDecoder(fs, cab)
            sd.cur_tile = tile_id
            sd.poc = poc
            sd.ref_list = ref_list
            sd.ref_list1 = ref_list1
            sd.no_backward = all(r["poc"] <= poc
                                 for r in ref_list + ref_list1)
            if ref_list and sh.temporal_mvp_enabled:
                col_l = (ref_list if sh.collocated_from_l0 or not ref_list1
                         else ref_list1)
                sd.col_pic = col_l[min(sh.collocated_ref_idx,
                                       len(col_l) - 1)]
            else:
                sd.col_pic = None
            return sd

        if tiles:
            # one substream per tile, fresh contexts at each tile start;
            # the end_of_subset bin after a tile is skipped with the rest
            # of its substream
            last_xy = (grid.col_bd[-1] - 1, grid.row_bd[-1] - 1)
            cab = sd = None
            cur = -1
            for ctu_x, ctu_y, tid, last_in_tile in grid.scan():
                if tid != cur:
                    cur = tid
                    ctx = ContextSet(init_type, sh.qp)
                    cab = CabacDecoder(BitReader(sub_data[tid]), ctx)
                    sd = make_sd(cab, tid)
                sd.decode_ctu(ctu_x, ctu_y)
                last = (ctu_x, ctu_y) == last_xy and last_in_tile
                end = cab.decode_bin_trm()
                # with --slices tiles, every tile's last CTU legitimately
                # codes end_of_slice_segment_flag = 1
                if end and not last and not last_in_tile:
                    raise ValueError("unexpected end_of_slice")
        else:
            ctx = ContextSet(init_type, sh.qp)
            cab = CabacDecoder(BitReader(sub_data[0]), ctx)
            saved_ctx: ContextSet | None = None
            sd = make_sd(cab)
            for ctu_y in range(n_ctu_y):
                if wpp and ctu_y > 0:
                    ctx = (saved_ctx.copy() if saved_ctx is not None
                           else ContextSet(init_type, sh.qp))
                    cab = CabacDecoder(BitReader(sub_data[ctu_y]), ctx)
                    # WPP resets qPY_PREV to SliceQpY per CTB row
                    sd = make_sd(cab)
                for ctu_x in range(n_ctu_x):
                    sd.decode_ctu(ctu_x, ctu_y)
                    if wpp and ctu_x == 1:
                        saved_ctx = ctx.copy()
                    last = (ctu_y == n_ctu_y - 1 and ctu_x == n_ctu_x - 1)
                    end = cab.decode_bin_trm()
                    if wpp and ctu_x == n_ctu_x - 1 and not last:
                        break
                    if end and not last:
                        raise ValueError("unexpected end_of_slice")
        byp_pre = None
        if pps.transquant_bypass_enabled and fs.bypass4.any():
            byp_pre = (fs.y.copy(), fs.cb.copy(), fs.cr.copy())
        if not pps.deblocking_filter_disabled and not \
                sh.deblocking_filter_disabled:
            from ..ops.deblock import compute_bs, deblock_frame
            from ..tables import chroma_qp as _cqp
            boff = sh.beta_offset_div2 or pps.beta_offset_div2
            toff = sh.tc_offset_div2 or pps.tc_offset_div2
            if sh.is_intra:
                bs_ver = fs.edges_ver.astype(np.int8) * 2
                bs_hor = fs.edges_hor.astype(np.int8) * 2
            else:
                is_intra4 = fs.pred_mode == 1
                bs_ver = compute_bs(fs.edges_ver, True, is_intra4,
                                    fs.nonzero, fs.mv, fs.ref_poc,
                                    -(1 << 30))
                bs_hor = compute_bs(fs.edges_hor, False, is_intra4,
                                    fs.nonzero, fs.mv, fs.ref_poc,
                                    -(1 << 30))
            if tiles and not pps.loop_filter_across_tiles:
                ctb = sps.ctb_size
                for xb in grid.col_bd[1:-1]:
                    bs_ver[:, (xb * ctb) >> 3] = 0
                for yb in grid.row_bd[1:-1]:
                    bs_hor[(yb * ctb) >> 3, :] = 0
            deblock_frame(fs.y, fs.cb, fs.cr, bs_ver, bs_hor, sh.qp,
                          _cqp(sh.qp, pps.cb_qp_offset),
                          _cqp(sh.qp, pps.cr_qp_offset), boff, toff,
                          self.sps.bit_depth_luma,
                          qp4=(fs.qp_map if pps.cu_qp_delta_enabled
                               else None),
                          cb_qp_off=pps.cb_qp_offset,
                          cr_qp_off=pps.cr_qp_offset)
        if sh.sao_luma or sh.sao_chroma:
            from ..ops.sao import apply_sao_plane
            bd = self.sps.bit_depth_luma
            pw, ph = sps.width, sps.height

            if tiles and not pps.loop_filter_across_tiles:
                # per-tile application: edge-offset neighbours across the
                # tile boundary are unavailable, and apply_sao_plane
                # already leaves samples with out-of-plane neighbours
                # unmodified — so tile sub-planes give exact semantics
                def sao_apply(plane, params, ctb):
                    out = plane.copy()
                    for tid in range(grid.n_tiles):
                        tx, ty, tw, th = grid.rect(tid)
                        y0, x0 = ty * ctb, tx * ctb
                        y1 = min(y0 + th * ctb, plane.shape[0])
                        x1 = min(x0 + tw * ctb, plane.shape[1])
                        sub = {(cy - ty, cx - tx): v
                               for (cy, cx), v in params.items()
                               if ty <= cy < ty + th and tx <= cx < tx + tw}
                        out[y0:y1, x0:x1] = apply_sao_plane(
                            plane[y0:y1, x0:x1], sub, ctb, bd)
                    return out
            else:
                def sao_apply(plane, params, ctb):
                    return apply_sao_plane(plane, params, ctb, bd)

            if sh.sao_luma:
                fs.y[:ph, :pw] = sao_apply(fs.y[:ph, :pw], fs.sao[0],
                                           sps.ctb_size)
            if sh.sao_chroma:
                fs.cb[:ph // 2, :pw // 2] = sao_apply(
                    fs.cb[:ph // 2, :pw // 2], fs.sao[1], sps.ctb_size // 2)
                fs.cr[:ph // 2, :pw // 2] = sao_apply(
                    fs.cr[:ph // 2, :pw // 2], fs.sao[2], sps.ctb_size // 2)
        if byp_pre is not None:
            # lossless CUs are exempt from deblocking and SAO
            my = np.repeat(np.repeat(fs.bypass4, 4, 0), 4, 1)
            mc = my[::2, ::2]
            fs.y[my] = byp_pre[0][my]
            fs.cb[mc] = byp_pre[1][mc]
            fs.cr[mc] = byp_pre[2][mc]
        # crop to conformance window
        cl, cr_, ct, cb_ = self.sps.conf_win
        w, h = sps.width, sps.height
        y = fs.y[:h, :w]
        cbp = fs.cb[:h // 2, :w // 2]
        crp = fs.cr[:h // 2, :w // 2]
        full = [y.astype(np.uint16), cbp.astype(np.uint16),
                crp.astype(np.uint16)]
        if any(self.sps.conf_win):
            y = y[ct * 2:h - cb_ * 2, cl * 2:w - cr_ * 2]
            cbp = cbp[ct:h // 2 - cb_, cl:w // 2 - cr_]
            crp = crp[ct:h // 2 - cb_, cl:w // 2 - cr_]
        frame = DecodedFrame(poc=poc,
                             planes=[y.astype(np.uint16),
                                     cbp.astype(np.uint16),
                                     crp.astype(np.uint16)],
                             full_planes=full)
        frame.stats = getattr(fs, "stats", None)
        # the slice's QP and type, for the benchmark's check of the
        # configuration's QPs
        frame.slice_qp = sh.qp
        # the intra prediction units and their luma modes, whole picture
        frame.pu_log2 = fs.pu_log2
        frame.intra_mode = fs.intra_mode
        frame.slice_type = sh.slice_type
        self.frames.append(frame)
        self._pending_frame = frame
        # store the decoded picture + motion field in the DPB
        self.dpb.append({
            "poc": poc,
            "y": fs.y[:h, :w].copy(),
            "cb": fs.cb[:h // 2, :w // 2].copy(),
            "cr": fs.cr[:h // 2, :w // 2].copy(),
            "mv": fs.mv.copy(),
            "ref_poc": fs.ref_poc.copy(),
        })
        if len(self.dpb) > 8:
            self.dpb.pop(0)

    def _check_hash(self, rbsp: bytes) -> None:
        for ptype, payload in parse_sei_messages(rbsp):
            if ptype != SEI_DECODED_PICTURE_HASH or not self._pending_frame:
                continue
            hash_type, hashes = parse_hash_sei(payload)
            frame = self._pending_frame
            ok = True
            for plane, expect in zip(frame.full_planes, hashes):
                if hash_type == 2:
                    got = plane_checksum(plane, self.sps.bit_depth_luma).to_bytes(4, "big")
                elif hash_type == 0:
                    got = plane_md5(plane, self.sps.bit_depth_luma)
                else:
                    continue
                ok = ok and (got == expect)
            frame.hash_ok = ok
