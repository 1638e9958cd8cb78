"""Quadtree (CTB 64) all-intra pipeline in PyTorch: CU leaves 64 down to
NxN (four 4x4 PUs of an 8x8 CU).

Device port of kvazaar_tpu/models/intra_md.py for 8- and 10-bit frames
(Main and Main 10) with any intra PU depth range (--pu-depth-intra 0-4)
and the --rd ladder (0-3), optionally with deblocking, SAO, RDOQ and
sign-data hiding, transform skip, scaling lists, lossless coding
(transquant bypass) and a --fast-coeff-table rate model, at one QP a frame
or (delta_qp: VAQ, ROI, LCU rate control) one QP a CTB.
One frame runs three stages on the pipeline's device:

1. search: every aligned block of every allowed size evaluates all 35
   intra modes (one constant-matrix float32 product, exact because TF32
   is off, plus Hadamard SATD), then gets an RD leaf cost (exact integer
   T/Q/IT distortion + the learned coefficient-rate model) for its best
   mode; with --rd above 0, the rd + 1 best-SATD modes are RD-costed and
   the cheapest kept. 64 leaves take one mode for four 32x32 TUs; NxN
   cells four 4x4 modes with DST TUs and one 4x4 chroma TU;
2. partition DP: bottom-up quadtree merge 8 -> 16 -> 32 -> 64 minimising
   D + lambda * R, with the NxN-vs-2Nx2N choice at 8 and the depth range's
   forced or forbidden splits;
3. self-scheduled wavefront recon: each wave fires, per size class and
   class row, the leftmost TU whose reference samples (with z-order
   availability and mode-dependent needs) are reconstructed; a 64 leaf
   fires as four 32 TUs, an NxN cell as an 8 leaf that waits for every
   neighbour and codes its four 4x4 TUs in z order. Prediction reads the
   reconstructed planes directly; the fire step runs masked over every
   class row, so the only host sync is the periodic all-written exit
   test.

B pictures of one shape (submit_many: frame_batch's frames, a mesh
device's block of tiles) run stages 1-3 once for all of them, stacked one
above another in one tall frame whose picture edges the search and the
wavefront respect; each picture's waves, maps and tail are its own.

Under delta QP the constants qpmap_y, qpmap_c and lammap carry the QP and
lambda of each CTB: the search, the split DP and the reconstruction read
them per block (RDOQ's context-init prices stay at the slice QP), and the
final-QP chain (spec 8.6.1; qPY_PREV resets at each CTB row with wpp)
gives each CTB's QP for deblocking and the writer (`qp_ctb`).

Then deblocking, SAO, the decoded-picture checksum and the SSE. Results
are bit-exact to the reference's decisions (float32 costs aside, which the
tests hold to a tolerance) and to the spec for recon and levels.

The search quantises with the plain deadzone rule; the reconstruction
applies the configured tools (RDOQ, then the sign-hiding parity fix) and,
with transform skip, lets every 4x4 TU (NxN luma, 4x4 chroma) choose the
shifted residual over the transform on a lower RD cost (the `ts8` map).
Quantisation runs in the Qp' domain (QP + 6 * (bit depth - 8)).
RDOQ's float32 costs are formed as the reference's compiled CPU program
forms them: its summation orders (_xla_sum, _xla_cumsum) and its fused
multiply-adds (_fma), so the levels match on the CPU and on the card.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.intra_matrices import (build_filter_matrix, build_pred_matrices,
                                  ref_vec_len)
from ..ops.me import satd_tiles
from ..tables import (DCT_MATRICES, DST4, INV_QUANT_SCALES, QUANT_SCALES,
                      SCAN_DIAG, SCAN_HOR, SCAN_VER, SIG_CTX_MAP_4X4,
                      chroma_qp, get_scan, scan_order, scanpos_map)

I32 = torch.int32
F32 = torch.float32
F64 = torch.float64


def _morton(rows: int, cols: int) -> np.ndarray:
    """Coding-order key per 8x8 cell: CTB raster index, then Morton
    (z-order) within the CTB."""
    r = np.arange(rows, dtype=np.int64)[:, None]
    c = np.arange(cols, dtype=np.int64)[None, :]

    def spread(v):
        v = v & 0xFFFF
        v = (v | (v << 8)) & 0x00FF00FF
        v = (v | (v << 4)) & 0x0F0F0F0F
        v = (v | (v << 2)) & 0x33333333
        v = (v | (v << 1)) & 0x55555555
        return v

    ctbs_per_row = (cols + 7) // 8
    ctb_idx = (r >> 3) * ctbs_per_row + (c >> 3)
    inner = 2 * spread(r & 7) + spread(c & 7)
    return (ctb_idx * 64 + inner).astype(np.int32)


def _hash_mask(hh: int, ww: int, y0: int = 0, x0: int = 0) -> np.ndarray:
    """Decoded-picture-hash xor mask (spec D.3.20) of an hh x ww
    rectangle whose top-left sample sits at (y0, x0) of the picture (a
    tile's; the checksum is a plain sum, so the tiles' sums add up)."""
    yy, xx = np.mgrid[y0:y0 + hh, x0:x0 + ww]
    return ((xx & 255) ^ (yy & 255) ^ (xx >> 8) ^ (yy >> 8)).astype(np.uint32)


def consts_from_numpy(d: dict, device) -> dict:
    """Per-QP constants given as numpy arrays (for example the JAX
    pipeline's `consts`) -> tensors on `device`. uint32 arrays widen to
    int64 (torch has no general uint32 arithmetic)."""
    out = {}
    for k, v in d.items():
        a = np.array(v)
        if a.dtype == np.uint32:
            a = a.astype(np.int64)
        out[k] = torch.from_numpy(a).to(device)
    return out


def rep2(x: torch.Tensor, k: int) -> torch.Tensor:
    """Repeat each element k times along dims 0 and 1."""
    return x.repeat_interleave(k, 0).repeat_interleave(k, 1)


def sum4(c: torch.Tensor) -> torch.Tensor:
    """Sum each 2x2 group of a [2R, 2C] map -> [R, C]."""
    return c.reshape(c.shape[0] // 2, 2, c.shape[1] // 2, 2).sum(dim=(1, 3))


def _seq_sum(x) -> torch.Tensor:
    """Sum over the last dim, one term at a time in order (the reference's
    float32 order for up to 32 terms)."""
    acc = x[..., 0]
    for i in range(1, x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def _xla_sum(x) -> torch.Tensor:
    """Sum over the last dim (a multiple of 32 when longer than 32) in the
    order of the reference's compiled CPU reduction: runs of 32 in order,
    then their sums the same way."""
    n = x.shape[-1]
    if n <= 32:
        return _seq_sum(x)
    return _xla_sum(_seq_sum(x.reshape(*x.shape[:-1], n // 32, 32)))


def _seq_cumsum(x) -> torch.Tensor:
    """Inclusive prefix sum over the last dim, one term at a time."""
    acc = x[..., 0]
    outs = [acc]
    for i in range(1, x.shape[-1]):
        acc = acc + x[..., i]
        outs.append(acc)
    return torch.stack(outs, dim=-1)


def _xla_cumsum(x) -> torch.Tensor:
    """Inclusive prefix sum over the last dim (a multiple of 16 when longer
    than 16) in the order of the reference's compiled CPU cumsum: in order
    within runs of 16, plus the exclusive prefix of the run totals (the
    same way, recursively)."""
    n = x.shape[-1]
    if n <= 16:
        return _seq_cumsum(x)
    loc = _seq_cumsum(x.reshape(*x.shape[:-1], n // 16, 16))
    carry = _xla_cumsum(loc[..., -1])
    carry = F.pad(carry[..., :-1], (1, 0))
    return (loc + carry[..., None]).reshape(x.shape)


def _fma(a, b, c) -> torch.Tensor:
    """a + b * c in float32 with one rounding, as the reference's compiled
    program contracts a product and a sum into a fused multiply-add
    (float64 holds the product of two float32 values exactly)."""
    f64 = torch.float64
    a = a.to(f64) if isinstance(a, torch.Tensor) else a
    b = b.to(f64) if isinstance(b, torch.Tensor) else b
    c = c.to(f64) if isinstance(c, torch.Tensor) else c
    return (a + b * c).to(F32)


def rdoq_lambda(qp: int) -> float:
    """RDOQ's float32 lambda 1.5 * 0.57 * 2^((qp - 12) / 3) as the
    reference's compiled program computes it: the division by 3 becomes a
    product with float32(1/3), the power is taken in float64 and rounded,
    and the two constant factors fold into float32(0.855)."""
    e = np.float32(np.float32(qp) - np.float32(12.0)) * np.float32(1 / 3)
    return float(np.float32(1.5) * np.float32(0.57)
                 * np.float32(2.0 ** float(e)))


def rdoq_lambda_t(qp: torch.Tensor) -> torch.Tensor:
    """rdoq_lambda of each QP of an int tensor, float32, same shape."""
    e = (qp.to(F32) - 12.0) * float(np.float32(1 / 3))
    p = torch.pow(2.0, e.to(F64)).to(F32)
    return p * float(np.float32(1.5) * np.float32(0.57))


def ts_lambda(qp):
    """The transform-skip competition's float32 lambda 0.57 * 2^((qp - 12)
    / 3) of the luma QP, formed as rdoq_lambda forms its own (float32(1/3),
    the power in float64 rounded once); qp an int or an int tensor."""
    f = float(np.float32(0.57))
    if isinstance(qp, torch.Tensor):
        e = (qp.to(F32) - 12.0) * float(np.float32(1 / 3))
        return torch.pow(2.0, e.to(F64)).to(F32) * f
    e = np.float32(np.float32(qp) - np.float32(12.0)) * np.float32(1 / 3)
    return float(np.float32(f) * np.float32(2.0 ** float(e)))


# exponents k at which the reference's floor(log2(2^k)) is k - 1 (its
# compiled log2 is log(x) * float32(1 / ln 2), which lands below k there);
# the Golomb price of RDOQ keeps the reference's value
_LOG2_LOW = (13, 15)


class MdIntraPipeline:
    """Quadtree all-intra encoder compute path for one frame size."""

    SIZES = (8, 16, 32)
    CTB = 64
    # fractional-bit DP costs, layout of the consts vector `dpc`
    DPC_SPLIT0, DPC_SPLIT1 = 0, 1
    DPC_CBF_Y0, DPC_CBF_Y1 = 2, 3
    DPC_CBF_Y0_D1, DPC_CBF_Y1_D1 = 4, 5
    DPC_CBF_C0, DPC_CBF_C1 = 6, 7
    DPC_CBF_C0_D1, DPC_CBF_C1_D1 = 8, 9
    DPC_CHROMA_DM = 10
    DPC_PART_2NX2N, DPC_PART_NXN = 11, 12
    INIT_TYPE = 0
    # source-reference noise factor on leaf distortions: dist *= 1 + K/n
    REF_NOISE_K = 4.0
    # waves between host checks of the wavefront's all-written exit test
    WAVE_CHECK = 8

    def __init__(self, height: int, width: int, qp: int,
                 deblock: bool = False, deblock_beta: int = 0,
                 deblock_tc: int = 0, sao: str = "off",
                 sign_hiding: bool = False, rdoq: bool = False,
                 delta_qp: bool = False, wpp: bool = False,
                 scaling=None, lossless: bool = False,
                 bit_depth: int = 8,
                 pu_depth: tuple[int, int] = (1, 3),
                 rd: int = 0, fast_coeff_table: str = "",
                 trskip: bool = False, device="cuda") -> None:
        assert height % self.CTB == 0 and width % self.CTB == 0
        self.device = torch.device(device)
        self.bd = bit_depth
        self.maxv = (1 << bit_depth) - 1
        # --transform-skip: the RD competition of the shifted residual
        # against the DST/DCT on every 4x4 TU of the reconstruction
        self.trskip = bool(trskip) and not lossless
        # lossless (transquant bypass): the residual is coded as it is;
        # RDOQ and sign hiding have nothing to act on
        self.lossless = lossless
        if lossless:
            sign_hiding = rdoq = False
        # scaling lists: per-position quantiser scales and dequantiser
        # matrices of the intra lists (luma id 0, chroma id 1)
        self.scaling = scaling
        # the learned coefficient-rate weights, or --fast-coeff-table's
        # JSON {log2size: {qp: [8 floats]}}; a size without weights takes
        # the analytic rate estimate
        from ..engine.fast_cost_weights import FAST_COST_WEIGHTS
        self.fast_cost = dict(FAST_COST_WEIGHTS)
        if fast_coeff_table:
            import json
            with open(fast_coeff_table) as f:
                raw = json.load(f)
            self.fast_cost = {int(k): {int(q): [float(x) for x in w]
                                       for q, w in v.items()}
                              for k, v in raw.items()}
        self.h, self.w, self.qp = height, width, qp
        self.deblock = deblock
        self.deblock_beta = deblock_beta
        self.deblock_tc = deblock_tc
        if sao not in ("off", "full", "band", "edge"):
            raise ValueError(f"sao must be off, full, band or edge: {sao!r}")
        self.sao = None if sao == "off" else sao
        self.rdoq = rdoq
        self.sign_hiding = sign_hiding
        # delta_qp: per-CTB QP maps (VAQ, ROI, LCU rate control); wpp
        # changes only the final-QP chain (qPY_PREV resets each CTB row)
        self.delta_qp = delta_qp
        self.wpp = wpp
        # leaf sizes of the depth range (0 = 64, 1 = 32, 2 = 16, 3 = 8,
        # 4 = NxN, kvazaar's --pu-depth-intra scale); at least one remains.
        # A 64 leaf is one CU whose TU tree splits once into four 32 TUs;
        # an NxN CU is an 8x8 CU of four 4x4 PUs and four 4x4 DST TUs
        lo, hi = max(pu_depth[0], 0), min(pu_depth[1], 4)
        if lo > hi:
            lo = hi = min(max(pu_depth[0], 0), 4)
        self.allow = {64: lo <= 0, 32: lo <= 1 <= hi, 16: lo <= 2 <= hi,
                      8: hi >= 3, 4: hi >= 4}
        # lo == 4: every 8x8 CU is NxN
        self.force_nxn = lo >= 4
        if not any(self.allow.values()):
            self.allow[16] = True
        # --rd: modes a leaf RD-costs among its best SATDs
        self.rd_cands = max(1, min(int(rd), 3) + 1)
        self.r8, self.c8 = height // 8, width // 8
        # pictures stacked one above another in the planes (_stacked):
        # each one's top and bottom rows are picture edges
        self.n_pics = 1
        self._mode_needs_cache: dict = {}
        self._const_cache: dict = {}
        self.consts = self._consts_for(qp)
        self.set_consts(self.consts)

    # ------------------------------------------------------------------
    # per-QP constants (the encoder's only "parameters")
    # ------------------------------------------------------------------

    def _dpc_vec(self, qp: int) -> list[float]:
        from ..engine.bit_cost import intra_dp_costs
        c = intra_dp_costs(qp, self.INIT_TYPE)
        return [c["split0"], c["split1"], c["cbf_y0"], c["cbf_y1"],
                c["cbf_y0_d1"], c["cbf_y1_d1"], c["cbf_c0"], c["cbf_c1"],
                c["cbf_c0_d1"], c["cbf_c1_d1"], c["chroma_dm"],
                c["part_2nx2n"], c["part_nxn"]]

    def _fcw_matrix(self, qp: int) -> list[list[float]]:
        """Coefficient-rate weights at the nearest QP of the table, rows
        by log2(TU size) - 2; a zero row where the table has no weights
        for the size (the rate then takes the analytic estimate)."""
        rows = []
        for log2s in (2, 3, 4, 5):
            per_qp = self.fast_cost.get(log2s)
            if not per_qp:
                rows.append([0.0] * 8)
                continue
            nearest = min(per_qp, key=lambda q: abs(q - qp))
            rows.append([float(x) for x in per_qp[nearest]])
        return rows

    def const_arrays(self, qp: int) -> dict:
        """The per-QP constants as numpy arrays (same names, values and
        dtypes as the JAX pipeline's consts)."""
        from ..engine.bit_cost import mode_cost_vec
        d = {
            "g8l": build_pred_matrices(8).astype(np.int8),
            "g16l": build_pred_matrices(16).astype(np.int8),
            "g32l": build_pred_matrices(32).astype(np.int8),
            "f8": build_filter_matrix(8).astype(np.int8),
            "f16l": build_filter_matrix(16).astype(np.int8),
            "f32": build_filter_matrix(32).astype(np.int8),
            "g4c": build_pred_matrices(4, chroma=True).astype(np.int8),
            "g8cc": build_pred_matrices(8, chroma=True).astype(np.int8),
            "g16c": build_pred_matrices(16, chroma=True).astype(np.int8),
            # 4x4 luma (NxN PUs): no [1 2 1] smoothing at n = 4 (spec
            # 8.4.4.2.3), the DST-VII transform (spec 8.6.4)
            "g4l": build_pred_matrices(4).astype(np.int8),
            "f4": build_filter_matrix(4).astype(np.int8),
            "dst4": np.asarray(DST4, np.int32),
            "t4": np.asarray(DCT_MATRICES[4], np.int32),
            "t8": np.asarray(DCT_MATRICES[8], np.int32),
            "t16": np.asarray(DCT_MATRICES[16], np.int32),
            "t32": np.asarray(DCT_MATRICES[32], np.int32),
            "m8": _morton(self.r8, self.c8),
            "hash_mask_y": _hash_mask(self.h, self.w),
            "hash_mask_c": _hash_mask(self.h // 2, self.w // 2),
            "qp2": np.asarray([qp, chroma_qp(qp)], np.int32),
            "lam2": np.asarray([0.57 * 2.0 ** ((qp - 12) / 3.0)],
                               np.float32),
            "dpc": np.asarray(self._dpc_vec(qp), np.float32),
            "mode_cost": np.asarray(mode_cost_vec(qp, self.INIT_TYPE),
                                    np.float32),
            "fcw": np.asarray(self._fcw_matrix(qp), np.float32),
        }
        for n in (4, 8, 16, 32):
            d[f"spos{n}"] = np.asarray(scanpos_map(n), np.int32)
        # in-CG coefficient orders of the diagonal, horizontal and
        # vertical scans: sign hiding follows the mode-dependent scan of
        # 8x8 luma / 4x4 chroma intra TUs (spec 7.4.9.11)
        ords = np.zeros((3, 16), np.int32)
        invs = np.zeros((3, 16), np.int32)
        for si in (SCAN_DIAG, SCAN_HOR, SCAN_VER):
            o = np.asarray([y * 4 + x for x, y in scan_order(si, 2)],
                           np.int32)
            ords[si] = o
            invs[si][o] = np.arange(16)
        d["sdh_ord"], d["sdh_inv"] = ords, invs
        d.update(self._rdoq_consts(qp))
        if self.delta_qp:
            d.update(self.qp_map_arrays(np.full(
                (self.h // self.CTB, self.w // self.CTB), qp, np.int32)))
        if self.trskip:
            d["tsp"] = np.asarray(self._tsp_vec(qp), np.float32)
        if self.scaling is not None:
            # Cr's lists (id 2) apart from Cb's (id 1): a --cqmfile may
            # give them different matrices
            for n in (4, 8, 16, 32):
                for sfx, mid in (("", 0), ("c", 1), ("r", 2)):
                    if sfx and n == 32:
                        continue
                    d[f"qt{n}{sfx}"] = np.asarray(
                        self.scaling.quant_table(n, mid), np.int32)
                    d[f"dm{n}{sfx}"] = np.asarray(
                        self.scaling.matrix(n, mid), np.int32)
        return d

    def _tsp_vec(self, qp: int) -> list[float]:
        """transform_skip_flag fractional-bit prices at context init:
        [luma 0, luma 1, chroma 0, chroma 1]."""
        from ..engine.bit_cost import ctx_bits
        ly = ctx_bits("transform_skip_flag", self.INIT_TYPE, qp, 0)
        lc = ctx_bits("transform_skip_flag", self.INIT_TYPE, qp, 1)
        return [ly[0], ly[1], lc[0], lc[1]]

    def _mats_for(self, n: int, is_luma: bool, cr: bool = False):
        """(quantiser scales [6, n, n], dequantiser matrix [n, n]) of the
        scaling lists for a luma, Cb or (cr) Cr TU, or None without
        scaling lists."""
        if self.scaling is None:
            return None
        sfx = "" if is_luma else "r" if cr else "c"
        return self.c[f"qt{n}{sfx}"], self.c[f"dm{n}{sfx}"]

    @staticmethod
    def qp_map_arrays(qm) -> dict:
        """The delta-QP constants of a per-CTB QP map qm: luma and chroma
        QPs and the float32 lambda of each CTB."""
        qm = np.asarray(qm, np.int32)
        return {"qpmap_y": qm,
                "qpmap_c": np.vectorize(chroma_qp)(qm).astype(np.int32),
                "lammap": np.asarray(0.57 * 2.0 ** ((qm - 12) / 3.0),
                                     np.float32)}

    def _rdoq_consts(self, qp: int) -> dict:
        """Context-init fractional-bit prices of the batched RDOQ, at the
        pipeline's slice type."""
        from ..engine.bit_cost import rdoq_prices
        p = rdoq_prices(qp, self.INIT_TYPE)
        out = {"sigp": p["sig"], "csbfp": p["csbf"], "g1p": p["g1"],
               "g2p": p["g2"]}
        for log2s in (2, 3, 4, 5):
            out[f"lastp{log2s}"] = p["last"][(log2s, False)]
            if log2s <= 4:
                out[f"lastc{log2s}"] = p["last"][(log2s, True)]
        return out

    def _consts_for(self, qp: int | None) -> dict:
        qp = self.qp if qp is None else qp
        c = self._const_cache.get(qp)
        if c is None:
            c = self._const_cache[qp] = consts_from_numpy(
                self.const_arrays(qp), self.device)
        return c

    def set_consts(self, consts: dict) -> None:
        """Make `consts` the constants of the following device calls."""
        self.c = consts
        self.qp_y, self.qp_c = (int(v) for v in consts["qp2"].tolist())
        self.dpc = consts["dpc"]
        self.mode_cost = consts["mode_cost"]
        self.lam = consts["lam2"][0]
        self._tf64 = {n: consts[f"t{n}"].to(F64) for n in (4, 8, 16, 32)}
        self._tf64["dst4"] = consts["dst4"].to(F64)

    def _gf(self, n: int, is_luma: bool):
        """(pred matrices, filter matrix) for a luma/chroma size."""
        c = self.c
        if is_luma:
            return {4: (c["g4l"], c["f4"]), 8: (c["g8l"], c["f8"]),
                    16: (c["g16l"], c["f16l"]),
                    32: (c["g32l"], c["f32"])}[n]
        g = {4: c["g4c"], 8: c["g8cc"], 16: c["g16c"]}[n]
        return g, g

    # ------------------------------------------------------------------
    # helpers (size-parametric)
    # ------------------------------------------------------------------

    def _arange(self, n: int) -> torch.Tensor:
        return torch.arange(n, device=self.device)

    def _qtab(self, table) -> torch.Tensor:
        """A (de)quantiser scale table as an int32 tensor."""
        return torch.as_tensor(np.asarray(table, np.int32),
                               device=self.device)

    def _planar(self, refs: torch.Tensor, n: int) -> torch.Tensor:
        """Planar prediction from (already filtered) refs."""
        log2n = int(np.log2(n))
        left = refs[..., :n + 1]
        top = refs[..., 2 * n + 1:3 * n + 2]
        x = self._arange(n)
        y = self._arange(n)
        ln = left[..., n][..., None, None]
        tn = top[..., n][..., None, None]
        ly = left[..., :n][..., :, None]
        tx = top[..., :n][..., None, :]
        p = ((n - 1 - x)[None, None, :] * ly + (x + 1)[None, None, :] * tn
             + (n - 1 - y)[None, :, None] * tx + (y + 1)[None, :, None] * ln
             + n)
        return (p >> (log2n + 1)).reshape(*refs.shape[:-1], n * n).to(I32)

    def _filt_refs(self, refs: torch.Tensor, f: torch.Tensor):
        """[1 2 1]-filtered refs, exact in float32: (refs @ F + 2) >> 2."""
        prod = refs.to(F32) @ f.t().to(F32)
        return torch.floor((prod + 2.0) / 4.0).to(I32)

    def _dc_pred(self, refs: torch.Tensor, n: int, is_luma: bool):
        """DC prediction [B, n*n] (with the luma edge filter for n < 32)."""
        left = refs[:, :n]
        top = refs[:, 2 * n + 1:3 * n + 1]
        log2n = int(np.log2(n))
        dc = (left.sum(1) + top.sum(1) + n) >> (log2n + 1)
        pred = dc[:, None, None].expand(refs.shape[0], n, n)
        if is_luma and n < 32:
            row0 = (top + 3 * dc[:, None] + 2) >> 2
            col0 = (left + 3 * dc[:, None] + 2) >> 2
            tl = (left[:, 0] + 2 * dc + top[:, 0] + 2) >> 2
            ii = self._arange(n)
            is_r0 = (ii == 0)[None, :, None]
            is_c0 = (ii == 0)[None, None, :]
            pred = torch.where(is_r0, row0[:, None, :], pred)
            pred = torch.where(is_c0 & ~is_r0, col0[:, :, None], pred)
            pred = torch.where(is_r0 & is_c0, tl[:, None, None], pred)
        return pred.reshape(refs.shape[0], n * n).to(I32)

    def _fix_1026(self, preds, refs, n: int):
        """Post-filter for pure horizontal/vertical luma modes (n < 32) of
        the search's predictions. It clips at 255 whatever the bit depth,
        as the reference's search does (kvazaar_tpu/models/
        intra_pipeline.py:241; ROADMAP.md queue 3); the reconstruction's
        _pred_one clips at the bit depth's maximum."""
        left = refs[:, :n]
        top = refs[:, 2 * n + 1:3 * n + 1]
        corner = refs[:, 2 * n]
        p = preds.reshape(-1, 35, n, n).clone()
        p[:, 26, :, 0] = (top[:, :1] + ((left - corner[:, None]) >> 1)) \
            .clamp(0, 255).to(p.dtype)
        p[:, 10, 0, :] = (left[:, :1] + ((top - corner[:, None]) >> 1)) \
            .clamp(0, 255).to(p.dtype)
        return p.reshape(-1, 35, n * n)

    def _preds_full(self, refs, g, f, n: int, is_luma: bool):
        """All-35-mode predictions [B, 35, n*n] with all special cases."""
        filt = self._filt_refs(refs, f) if is_luma else refs
        both = torch.cat([refs, filt], dim=1).to(F32)
        gm = g.reshape(-1, g.shape[-1]).to(F32)
        preds = torch.floor((both @ gm.t() + 16.0) / 32.0).to(I32) \
            .reshape(-1, 35, n * n)
        if n < 32 and is_luma:
            preds = self._fix_1026(preds, refs, n)
        preds[:, 1, :] = self._dc_pred(refs, n, is_luma)
        if is_luma and n == 32:
            preds[:, 0, :] = self._planar(filt, n)
        return preds

    def _pred_one(self, refs, modes, g, f, n: int, is_luma: bool):
        """Per-block single-mode prediction [L, n*n] (recon path)."""
        filt = self._filt_refs(refs, f) if is_luma else refs
        both = torch.cat([refs, filt], dim=1).to(F32)
        gsel = g[modes.long()].to(F32)
        pred = torch.floor((torch.bmm(gsel, both[:, :, None])[:, :, 0]
                            + 16.0) / 32.0).to(I32)
        pred = torch.where((modes == 1)[:, None],
                           self._dc_pred(refs, n, is_luma), pred)
        if is_luma and n == 32:
            pred = torch.where((modes == 0)[:, None], self._planar(filt, n),
                               pred)
        if is_luma and n < 32:
            left = refs[:, :n]
            top = refs[:, 2 * n + 1:3 * n + 1]
            corner = refs[:, 2 * n]
            p = pred.reshape(-1, n, n)
            col = (top[:, :1] + ((left - corner[:, None]) >> 1)) \
                .clamp(0, self.maxv)
            row = (left[:, :1] + ((top - corner[:, None]) >> 1)) \
                .clamp(0, self.maxv)
            ii = self._arange(n)
            m26 = (modes == 26)[:, None, None] & (ii == 0)[None, None, :]
            m10 = (modes == 10)[:, None, None] & (ii == 0)[None, :, None]
            p = torch.where(m26, col[:, :, None].to(I32), p)
            p = torch.where(m10, row[:, None, :].to(I32), p)
            pred = p.reshape(-1, n * n)
        return pred

    def _src_refs(self, src, n: int):
        """Clamped source refs for every aligned n-block [B, rlen], each
        clamped to its own picture's rows."""
        h, w = src.shape
        rows, cols = h // n, w // n
        bid = self._arange(rows * cols)
        y0 = (bid // cols) * n
        x0 = (bid % cols) * n
        ph = h // self.n_pics
        top_y = y0 // ph * ph
        ar = self._arange(2 * n)
        iy = torch.minimum(y0[:, None] + ar[None, :], top_y[:, None] + ph - 1)
        ix = (x0[:, None] - 1).clamp(0, w - 1)
        left = src[iy, ix.expand_as(iy)]
        ty = torch.maximum(y0 - 1, top_y)[:, None]
        tx = (x0[:, None] + ar[None, :]).clamp(0, w - 1)
        top = src[ty.expand_as(tx), tx]
        corner = src[ty[:, 0], (x0 - 1).clamp(0, w - 1)]
        pad = torch.zeros((rows * cols, 1), dtype=src.dtype,
                          device=self.device)
        return torch.cat([left, corner[:, None], top, pad], dim=1)

    @staticmethod
    def _blocks(plane, n: int):
        rows, cols = plane.shape[0] // n, plane.shape[1] // n
        return plane.reshape(rows, n, cols, n).permute(0, 2, 1, 3) \
            .reshape(rows * cols, n, n)

    def _tu_features(self, levels, n: int):
        """Batched rate features per TU [L, n, n] -> 7 x [L] float32."""
        al = levels.abs().to(F32)
        nz = al > 0
        f1 = nz.to(F32).sum(dim=(-1, -2))
        f2 = (al >= 2.0).to(F32).sum(dim=(-1, -2))
        f3 = al.clamp(max=3.0).sum(dim=(-1, -2))
        f4 = torch.log2((al - 2.0).clamp(min=1.0)).sum(dim=(-1, -2))
        spos = self.c[f"spos{n}"].to(F32)
        f5 = torch.where(nz, spos, -1.0).amax(dim=(-1, -2)) + 1.0
        g = n // 4
        L = levels.shape[0]
        cgnz = nz.reshape(L, g, 4, g, 4).any(dim=4).any(dim=2)
        f6 = cgnz.to(F32).sum(dim=(-1, -2))
        ii = self._arange(n).to(F32)
        lastx = torch.where(nz.any(dim=-2), ii, -1.0).amax(dim=-1)
        lasty = torch.where(nz.any(dim=-1), ii, -1.0).amax(dim=-1)
        f7 = torch.floor(torch.log2(lastx + 2.0)) + \
            torch.floor(torch.log2(lasty + 2.0))
        return f1, f2, f3, f4, f5, f6, f7

    @staticmethod
    def _rate_bins(levels):
        """Context-free CABAC-bin rate estimate per TU [L, n, n] -> [L]
        (the model of the RDOQ level rates)."""
        al = levels.abs().to(F32)
        r3 = 5.0 + 2.0 * torch.floor(torch.log2((al - 1.0).clamp(min=1.0)))
        r = torch.where(al == 0, 0.0, torch.where(
            al == 1, 3.0, torch.where(al == 2, 4.0, r3)))
        return r.sum(dim=(-1, -2))

    def _rate_tu(self, levels, n: int):
        """Coefficient rate of a coded TU (excl. cbf): the learned fast
        coefficient-cost model, or, for a size the table has no weights
        for, an analytic estimate (level bins, last position, in-span
        significance flags and coded sub-blocks)."""
        f1, f2, f3, f4, f5, f6, f7 = self._tu_features(levels, n)
        log2s = n.bit_length() - 1
        if not self.fast_cost.get(log2s):
            r = self._rate_bins(levels) + 0.6 * (f5 - f1) + f6 + f7 + 2.0
            return r * (f1 > 0)
        w = self.c["fcw"][log2s - 2]
        r = (w[0] + w[1] * f1 + w[2] * f2 + w[3] * f3 + w[4] * f4
             + w[5] * f5 + w[6] * f6 + w[7] * f7)
        return r.clamp(min=1.0) * (f1 > 0)

    def _tu_rate_y(self, levels, n: int, depth1: bool = False):
        """Luma TU rate incl. the cbf_luma flag (fractional bits)."""
        cbf = (levels != 0).any(dim=-1).any(dim=-1)
        i0 = self.DPC_CBF_Y0_D1 if depth1 else self.DPC_CBF_Y0
        i1 = self.DPC_CBF_Y1_D1 if depth1 else self.DPC_CBF_Y1
        return torch.where(cbf, self.dpc[i1] + self._rate_tu(levels, n),
                           self.dpc[i0])

    def _tu_rate_c(self, levels, n: int, depth1: bool = False):
        """Chroma TU rate incl. the cbf_cb/cr flag (fractional bits)."""
        cbf = (levels != 0).any(dim=-1).any(dim=-1)
        i0 = self.DPC_CBF_C0_D1 if depth1 else self.DPC_CBF_C0
        i1 = self.DPC_CBF_C1_D1 if depth1 else self.DPC_CBF_C1
        return torch.where(cbf, self.dpc[i1] + self._rate_tu(levels, n),
                           self.dpc[i0])

    def _transform_quant(self, resi, n: int, qp, *, is_luma: bool,
                         tools: bool, scan_sel=None, dst: bool = False,
                         cr: bool = False):
        """Forward transform + quant + dequant + inverse, exact integer
        arithmetic (the products run in float64, exact far beyond these
        magnitudes; CUDA has no int32 matmul). resi [L, n, n] ->
        (levels, recon_resi) int32. qp: an int, or an int32 tensor [L]
        of one QP a TU (delta QP), before the bit depth's QpBdOffset.
        tools: quantise with the configured RDOQ / sign hiding (the
        reconstruction) instead of the plain deadzone rule (the search);
        scan_sel [L]: per-TU scan index that sign hiding follows
        (mode-dependent scans), None for diagonal; dst: the 4x4 DST-VII
        of intra luma instead of the DCT; cr: a Cr TU (its own scaling
        list). Lossless: the residual is its own levels and
        reconstruction."""
        if self.lossless:
            return resi.to(I32), resi.to(I32)
        log2n = int(np.log2(n))
        bd = self.bd
        t = self._tf64["dst4" if dst else n]
        shift1 = log2n + bd - 9
        shift2 = log2n + 6
        tmp = (t @ resi.to(F64).transpose(1, 2)).to(I32)
        tmp = (tmp + (1 << (shift1 - 1))) >> shift1
        co = (t @ tmp.to(F64).transpose(1, 2)).to(I32)
        co = (co + (1 << (shift2 - 1))) >> shift2
        levels, deq = self._quant_dequant(co, n, qp, is_luma=is_luma,
                                          tools=tools, scan_sel=scan_sel,
                                          cr=cr)
        ishift2 = 20 - bd
        tmp2 = (t.t() @ deq.to(F64)).to(I32)
        tmp2 = ((tmp2 + 64) >> 7).clamp(-32768, 32767)
        r2 = (tmp2.to(F64) @ t).to(I32)
        r2 = ((r2 + (1 << (ishift2 - 1))) >> ishift2).clamp(-32768, 32767)
        return levels, r2

    def _transform_quant_skip(self, resi, qp, *, is_luma: bool,
                              tools: bool, scan_sel=None, cr: bool = False):
        """transform_skip T/Q/IT of 4x4 TUs (kvazaar transform.c:163-196):
        the residual shifted into the coefficient range instead of the
        transform, the quantiser and dequantiser as in _transform_quant
        (RDOQ and sign hiding included), then the shift back. Returns
        (levels, recon_resi) int32 [L, 4, 4]."""
        tshift = 15 - self.bd - 2
        co = resi.to(I32) << tshift
        levels, deq = self._quant_dequant(co, 4, qp, is_luma=is_luma,
                                          tools=tools, scan_sel=scan_sel,
                                          cr=cr)
        r2 = (deq + (1 << (tshift - 1))) >> tshift
        return levels, r2.clamp(-32768, 32767)

    def _quant_dequant(self, co, n: int, qp, *, is_luma: bool, tools: bool,
                       scan_sel=None, cr: bool = False):
        """Quantise the coefficients co [L, n, n] int32 in the Qp' domain
        (qp + QpBdOffset, spec 8.6.3), with the scaling lists' scale per
        position when on, then dequantise; the dequantised coefficients are
        clipped to 16 bits. Returns (levels, dequantised) int32."""
        log2n = int(np.log2(n))
        bd = self.bd
        mats = self._mats_for(n, is_luma, cr)
        tshift = 15 - bd - log2n
        if isinstance(qp, torch.Tensor):
            # one QP a TU: int32 [L, 1, 1] factors, as the reference's
            qb = qp.to(I32)[:, None, None] + 6 * (bd - 8)
            qbits = 14 + qb // 6 + tshift
            ils = self._qtab(INV_QUANT_SCALES)[qb % 6]
            one = torch.ones_like(qbits)
            scale = (self._qtab(QUANT_SCALES)[qb % 6] if mats is None
                     else mats[0][qb[:, 0, 0].long() % 6])
        else:
            qb = qp + 6 * (bd - 8)
            qbits = 14 + qb // 6 + tshift
            ils = int(INV_QUANT_SCALES[qb % 6])
            one = 1
            scale = (int(QUANT_SCALES[qb % 6]) if mats is None
                     else mats[0][qb % 6])
        if tools and self.rdoq:
            levels = self._rdoq_levels(co, scale, qbits, qb, log2n, is_luma)
        else:
            offset = 171 << (qbits - 9)
            absq = (co.abs() * scale + offset) >> qbits
            levels = (torch.sign(co) * absq).to(I32)
        if tools and self.sign_hiding:
            err = co.abs() * scale - (levels.abs() << qbits)
            levels = self._sdh_fix(levels, n, err, one << qbits, scan_sel)
        if mats is None:
            dshift = bd + log2n - 9
            deq = (levels * (ils << (qb // 6)) + (1 << (dshift - 1))) \
                >> dshift
        else:
            # spec 8.6.3 with m: (level * m * ls << qp/6 + rnd) >> bdShift,
            # the left shift folded into the right one (exact), and the
            # product clipped where the fold turns into a left shift (the
            # final clip absorbs it): int32 as the reference's, and
            # |level * m * ls| <= 2^15 * 255 * 72 < 2^31
            x = levels * mats[1] * ils
            s_fold = bd + log2n - 5 - qb // 6
            if isinstance(s_fold, torch.Tensor):
                pos = s_fold.clamp(min=0)
                bias = torch.where(pos > 0, 1 << (pos - 1).clamp(min=0), 0)
                deq = torch.where(s_fold > 0, (x + bias) >> pos,
                                  x.clamp(-40000, 40000)
                                  << (-s_fold).clamp(min=0))
            elif s_fold > 0:
                deq = (x + (1 << (s_fold - 1))) >> s_fold
            else:
                deq = x.clamp(-40000, 40000) << -s_fold
        return levels, deq.clamp(-32768, 32767).to(I32)

    def _tq_4x4_rd(self, resi, qp, lam, *, is_luma: bool, scan_sel=None,
                   dst: bool = False, cr: bool = False):
        """4x4 T/Q/IT of the reconstruction with the transform-skip RD
        competition (kvazaar search_intra.c:94-152, made exact: both
        paths quantised and priced): skip wins on a strictly lower D +
        lam * (R + transform_skip_flag price), never on a TU whose skip
        levels are all zero (no flag is coded there). lam: float32, a
        scalar or [L]. Returns (levels, recon_resi, use_skip [L] bool)."""
        levels, r2 = self._transform_quant(resi, 4, qp, is_luma=is_luma,
                                           tools=True, scan_sel=scan_sel,
                                           dst=dst, cr=cr)
        lv_s, r2_s = self._transform_quant_skip(resi, qp, is_luma=is_luma,
                                                tools=True,
                                                scan_sel=scan_sel, cr=cr)
        d_t = self._sqsum(resi - r2)
        d_s = self._sqsum(resi - r2_s)
        tsp = self.c["tsp"]
        p0, p1 = (tsp[0], tsp[1]) if is_luma else (tsp[2], tsp[3])
        c_t = d_t + lam * (self._rate_tu(levels, 4) + p0)
        c_s = d_s + lam * (self._rate_tu(lv_s, 4) + p1)
        use = (c_s < c_t) & (lv_s != 0).any(dim=-1).any(dim=-1)
        u3 = use[:, None, None]
        return torch.where(u3, lv_s, levels), torch.where(u3, r2_s, r2), use

    # ------------------------------------------------------------------
    # quantisation tools: RDOQ and the sign-hiding parity fix
    # ------------------------------------------------------------------

    _SCAN_CACHE: dict = {}

    def _scan_perm(self, log2n: int):
        """(perm, inv_perm) of the diagonal scan as index tensors: perm[p]
        = flat (y*n+x) index of scan position p."""
        key = (log2n, self.device)
        if key not in self._SCAN_CACHE:
            n = 1 << log2n
            scan = get_scan(SCAN_DIAG, log2n)
            perm = (scan[:, 1] * n + scan[:, 0]).astype(np.int64)
            invp = np.empty(n * n, np.int64)
            invp[perm] = np.arange(n * n)
            self._SCAN_CACHE[key] = (torch.from_numpy(perm).to(self.device),
                                     torch.from_numpy(invp).to(self.device))
        return self._SCAN_CACHE[key]

    def _golomb_log2(self, rem):
        """floor(log2(rem)) of integer-valued float32 rem >= 1, with the
        reference's value at the powers of two of _LOG2_LOW."""
        exp = torch.frexp(rem)[1] - 1
        low = torch.zeros_like(rem, dtype=torch.bool)
        for k in _LOG2_LOW:
            low = low | (rem == float(1 << k))
        return (exp - low.to(exp.dtype)).to(F32)

    def _rdoq_levels(self, co, scale, qbits, qp, log2n: int,
                     is_luma: bool = True):
        """Batched RDOQ (kvazaar_tpu MdIntraPipeline._rdoq_levels):

        1. per coefficient, the level among {0, l-1, l} priced with
           sig_coeff_flag / greater1 / greater2 / Golomb fractional bits at
           context init, significance contexts from a provisional
           coded-sub-block map;
        2. the last-significant-position walk over the diagonal scan:
           every candidate last position priced with its last_sig_x/y bits,
           in-span costs before it and pure distortion after it, and the
           all-zero option;
        3. the coded-sub-block zeroing pass.
        co [L, n, n] int32 -> levels [L, n, n] int32. qp is the Qp'
        (QpBdOffset included) that the lambda follows; scale, qbits and
        qp are ints, or (one QP a TU) int32 tensors [L, 1, 1]: the lambda
        then follows each TU's QP, the context-init prices stay the
        slice's. With scaling lists scale is per position ([n, n], or
        [L, n, n])."""
        n = 1 << log2n
        L = co.shape[0]
        c = self.c
        absco = co.abs()
        four = np.float32(4.0 ** (15 - self.bd - log2n))
        if isinstance(qp, torch.Tensor):
            lf = (absco * scale + (torch.ones_like(qbits) << (qbits - 1))) \
                >> qbits
            lamb = rdoq_lambda_t(qp)
            lamb2 = lamb.reshape(L, 1)
        else:
            lf = (absco * scale + (1 << (qbits - 1))) >> qbits
            lamb = lamb2 = rdoq_lambda(qp)
        # pixel-SSE currency: scaled-domain err^2 / (scale^2 * 4^shift)
        if isinstance(scale, torch.Tensor):
            sf = scale.to(F32)
            inv = 1.0 / (sf * sf * float(four))
        else:
            sf = np.float32(scale)
            inv = float(np.float32(1.0) / (sf * sf * four))

        def ee(lv):
            """Squared scaled-domain error of level(s) lv, float32."""
            e = (absco * scale - (lv << qbits)).to(F32)
            return e * e

        xx = self._arange(n)[None, :]
        yy = self._arange(n)[:, None]
        # --- significance-flag prices per position -------------------
        if log2n == 2:
            sigc = torch.as_tensor(SIG_CTX_MAP_4X4, device=self.device) \
                .reshape(4, 4).long()
            if not is_luma:
                sigc = sigc + 27
        else:
            g = n // 4
            cgf = (lf != 0).reshape(L, g, 4, g, 4).any(dim=4).any(dim=2)
            right = F.pad(cgf[:, :, 1:], (0, 1))
            below = F.pad(cgf[:, 1:, :], (0, 0, 0, 1))
            prev = (right.long() + 2 * below.long()) \
                .repeat_interleave(4, 1).repeat_interleave(4, 2)  # [L,n,n]
            xp, yp = xx & 3, yy & 3
            s0 = torch.where(xp + yp == 0, 2, torch.where(xp + yp < 3, 1, 0))
            s1 = torch.where(yp == 0, 2, torch.where(yp == 1, 1, 0))
            s2 = torch.where(xp == 0, 2, torch.where(xp == 1, 1, 0))
            sigc = torch.where(prev == 0, s0, torch.where(
                prev == 1, s1, torch.where(prev == 2, s2, 2)))
            if is_luma:
                sigc = sigc + torch.where((xx >> 2) + (yy >> 2) > 0, 3, 0)
                sigc = sigc + (9 if log2n == 3 else 21)
            else:
                sigc = sigc + (9 if log2n == 3 else 12)
            sigc = torch.where((xx == 0) & (yy == 0), 0, sigc)
            if not is_luma:
                sigc = sigc + 27
        s0b = c["sigp"][sigc, 0]
        s1b = c["sigp"][sigc, 1]
        # --- level prices (greater1/greater2 at in-CG start ctx) -----
        if is_luma:
            rowmap = torch.where((xx < 4) & (yy < 4), 0, 1)
        else:
            rowmap = torch.full((n, n), 2, device=self.device)
        g1b = c["g1p"][rowmap]                             # [n, n, 2]
        g2b = c["g2p"][rowmap]

        def lvl_bits(lv):
            rem = (lv.to(F32) - 3.0).clamp(min=0.0)
            gol = torch.where(rem < 3.0, rem + 1.0, 4.0 + 2.0
                              * self._golomb_log2(rem.clamp(min=1.0)))
            b3 = g1b[..., 1] + g2b[..., 1] + 1.0 + gol
            return torch.where(lv == 0, 0.0, torch.where(
                lv == 1, g1b[..., 0] + 1.0,
                torch.where(lv == 2, g1b[..., 1] + g2b[..., 0] + 1.0, b3)))

        big = 1e30
        l1 = (lf - 1).clamp(min=0)
        ee0 = ee(lf * 0)
        d0 = ee0 * inv
        # which product the compiled reference contracts into a sum
        # depends on the operands' other uses: for the zero level it is
        # the rate's (the distortion's at 4x4, whose significance contexts
        # are constant), for the nonzero levels the distortion's
        c0 = _fma(lamb * s0b, ee0, inv) if log2n == 2 \
            else _fma(d0, lamb, s0b)
        lv = torch.stack([l1, lf])                         # both candidates
        c1v, c2v = torch.where(lv > 0, _fma(lamb * (s1b + lvl_bits(lv)),
                                            ee(lv), inv), big)
        A = torch.minimum(c0, torch.minimum(c1v, c2v))     # best in-span
        lin = torch.where((c1v <= c2v) & (c1v <= c0), l1,
                          torch.where(c2v <= c0, lf, 0))
        ANZ = torch.minimum(c1v, c2v)                      # best nonzero
        lnz = torch.where(c1v <= c2v, l1, lf)
        B = d0                                             # beyond last
        # --- last-position walk over the diagonal scan ----------------
        perm, invp = self._scan_perm(log2n)

        def gs(x):
            return x.expand(L, n, n).reshape(L, n * n)[:, perm]

        As, ANZs, Bs = gs(A), gs(ANZ), gs(B)
        lins, lnzs = gs(lin), gs(lnz)
        scans = _xla_cumsum(torch.stack([As, Bs.flip(-1)]))
        prefA = scans[0] - As                              # exclusive
        sufB = scans[1].flip(-1) - Bs
        lastv = c[f"last{'p' if is_luma else 'c'}{log2n}"]
        # the compiled reference contracts lam * last into the sum except
        # at 32x32, where the product is formed on its own
        tot = (prefA + ANZs + lamb2 * lastv[None, :] if log2n == 5
               else _fma(prefA + ANZs, lamb2, lastv[None, :])) + sufB
        tot = torch.where(gs(lf > 0), tot, big)
        p_star = torch.argmin(tot, dim=1)                  # first minimum
        tot_min = torch.gather(tot, 1, p_star[:, None])[:, 0]
        all_zero = _xla_sum(Bs) <= tot_min
        j = torch.arange(n * n, device=self.device)[None, :]
        ps = p_star[:, None]
        lev_s = torch.where(j < ps, lins, torch.where(j == ps, lnzs, 0))
        lev_s = torch.where(all_zero[:, None], 0, lev_s)
        # --- coded-sub-block zeroing pass ------------------------------
        ncg = (n * n) >> 4
        if ncg > 1:
            cost_keep = torch.where(j < ps, As,
                                    torch.where(j == ps, ANZs, Bs))
            keep_cg, zero_cg = _seq_sum(torch.stack(
                [cost_keep, Bs]).reshape(2, L, ncg, 16))
            ci = 1 + (0 if is_luma else 2)     # neighbour-coded csbf ctx
            csbf0 = lamb2 * c["csbfp"][ci, 0]
            csbf1 = lamb2 * c["csbfp"][ci, 1]
            gidx = torch.arange(ncg, device=self.device)[None, :]
            zmask = (zero_cg + csbf0 < keep_cg + csbf1) \
                & (gidx != 0) & (gidx != (p_star >> 4)[:, None])
            lev_s = torch.where(zmask.repeat_interleave(16, dim=1), 0,
                                lev_s)
        lev = lev_s[:, invp].reshape(L, n, n)
        return (torch.sign(co) * lev).to(I32)

    def _sdh_fix(self, levels, n: int, err, q1, scan_sel=None):
        """Sign-data-hiding parity fix (spec 7.4.9.11): in each 4x4
        coefficient group whose nonzero span covers >= 4 scan positions the
        writer omits the first coefficient's sign and the decoder infers it
        from the parity of the level sum. Where the parity disagrees, apply
        the distortion-cheapest |level| +-1 among the nonzero coefficients:
        +1 where the quantiser rounded down hardest (max err), -1 where it
        rounded up hardest (min err; only on |level| >= 2, so scan positions
        and the hidden sign never move). q1: 2^qbits, an int or a [L, 1, 1]
        tensor (one QP a TU). scan_sel [L]: per-TU in-CG scan (0
        diagonal, 1 horizontal, 2 vertical), None for diagonal."""
        L = levels.shape[0]
        if isinstance(q1, torch.Tensor):
            q1 = q1.reshape(L, 1)
        g = n // 4
        big = 1 << 30
        sel = (torch.zeros(L, dtype=torch.long, device=self.device)
               if scan_sel is None else scan_sel.long())
        ordm = self.c["sdh_ord"][sel].long()[:, None, :].expand(L, g * g, 16)
        invm = self.c["sdh_inv"][sel].long()[:, None, :].expand(L, g * g, 16)

        def reorder(x):
            x = x.reshape(L, g, 4, g, 4).transpose(2, 3).reshape(L, g * g, 16)
            return torch.gather(x, 2, ordm)

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
        # +1 candidate: nonzero coeff with max rounding deficit
        e_up = torch.where(nz, e, -big)
        pos_up = torch.argmax(e_up, dim=-1)
        cost_up = q1 - 2 * torch.gather(e_up, 2,
                                                  pos_up[..., None])[..., 0]
        # -1 candidate: |level| >= 2 coeff with max rounding excess
        ok_dn = s.abs() >= 2
        e_dn = torch.where(ok_dn, e, big)
        pos_dn = torch.argmin(e_dn, dim=-1)
        cost_dn = q1 + 2 * torch.gather(e_dn, 2,
                                                  pos_dn[..., None])[..., 0]
        use_dn = ok_dn.any(dim=-1) & (cost_dn < cost_up)
        pos = torch.where(use_dn, pos_dn, pos_up)
        step = torch.where(use_dn, -1, 1)
        selv = torch.gather(s, 2, pos[..., None])[..., 0]
        bump = torch.where(need, torch.sign(selv) * step, 0)
        s = s + F.one_hot(pos, 16).to(s.dtype) * bump[..., None]
        out = torch.gather(s, 2, invm).reshape(L, g, g, 4, 4)
        return out.transpose(2, 3).reshape(L, n, n).to(I32)

    @staticmethod
    def _sqsum(x) -> torch.Tensor:
        """Exact integer sum of squares over the trailing [n, n] as
        float32 (equals a float32 sum whenever that is exact)."""
        x = x.to(torch.int64)
        return (x * x).sum(dim=(-1, -2)).to(F32)

    # ------------------------------------------------------------------
    # stage 1+2: mode search and partition DP
    # ------------------------------------------------------------------

    def _ctb_vec(self, key: str, n: int) -> torch.Tensor:
        """A per-CTB constant map (qpmap_y, qpmap_c, lammap) as one value
        per aligned n-block, blocks in raster order [B]."""
        k = self.CTB // n
        return rep2(self.c[key], k).reshape(-1)

    def _qp_lam_for(self, n: int):
        """(luma QP, chroma QP, lambda) of every aligned n-block: the
        frame's scalars, or [B] tensors under delta QP."""
        if not self.delta_qp:
            return self.qp_y, self.qp_c, self.lam
        return (self._ctb_vec("qpmap_y", n), self._ctb_vec("qpmap_c", n),
                self._ctb_vec("lammap", n))

    def _leaf_rd(self, src_y, src_cb, src_cr, n: int):
        """Best mode + RD cost for every aligned n-block.
        Returns (modes [B] int32, cost [B] float32)."""
        g, f = self._gf(n, True)
        qp_y, qp_c, lam = self._qp_lam_for(n)
        refs = self._src_refs(src_y, n)
        preds = self._preds_full(refs, g, f, n, True)
        blocks = self._blocks(src_y, n)
        satd = satd_tiles(blocks[:, None] - preds.reshape(-1, 35, n, n))
        k = self.rd_cands
        if k == 1:
            modes = torch.argmin(satd, dim=1).to(I32)
        else:
            # the rd ladder: RD-cost the k best-SATD modes, keep the
            # cheapest; a stable sort orders tied SATDs by mode, as the
            # reference's top_k does
            cand = torch.sort(satd, dim=1, stable=True).indices[:, :k]
            B = blocks.shape[0]
            predk = torch.gather(preds, 1, cand[:, :, None]
                                 .expand(-1, -1, n * n)).reshape(B, k, n, n)
            resik = (blocks[:, None] - predk).reshape(B * k, n, n)
            qpk, lamk = qp_y, lam
            if self.delta_qp:
                qpk = qp_y.repeat_interleave(k)
                lamk = lam.repeat_interleave(k)
            lvk, rk2 = self._transform_quant(resik, n, qpk, is_luma=True,
                                             tools=False)
            dk = self._sqsum(resik - rk2)
            rtk = self._tu_rate_y(lvk, n) + self.mode_cost[cand.reshape(-1)]
            # the final leaf cost's metric, noise factor included
            ck = (dk * (1 + self.REF_NOISE_K / n) + lamk * rtk).reshape(B, k)
            sel = torch.argmin(ck, dim=1)                  # first minimum
            modes = torch.gather(cand, 1, sel[:, None])[:, 0].to(I32)
        pred = torch.gather(preds, 1, modes.long()[:, None, None]
                            .expand(-1, 1, n * n))[:, 0].reshape(-1, n, n)
        resi = blocks - pred
        levels, r2 = self._transform_quant(resi, n, qp_y, is_luma=True,
                                           tools=False)
        dist = self._sqsum(resi - r2)
        rate = self._tu_rate_y(levels, n)
        ccost = self._add_chroma_costs(torch.zeros_like(dist), src_cb,
                                       src_cr, modes, n // 2, qp_c, lam)
        cost = dist * (1 + self.REF_NOISE_K / n) \
            + lam * (rate + self.mode_cost[modes.long()]
                     + self.dpc[self.DPC_CHROMA_DM]) + ccost
        return modes, cost

    def _add_chroma_costs(self, acc, src_cb, src_cr, modes, nc: int, qp_c,
                          lam, depth1: bool = False):
        """acc plus, plane by plane (Cb, then Cr), the RD cost of each
        block's nc x nc chroma TU predicted from source references with
        the derived (DM) mode `modes`: its distortion with the noise
        factor, plus lambda times its rate at trafo depth 0 or 1. qp_c
        and lam: scalars, or one a block under delta QP."""
        gc, _ = self._gf(nc, False)
        for i, plane in enumerate((src_cb, src_cr)):
            cpred = self._pred_one(self._src_refs(plane, nc), modes, gc, gc,
                                   nc, False)
            cresi = self._blocks(plane, nc) - cpred.reshape(-1, nc, nc)
            clev, cr2 = self._transform_quant(cresi, nc, qp_c,
                                              is_luma=False, tools=False,
                                              cr=i == 1)
            acc = acc + self._sqsum(cresi - cr2) \
                * (1 + self.REF_NOISE_K / nc) \
                + lam * self._tu_rate_c(clev, nc, depth1=depth1)
        return acc

    def _leaf_rd64(self, src_y, src_cb, src_cr):
        """64x64 leaf cost: one luma mode (the least summed SATD of its four
        32x32 quarters) for four 32x32 TUs (the TU tree splits once, spec
        7.3.8.8) and four 16x16 chroma TUs a plane, rates at trafo depth 1.
        Returns (modes [B64] int32, cost [B64] float32)."""
        qp_y, qp_c, lam = self._qp_lam_for(64)
        n = 32
        r64, c64 = self.h // 64, self.w // 64

        def to_children(v64):
            return rep2(v64.reshape(r64, c64), 2).reshape(-1)
        qy, qc, lam_ch = qp_y, qp_c, lam
        if self.delta_qp:
            qy, qc, lam_ch = (to_children(v) for v in (qp_y, qp_c, lam))

        g, f = self._gf(n, True)
        refs = self._src_refs(src_y, n)
        preds = self._preds_full(refs, g, f, n, True)
        blocks = self._blocks(src_y, n)
        satd = satd_tiles(blocks[:, None] - preds.reshape(-1, 35, n, n))
        satd4 = satd.reshape(r64, 2, c64, 2, 35).sum(dim=(1, 3))
        m64 = torch.argmin(satd4.reshape(-1, 35), dim=1).to(I32)
        mch = to_children(m64)
        pred = torch.gather(preds, 1, mch.long()[:, None, None]
                            .expand(-1, 1, n * n))[:, 0].reshape(-1, n, n)
        resi = blocks - pred
        levels, r2 = self._transform_quant(resi, n, qy, is_luma=True,
                                           tools=False)
        dist = self._sqsum(resi - r2)
        rate = self._tu_rate_y(levels, n, depth1=True)
        child = self._add_chroma_costs(
            dist * (1 + self.REF_NOISE_K / n) + lam_ch * rate, src_cb,
            src_cr, mch, 16, qc, lam_ch, depth1=True)
        cost64 = child.reshape(r64, 2, c64, 2).sum(dim=(1, 3)).reshape(-1) \
            + lam * (self.mode_cost[m64.long()]
                     + self.dpc[self.DPC_CHROMA_DM])
        return m64, cost64

    @staticmethod
    def _satd4(diff):
        """SATD over trailing [.., 4, 4]: the 4x4 Hadamard transform, then
        (sum |t| + 1) >> 1 (exact integers)."""
        d = diff.to(I32)
        t = torch.stack([d[..., 0, :] + d[..., 1, :] + d[..., 2, :]
                         + d[..., 3, :],
                         d[..., 0, :] - d[..., 1, :] + d[..., 2, :]
                         - d[..., 3, :],
                         d[..., 0, :] + d[..., 1, :] - d[..., 2, :]
                         - d[..., 3, :],
                         d[..., 0, :] - d[..., 1, :] - d[..., 2, :]
                         + d[..., 3, :]], dim=-2)
        t = torch.stack([t[..., 0] + t[..., 1] + t[..., 2] + t[..., 3],
                         t[..., 0] - t[..., 1] + t[..., 2] - t[..., 3],
                         t[..., 0] + t[..., 1] - t[..., 2] - t[..., 3],
                         t[..., 0] - t[..., 1] - t[..., 2] + t[..., 3]],
                        dim=-1)
        return (t.abs().sum(dim=(-1, -2), dtype=I32) + 1) >> 1

    def _leaf_rd4(self, src_y, src_cb, src_cr):
        """NxN cost per 8x8 CU: four 4x4 luma PUs with their own SATD-best
        modes and 4x4 DST TUs at trafo depth 1, plus one 4x4 chroma TU a
        plane on PU0's mode. Returns (modes4 [B4] int32 per 4x4 block,
        cost [B8] float32 per 8x8 cell)."""
        _, qp_c, lam = self._qp_lam_for(8)
        qy, lam4 = self.qp_y, self.lam
        if self.delta_qp:
            qy, lam4 = self._ctb_vec("qpmap_y", 4), self._ctb_vec("lammap", 4)
        r4n, c4n = self.h // 4, self.w // 4
        g, f = self._gf(4, True)
        refs = self._src_refs(src_y, 4)
        preds = self._preds_full(refs, g, f, 4, True)
        blocks = self._blocks(src_y, 4)
        satd = self._satd4(blocks[:, None] - preds.reshape(-1, 35, 4, 4))
        m4 = torch.argmin(satd, dim=1).to(I32)
        pred = torch.gather(preds, 1, m4.long()[:, None, None]
                            .expand(-1, 1, 16))[:, 0].reshape(-1, 4, 4)
        resi = blocks - pred
        levels, r2 = self._transform_quant(resi, 4, qy, is_luma=True,
                                           tools=False, dst=True)
        dist = self._sqsum(resi - r2)
        rate = self._tu_rate_y(levels, 4, depth1=True)
        child = (dist * (1 + self.REF_NOISE_K / 4)
                 + lam4 * (rate + self.mode_cost[m4.long()])) \
            .reshape(r4n // 2, 2, c4n // 2, 2).sum(dim=(1, 3)).reshape(-1)
        m0 = m4.reshape(r4n, c4n)[::2, ::2].reshape(-1)
        return m4, self._add_chroma_costs(
            child + lam * self.dpc[self.DPC_CHROMA_DM], src_cb, src_cr, m0,
            4, qp_c, lam)

    def _split_dp(self, cost8, leaf16, leaf32, lam16=None, lam32=None):
        """The 8 -> 16 -> 32 steps of the bottom-up split DP over the cost
        of each 8x8 CU cost8 [R8,C8] and the leaf costs leaf16 and leaf32.
        The intra depth range forces or forbids the splits (in the inter
        quadtree too, as in the reference). lam16 / lam32: the lambda of
        each 16 / 32 region under delta QP (the frame's by default).
        Returns split16, split32 and best32, the cost of each 32x32
        region's choice."""
        allow = self.allow
        lam16 = self.lam if lam16 is None else lam16
        lam32 = self.lam if lam32 is None else lam32
        sp0 = self.dpc[self.DPC_SPLIT0]
        sp1 = self.dpc[self.DPC_SPLIT1]
        sum8 = sum4(cost8)
        split16 = sum8 + lam16 * sp1 < leaf16 + lam16 * sp0
        if not allow[8]:
            split16 = torch.zeros_like(split16)
        if not allow[16]:
            split16 = torch.ones_like(split16)
        best16 = torch.where(split16, sum8 + lam16 * sp1,
                             leaf16 + lam16 * sp0)
        sum16 = sum4(best16)
        split32 = sum16 + lam32 * sp1 < leaf32 + lam32 * sp0
        if not allow[32]:
            split32 = torch.ones_like(split32)
        elif not (allow[16] or allow[8]):
            split32 = torch.zeros_like(split32)
        best32 = torch.where(split32, sum16 + lam32 * sp1,
                             leaf32 + lam32 * sp0)
        return split16, split32, best32

    def _partition(self, src_y, src_cb, src_cr):
        """Returns (size_map8 [R8,C8] in {4, 8, 16, 32, 64}, 4 marking an
        NxN 8x8 CU, mode_map8 [R8,C8] (PU0's mode for NxN), mode_map4
        [R4,C4] with the per-4x4 PU modes)."""
        lam = self.lam
        allow = self.allow
        m8, c8c = self._leaf_rd(src_y, src_cb, src_cr, 8)
        # the NxN-vs-2Nx2N choice at the 8x8 CU: part_mode is coded either
        # way at the minimum CB size, its two values at different prices
        c8c = c8c + lam * self.dpc[self.DPC_PART_2NX2N]
        nxn8 = m4 = None
        if allow[4]:
            m4, cnxn = self._leaf_rd4(src_y, src_cb, src_cr)
            cn = (cnxn + lam * self.dpc[self.DPC_PART_NXN]) \
                .reshape(self.r8, self.c8)
            c2n = c8c.reshape(self.r8, self.c8)
            nxn8 = torch.ones_like(cn, dtype=torch.bool) if self.force_nxn \
                else cn < c2n
            c8c = torch.where(nxn8, cn, c2n).reshape(-1)
        m16, c16c = self._leaf_rd(src_y, src_cb, src_cr, 16)
        m32, c32c = self._leaf_rd(src_y, src_cb, src_cr, 32)
        r16, c16n = self.h // 16, self.w // 16
        r32, c32n = self.h // 32, self.w // 32
        r64, c64n = self.h // 64, self.w // 64
        # the split DP's lambdas: the CTB's under delta QP (the 8x8
        # part_mode prices above stay at the frame's, as the reference's)
        lam16 = lam32 = lam64 = lam
        if self.delta_qp:
            lam16, lam32, lam64 = (rep2(self.c["lammap"], self.CTB // n)
                                   for n in (16, 32, 64))
        split16, split32, best32 = self._split_dp(
            c8c.reshape(self.r8, self.c8), c16c.reshape(r16, c16n),
            c32c.reshape(r32, c32n), lam16, lam32)
        split64 = None
        if allow[64]:
            m64, c64c = self._leaf_rd64(src_y, src_cb, src_cr)
            split64 = sum4(best32) + lam64 * self.dpc[self.DPC_SPLIT1] \
                < c64c.reshape(r64, c64n) + lam64 * self.dpc[self.DPC_SPLIT0]
            if not (allow[32] or allow[16] or allow[8]):
                split64 = torch.zeros_like(split64)
        e32 = rep2(split32, 2)
        sz16 = torch.where(~e32, 32, torch.where(split16, 8, 16))
        size_map8 = rep2(sz16, 2).to(I32)
        mode16_8 = rep2(m16.reshape(r16, c16n), 2)
        mode32_8 = rep2(m32.reshape(r32, c32n), 4)
        mode_map8 = torch.where(
            size_map8 == 8, m8.reshape(self.r8, self.c8),
            torch.where(size_map8 == 16, mode16_8, mode32_8)).to(I32)
        if split64 is not None:
            is64 = ~rep2(split64, 8)
            size_map8 = torch.where(is64, 64, size_map8).to(I32)
            mode_map8 = torch.where(is64, rep2(m64.reshape(r64, c64n), 8),
                                    mode_map8).to(I32)
        if nxn8 is None:
            return size_map8, mode_map8, rep2(mode_map8, 2)
        m4m = m4.reshape(self.h // 4, self.w // 4)
        isn = (size_map8 == 8) & nxn8
        size_map8 = torch.where(isn, 4, size_map8).to(I32)
        mode_map8 = torch.where(isn, m4m[::2, ::2], mode_map8).to(I32)
        mode_map4 = torch.where(rep2(isn, 2), m4m,
                                rep2(mode_map8, 2)).to(I32)
        return size_map8, mode_map8, mode_map4

    # ------------------------------------------------------------------
    # stage 3: self-scheduled wavefront reconstruction
    # ------------------------------------------------------------------

    def _leaf_z(self, size_map8):
        """Morton code of each cell's leaf (coding-order key per cell)."""
        r = self._arange(self.r8)[:, None]
        c = self._arange(self.c8)[None, :]
        k = (size_map8 >> 3).long()
        lr = r & ~(k - 1)
        lc = c & ~(k - 1)
        return self.c["m8"][lr, lc]

    def _mode_needs(self, s: int) -> np.ndarray:
        """Per-mode reference dependency masks [4 (l, t, bl, tr), 35] for
        luma size s, derived from the prediction matrices (a mode waits
        for a region iff some weight, raw or through the [1 2 1] filter,
        touches it); the chroma TU rides the same mode at half size."""
        if s in self._mode_needs_cache:
            return self._mode_needs_cache[s]
        need = np.zeros((4, 35), bool)
        for n_, is_luma in ((s, True), (s // 2, False)):
            g = np.abs(np.asarray(
                build_pred_matrices(n_, chroma=not is_luma), np.float64))
            f = np.abs(np.asarray(build_filter_matrix(n_), np.float64))
            rlen = ref_vec_len(n_)
            dep = g[:, :, :rlen].sum(1) + g[:, :, rlen:].sum(1) @ f
            reg = {
                0: np.arange(0, n_),
                1: np.arange(2 * n_ + 1, 3 * n_ + 1),
                2: np.arange(n_, 2 * n_),
                3: np.arange(3 * n_ + 1, 4 * n_ + 1),
            }
            for i in range(4):
                need[i] |= dep[:, reg[i]].sum(axis=1) > 0
        need[0, 1] = need[1, 1] = True                     # DC
        need[:, 0] = True                                  # planar
        if s < 32:
            need[1, 10] = True                             # mode 10 row0
            need[0, 26] = True                             # mode 26 col0
        self._mode_needs_cache[s] = need
        return need

    def _class_static(self, size_map8, leafz, s: int, mode_map8):
        """Frame-constant per-class scheduling data: leaf mask, z-order
        below-left/top-right availability (masks and counts), the class
        rows with a row above them in their picture, and the
        mode-dependent dependency masks."""
        k = s // 8
        rs, cs = self.r8 // k, self.c8 // k
        big = 1 << 30
        zt = self.c["m8"][::k, ::k]
        z4 = F.pad(leafz, (0, k, 0, k), value=big) \
            .reshape(rs + 1, k, cs + 1, k)
        # a picture's first class row: nothing above or above-right of it,
        # nor below-left of the row before it, is available
        top = self._arange(rs) % (rs // self.n_pics) == 0
        av_bl = (z4[1:, :, :cs - 1, k - 1] < zt[:, None, 1:]) \
            & ~F.pad(top[1:], (0, 1))[:, None, None]
        av_tr = (z4[:rs - 1, k - 1, 1:, :] < zt[1:, :, None]) \
            & ~top[1:, None, None]
        st = {
            "leaf": size_map8[::k, ::k] == s,
            "av_bl": av_bl,
            "av_tr": av_tr,
            "n_bl": F.pad(av_bl.sum(1), (1, 0)),
            "n_tr": F.pad(av_tr.sum(-1), (0, 0, 1, 0)),
            "has_top": ~top,
        }
        if self.n_pics > 1:
            st["pic_top"] = top[:, None]
        m = mode_map8[::k, ::k].long()
        row0 = top[:, None]
        col0 = (self._arange(cs) == 0)[None, :]
        nl, nt, nbl, ntr = (torch.as_tensor(a, device=self.device)
                            for a in self._mode_needs(s))
        st["need_l"] = nl[m] | row0
        st["need_t"] = nt[m] | col0
        st["need_bl"] = nbl[m]
        st["need_tr"] = ntr[m]
        return st

    def _class_ready(self, written, st, s: int):
        """Per class-grid position: a leaf not yet fired whose needed
        neighbour samples are all reconstructed."""
        k = s // 8
        rs, cs = self.r8 // k, self.c8 // k
        notdone = ~written[::k, ::k]
        unwr = (~written).to(I32)
        col_last = unwr[:, k - 1::k]                      # [r8, cs]
        row_last = unwr[k - 1::k, :]                      # [rs, c8]
        lm_full = col_last.reshape(rs, k, cs).sum(1)
        lm = F.pad(lm_full, (1, 0))[:, :cs]
        cor_cells = col_last[k - 1::k, :]
        cor = F.pad(cor_cells, (1, 0, 1, 0))[:rs, :cs]
        tm_full = row_last.reshape(rs, cs, k).sum(-1)
        tm = F.pad(tm_full, (0, 0, 1, 0))[:rs, :]
        if "pic_top" in st:
            # the picture stacked above is no neighbour
            cor = cor.masked_fill(st["pic_top"], 0)
            tm = tm.masked_fill(st["pic_top"], 0)
        blv = F.pad(col_last, (0, 0, 0, k))[k:].reshape(rs, k, cs)
        bl_dep = F.pad((st["av_bl"] & (blv[:, :, :cs - 1] > 0)).sum(1),
                       (1, 0))
        trv = F.pad(row_last, (0, k))[:, k:].reshape(rs, cs, k)
        tr_dep = F.pad((st["av_tr"] & (trv[:rs - 1] > 0)).sum(-1),
                       (0, 0, 1, 0))
        ok_l = (lm == 0) | ~st["need_l"]
        ok_t = (tm == 0) | ~st["need_t"]
        ok_bl = (bl_dep == 0) | ~st["need_bl"]
        ok_tr = (tr_dep == 0) | ~st["need_tr"]
        return st["leaf"] & notdone & ok_l & (cor == 0) & ok_t & ok_bl \
            & ok_tr

    def _substitute(self, left_raw, top_raw, corner_raw, n: int, has_left,
                    has_top, n_bl, n_tr, cell_px: int):
        """Reference substitution (spec 8.4.4.2.2). Raw inputs [L, 2n],
        [L, 2n], [L]; returns the [L, 4n+2] reference vector."""
        idx = self._arange(2 * n)[None, :]
        fill = torch.where(has_top, top_raw[:, 0], 1 << (self.bd - 1))
        bl_px = n_bl * cell_px
        last_left = torch.where(n_bl > 0, n + bl_px - 1, n - 1)
        lval = torch.gather(left_raw, 1,
                            last_left.clamp(0, 2 * n - 1)[:, None].long())
        left = torch.where(idx < n + bl_px[:, None], left_raw, lval)
        left = torch.where(has_left[:, None], left, fill[:, None])
        has_corner = has_left & has_top
        corner = torch.where(has_corner, corner_raw,
                             torch.where(has_left, left[:, 0], fill))
        tr_px = n_tr * cell_px
        last_top = torch.where(n_tr > 0, n + tr_px - 1, n - 1)
        tval = torch.gather(top_raw, 1,
                            last_top.clamp(0, 2 * n - 1)[:, None].long())
        top = torch.where(idx < n + tr_px[:, None], top_raw, tval)
        top = torch.where(has_top[:, None], top, corner[:, None])
        pad = torch.zeros((left.shape[0], 1), dtype=left.dtype,
                          device=self.device)
        return torch.cat([left, corner[:, None], top, pad], dim=1)

    def _tu_apply(self, plane, srcb, n: int, cell_px: int, y0, x0,
                  has_left, has_top, nbl, ntr, modes, qp, is_luma: bool,
                  lam_ts=None, cr: bool = False):
        """Predict, transform and reconstruct one TU per slot from the
        reconstructed plane (padded, +1 offset); qp: an int, or one a
        slot under delta QP; lam_ts: the transform-skip competition's
        lambda (4x4 TUs compete when it is given); cr: a Cr TU. Returns
        (recon, levels, use_skip [L] bool or None) [L, n, n]."""
        ar = self._arange(2 * n)
        left_raw = plane[1 + y0[:, None] + ar[None, :], x0[:, None]]
        top_raw = plane[y0[:, None], 1 + x0[:, None] + ar[None, :]]
        corner_raw = plane[y0, x0]
        refs = self._substitute(left_raw, top_raw, corner_raw, n, has_left,
                                has_top, nbl, ntr, cell_px)
        g, f = self._gf(n, is_luma)
        pred = self._pred_one(refs, modes, g, f, n, is_luma) \
            .reshape(-1, n, n)
        resi = srcb - pred
        scan_sel = None
        if n == 4 or (is_luma and n == 8):
            # mode-dependent coefficient scan (spec 7.4.9.11)
            scan_sel = torch.where((modes >= 6) & (modes <= 14), SCAN_VER,
                                   torch.where((modes >= 22) & (modes <= 30),
                                               SCAN_HOR, SCAN_DIAG))
        ts = None
        if lam_ts is not None and n == 4:
            levels, r2, ts = self._tq_4x4_rd(resi, qp, lam_ts,
                                             is_luma=is_luma,
                                             scan_sel=scan_sel, dst=is_luma,
                                             cr=cr)
        else:
            levels, r2 = self._transform_quant(resi, n, qp, is_luma=is_luma,
                                               tools=True, scan_sel=scan_sel,
                                               dst=is_luma and n == 4, cr=cr)
        cbf = (levels != 0).any(dim=-1).any(dim=-1)[:, None, None]
        rec = (pred + torch.where(cbf, r2, 0)).clamp(0, self.maxv)
        return rec, torch.where(cbf, levels, 0), ts

    def _put(self, plane, y0, x0, n: int, blk, valid) -> None:
        """Write [L, n, n] blocks at (y0, x0) (+1 offset) where valid."""
        ar = self._arange(n)
        yy = 1 + y0[:, None, None] + ar[None, :, None]
        xx = 1 + x0[:, None, None] + ar[None, None, :]
        plane[yy, xx] = torch.where(valid[:, None, None], blk.to(plane.dtype),
                                    plane[yy, xx])

    def _fire_class(self, luma, chroma, s: int, c_star, valid, st, pre,
                    ts8=None):
        """Reconstruct the fired TUs of size s (slot r fires class column
        c_star[r] where valid) into the planes, in place. ts8 [r8, c8, 6]
        int8: with transform skip, where the 8-class slots write their
        cells' skip bits (the four NxN luma sub-TUs in z order, Cb, Cr)."""
        k = s // 8
        rs, cs = self.r8 // k, self.c8 // k
        r = self._arange(rs)
        c = c_star.long()
        has_left = valid & (c > 0)
        has_top = valid & st["has_top"]
        nbl = st["n_bl"][r, c]
        ntr = st["n_tr"][r, c]
        modes = pre["modes"][r, c]
        bidx = r * cs + c
        y0, x0 = r * s, c * s
        qp_y, qp_c = self.qp_y, self.qp_c
        if "qpy" in pre:
            qp_y, qp_c = pre["qpy"][r, c], pre["qpc"][r, c]
        # the skip competition prices with the luma QP's lambda on luma
        # and chroma TUs alike, as the reference's
        lam_ts = ts_lambda(qp_y) if ts8 is not None and s == 8 else None
        rb, lb, _ = self._tu_apply(luma[0], pre["by"][bidx], s, 8, y0, x0,
                                   has_left, has_top, nbl, ntr, modes, qp_y,
                                   True)
        nxn = None
        if "nxn" in pre:
            nxn = valid & pre["nxn"][r, c]
            valid_2n = valid & ~nxn
        else:
            valid_2n = valid
        self._put(luma[0], y0, x0, s, rb, valid_2n)
        self._put(luma[1], y0, x0, s, lb, valid_2n)
        ts_y = None
        if nxn is not None:
            ts_y = self._nxn_apply(luma, pre["by"][bidx], y0, x0, has_left,
                                   has_top, nbl, ntr, pre["modes4"][r, c],
                                   nxn, qp_y, lam_ts)
        sc = s // 2
        ts_c = []
        for i, key in enumerate(("bcb", "bcr")):
            rb, lb, ts = self._tu_apply(chroma[i], pre[key][bidx], sc, 4,
                                        r * sc, c * sc, has_left, has_top,
                                        nbl, ntr, modes, qp_c, False, lam_ts,
                                        cr=i == 1)
            self._put(chroma[i], r * sc, c * sc, sc, rb, valid)
            self._put(chroma[2 + i], r * sc, c * sc, sc, lb, valid)
            ts_c.append(ts)
        if ts8 is not None and s == 8:
            if ts_y is None:
                ts_y = torch.zeros((rs, 4), dtype=torch.bool,
                                   device=self.device)
            else:
                ts_y = ts_y & nxn[:, None]
            bits = torch.cat([ts_y, ts_c[0][:, None], ts_c[1][:, None]],
                             dim=1).to(ts8.dtype)
            ts8[r, c] = torch.where(valid[:, None], bits, ts8[r, c])

    def _nxn_apply(self, luma, src8, y0, x0, has_left, has_top, nbl, ntr,
                   modes4, nxn, qp_y, lam_ts=None):
        """Reconstruct the four 4x4 luma TUs of the NxN cells nxn [L] of
        the fired 8-class slots into the planes, one after another in z
        order: each predicts from the plane, its neighbours in the cell
        being the TUs just written, with its own availability (spec
        8.4.4.2.2): sub-TU 1 has no below-left and the cell's first
        top-right cell, sub-TU 2 the cell's first below-left cell and
        sub-TU 1 as top-right, sub-TU 3 neither. modes4 [L, 4] in z
        order; qp_y: the slots' luma QP (an int, or [L]); lam_ts: the
        transform-skip lambda, or None. Returns the sub-TUs' skip bits
        [L, 4] (with lam_ts), else None."""
        one = torch.ones_like(has_left)
        zero = torch.zeros_like(nbl)
        nb1, nt1 = nbl.clamp(max=1), ntr.clamp(max=1)
        avail = ((has_left, has_top, has_left.to(nbl.dtype),
                  has_top.to(nbl.dtype)),
                 (one, has_top, zero, nt1),
                 (has_left, one, nb1, zero + 1),
                 (one, one, zero, zero))
        tss = []
        for i, (dy, dx) in enumerate(((0, 0), (0, 4), (4, 0), (4, 4))):
            hl, ht, nb, nt = avail[i]
            rb, lb, ts = self._tu_apply(
                luma[0], src8[:, dy:dy + 4, dx:dx + 4], 4, 4, y0 + dy,
                x0 + dx, hl, ht, nb, nt, modes4[:, i], qp_y, True, lam_ts)
            self._put(luma[0], y0 + dy, x0 + dx, 4, rb, nxn)
            self._put(luma[1], y0 + dy, x0 + dx, 4, lb, nxn)
            tss.append(ts)
        return None if lam_ts is None else torch.stack(tss, dim=1)

    def _new_planes(self):
        h, w = self.h, self.w
        luma = torch.zeros((2, 1 + h + 64, 1 + w + 64), dtype=I32,
                           device=self.device)
        chroma = torch.zeros((4, 1 + h // 2 + 32, 1 + w // 2 + 32),
                             dtype=I32, device=self.device)
        written = torch.zeros((self.r8, self.c8), dtype=torch.bool,
                              device=self.device)
        return luma, chroma, written

    def _recon_md(self, src_y, src_cb, src_cr, size_map8, mode_map8,
                  init_state=None, exclude8=None, mode_map4=None, ts8=None):
        """Self-scheduled recon. init_state: optional pre-written
        (luma [2, Hp, Wp], chroma [4, Hc, Wc], written8) planes in the
        +1-offset layout (the inter path reconstructs its leaves first);
        exclude8: cells whose leaves the wavefront must not fire;
        mode_map4: the per-4x4 PU modes of the NxN cells (size code 4).
        A 64 leaf reconstructs as four 32 TUs of one mode, so it fires as
        four 32 leaves; an NxN cell fires as an 8 leaf that waits for
        every neighbour region its four modes might read. ts8: an int8
        [r8, c8, 6] zeros tensor to run the transform-skip competition on
        the 4x4 TUs and collect each 8x8 cell's skip bits (the four NxN
        luma sub-TUs in z order, Cb, Cr) into; None runs without it.
        Returns (luma, chroma, written, n_waves [n_pics] int64)."""
        nxn8 = None
        if mode_map4 is not None and self.allow[4]:
            nxn8 = size_map8 == 4
        size_map8 = size_map8.clamp(8, 32)
        if init_state is None:
            luma, chroma, written = self._new_planes()
        else:
            luma, chroma, written = (t.clone() for t in init_state)
        leafz = self._leaf_z(size_map8)
        statics, pres = {}, {}
        for s in self.SIZES:
            k = s // 8
            rs, cs = self.r8 // k, self.c8 // k
            st = self._class_static(size_map8, leafz, s, mode_map8)
            if exclude8 is not None:
                st["leaf"] = st["leaf"] & ~exclude8[::k, ::k]
            pres[s] = {"by": self._blocks(src_y, s),
                       "bcb": self._blocks(src_cb, s // 2),
                       "bcr": self._blocks(src_cr, s // 2),
                       "modes": mode_map8[::k, ::k],
                       "cols": self._arange(cs)}
            if self.delta_qp:
                # the QPs of each class position's CTB
                rr = self._arange(rs) * s // self.CTB
                cc = self._arange(cs) * s // self.CTB
                for key, m in (("qpy", "qpmap_y"), ("qpc", "qpmap_c")):
                    pres[s][key] = self.c[m][rr[:, None], cc[None, :]]
            if s == 8 and nxn8 is not None:
                for key in ("need_l", "need_t", "need_bl", "need_tr"):
                    st[key] = st[key] | nxn8
                m4 = mode_map4
                pres[s]["nxn"] = nxn8
                pres[s]["modes4"] = torch.stack(
                    [m4[0::2, 0::2], m4[0::2, 1::2], m4[1::2, 0::2],
                     m4[1::2, 1::2]], dim=-1)
            statics[s] = st
        # every wave fires a TU of a picture until it is written, so its
        # 8x8 cells bound its waves (the reference stops at 3 * r8 + 2 *
        # c8 + 64 waves, which NxN-heavy frames need more than: ROADMAP.md
        # queue 3); a check window in which a picture left unwritten fires
        # nothing is a stall. Each picture counts its own waves: the last
        # in which it fired
        P = self.n_pics
        cap = self.r8 // P * self.c8
        n_waves = torch.zeros(P, dtype=torch.int64, device=self.device)
        wave = 0
        done = bool(written.all())
        while not done:
            for _ in range(self.WAVE_CHECK):
                new_written = written.clone()
                fired_any = torch.zeros(P, dtype=torch.bool,
                                        device=self.device)
                for s in self.SIZES:
                    k = s // 8
                    rs, cs = self.r8 // k, self.c8 // k
                    cols = pres[s]["cols"]
                    ready = self._class_ready(written, statics[s], s)
                    # the leftmost ready TU of every class row fires
                    c_star = torch.argmin(
                        torch.where(ready, cols[None, :], cs), dim=1)
                    row_has = ready.any(dim=1)
                    fired = ready & (cols[None, :] == c_star[:, None])
                    new_written |= fired[:, None, :, None].expand(
                        rs, k, cs, k).reshape(self.r8, self.c8)
                    fired_any = fired_any | row_has.reshape(P, -1).any(1)
                    self._fire_class(luma, chroma, s, c_star, row_has,
                                     statics[s], pres[s], ts8)
                written = new_written
                wave += 1
                n_waves = torch.where(fired_any, wave, n_waves)
            pic_done = written.reshape(P, -1).all(1).to(torch.int64)
            done_p, last = torch.stack([pic_done, n_waves]).tolist()
            done = all(done_p)
            for p in range(P):
                if not done_p[p] and (wave - last[p] >= self.WAVE_CHECK
                                      or wave >= cap):
                    raise RuntimeError(
                        f"the wavefront stalled after {last[p]} waves with "
                        f"cells of picture {p} left unwritten")
        return luma, chroma, written, n_waves

    # ------------------------------------------------------------------
    # full frame
    # ------------------------------------------------------------------

    def _edge_maps(self, size_map8):
        """Deblocking BS=2 maps on the TU grid from the partition. A 64
        CU's 32-TU edges are TU edges (code 64 acts as 32); an NxN cell's
        4x4 TU edges are off the 8-sample grid (code 4 acts as 8)."""
        k = size_map8.clamp(8, 32) >> 3
        c = self._arange(self.c8)[None, :]
        r = self._arange(self.r8)[:, None]
        ver8 = ((c & (k - 1)) == 0) & (c > 0)
        hor8 = ((r & (k - 1)) == 0) & (r > 0)
        bs_ver = ver8.repeat_interleave(2, 0).to(I32) * 2
        bs_hor = hor8.repeat_interleave(2, 1).to(I32) * 2
        return bs_ver, bs_hor

    def _unpack_planes(self, luma, chroma):
        h, w = self.h, self.w
        return (luma[0, 1:1 + h, 1:1 + w], chroma[0, 1:1 + h // 2,
                                                  1:1 + w // 2],
                chroma[1, 1:1 + h // 2, 1:1 + w // 2],
                luma[1, 1:1 + h, 1:1 + w],
                chroma[2, 1:1 + h // 2, 1:1 + w // 2],
                chroma[3, 1:1 + h // 2, 1:1 + w // 2])

    def _final_qp(self, lvl_y, lvl_cb, lvl_cr) -> torch.Tensor:
        """Final per-CTB QP (spec 8.6.1 through the qPY_PREV chain): a CTB
        that codes no coefficient never codes its delta, so its QP is the
        predecessor's in coding order (the slice QP at the frame start,
        and with wpp at every CTB row start). Returns int32 [rows, cols]."""
        rc, cc = self.h // self.CTB, self.w // self.CTB
        n, nc2 = self.CTB, self.CTB // 2

        def coded(lv, m):
            return (lv.reshape(rc, m, cc, m) != 0).any(dim=3).any(dim=1)
        cbf = coded(lvl_y, n) | coded(lvl_cb, nc2) | coded(lvl_cr, nc2)
        qpm = self.c["qpmap_y"]
        if self.wpp:
            pos = torch.where(cbf, self._arange(cc)[None, :], -1)
            last = torch.cummax(pos, dim=1).values
            fq = torch.gather(qpm, 1, last.clamp(min=0))
        else:
            pos = torch.where(cbf.reshape(-1), self._arange(rc * cc), -1)
            last = torch.cummax(pos, dim=0).values
            fq = qpm.reshape(-1)[last.clamp(min=0)]
            last = last.reshape(rc, cc)
            fq = fq.reshape(rc, cc)
        return torch.where(last >= 0, fq, self.qp_y).to(I32)

    def _deblock(self, ry, rcb, rcr, bs_ver, bs_hor, fq=None):
        """Deblocking at the frame's QP, or with the final per-CTB QPs fq
        (delta QP) every edge at its two sides' rounded mean."""
        from ..ops.deblock_torch import deblock_frame_torch
        qp4 = None if fq is None else rep2(fq, self.CTB // 4)
        return deblock_frame_torch(ry, rcb, rcr, bs_ver, bs_hor, self.qp_y,
                                   self.qp_c, self.qp_c, self.deblock_beta,
                                   self.deblock_tc, bit_depth=self.bd,
                                   qp4=qp4)

    def _sao(self, src_y, src_cb, src_cr, ry, rcb, rcr):
        """SAO search and filter of the deblocked planes (luma per CTB,
        chroma jointly over Cb/Cr at half the CTB). Returns the filtered
        planes and the per-CTB parameter maps as int8, under the
        reference's names (sao_y_*, sao_c_*)."""
        from ..ops.sao_torch import sao_chroma, sao_luma
        ab = self.sao in ("full", "band")
        ae = self.sao in ("full", "edge")
        ry, py = sao_luma(src_y, ry, self.CTB, self.lam, ab, ae,
                          bit_depth=self.bd)
        rcb, rcr, pc = sao_chroma(src_cb, src_cr, rcb, rcr, self.CTB // 2,
                                  self.lam, ab, ae, bit_depth=self.bd)
        maps = {"sao_y_" + k: v.to(torch.int8) for k, v in py.items()}
        maps.update({"sao_c_" + k: v.to(torch.int8) for k, v in pc.items()})
        return ry, rcb, rcr, maps

    def _frame_outputs(self, ry, rcb, rcr, lvl_y, lvl_cb, lvl_cr, src_y,
                       src_cb, src_cr, masks=None) -> dict:
        """SAO of the deblocked planes (when on), then the final planes
        (the frame's reference picture), levels, the decoded-picture
        checksum (summed in int64, reduced mod 2^32) and the SSE (int64).
        masks: the picture's hash masks (hash_mask_y, hash_mask_c), the
        pipeline's by default."""
        sao_maps = {}
        if self.sao:
            ry, rcb, rcr, sao_maps = self._sao(src_y, src_cb, src_cr, ry,
                                               rcb, rcr)
        masks = masks or self.c

        def cksum(plane, mask):
            p64 = plane.to(torch.int64)
            tot = ((p64 & 0xFF) ^ mask).sum()
            if self.bd > 8:
                tot = tot + ((p64 >> 8) ^ mask).sum()
            return tot & 0xFFFFFFFF

        def sse(a, b):
            d = (a - b).to(torch.int64)
            return (d * d).sum()

        pix = torch.uint8 if self.bd == 8 else torch.uint16
        return {**sao_maps,
            "rec_y": ry.to(pix),
            "rec_cb": rcb.to(pix),
            "rec_cr": rcr.to(pix),
            "levels_y": lvl_y.to(torch.int16),
            "levels_cb": lvl_cb.to(torch.int16),
            "levels_cr": lvl_cr.to(torch.int16),
            "hash": torch.stack([cksum(ry, masks["hash_mask_y"]),
                                 cksum(rcb, masks["hash_mask_c"]),
                                 cksum(rcr, masks["hash_mask_c"])]),
            "sse": torch.stack([sse(ry, src_y), sse(rcb, src_cb),
                                sse(rcr, src_cr)]),
        }

    @contextlib.contextmanager
    def _stacked(self, n: int):
        """Within the block, the pipeline's frame is n pictures of its
        shape stacked one above another: n times its height, the
        coding-order key m8 of that frame (each picture's cells after the
        picture above's, so their z order within a picture is unchanged)
        and the per-CTB QP maps repeated down it. The search and the
        wavefront treat each picture's first and last rows as picture
        edges. The pipeline's own shape and constants come back on exit.
        """
        if n == 1:
            yield
            return
        saved = self.h, self.r8, self.n_pics, self.c
        c = dict(self.c)
        c["m8"] = torch.from_numpy(_morton(n * self.r8, self.c8)) \
            .to(self.device)
        for key in ("qpmap_y", "qpmap_c", "lammap"):
            if key in c:
                c[key] = c[key].repeat(n, 1)
        self.h, self.r8, self.n_pics, self.c = n * self.h, n * self.r8, n, c
        try:
            yield
        finally:
            self.h, self.r8, self.n_pics, self.c = saved

    def _full_impl(self, srcs, masks=None) -> list[dict]:
        """The frame program over pictures srcs [(y, cb, cr)] of the
        pipeline's shape, stacked: one mode search and partition and one
        wavefront whose every wave holds the ready TUs of all of them,
        then each picture's tail (final QPs, deblocking, SAO, checksum,
        SSE) on its own. masks: one dict of hash masks a picture, or None.
        Returns one output dict a picture."""
        n = len(srcs)
        src_y, src_cb, src_cr = (torch.cat([f[i] for f in srcs]).to(I32)
                                 for i in range(3))
        with self._stacked(n):
            size_map8, mode_map8, mode_map4 = self._partition(
                src_y, src_cb, src_cr)
            ts8 = (torch.zeros((self.r8, self.c8, 6), dtype=torch.int8,
                               device=self.device) if self.trskip else None)
            luma, chroma, _, n_waves = self._recon_md(
                src_y, src_cb, src_cr, size_map8, mode_map8,
                mode_map4=mode_map4, ts8=ts8)
        h, hc, r8 = self.h, self.h // 2, self.r8
        outs = []
        for p in range(n):
            def rows(a, k):
                return a[p * k:(p + 1) * k]
            sm8 = rows(size_map8, r8)
            ry, rcb, rcr, lvl_y, lvl_cb, lvl_cr = self._unpack_planes(
                luma[:, p * h:], chroma[:, p * hc:])
            fq = (self._final_qp(lvl_y, lvl_cb, lvl_cr) if self.delta_qp
                  else None)
            if self.deblock:
                ry, rcb, rcr = self._deblock(ry, rcb, rcr,
                                             *self._edge_maps(sm8), fq)
            out = self._frame_outputs(
                ry, rcb, rcr, lvl_y, lvl_cb, lvl_cr, rows(src_y, h),
                rows(src_cb, hc), rows(src_cr, hc),
                None if masks is None else masks[p])
            out.update(size_map8=sm8.to(torch.int8),
                       mode_map8=rows(mode_map8, r8).to(torch.int8),
                       mode_map4=rows(mode_map4, 2 * r8).to(torch.int8),
                       n_waves=n_waves[p])
            if fq is not None:
                out["qp_ctb"] = fq.to(torch.int8)
            if ts8 is not None:
                out["ts8"] = rows(ts8, r8)
            outs.append(out)
        return outs

    # ------------------------------------------------------------------
    # host interface
    # ------------------------------------------------------------------

    def _to_dev(self, a) -> torch.Tensor:
        """A source plane on the device; 16-bit samples widen to int32 on
        the host (torch's uint16 arithmetic is thin)."""
        if isinstance(a, torch.Tensor):
            return a.to(self.device)
        a = np.ascontiguousarray(a)
        if a.dtype == np.uint16:
            a = a.astype(np.int32)
        return torch.from_numpy(a).to(self.device)

    @torch.inference_mode()
    def submit(self, src_y, src_cb, src_cr, qp: int | None = None,
               masks: dict | None = None, qp_map=None) -> dict:
        """Run the frame's device work; the result dict holds device
        tensors for materialize. The host waits only for the wavefront's
        periodic exit test. qp_map: the QP of each CTB (delta QP);
        masks: the picture's hash masks (hash_mask_y, hash_mask_c: a
        tile's at its offset in the picture), tensors on the pipeline's
        device, or None for the pipeline's."""
        consts = self._consts_for(qp)
        if qp_map is not None:
            if not self.delta_qp:
                raise ValueError("qp_map needs a delta_qp pipeline")
            consts = dict(consts)
            consts.update(consts_from_numpy(self.qp_map_arrays(qp_map),
                                            self.device))
        self.set_consts(consts)
        return self._full_impl([(self._to_dev(src_y), self._to_dev(src_cb),
                                 self._to_dev(src_cr))],
                               None if masks is None else [masks])[0]

    @torch.inference_mode()
    def submit_many(self, ys, cbs, crs, qp: int | None = None,
                    masks=None) -> list[dict]:
        """B pictures of the pipeline's shape (all-intra frames, or the
        tiles of a device's block) through one search and one wavefront
        at one QP; returns one result dict a picture, each equal to what
        submit returns for that picture alone. masks: one dict a picture
        of its hash masks, as submit's masks, or None for the
        pipeline's. Takes no QP map: under delta_qp every CTB has the
        frame's QP."""
        srcs = [tuple(self._to_dev(a) for a in f)
                for f in zip(ys, cbs, crs, strict=True)]
        want = [(self.h, self.w)] + [(self.h // 2, self.w // 2)] * 2
        for f in srcs:
            if [tuple(a.shape) for a in f] != want:
                raise ValueError("submit_many takes pictures of the "
                                 f"pipeline's shape {self.h}x{self.w}")
        if masks is not None and len(masks) != len(srcs):
            raise ValueError("submit_many takes one set of masks a picture")
        self.set_consts(self._consts_for(qp))
        return self._full_impl(srcs, masks)

    def materialize(self, out: dict) -> dict:
        """Pull the decisions the writers read to the host as numpy;
        the reconstructed planes stay on the device."""
        res = {}
        for k, v in out.items():
            if k in ("rec_y", "rec_cb", "rec_cr"):
                res[k] = v
            elif k.startswith("levels_"):
                res[k] = v.cpu().numpy().astype(np.int32)
            elif k == "n_waves":
                res[k] = int(v)
            else:
                res[k] = v.cpu().numpy()
        res["hash"] = res["hash"].astype(np.uint32)
        if "inter8" in res:
            res["inter8"] = res["inter8"].astype(bool)
            res["mv8"] = res["mv8"].astype(np.int32)
        if "mv8b" in res:
            res["mv8b"] = res["mv8b"].astype(np.int32)
        return res
