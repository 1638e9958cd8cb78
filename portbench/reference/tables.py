"""HEVC constant tables for the benchmark's reference decoder, written
from ITU-T H.265 (the clause or table of each is named beside it), not
from the program under test: typed where the specification lists the
numbers, derived where it defines them (the scans, the transform
matrices of every size from the 32-point one, the CABAC engine's
renormalisation shifts). portbench/tests/test_portbench_spec_tables.py
holds them to the specification's properties.
"""
from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# CABAC engine (9.3.4.3.2): rangeTabLps[pStateIdx][qRangeIdx] (Table 9-46)
# and transIdxLps (Table 9-47); transIdxMps is pStateIdx + 1 up to 62.
# ---------------------------------------------------------------------------

LPS_TABLE = np.array([
    [128, 176, 208, 240], [128, 167, 197, 227], [128, 158, 187, 216],
    [123, 150, 178, 205], [116, 142, 169, 195], [111, 135, 160, 185],
    [105, 128, 152, 175], [100, 122, 144, 166], [95, 116, 137, 158],
    [90, 110, 130, 150], [85, 104, 123, 142], [81, 99, 117, 135],
    [77, 94, 111, 128], [73, 89, 105, 122], [69, 85, 100, 116],
    [66, 80, 95, 110], [62, 76, 90, 104], [59, 72, 86, 99],
    [56, 69, 81, 94], [53, 65, 77, 89], [51, 62, 73, 85],
    [48, 59, 69, 80], [46, 56, 66, 76], [43, 53, 63, 72],
    [41, 50, 59, 69], [39, 48, 56, 65], [37, 45, 54, 62],
    [35, 43, 51, 59], [33, 41, 48, 56], [32, 39, 46, 53],
    [30, 37, 43, 50], [29, 35, 41, 48], [27, 33, 39, 45],
    [26, 31, 37, 43], [24, 30, 35, 41], [23, 28, 33, 39],
    [22, 27, 32, 37], [21, 26, 30, 35], [20, 24, 29, 33],
    [19, 23, 27, 31], [18, 22, 26, 30], [17, 21, 25, 28],
    [16, 20, 23, 27], [15, 19, 22, 25], [14, 18, 21, 24],
    [14, 17, 20, 23], [13, 16, 19, 22], [12, 15, 18, 21],
    [12, 14, 17, 20], [11, 14, 16, 19], [11, 13, 15, 18],
    [10, 12, 15, 17], [10, 12, 14, 16], [9, 11, 13, 15],
    [9, 11, 12, 14], [8, 10, 12, 14], [8, 9, 11, 13],
    [7, 9, 11, 12], [7, 9, 10, 12], [7, 8, 10, 11],
    [6, 8, 9, 11], [6, 7, 9, 10], [6, 7, 8, 9],
    [2, 2, 2, 2]], dtype=np.int32)

TRANS_LPS = np.array([
    0, 0, 1, 2, 2, 4, 4, 5, 6, 7, 8, 9, 9, 11, 11, 12,
    13, 13, 15, 15, 16, 16, 18, 18, 19, 19, 21, 21, 22, 22, 23, 24,
    24, 25, 26, 26, 27, 27, 28, 29, 29, 30, 30, 30, 31, 32, 32, 33,
    33, 33, 34, 34, 35, 35, 35, 36, 36, 36, 37, 37, 37, 38, 38, 63],
    dtype=np.int32)

TRANS_MPS = np.array([min(s + 1, 62) for s in range(63)] + [63],
                     dtype=np.int32)

# renormalisation (9.3.4.3.3) after an LPS: the shifts that bring a range
# of 8 * i .. 8 * i + 7 (the least LPS range being 6) to 256 or more
RENORM_TABLE = np.array([9 - max(8 * i, 6).bit_length() for i in range(32)],
                        dtype=np.int32)


def context_init_state(init_value: int, qp: int) -> tuple[int, int]:
    """(pStateIdx, valMps) of an initValue at SliceQpY (9.3.2.2)."""
    slope = (init_value >> 4) * 5 - 45
    offset = ((init_value & 15) << 3) - 16
    pre = min(max(1, ((slope * min(max(0, qp), 51)) >> 4) + offset), 126)
    if pre <= 63:
        return 63 - pre, 0
    return pre - 64, 1


# ---------------------------------------------------------------------------
# initValue of every context (9.3.2.2, Tables 9-5 to 9-37), as the
# specification lists them: ctxIdx ascending, initType 0 (I), 1 (P),
# 2 (B) one after another. A syntax element that I slices do not code
# has no initType 0 contexts; it gets the unused value 154 there so that
# every element has one row of the same length an initType.
# ---------------------------------------------------------------------------

CNU = 154

_SPEC_INIT = {
    # name: (contexts an initType, initType 0 coded?, the listed values)
    "sao_merge_flag": (1, True, [153, 153, 153]),
    "sao_type_idx": (1, True, [200, 185, 160]),
    "split_cu_flag": (3, True, [139, 141, 157, 107, 139, 126,
                                107, 139, 126]),
    "cu_transquant_bypass_flag": (1, True, [154, 154, 154]),
    "cu_skip_flag": (3, False, [197, 185, 201, 197, 185, 201]),
    "pred_mode_flag": (1, False, [149, 134]),
    # part_mode: one context in I slices, four in P and B
    "part_mode": (4, None, [184, 154, 139, 154, 154, 154, 139, 154, 154]),
    "prev_intra_luma_pred_flag": (1, True, [184, 154, 183]),
    "intra_chroma_pred_mode": (1, True, [63, 152, 152]),
    "rqt_root_cbf": (1, False, [79, 79]),
    "merge_flag": (1, False, [110, 154]),
    "merge_idx": (1, False, [122, 137]),
    "inter_pred_idc": (5, False, [95, 79, 63, 31, 31, 95, 79, 63, 31, 31]),
    "ref_idx": (2, False, [153, 153, 153, 153]),
    # abs_mvd_greater0_flag then abs_mvd_greater1_flag, an initType each
    "mvd": (2, False, [140, 198, 169, 198]),
    "mvp_flag": (1, False, [168, 168]),
    "split_transform_flag": (3, True, [153, 138, 138, 124, 138, 94,
                                       224, 167, 122]),
    "cbf_luma": (2, True, [111, 141, 153, 111, 153, 111]),
    "cbf_chroma": (5, True, [94, 138, 182, 154, 154,
                             149, 107, 167, 154, 154,
                             149, 92, 167, 154, 154]),
    "cu_qp_delta_abs": (3, True, [154] * 9),
    "chroma_qp_offset_flag": (1, True, [154, 154, 154]),
    "chroma_qp_offset_idx": (1, True, [154, 154, 154]),
    # last_sig_coeff_x_prefix and _y_prefix: 15 luma then 3 chroma
    "last_sig_x": (18, True, [
        110, 110, 124, 125, 140, 153, 125, 127, 140, 109, 111, 143, 127,
        111, 79, 108, 123, 63,
        125, 110, 94, 110, 95, 79, 125, 111, 110, 78, 110, 111, 111,
        95, 94, 108, 123, 108,
        125, 110, 124, 110, 95, 94, 125, 111, 111, 79, 125, 126, 111,
        111, 79, 108, 123, 93]),
    "last_sig_y": (18, True, [
        110, 110, 124, 125, 140, 153, 125, 127, 140, 109, 111, 143, 127,
        111, 79, 108, 123, 63,
        125, 110, 94, 110, 95, 79, 125, 111, 110, 78, 110, 111, 111,
        95, 94, 108, 123, 108,
        125, 110, 124, 110, 95, 94, 125, 111, 111, 79, 125, 126, 111,
        111, 79, 108, 123, 93]),
    # coded_sub_block_flag: 2 luma then 2 chroma
    "coded_sub_block_flag": (4, True, [91, 171, 134, 141, 121, 140, 61, 154,
                                       121, 140, 61, 154]),
    # sig_coeff_flag: 27 luma then 15 chroma
    "sig_coeff_flag": (42, True, [
        111, 111, 125, 110, 110, 94, 124, 108, 124, 107, 125, 141, 179,
        153, 125, 107, 125, 141, 179, 153, 125, 107, 125, 141, 179, 153,
        125, 140, 139, 182, 182, 152, 136, 152, 136, 153, 136, 139, 111,
        136, 139, 111,
        155, 154, 139, 153, 139, 123, 123, 63, 153, 166, 183, 140, 136,
        153, 154, 166, 183, 140, 136, 153, 154, 166, 183, 140, 136, 153,
        154, 170, 153, 123, 123, 107, 121, 107, 121, 167, 151, 183, 140,
        151, 183, 140,
        170, 154, 139, 153, 139, 123, 123, 63, 124, 166, 183, 140, 136,
        153, 154, 166, 183, 140, 136, 153, 154, 166, 183, 140, 136, 153,
        154, 170, 153, 138, 138, 122, 121, 122, 121, 167, 151, 183, 140,
        151, 183, 140]),
    # coeff_abs_level_greater1_flag: 16 luma then 8 chroma
    "coeff_abs_level_greater1_flag": (24, True, [
        140, 92, 137, 138, 140, 152, 138, 139, 153, 74, 149, 92, 139, 107,
        122, 152, 140, 179, 166, 182, 140, 227, 122, 197,
        154, 196, 196, 167, 154, 152, 167, 182, 182, 134, 149, 136, 153,
        121, 136, 137, 169, 194, 166, 167, 154, 167, 137, 182,
        154, 196, 167, 167, 154, 152, 167, 182, 182, 134, 149, 136, 153,
        121, 136, 122, 169, 208, 166, 167, 154, 152, 167, 182]),
    # coeff_abs_level_greater2_flag: 4 luma then 2 chroma
    "coeff_abs_level_greater2_flag": (6, True, [
        138, 153, 136, 167, 152, 152, 107, 167, 91, 122, 107, 167,
        107, 167, 91, 107, 107, 167]),
    "transform_skip_flag": (2, True, [139, 139, 139, 139, 139, 139]),
}


def _rows(n: int, in_i, values: list[int]) -> list[list[int]]:
    """The listed values as three rows of n, initType 0 to 2."""
    if in_i is None:            # part_mode: one I context, then n a type
        return [values[:1] + [CNU] * (n - 1), values[1:1 + n],
                values[1 + n:1 + 2 * n]]
    if not in_i:
        values = [CNU] * n + values
    if len(values) != 3 * n:
        raise ValueError(f"{len(values)} initValues for {n} contexts")
    return [values[k * n:(k + 1) * n] for k in range(3)]


CONTEXT_INIT = {k: _rows(*v) for k, v in _SPEC_INIT.items()}

# ---------------------------------------------------------------------------
# Scans (6.5.3 up-right diagonal, 6.5.4 horizontal, 6.5.5 vertical), as
# (x, y) in scan order; blocks above 4x4 scan their 4x4 sub-blocks in the
# same order and the samples of each sub-block in it (7.3.8.11).
# ---------------------------------------------------------------------------

SCAN_DIAG, SCAN_HOR, SCAN_VER = 0, 1, 2


def _diag_scan(blk: int) -> np.ndarray:
    """6.5.3: from (0, 0), each anti-diagonal from its bottom-left end up
    to the right, the positions inside the block kept."""
    out = []
    x = y = 0
    while len(out) < blk * blk:
        while y >= 0:
            if x < blk and y < blk:
                out.append((x, y))
            y -= 1
            x += 1
        y, x = x, 0
    return np.array(out, dtype=np.int32)


def _hor_scan(blk: int) -> np.ndarray:
    """6.5.4: row by row, left to right."""
    return np.array([(x, y) for y in range(blk) for x in range(blk)],
                    dtype=np.int32)


def _ver_scan(blk: int) -> np.ndarray:
    """6.5.5: column by column, top to bottom."""
    return np.array([(x, y) for x in range(blk) for y in range(blk)],
                    dtype=np.int32)


_SCANS = {SCAN_DIAG: _diag_scan, SCAN_HOR: _hor_scan, SCAN_VER: _ver_scan}
_SCAN_CACHE: dict = {}


def get_cg_scan(scan_idx: int, log2_size: int) -> np.ndarray:
    """ScanOrder[log2TrafoSize - 2][scanIdx]: the 4x4 sub-blocks' order."""
    if log2_size <= 2:
        return np.zeros((1, 2), dtype=np.int32)
    key = ("cg", scan_idx, log2_size)
    if key not in _SCAN_CACHE:
        _SCAN_CACHE[key] = _SCANS[scan_idx](1 << (log2_size - 2))
    return _SCAN_CACHE[key]


def get_scan(scan_idx: int, log2_size: int) -> np.ndarray:
    """Every coefficient of a TU in coding order: (N*N, 2) of (x, y)."""
    key = ("tu", scan_idx, log2_size)
    if key not in _SCAN_CACHE:
        inner = _SCANS[scan_idx](4)
        if log2_size <= 2:
            out = inner
        else:
            out = np.concatenate([inner + 4 * sb for sb in
                                  get_cg_scan(scan_idx, log2_size)])
        _SCAN_CACHE[key] = out.astype(np.int32)
    return _SCAN_CACHE[key]


def scan_order(scan_idx: int, log2_size: int) -> np.ndarray:
    return get_scan(scan_idx, log2_size)


# ctxIdxMap of sig_coeff_flag in 4x4 TUs (9.3.4.2.5, Table 9-41), indexed
# by (yC << 2) + xC; position 15 is never coded
SIG_CTX_MAP_4X4 = np.array([0, 1, 4, 5, 2, 3, 4, 5, 6, 6, 8, 8, 7, 7, 8],
                           dtype=np.int32)


def intra_mode_scan_idx(pred_mode: int, log2_size: int,
                        is_chroma: bool) -> int:
    """scanIdx of an intra TU (7.4.9.11): vertical for modes 6 to 14 and
    horizontal for 22 to 30 in 4x4 TUs and 8x8 luma TUs (4:2:0)."""
    if log2_size == 2 or (log2_size == 3 and not is_chroma):
        if 6 <= pred_mode <= 14:
            return SCAN_VER
        if 22 <= pred_mode <= 30:
            return SCAN_HOR
    return SCAN_DIAG


# ---------------------------------------------------------------------------
# Transforms (8.6.4.2). transMatrix is 32x32; its column 0 lists, row by
# row, the coefficients c[k] ~ 64 * sqrt(2) * cos(k * pi / 64) (c[0] = 64),
# and every entry is the c of its angle (2n + 1) * m * pi / 64 with the
# cosine's sign. An nTbS-point transform takes rows 0, 32 / nTbS, ... and
# its first nTbS columns.
# ---------------------------------------------------------------------------

TRANS_MATRIX_COL0 = [64, 90, 90, 90, 89, 88, 87, 85, 83, 82, 80, 78, 75, 73,
                     70, 67, 64, 61, 57, 54, 50, 46, 43, 38, 36, 31, 25, 22,
                     18, 13, 9, 4]


def _trans_matrix() -> np.ndarray:
    c = TRANS_MATRIX_COL0
    m = np.zeros((32, 32), dtype=np.int32)
    for row in range(32):
        for col in range(32):
            a = (2 * col + 1) * row % 128        # angle in pi / 64
            if a <= 32:
                v = c[a] if a < 32 else 0
            elif a <= 64:
                v = -c[64 - a]
            elif a < 96:
                v = -c[a - 64]
            else:
                v = c[128 - a]
            m[row, col] = v
    return m


TRANS_MATRIX = _trans_matrix()
DCT_MATRICES = {n: TRANS_MATRIX[::32 // n, :n].copy() for n in (4, 8, 16, 32)}

# the 4x4 DST-VII of intra 4x4 luma TUs (8.6.4.2, trType 1)
DST4 = np.array([[29, 55, 74, 84],
                 [74, 74, 0, -74],
                 [84, -29, -74, 55],
                 [55, -84, 74, -29]], dtype=np.int32)

# levelScale (8.6.3)
INV_QUANT_SCALES = np.array([40, 45, 51, 57, 64, 72], dtype=np.int64)

# QpC of qPi for 4:2:0 (Table 8-10): qPi below 30 maps to itself, above
# 43 to qPi - 6
_QPC = {30: 29, 31: 30, 32: 31, 33: 32, 34: 33, 35: 33, 36: 34, 37: 34,
        38: 35, 39: 35, 40: 36, 41: 36, 42: 37, 43: 37}


def chroma_qp(qp_y: int, offset: int = 0) -> int:
    q = min(max(qp_y + offset, 0), 57)
    if q < 30:
        return q
    if q > 43:
        return q - 6
    return _QPC[q]


# ---------------------------------------------------------------------------
# Intra angles: intraPredAngle of modes 2..34 (Table 8-5) and invAngle of
# modes 11..25 (Table 8-6).
# ---------------------------------------------------------------------------

INTRA_PRED_ANGLE = np.array([
    32, 26, 21, 17, 13, 9, 5, 2, 0, -2, -5, -9, -13, -17, -21, -26, -32,
    -26, -21, -17, -13, -9, -5, -2, 0, 2, 5, 9, 13, 17, 21, 26, 32],
    dtype=np.int32)

INV_ANGLE = np.array([-4096, -1638, -910, -630, -482, -390, -315, -256,
                      -315, -390, -482, -630, -910, -1638, -4096],
                     dtype=np.int32)


def intra_pred_angle(mode: int) -> int:
    return int(INTRA_PRED_ANGLE[mode - 2])


def intra_inv_angle(mode: int) -> int:
    """|invAngle| of a mode with a negative angle (11 to 25)."""
    return -int(INV_ANGLE[mode - 11])
