"""residual_coding() syntax — CABAC encode and decode (spec 7.3.8.11, 9.3.4.2).

Host-side entropy layer: the encoder consumes quantized coefficient blocks
(computed batched on device) and emits bins; the decoder mirrors it for
validation.

Reference parity: kvazaar src/encode_coding_tree.c (kvz_encode_coeff_nxn at
src/strategies/generic/encode_coding_tree-generic.c, last-significant-xy at
encode_coding_tree.c:63) and src/rdo.c for the same context derivations.
"""
from __future__ import annotations

import numpy as np

from ..cabac import CabacDecoder, ContextSet
from ..tables import SCAN_VER, SIG_CTX_MAP_4X4, get_cg_scan, get_scan

# last significant coefficient position binarization tables
GROUP_IDX = [0, 1, 2, 3, 4, 4, 5, 5, 6, 6, 6, 6, 7, 7, 7, 7,
             8, 8, 8, 8, 8, 8, 8, 8, 9, 9, 9, 9, 9, 9, 9, 9]
MIN_IN_GROUP = [0, 1, 2, 3, 4, 6, 8, 12, 16, 24]


def _last_ctx_params(log2_size: int, is_chroma: bool) -> tuple[int, int]:
    if is_chroma:
        return 15, log2_size - 2
    return 3 * (log2_size - 2) + ((log2_size - 1) >> 2), \
        (log2_size + 1) >> 2


def _sig_ctx(x: int, y: int, log2_size: int, c_idx: int, scan_idx: int,
             csbf_right: int, csbf_below: int) -> int:
    """sig_coeff_flag context increment (spec 9.3.4.2.5)."""
    if log2_size == 2:
        sig = int(SIG_CTX_MAP_4X4[(y << 2) + x])
    elif x + y == 0:
        sig = 0
    else:
        xp, yp = x & 3, y & 3
        prev = csbf_right + 2 * csbf_below
        if prev == 0:
            sig = 2 if xp + yp == 0 else (1 if xp + yp < 3 else 0)
        elif prev == 1:
            sig = 2 if yp == 0 else (1 if yp == 1 else 0)
        elif prev == 2:
            sig = 2 if xp == 0 else (1 if xp == 1 else 0)
        else:
            sig = 2
        if c_idx == 0:
            if (x >> 2) + (y >> 2) > 0:
                sig += 3
            sig += (9 if scan_idx == 0 else 15) if log2_size == 3 else 21
        else:
            sig += 9 if log2_size == 3 else 12
    return sig + (27 if c_idx else 0)


def decode_last_position(cab: CabacDecoder, log2_size: int, c_idx: int,
                         scan_idx: int) -> tuple[int, int]:
    is_chroma = c_idx > 0
    offset, shift = _last_ctx_params(log2_size, is_chroma)
    cmax = (log2_size << 1) - 1
    base_x = ContextSet.idx("last_sig_x", 0)
    base_y = ContextSet.idx("last_sig_y", 0)
    if is_chroma:
        base_x += 15
        base_y += 15
        offset = 0
        shift = log2_size - 2
    gx = 0
    while gx < cmax and cab.decode_bin(base_x + offset + (gx >> shift)):
        gx += 1
    gy = 0
    while gy < cmax and cab.decode_bin(base_y + offset + (gy >> shift)):
        gy += 1
    if gx > 3:
        x = MIN_IN_GROUP[gx] + cab.decode_bins_ep((gx - 2) >> 1)
    else:
        x = gx
    if gy > 3:
        y = MIN_IN_GROUP[gy] + cab.decode_bins_ep((gy - 2) >> 1)
    else:
        y = gy
    if scan_idx == SCAN_VER:
        x, y = y, x
    return x, y


def _read_remaining(cab: CabacDecoder, rice: int, base_level: int,
                    crypto) -> int:
    """Inverse of _write_remaining: decrypts the rice-suffix window."""
    if crypto is None or rice == 0:
        return cab.decode_remaining_golomb(rice)
    from ..extras import crypto as _cr
    hdl, feats = crypto
    if not feats & _cr.CRYPTO_TRANSF_COEFFS:
        return cab.decode_remaining_golomb(rice)
    prefix = 0
    while prefix < 32 and cab.decode_bin_ep():
        prefix += 1
    if prefix < 3:
        hi = prefix << rice
        recv = cab.decode_bins_ep(rice)
        return hi | _cr.decrypt_golomb_suffix(hdl, recv, rice,
                                              base_level + hi)
    # escape path (never encrypted)
    length = prefix - 3 + rice
    return ((((1 << (prefix - 3)) + 3 - 1) << rice)
            + cab.decode_bins_ep(length))


def decode_residual(cab: CabacDecoder, log2_size: int, c_idx: int,
                    scan_idx: int, sign_hiding: bool,
                    transform_skip_enabled: bool = False,
                    crypto=None) -> tuple[np.ndarray, bool]:
    """Decode one TU's coefficients. Returns (coeffs [y][x], transform_skip).

    crypto: optional (CryptoHandle, features) — inverts the selective
    encryption applied by encode_residual. Defaults to the CABAC
    engine's ``crypto_res`` attribute."""
    if crypto is None:
        crypto = getattr(cab, "crypto_res", None)
    size = 1 << log2_size
    transform_skip = False
    if transform_skip_enabled and log2_size == 2:
        transform_skip = bool(cab.decode_bin(
            ContextSet.idx("transform_skip_flag", 1 if c_idx else 0)))
    lx, ly = decode_last_position(cab, log2_size, c_idx, scan_idx)
    scan = get_scan(scan_idx, log2_size)
    # map (x,y) -> scan pos
    pos_of = np.zeros((size, size), dtype=np.int32)
    pos_of[scan[:, 1], scan[:, 0]] = np.arange(size * size)
    last_scan_pos = int(pos_of[ly, lx])
    flat = np.zeros(size * size, dtype=np.int32)

    n_cgs = max(1, (size * size) >> 4)
    last_cg = last_scan_pos >> 4
    cg_scan = get_cg_scan(scan_idx, log2_size)
    width_cg = max(1, size >> 2)
    csbf_map = np.zeros((width_cg, width_cg), dtype=np.int32)

    c1 = 1
    sig_base = ContextSet.idx("sig_coeff_flag", 0)
    csbf_base = ContextSet.idx("coded_sub_block_flag", 0)
    g1_base = ContextSet.idx("coeff_abs_level_greater1_flag", 0)
    g2_base = ContextSet.idx("coeff_abs_level_greater2_flag", 0)

    for cg in range(last_cg, -1, -1):
        cgx, cgy = int(cg_scan[cg, 0]), int(cg_scan[cg, 1])
        infer_sb_dc = 0
        if cg == last_cg or cg == 0:
            cur_csbf = 1
        else:
            right = int(csbf_map[cgy, cgx + 1]) if cgx + 1 < width_cg else 0
            below = int(csbf_map[cgy + 1, cgx]) if cgy + 1 < width_cg else 0
            ctx = csbf_base + (1 if (right or below) else 0) + \
                (2 if c_idx else 0)
            cur_csbf = cab.decode_bin(ctx)
            infer_sb_dc = 1
        csbf_map[cgy, cgx] = cur_csbf
        if not cur_csbf:
            continue
        sub_pos = cg << 4
        right = int(csbf_map[cgy, cgx + 1]) if cgx + 1 < width_cg else 0
        below = int(csbf_map[cgy + 1, cgx]) if cgy + 1 < width_cg else 0
        sig_positions = []
        num_nz = 0
        if cg == last_cg:
            sig_positions.append(last_scan_pos)
            num_nz = 1
            start = last_scan_pos - 1
        else:
            start = sub_pos + 15
        for pos in range(start, sub_pos - 1, -1):
            if pos == sub_pos and infer_sb_dc and num_nz == 0:
                sig_positions.append(pos)
                continue
            x, y = int(scan[pos, 0]), int(scan[pos, 1])
            ctx = sig_base + _sig_ctx(x, y, log2_size, c_idx, scan_idx,
                                      right, below)
            if cab.decode_bin(ctx):
                sig_positions.append(pos)
                num_nz += 1
        if not sig_positions:
            continue  # CG0 is inferred coded but may contain no coefficients
        ctx_set = (2 if (cg > 0 and c_idx == 0) else 0)
        if c1 == 0:
            ctx_set += 1
        c1 = 1
        nsig = len(sig_positions)
        g1 = [0] * nsig
        first_g1_idx = -1
        for i in range(min(8, nsig)):
            ctx = g1_base + (16 if c_idx else 0) + ctx_set * 4 + c1
            g1[i] = cab.decode_bin(ctx)
            if g1[i]:
                c1 = 0
                if first_g1_idx == -1:
                    first_g1_idx = i
            elif 0 < c1 < 3:
                c1 += 1
        g2 = 0
        if first_g1_idx != -1:
            g2 = cab.decode_bin(g2_base + (4 if c_idx else 0) + ctx_set)
        first_sig = sig_positions[-1]
        last_sig = sig_positions[0]
        hide = sign_hiding and (last_sig - first_sig > 3)
        n_signs = nsig - 1 if hide else nsig
        if n_signs and crypto is not None:
            from ..extras import crypto as _cr
            hdl, feats = crypto
            pattern = cab.decode_bins_ep(n_signs)
            if feats & _cr.CRYPTO_TRANSF_COEFF_SIGNS:
                pattern = _cr.xor_bits(hdl, pattern, n_signs)
            signs = [(pattern >> (n_signs - 1 - i)) & 1
                     for i in range(n_signs)]
        else:
            signs = [cab.decode_bin_ep() for _ in range(n_signs)]
        # levels
        levels = [0] * nsig
        rice = 0
        first_coeff2 = 1
        for i in range(nsig):
            if i < 8:
                lev = 1 + g1[i] + (g2 if i == first_g1_idx else 0)
            else:
                lev = 1
            base_level = (2 + first_coeff2) if i < 8 else 1
            if lev >= base_level:
                lev = base_level + _read_remaining(cab, rice, base_level,
                                                   crypto)
                if lev > 3 * (1 << rice):
                    rice = min(rice + 1, 4)
            levels[i] = lev
            if lev >= 2:
                first_coeff2 = 0
        if hide:
            total = sum(levels)
            signs.append(1 if (total & 1) else 0)
        for i, pos in enumerate(sig_positions):
            flat[pos] = -levels[i] if signs[i] else levels[i]
    coeffs = np.zeros((size, size), dtype=np.int32)
    coeffs[scan[:, 1], scan[:, 0]] = flat
    return coeffs, transform_skip
