"""Scaling lists (quantization matrices): spec 7.3.4 / 7.4.5 / 8.6.3.

Reference parity: kvazaar src/scalinglist.c (default matrices
:46-76, list selection :268-281, per-QP quant/dequant table build) —
here the normative dequant uses m directly and the encoder-side forward
tables are derived as (quant_scale * 16) / m like the reference.
"""
from __future__ import annotations

import numpy as np

from ..tables import SCAN_DIAG, scan_order

# default matrices, raster order (kvazaar scalinglist.c:46-76)
DEFAULT_4x4 = np.full((4, 4), 16, np.int32)
DEFAULT_INTRA_8x8 = np.array([
    16, 16, 16, 16, 17, 18, 21, 24,
    16, 16, 16, 16, 17, 19, 22, 25,
    16, 16, 17, 18, 20, 22, 25, 29,
    16, 16, 18, 21, 24, 27, 31, 36,
    17, 17, 20, 24, 30, 35, 41, 47,
    18, 19, 22, 27, 35, 44, 54, 65,
    21, 22, 25, 31, 41, 54, 70, 88,
    24, 25, 29, 36, 47, 65, 88, 115], np.int32).reshape(8, 8)
DEFAULT_INTER_8x8 = np.array([
    16, 16, 16, 16, 17, 18, 20, 24,
    16, 16, 16, 17, 18, 20, 24, 25,
    16, 16, 17, 18, 20, 24, 25, 28,
    16, 17, 18, 20, 24, 25, 28, 33,
    17, 18, 20, 24, 25, 28, 33, 41,
    18, 20, 24, 25, 28, 33, 41, 54,
    20, 24, 25, 28, 33, 41, 54, 71,
    24, 25, 28, 33, 41, 54, 71, 91], np.int32).reshape(8, 8)

def matrix_ids(size_id: int):
    """matrixId values per sizeId: 0..5, except 32x32 where the syntax
    steps by 3 (ids 0 = intra luma, 3 = inter luma)."""
    return (0, 3) if size_id == 3 else tuple(range(6))


def default_list(size_id: int, matrix_id: int) -> np.ndarray:
    """Raw default list (4x4 or 8x8 base grid, raster)."""
    if size_id == 0:
        return DEFAULT_4x4.copy()
    return (DEFAULT_INTRA_8x8 if matrix_id < 3
            else DEFAULT_INTER_8x8).copy()


class ScalingLists:
    """Resolved per-(sizeId, matrixId) base lists + DC values."""

    def __init__(self) -> None:
        self.lists = {}   # (size_id, matrix_id) -> base grid [4x4|8x8]
        self.dc = {}      # (size_id, matrix_id) -> DC (sizeId >= 2)
        for s in range(4):
            for m in matrix_ids(s):
                self.lists[(s, m)] = default_list(s, m)
                if s >= 2:
                    self.dc[(s, m)] = 16

    def matrix(self, n: int, matrix_id: int) -> np.ndarray:
        """Expanded m[y][x] for an n x n TU (spec 8.6.3 upsampling)."""
        size_id = {4: 0, 8: 1, 16: 2, 32: 3}[n]
        base = self.lists[(size_id, matrix_id)]
        if size_id <= 1:
            return base
        k = n // 8
        m = np.repeat(np.repeat(base, k, 0), k, 1)
        m[0, 0] = self.dc[(size_id, matrix_id)]
        return m


def parse_scaling_list_data(br) -> ScalingLists:
    """scaling_list_data() (spec 7.3.4)."""
    out = ScalingLists()
    for size_id in range(4):
        for m_id in matrix_ids(size_id):
            pred = br.u(1)
            if not pred:
                delta = br.ue()
                if delta:
                    ref = m_id - delta * (3 if size_id == 3 else 1)
                    out.lists[(size_id, m_id)] = \
                        out.lists[(size_id, ref)].copy()
                    if size_id >= 2:
                        out.dc[(size_id, m_id)] = out.dc[(size_id, ref)]
                # delta == 0 -> default (already filled)
            else:
                coef_num = min(64, 1 << (4 + (size_id << 1)))
                next_coef = 8
                if size_id >= 2:
                    next_coef = 8 + br.se()
                    out.dc[(size_id, m_id)] = next_coef
                log2 = 2 if size_id == 0 else 3
                xy = scan_order(SCAN_DIAG, log2)
                grid = np.zeros((1 << log2, 1 << log2), np.int32)
                for i in range(coef_num):
                    next_coef = (next_coef + br.se() + 256) % 256
                    x, y = xy[i]
                    grid[y, x] = next_coef
                out.lists[(size_id, m_id)] = grid
    return out
