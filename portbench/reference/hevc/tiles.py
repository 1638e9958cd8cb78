"""Tile geometry (H.265 6.5.1, eqs 6-3..6-7).

Shared by encoder and decoder. Mirrors the reference's geometry setup
(kvazaar src/encoder.c:337-624: colWidth/rowHeight/colBd/rowBd and the
ctb-addr raster<->tile-scan maps) as one small class over numpy maps.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


def uniform_split(n_ctbs: int, n_tiles: int) -> list[int]:
    """colWidth[i] for uniform_spacing_flag=1 (eq 6-3/6-4)."""
    return [((i + 1) * n_ctbs) // n_tiles - (i * n_ctbs) // n_tiles
            for i in range(n_tiles)]


@dataclass
class TileGrid:
    """Geometry of a tile grid over a CTB raster of w_ctbs x h_ctbs."""

    w_ctbs: int
    h_ctbs: int
    col_widths: list[int]   # CTBs per tile column, sums to w_ctbs
    row_heights: list[int]  # CTBs per tile row, sums to h_ctbs
    col_bd: list[int] = field(init=False)
    row_bd: list[int] = field(init=False)

    def __post_init__(self) -> None:
        assert sum(self.col_widths) == self.w_ctbs
        assert sum(self.row_heights) == self.h_ctbs
        assert all(w > 0 for w in self.col_widths + self.row_heights)
        self.col_bd = np.cumsum([0] + list(self.col_widths)).tolist()
        self.row_bd = np.cumsum([0] + list(self.row_heights)).tolist()
        self.n_cols = len(self.col_widths)
        self.n_rows = len(self.row_heights)
        self.n_tiles = self.n_cols * self.n_rows
        # per-CTB tile id (raster layout)
        cid = np.repeat(np.arange(self.n_cols), self.col_widths)
        rid = np.repeat(np.arange(self.n_rows), self.row_heights)
        self.tile_id_ctb = (rid[:, None] * self.n_cols
                            + cid[None, :]).astype(np.int32)

    @classmethod
    def make(cls, w_ctbs: int, h_ctbs: int, n_cols: int, n_rows: int,
             uniform: bool = True,
             col_widths: list[int] | None = None,
             row_heights: list[int] | None = None) -> "TileGrid":
        if uniform:
            cw = uniform_split(w_ctbs, n_cols)
            rh = uniform_split(h_ctbs, n_rows)
        else:
            cw = list(col_widths)
            rh = list(row_heights)
            # the PPS carries all but the last entry; infer the remainder
            if len(cw) == n_cols - 1:
                cw.append(w_ctbs - sum(cw))
            if len(rh) == n_rows - 1:
                rh.append(h_ctbs - sum(rh))
        return cls(w_ctbs, h_ctbs, cw, rh)

    @classmethod
    def from_pps(cls, pps, w_ctbs: int, h_ctbs: int) -> "TileGrid":
        return cls.make(w_ctbs, h_ctbs, pps.num_tile_columns,
                        pps.num_tile_rows, bool(pps.uniform_spacing),
                        pps.column_widths, pps.row_heights)

    def rect(self, tid: int) -> tuple[int, int, int, int]:
        """(x0, y0, w, h) of tile `tid` in CTBs."""
        r, c = divmod(tid, self.n_cols)
        return (self.col_bd[c], self.row_bd[r],
                self.col_widths[c], self.row_heights[r])

    def scan(self):
        """All CTB coords (ctu_x, ctu_y) in tile-scan order, annotated
        with (tile_id, is_last_in_tile)."""
        for tid in range(self.n_tiles):
            x0, y0, w, h = self.rect(tid)
            n = w * h
            i = 0
            for yy in range(y0, y0 + h):
                for xx in range(x0, x0 + w):
                    i += 1
                    yield xx, yy, tid, i == n

    def tile4_map(self, ctb_size: int) -> np.ndarray:
        """Per-4x4-luma-block tile id map [H/4, W/4]."""
        s = ctb_size // 4
        return np.repeat(np.repeat(self.tile_id_ctb, s, axis=0), s, axis=1)
