"""Tiled frame pipeline: HEVC tiles as independent per-tile runs of the
quadtree intra pipeline (counterpart of kvazaar_tpu/parallel/tiled.py).

Each tile runs the full multi-depth intra pipeline on its own rectangle.
The PPS signals loop_filter_across_tiles = 0 (as the reference does:
src/encoder_state-bitstream.c:545), so the per-tile deblocking and SAO
are exactly the normative in-loop filtering, and the device checksum
stays valid through per-tile hash masks at the tile's offset in the
picture (the HEVC checksum is a plain sum, so the tiles' sums add up).

Tiles of one shape share one pipeline (its per-QP constants); they run
one after another on the pipeline's device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..hevc.tiles import TileGrid
from ..models.intra_md import MdIntraPipeline, _hash_mask, consts_from_numpy


def tile_masks(grid: TileGrid, tid: int, ctb: int, device) -> dict:
    """The hash masks of tile tid at its offset in the picture, as the
    masks of its pipeline's submit."""
    x0, y0, tw, th = grid.rect(tid)
    h, w, py, px = th * ctb, tw * ctb, y0 * ctb, x0 * ctb
    return consts_from_numpy(
        {"hash_mask_y": _hash_mask(h, w, py, px),
         "hash_mask_c": _hash_mask(h // 2, w // 2, py // 2, px // 2)},
        device)


def tile_planes(grid: TileGrid, tid: int, ctb: int, y, cb, cr) -> tuple:
    """The source planes of tile tid (views of the frame's planes)."""
    x0, y0, tw, th = grid.rect(tid)
    ys, xs = slice(y0 * ctb, (y0 + th) * ctb), slice(x0 * ctb,
                                                     (x0 + tw) * ctb)
    ysc = slice(y0 * ctb // 2, (y0 + th) * ctb // 2)
    xsc = slice(x0 * ctb // 2, (x0 + tw) * ctb // 2)
    return y[ys, xs], cb[ysc, xsc], cr[ysc, xsc]


def tile_qp_map(grid: TileGrid, tid: int, qp_map):
    """The rows and columns of a per-CTB QP map that tile tid covers."""
    if qp_map is None:
        return None
    x0, y0, tw, th = grid.rect(tid)
    return np.asarray(qp_map)[y0:y0 + th, x0:x0 + tw]


def stitch(grid: TileGrid, tiles: list, device) -> dict:
    """One frame's decisions from the materialized decisions of its tiles
    (tile order): every per-sample and per-block map (reconstruction,
    levels, size_map8, mode_map8, mode_map4, qp_ctb, the SAO parameters)
    placed at its tile's offset, the checksums and SSEs summed, and the
    tiles' wave counts (`tile_waves`; `n_waves` their sum). The
    reconstructed planes land on `device`, the rest on the host."""
    rows, cols = grid.row_bd[-1], grid.col_bd[-1]
    res: dict = {}
    hash_sum = np.zeros(3, np.uint64)
    sse_sum = np.zeros(3, np.int64)
    for tid, d in enumerate(tiles):
        x0, y0, tw, th = grid.rect(tid)
        hash_sum += np.asarray(d["hash"]).astype(np.uint64)
        sse_sum += np.asarray(d["sse"]).astype(np.int64)
        for k, v in d.items():
            if k in ("hash", "sse", "n_waves"):
                continue
            # every map has its two spatial axes last, in units of a
            # fixed size per CTB (64 luma samples, 32 chroma, 16 for the
            # 4x4 modes, 8 for the 8x8 maps, 1 per CTB)
            uy, ux = v.shape[-2] // th, v.shape[-1] // tw
            if (uy, ux) != (v.shape[-2] / th, v.shape[-1] / tw) or uy != ux:
                raise ValueError(f"{k} of shape {tuple(v.shape)} is no "
                                 "per-tile map")
            if k not in res:
                shape = tuple(v.shape[:-2]) + (rows * uy, cols * ux)
                res[k] = (torch.zeros(shape, dtype=v.dtype, device=device)
                          if isinstance(v, torch.Tensor)
                          else np.zeros(shape, v.dtype))
            dst = res[k][..., y0 * uy:(y0 + th) * uy,
                         x0 * ux:(x0 + tw) * ux]
            if isinstance(v, torch.Tensor):
                dst.copy_(v.to(device))
            else:
                dst[...] = v
    res["hash"] = (hash_sum & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    res["sse"] = sse_sum
    res["tile_waves"] = [int(d.get("n_waves", 0)) for d in tiles]
    res["n_waves"] = sum(res["tile_waves"])
    return res


class TiledIntraPipeline:
    """submit/materialize-compatible wrapper that runs one MdIntraPipeline
    per tile rectangle (shared by the tiles of one shape) and stitches
    the frame's decisions."""

    def __init__(self, height: int, width: int, qp: int, grid: TileGrid,
                 ctb: int = 64, device="cuda", **pipe_kw) -> None:
        assert height == grid.row_bd[-1] * ctb
        assert width == grid.col_bd[-1] * ctb
        self.h, self.w, self.ctb = height, width, ctb
        self.device = torch.device(device)
        self.grid = grid
        self.pipes: dict[tuple[int, int], MdIntraPipeline] = {}
        self.masks = []
        for tid in range(grid.n_tiles):
            _, _, tw, th = grid.rect(tid)
            shape = (th * ctb, tw * ctb)
            if shape not in self.pipes:
                self.pipes[shape] = MdIntraPipeline(
                    shape[0], shape[1], qp, device=self.device, **pipe_kw)
            self.masks.append(tile_masks(grid, tid, ctb, self.device))

    def pipe_of(self, tid: int) -> MdIntraPipeline:
        _, _, tw, th = self.grid.rect(tid)
        return self.pipes[(th * self.ctb, tw * self.ctb)]

    def submit(self, src_y, src_cb, src_cr, qp: int | None = None,
               qp_map=None) -> list:
        """Run every tile's device work, one tile after another; returns
        the tiles' pending results."""
        return [self.pipe_of(tid).submit(
            *tile_planes(self.grid, tid, self.ctb, src_y, src_cb, src_cr),
            qp=qp, masks=self.masks[tid],
            qp_map=tile_qp_map(self.grid, tid, qp_map))
            for tid in range(self.grid.n_tiles)]

    def materialize(self, outs: list) -> dict:
        return stitch(self.grid, [self.pipe_of(t).materialize(o)
                                  for t, o in enumerate(outs)], self.device)
