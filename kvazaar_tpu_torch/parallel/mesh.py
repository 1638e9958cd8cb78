"""Tile parallelism over several devices: the quadtree intra pipeline
(counterpart of kvazaar_tpu/parallel/mesh.py).

HEVC tiles are independent picture rectangles with no cross-tile
prediction or filtering (the PPS signals loop_filter_across_tiles = 0,
as the reference does: src/encoder_state-bitstream.c:545), so a uniform
grid of R rows x C columns of tiles maps onto an (mr, mc) grid of
devices with R % mr == C % mc == 0: each device codes its (R/mr) x
(C/mc) block of tiles with its own MdIntraPipeline (its constants on
that device), the tiles of a block in one batched call
(MdIntraPipeline.submit_many: one search and one wavefront for the
block, each tile with its own hash masks, as the reference vmaps its
per-tile program over the block). Distinct CUDA devices run their
blocks concurrently, one host thread a device; a device listed more
than once runs its blocks one after another in its one thread.

Each tile's decisions and planes equal those of TiledIntraPipeline
(parallel/tiled.py), which codes tile by tile, so the stream is
byte-identical to the one-device tiled stream. Reference parity:
kvazaar maps tiles to threads (src/encoderstate.c:944-979).
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext

import torch

from ..hevc.tiles import TileGrid
from ..models.intra_md import MdIntraPipeline
from .tiled import stitch, tile_masks, tile_planes


def grid_is_uniform(grid: TileGrid) -> bool:
    """True when every tile has the same CTB shape (mesh-mappable)."""
    return (len(set(grid.col_widths)) == 1
            and len(set(grid.row_heights)) == 1)


def mesh_shape_for(grid: TileGrid, n_devices: int) -> "tuple | None":
    """(mr, mc) device mesh for an (R, C) uniform tile grid, or None if
    no useful mapping exists. Prefers one tile per device; otherwise the
    largest mesh whose rows/cols divide the grid's."""
    rows, cols = len(grid.row_heights), len(grid.col_widths)
    best = None
    for mr in range(1, rows + 1):
        if rows % mr:
            continue
        for mc in range(1, cols + 1):
            if cols % mc or mr * mc > n_devices:
                continue
            if best is None or mr * mc > best[0] * best[1]:
                best = (mr, mc)
    if best is None or best == (1, 1):
        return None
    return best


class MeshTiledIntraPipeline:
    """TiledIntraPipeline-compatible encoder that gives each of the
    first mr * mc `devices` (torch devices; one may repeat) its block of
    tiles, and stitches the frame's decisions on devices[0]."""

    def __init__(self, devices, height: int, width: int, qp: int,
                 grid: TileGrid, ctb: int = 64, **pipe_kw) -> None:
        assert grid_is_uniform(grid)
        shape = mesh_shape_for(grid, len(devices))
        assert shape is not None, "no mesh mapping for this grid"
        if pipe_kw.get("delta_qp"):
            raise NotImplementedError(
                "delta-QP not supported on the mesh tile path")
        self.mr, self.mc = shape
        self.rows, self.cols = grid.n_rows, grid.n_cols
        self.h, self.w, self.ctb = height, width, ctb
        self.grid = grid
        self.th = grid.row_heights[0] * ctb
        self.tw = grid.col_widths[0] * ctb
        assert self.th * self.rows == height and self.tw * self.cols == width
        self.devices = [torch.device(d) for d in devices[:self.mr * self.mc]]
        # device of each tile: block (i, j) of the mesh is device
        # i * mc + j, and holds tile rows i*kr.. and columns j*kc..
        kr, kc = self.rows // self.mr, self.cols // self.mc
        self.tile_dev = [self.devices[(t // self.cols) // kr * self.mc
                                      + (t % self.cols) // kc]
                         for t in range(grid.n_tiles)]
        self.pipes: dict[torch.device, MdIntraPipeline] = {}
        for d in self.devices:
            if d not in self.pipes:
                self.pipes[d] = MdIntraPipeline(self.th, self.tw, qp,
                                                device=d, **pipe_kw)
        self.masks = [tile_masks(grid, t, ctb, self.tile_dev[t])
                      for t in range(grid.n_tiles)]
        # each device's tiles in block order (its blocks in mesh order,
        # row-major within a block), kr * kc tiles a block
        self.block = kr * kc
        self.work: dict[torch.device, list[int]] = {d: [] for d in self.pipes}
        for b, d in enumerate(self.devices):
            i, j = divmod(b, self.mc)
            self.work[d] += [r * self.cols + c
                             for r in range(i * kr, (i + 1) * kr)
                             for c in range(j * kc, (j + 1) * kc)]

    def _run_device(self, dev, tids, planes, qp) -> dict:
        """The device's blocks of tiles, one batched call a block."""
        pipe = self.pipes[dev]
        outs = {}
        with torch.cuda.device(dev) if dev.type == "cuda" else nullcontext():
            for b in range(0, len(tids), self.block):
                blk = tids[b:b + self.block]
                tiles = [tile_planes(self.grid, t, self.ctb, *planes)
                         for t in blk]
                outs.update(zip(blk, pipe.submit_many(
                    *zip(*tiles), qp=qp, masks=[self.masks[t] for t in blk])))
        return outs

    def submit(self, src_y, src_cb, src_cr, qp: int | None = None,
               qp_map=None) -> list:
        """Run every device's block of tiles (devices concurrently);
        returns the tiles' pending results in tile order."""
        assert qp_map is None
        planes = (src_y, src_cb, src_cr)
        if len(self.work) == 1:
            parts = [self._run_device(d, t, planes, qp)
                     for d, t in self.work.items()]
        else:
            with ThreadPoolExecutor(len(self.work)) as pool:
                futs = [pool.submit(self._run_device, d, t, planes, qp)
                        for d, t in self.work.items()]
                parts = [f.result() for f in futs]
        outs = {t: o for p in parts for t, o in p.items()}
        return [outs[t] for t in range(self.grid.n_tiles)]

    def materialize(self, outs: list) -> dict:
        return stitch(self.grid, [self.pipes[self.tile_dev[t]].materialize(o)
                                  for t, o in enumerate(outs)],
                      self.devices[0])

