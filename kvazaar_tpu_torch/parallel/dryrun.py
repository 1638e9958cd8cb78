"""Multi-device dryrun: encode a tiled frame over N devices and verify
the stitched stream decodes hash-exactly (counterpart of
kvazaar_tpu/parallel/dryrun.py).

    python -m kvazaar_tpu_torch.parallel.dryrun N [--device cuda|cpu]

Runs MeshTiledIntraPipeline over N devices: the CUDA devices present
(the named one repeated where fewer than N exist), or the CPU N times;
stdout names them. What it checks, end to end:
  1. the quadtree (CTB 64) tile pipeline runs every device's block of
     tiles in one batched call (4x4 tiles of 320x192, 1280x768 in all,
     for N >= 4; else N x 1 tiles of 128x64), more tiles than devices;
  2. the tiles' outputs stitch into a conformant HEVC stream (tile
     substreams, entry points, the tiles' checksum sums);
  3. the port's decoder reproduces the reconstruction hash-exactly;
  4. the N-device stream is byte-identical to the one-device tile by
     tile encode (TiledIntraPipeline) of the same frames.
Prints `MULTICHIP OK ...` and exits 0, or raises.
"""
from __future__ import annotations

import argparse

import numpy as np


def dryrun_frames(cols: int, rows: int, tw: int, th: int) -> list:
    """The JAX dryrun's two frames: a ramp with a noise block in the
    bottom-left quarter, a sine Cb and a noise Cr (seed 3)."""
    w, h = tw * cols, th * rows
    rng = np.random.RandomState(3)
    xx, yy = np.meshgrid(np.arange(w), np.arange(h))
    frames = []
    for i in range(2):
        y = (60 + xx // 3 + yy // 5 + 9 * i).astype(np.uint8)
        y[h // 2:, : w // 2] = rng.randint(0, 255, (h - h // 2, w // 2))
        cb = (128 + 30 * np.sin(xx[: h // 2, : w // 2] / 9)).astype(np.uint8)
        cr = rng.randint(0, 255, (h // 2, w // 2)).astype(np.uint8)
        frames.append((y, cb, cr))
    return frames


def dryrun_config(n_devices: int):
    """(Config, frames) of the dryrun over n_devices: 4x4 tiles of
    320x192 for n_devices >= 4, else n_devices x 1 tiles of 128x64; QP
    30, all-intra, SAO full, RDOQ and sign hiding."""
    from ..cfg import Config
    if n_devices >= 4:
        cols, rows, tw, th = 4, 4, 320, 192
    else:
        cols, rows, tw, th = n_devices, 1, 128, 64
    cfg = Config(width=tw * cols, height=th * rows, qp=30,
                 tiles=(cols, rows), intra_period=1, sao_type="full",
                 rdoq_enable=True, signhide_enable=True)
    return cfg, dryrun_frames(cols, rows, tw, th)


def dryrun_devices(n_devices: int, device: str = "cuda") -> list:
    """n_devices torch devices: the CUDA devices present when `device`
    is cuda (cuda:0 repeated where fewer than n_devices exist), else
    `device` n_devices times."""
    import torch
    if device.startswith("cuda"):
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass --device cpu")
        have = torch.cuda.device_count()
        return [torch.device("cuda", i if have >= n_devices else 0)
                for i in range(n_devices)]
    return [torch.device(device)] * n_devices


def mesh_stream(devs, grid_for: int, n_frames: int = 2) -> tuple:
    """The dryrun's first n_frames frames (dryrun_config(grid_for))
    through MeshTiledIntraPipeline over the torch devices devs: (stream,
    the encode's infos, the mesh shape, seconds)."""
    import time

    from ..api import Encoder, encode_sequence
    from .mesh import MeshTiledIntraPipeline
    cfg, frames = dryrun_config(grid_for)
    enc = Encoder(cfg, device=devs[0], tile_devices=devs)
    assert isinstance(enc._pipeline, MeshTiledIntraPipeline), \
        f"mesh path not taken: {type(enc._pipeline).__name__}"
    mesh = (enc._pipeline.mr, enc._pipeline.mc)
    assert 1 < mesh[0] * mesh[1] <= len(devs)
    t = time.perf_counter()
    stream, infos = encode_sequence(cfg, frames[:n_frames], encoder=enc)
    return stream, infos, mesh, time.perf_counter() - t


def tiled_stream(grid_for: int, device, n_frames: int = 2) -> tuple:
    """The same frames tile by tile on one device (TiledIntraPipeline):
    (stream, seconds)."""
    import copy
    import time

    from ..api import Encoder, encode_sequence
    from .tiled import TiledIntraPipeline
    cfg, frames = dryrun_config(grid_for)
    cfg = copy.copy(cfg)
    cfg.mesh_tiles = "off"
    enc = Encoder(cfg, device=device)
    assert isinstance(enc._pipeline, TiledIntraPipeline)
    t = time.perf_counter()
    stream, _ = encode_sequence(cfg, frames[:n_frames], encoder=enc)
    return stream, time.perf_counter() - t


def run(n_devices: int, device: str = "cuda", grid_for: int = 0) -> dict:
    """The dryrun over n_devices (dryrun_devices), on the grid and
    frames that dryrun_config gives grid_for devices (n_devices when 0):
    the mesh's stream decodes hash-exactly and equals the tiled one on
    the first device. Returns the stream, the devices, the mesh shape and
    the seconds of both encodes."""
    from ..decoder.decoder import HEVCDecoder
    devs = dryrun_devices(n_devices, device)
    grid_for = grid_for or n_devices
    stream, infos, mesh, t_mesh = mesh_stream(devs, grid_for)
    decoded = HEVCDecoder().decode(stream)
    assert len(decoded) == len(infos)
    for f in decoded:
        assert f.hash_ok, "decoded-picture-hash mismatch on the mesh stream"
    # byte identity with the one-device tile-by-tile path
    stream1, t_tiled = tiled_stream(grid_for, devs[0])
    assert stream == stream1, "N-device stream differs from 1-device stream"
    cols, rows = dryrun_config(grid_for)[0].tiles
    print(f"MULTICHIP OK: {n_devices} devices "
          f"({', '.join(str(d) for d in devs)}), mesh {mesh[0]}x{mesh[1]}, "
          f"{rows}x{cols} tiles, {len(stream)} bytes, {len(decoded)} frames "
          f"hash-exact, bit-identical to 1-device (encodes: mesh "
          f"{t_mesh:.1f} s, one device {t_tiled:.1f} s)", flush=True)
    return {"stream": stream, "devices": devs, "mesh": mesh,
            "mesh_s": t_mesh, "tiled_s": t_tiled}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="kvazaar_tpu_torch.parallel.dryrun")
    p.add_argument("n_devices", nargs="?", type=int, default=8)
    p.add_argument("--device", default="cuda",
                   help="cuda (the CUDA devices present) or cpu")
    a = p.parse_args(argv)
    if a.device == "cpu":
        import torch
        torch.set_num_threads(1)
    run(a.n_devices, a.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
