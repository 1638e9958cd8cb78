"""Phase 15 of chip_smoke.py alone (the batched CTB-64 intra program),
then phase 13 (iv)'s mesh frame against the same frame tile by tile on
the card, with the device line and the kernels' build first:

    python3 perf_logs/pr15/phase15.py

The mesh frame: the dryrun's first frame (4x4 tiles of 320x192) through
MeshTiledIntraPipeline over cuda:0 twice (two batched calls of 8 tiles)
and through TiledIntraPipeline on cuda:0 (16 calls, tile by tile), in
turns (mesh, tiled, tiled, mesh); the streams must be equal.
"""
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)
os.chdir(ROOT)

import chip_smoke as cs  # noqa: E402

if __name__ == "__main__":
    import torch
    me, kind, name_limit, rates = cs.open_device(torch)
    from kvazaar_tpu_torch import native
    from kvazaar_tpu_torch.parallel import dryrun
    t = time.perf_counter()
    native.get_lib()
    me.build_kernels(force=True)
    print(f"build: {time.perf_counter() - t:.2f} s", flush=True)
    t = time.perf_counter()
    print(f"phase 15 launches {cs.phase_batch(torch, me)}", flush=True)
    cs.check_decodes()
    print(f"phase 15 with its decodes: {time.perf_counter() - t:.1f} s",
          flush=True)
    devs = dryrun.dryrun_devices(2, "cuda")
    streams = set()
    for run in ("mesh", "tiled", "tiled", "mesh"):
        if run == "mesh":
            stream, _, mesh, secs = dryrun.mesh_stream(devs, 4, 1)
        else:
            stream, secs = dryrun.tiled_stream(4, devs[0], 1)
        streams.add(stream)
        print(f"dryrun frame, {run}: {secs:.3f} s, {len(stream)} bytes",
              flush=True)
    if len(streams) != 1:
        cs.fail("the mesh's stream differs from the tiled one")
    print("dryrun frame: the mesh's and the tiled stream are equal",
          flush=True)
    print(name_limit)
