"""Per-CTB QPs of the JAX package's LCU OBA rate control at a small size
and chip_smoke.py phase 11 (iii)'s bits per pixel, on the CPU:

    JAX_PLATFORMS=cpu python3 perf_logs/pr11/oba_floor.py [W H]

chip_smoke.py (iii) codes 2 frames of mixed_frames at 1920x1080 with
-p 1 --bitrate 10000000 --rc-algorithm oba --wpp (25 fps). This script
codes mixed_frames(2, W, H) (default 256x192) with the same options and
the bitrate scaled to the same bits per pixel, through the JAX package
and through kvazaar_tpu_torch on the CPU, and prints each frame's QP and
its CTB QPs by count for both."""
import os
import sys

import numpy as np

root = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
sys.path.insert(0, root)
sys.path.insert(0, os.path.join(root, "tools"))

from chip_smoke import H as SMOKE_H, LCU_OBA, W as SMOKE_W  # noqa: E402
from chip_smoke import mixed_frames  # noqa: E402
from torch_goldens import jax_gop_stream  # noqa: E402

w, h = (int(sys.argv[1]), int(sys.argv[2])) if len(sys.argv) > 2 \
    else (256, 192)
cfg = dict(LCU_OBA, target_bitrate=round(
    LCU_OBA["target_bitrate"] * w * h / (SMOKE_W * SMOKE_H)))
frames = mixed_frames(2, w, h)
print(f"{w}x{h}, bitrate {cfg['target_bitrate']}", flush=True)


def show(label, qps, maps):
    for k, (qp, q) in enumerate(zip(qps, maps)):
        vals, cnt = np.unique(q, return_counts=True)
        print(f"  {label} frame {k}: frame QP {qp}, CTBs by QP "
              f"{dict(zip(vals.tolist(), cnt.tolist()))}", flush=True)


stream, decs, plan = jax_gop_stream(frames, ("qp_ctb",), **cfg)
show("jax", [p["qp"] for p in plan], [d["qp_ctb"] for d in decs])
jax_maps = [d["qp_ctb"] for d in decs]

from kvazaar_tpu_torch.api import Encoder, encode_sequence  # noqa: E402
from kvazaar_tpu_torch.cfg import Config  # noqa: E402

enc = Encoder(Config(width=w, height=h, **cfg), device="cpu")
maps = []
finalize = enc.finalize_frame


def record(meta):
    out = finalize(meta)
    maps.append(np.asarray(enc._last_decisions["qp_ctb"]))
    return out


enc.finalize_frame = record
got, infos = encode_sequence(enc.cfg, frames, encoder=enc)
show("port", [i["qp"] for i in infos], maps)
same = got == stream and all(np.array_equal(a, b)
                             for a, b in zip(maps, jax_maps))
print(f"port stream and qp_ctb equal the JAX package's: {same}")
