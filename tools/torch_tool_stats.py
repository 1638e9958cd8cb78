"""CPU counts behind the tool row's predictions and findings (PERF.md,
PR 6), from the PyTorch port on the CPU at small sizes:

- `ops`: PyTorch operators dispatched a wave step of the intra wavefront
  (torch.profiler, CPU activity, over the first 8 steps of a 256x128 IDR
  at QP 27), default tools against bench.py's scenario 1 tool row (SAO
  full + RDOQ). Nested dispatches count too (an `aten::to` and the copy
  under it), so only the ratio of the two configurations means anything.
- `bytes`: bytes and PSNR Y per frame of mixed_frames at QP 27 under
  each tool combination: 2 all-intra frames at 128x64 and IDR + B at
  416x240; with --jax the JAX package encodes the 416x240 IDR alone
  (all-intra) with and without sign hiding, for comparison.

A count, not a device metric: no time is printed.

Usage:  python tools/torch_tool_stats.py ops|bytes [--jax]
"""
from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def ops() -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile
    from chip_smoke import TOOL_ROW, mixed_frames
    from kvazaar_tpu_torch.api import Encoder
    from kvazaar_tpu_torch.cfg import Config
    steps = 8
    frame = mixed_frames(1, 256, 128)[0]
    for label, cfg in (("default", dict(qp=27, intra_period=1)),
                       ("tool row", dict(TOOL_ROW, intra_period=1))):
        enc = Encoder(Config(width=256, height=128, **cfg), device="cpu")
        pipe = enc._pipeline
        ready, calls = pipe._class_ready, [0]
        prof = profile(activities=[ProfilerActivity.CPU])

        def counted(*a, **kw):
            if calls[0] == 0:
                prof.start()
            if calls[0] == steps * len(pipe.SIZES):
                prof.stop()
            calls[0] += 1
            return ready(*a, **kw)
        pipe._class_ready = counted
        enc.encode_frame(*frame)
        n = sum(e.count for e in prof.key_averages()
                if e.key.startswith("aten::"))
        print(f"{label}: {n / steps:.1f} aten operators dispatched a wave "
              f"step ({steps} steps, 256x128 IDR, QP 27)", flush=True)


CONFIGS = (dict(), dict(sao_type="full"), dict(rdoq_enable=True),
           dict(signhide_enable=True),
           dict(rdoq_enable=True, signhide_enable=True),
           dict(sao_type="full", rdoq_enable=True, signhide_enable=True))


def bytes_(jax: bool) -> None:
    from chip_smoke import mixed_frames
    from kvazaar_tpu_torch.api import encode_sequence
    from kvazaar_tpu_torch.cfg import Config
    for (w, h, period) in ((128, 64, 1), (416, 240, 64)):
        frames = mixed_frames(2, w, h)
        for tools in CONFIGS:
            _, infos = encode_sequence(
                Config(width=w, height=h, qp=27, intra_period=period,
                       **tools), frames, device="cpu")
            print(f"{w}x{h} period {period} {tools or 'no tools'}: bytes "
                  f"{[i['bytes'] for i in infos]}, PSNR Y "
                  f"{[round(float(i['psnr'][0]), 4) for i in infos]}",
                  flush=True)
    if jax:
        from tools.torch_goldens import jax_stream
        for tools in (dict(), dict(signhide_enable=True)):
            stream, _ = jax_stream(mixed_frames(1, 416, 240), qp=27,
                                   intra_period=1, **tools)
            print(f"JAX package 416x240 IDR {tools or 'no tools'}: "
                  f"{len(stream)} bytes", flush=True)


if __name__ == "__main__":
    import torch
    torch.set_num_threads(1)      # tiny eager ops: the pool only costs
    {"ops": ops, "bytes": lambda: bytes_("--jax" in sys.argv)}[
        sys.argv[1]]()
