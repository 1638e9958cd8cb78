"""Bench scenario 2 with one and with two reference pictures a list, on one
NVIDIA GPU.

Encodes chip_smoke.py's low-delay phase (IDR + 5 B of mixed_frames at
1920x1080, --gop lp-g4d3t1, the tool row at QP 27) through
encode_sequence on cuda with --ref 1, 2, 2, 1 (chip_smoke.encode_timed:
per frame POC, QP, list 0, bytes, PSNR, waves, submit wall, wavefront,
SAO and host entropy ms; launches; hash-exact decode), after one warm-up
encode, and prints per run the B frames' summed bytes and mean PSNR Y.
Exits non-zero without a card or on a failed check.

Usage (on a machine with a GPU):  python3 tools/torch_lowdelay_refs.py
"""
from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> None:
    import torch
    from chip_smoke import (H, LOWDELAY, TOOL_ROW, W, encode_timed,
                            mixed_frames, open_device)
    me, _, name_limit, _ = open_device(torch)
    me.build_kernels(force=True)
    from kvazaar_tpu_torch.api import encode_sequence
    from kvazaar_tpu_torch.cfg import Config
    frames = mixed_frames(6, W, H)
    # warm-up (library initialisation, allocator), not counted
    encode_sequence(Config(width=W, height=H, **TOOL_ROW, **LOWDELAY),
                    frames[:2], device="cuda")
    torch.cuda.synchronize()
    summary = []
    for run, refs in enumerate((1, 2, 2, 1)):
        _, infos, _ = encode_timed(
            torch, me, dict(TOOL_ROW, **dict(LOWDELAY, ref_frames=refs)),
            frames, f"run {run}: --ref {refs}")
        b = [i for i in infos if i["slice_type"] == 0]
        summary.append((run, refs, sum(i["bytes"] for i in b),
                        sum(i["psnr"][0] for i in b) / len(b)))
    for run, refs, nbytes, psnr in summary:
        print(f"run {run} --ref {refs}: B frames {nbytes} bytes, mean PSNR "
              f"Y {psnr:.4f} dB", flush=True)
    print(name_limit)


if __name__ == "__main__":
    main()
