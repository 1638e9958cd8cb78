"""Kernel-only check of the motion-estimation kernels on one NVIDIA GPU.

Builds me_refine.cu and me_eval.cu from this checkout (printing each
source's sha256 and ptxas's registers and spills), holds both kernels
bit-exact against their plain versions at the 1080p shapes of the main
path (synthetic frames and tie-heavy planes), and prints each kernel's
time, bound and blocks per SM per block size for one B frame's launches
in the main path's pattern (me_refine 2 a size, me_eval 3) and their
sums: chip_smoke.py's phases 1-3, without the main-path encode. Exits
non-zero on a mismatch or without a card.

Usage (on a machine with a GPU):  python3 tools/me_bench.py
"""
from __future__ import annotations

import hashlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> None:
    import torch
    from chip_smoke import open_device, phase_kernels
    me, _, name_limit, rates = open_device(torch)
    t0 = time.perf_counter()
    me.build_kernels(force=True)
    for name in me.KERNELS:
        with open(os.path.join(ROOT, "kvazaar_tpu_torch", "csrc",
                               f"{name}.cu"), "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:16]
        print(f"build: {name}.cu (sha256 {digest}) ptxas: " + " | ".join(
            ln.strip() for ln in open(os.path.join(
                me.BUILD_DIR, f"{name}.ptxas.txt")).read().splitlines()
            if "registers" in ln or "spill" in ln
            or "entry function" in ln), flush=True)
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    kern = phase_kernels(me, torch, rates)
    print(json.dumps({"kernels": [dict(name=k, **v)
                                  for k, v in kern.items()]}))
    print(name_limit)


if __name__ == "__main__":
    main()
