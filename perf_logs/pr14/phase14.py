"""Phase 14 of chip_smoke.py alone (the 16x16-grid pipelines and the host
route of CTB 32), with the device line and the kernels' build first:

    python3 perf_logs/pr14/phase14.py
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
    t = time.perf_counter()
    native.get_lib()
    me.build_kernels(force=True)
    print(f"build: {time.perf_counter() - t:.2f} s", flush=True)
    t = time.perf_counter()
    print(f"phase 14 launches {cs.phase_grid(torch, me)}", flush=True)
    cs.check_decodes()
    print(f"phase 14 with its decodes: {time.perf_counter() - t:.1f} s",
          flush=True)
    print(name_limit)
