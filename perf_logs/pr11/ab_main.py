"""Main-path wall time of one tree, for parent-against-change runs in one
chip call (perf_logs/pr11/call3_run.sh runs it as parent, change, change,
parent):

    python3 perf_logs/pr11/ab_main.py <root of a tree>

Builds that tree's kernels and native writer, encodes
chip_smoke.mixed_frames (1 IDR + 3 B at 1920x1080, the default
configuration) through its kvazaar_tpu_torch.api.encode_sequence on cuda
once to warm up, then 3 times, and prints each run's wall time (host
clock, synchronized) and bytes."""
import os
import sys
import time

root = os.path.abspath(sys.argv[1])
sys.path.insert(0, root)
os.chdir(root)

import torch  # noqa: E402

from chip_smoke import H, W, mixed_frames  # noqa: E402
from kvazaar_tpu_torch import native  # noqa: E402
from kvazaar_tpu_torch.api import encode_sequence  # noqa: E402
from kvazaar_tpu_torch.cfg import Config  # noqa: E402
from kvazaar_tpu_torch.ops import me  # noqa: E402

me.build_kernels(force=True)
native.get_lib()
frames = mixed_frames(4, W, H)
encode_sequence(Config(width=W, height=H), frames[:2], device="cuda")
for i in range(3):
    torch.cuda.synchronize()
    t = time.perf_counter()
    stream, _ = encode_sequence(Config(width=W, height=H), frames,
                                device="cuda")
    torch.cuda.synchronize()
    print(f"{sys.argv[1]} run {i}: {time.perf_counter() - t:.3f} s, "
          f"{len(stream)} bytes", flush=True)
