"""Diagnostic: does torch.profiler record every ctypes-launched me_eval kernel?"""
import sys
sys.path.insert(0, '.')
import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from chip_smoke import synth_frames, kernel_inputs
from kvazaar_tpu_torch.ops import me
ref, src = (torch.from_numpy(f[0].astype(np.int32)).cuda() for f in synth_frames(2, 1920, 1088))
gen = torch.Generator().manual_seed(1)
new = hasattr(me, "eval_one_plain")
for n in (8, 64):
    blocks, _, mvs, cols = kernel_inputs(ref, src, n, 1, gen)
    if new:
        m0, m1 = mvs
        calls = [lambda: me.me_eval(ref, ref, blocks, m0[:, :1].contiguous(), m1[:, :1].contiguous(), n=n, cols=cols),
                 lambda: me.me_eval(ref, ref, blocks, m0.contiguous(), m1.contiguous(), n=n, cols=cols),
                 lambda: me.me_eval(ref, ref, blocks, m0[:, :1].contiguous(), m1[:, :1].contiguous(), n=n, cols=cols, want_satd=False, want_pred=True)]
    else:
        calls = [lambda: me.me_eval(ref, blocks, mvs, n=n, cols=cols, hi=True)] * 3
    for c in calls: c()
    torch.cuda.synchronize()
    for sep in (False, True):
        before = me.me_eval.launches
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            x = ref + 1
            for c in calls:
                c()
                if sep:
                    x = x * 2
            torch.cuda.synchronize()
        ka = [(e.key[:40], e.count) for e in prof.key_averages() if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        raw = sum(1 for e in prof.events() if "me_eval_kernel" in e.name and e.device_type == DeviceType.CUDA)
        print(f"n={n} separated={sep}: wrapper launches {me.me_eval.launches - before}, profiler raw me_eval events {raw}, key_averages {ka}", flush=True)
