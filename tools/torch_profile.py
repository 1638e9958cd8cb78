"""Where the time goes in the PyTorch port's main path on the GPU.

Encodes chip_smoke.py's main-path sequence (mixed_frames at 1920x1080:
IDR + B frames, default configuration) after a warm-up, and reports:
- per-stage wall times of each frame (host clock around synchronized
  stage calls: partition / ME / leaf search / recon / deblock / entropy);
- the next B frame's inter leaf stage alone (`_inter_leaf_b`, its 4
  sizes each profiled on its own): kernel-busy ms, kernel launches and
  host wall ms, its top kernels, and every row of the hand-written
  kernels (me_eval, me_refine) by block size;
- unless --leaf is given, a torch.profiler breakdown of one IDR and one
  B frame of a second encoder: kernel time by name (top rows), kernel
  launches, and the kernels' busy share of the frame's unprofiled wall
  time (the rest is the device idle). The profiled IDR frame alone takes
  a minute or more.

With --wave it profiles the intra wavefront instead: one 1080p IDR frame
at QP 27 with the default tools and with bench.py's scenario 1 tool row
(SAO full + RDOQ), in turns (default, tool row, tool row, default). Per
run: the unprofiled submit, wavefront and SAO ms and the waves, then the
kernel launches and kernel-busy ms a wave step over the first
WAVE_STEPS steps of a second encode of the frame (the step is the same
ops on every step, masked over the class rows). With --wave medium the
two runs are the tool row and the intra frame of --preset medium at QP
27, which is the tool row with NxN 4x4 leaves (--pu-depth-intra 1-4), in
turns (tool row, medium, medium, tool row). With --wave batch the two
runs code two 1080p IDR frames at QP 22 (the default tools, -p 1): one
frame a MdIntraPipeline.submit call, and both in one submit_many call
(one search and one wavefront, as frame_batch 2 codes them), in turns
(unbatched, batched, batched, unbatched); the steps profiled are those
of the first frame's wavefront, or of the batch's.

With --recon it times the stages of IDR + 2 B frames at 1080p and QP 27
with the default tools and with SAO full + RDOQ + sign hiding
(chip_smoke.TOOL_LDB), in turns: per frame the submit, partition,
batched inter recon, wavefront and SAO ms (host clock, synchronized).

With --p it measures the P program (--no-bipred, --ref 2) on
chip_smoke.py's P-phase content (split_motion_frames at 1080p): IDR + 2
P without and with SMP/AMP, in turns (SMP, plain, plain, SMP), per frame
the submit, partition, P leaf, SMP leaf, batched recon, wavefront and
host entropy ms (host clock, synchronized); then, with SMP, one P
frame's SMP search (`_smp_leaf` at n = 16 and 32, each profiled on its
own: kernel launches, kernel-busy ms, host wall ms and top kernels) and
the whole next P frame under torch.profiler (launches, kernel-busy share
of its unprofiled wall time).

With --grid it measures the 16x16-grid pipelines (--ctu 16) at 1080p:
IDR + P of mixed_frames with the default tools and with the tool row
plus sign hiding, in turns (default, tool row, tool row, default). Per
run the unprofiled submit and wavefront ms of each frame, then on a
second encode, each under torch.profiler on its own, the IDR's and the
P frame's wavefront (`_wave_loop`) and the P frame's motion search
(`_best_uni`): kernel launches (a wave for the wavefronts), kernel-busy
ms and host wall ms.

Usage (on a machine with a GPU):
    python3 tools/torch_profile.py [frames] [--leaf]
    python3 tools/torch_profile.py --wave [medium | batch] | --recon | --p
    python3 tools/torch_profile.py --grid
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(n_frames: int = 3, leaf_only: bool = False) -> None:
    import torch
    from chip_smoke import mixed_frames, wrap_timed
    from kvazaar_tpu_torch.api import Encoder, encode_sequence
    from kvazaar_tpu_torch.cfg import Config
    w, h = 1920, 1080
    # the last frame is the B frame whose inter leaf stage is profiled
    frames = mixed_frames(max(n_frames, 1) + 1, w, h)
    encode_sequence(Config(width=w, height=h), frames[:2])   # warm-up
    enc = Encoder(Config(width=w, height=h))
    pipe = enc._pipeline
    stages: dict = {}
    wrap_timed(torch, pipe, {k: k for k in (
        "_partition", "_partition_inter_b", "_coarse_field", "_me_sizes",
        "_leaf_rd", "_inter_leaf_b", "_inter_recon_batch", "_recon_md",
        "_deblock")}, stages)
    wrap_timed(torch, enc, {"finalize_frame": "finalize_frame"}, stages)
    walls = []
    for i, f in enumerate(frames[:-1]):
        stages.clear()
        torch.cuda.synchronize()
        t = time.perf_counter()
        enc.encode_frame(*f)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
        walls.append(wall)
        kind = "IDR" if i == 0 else "B"
        parts = ", ".join(f"{k} {sum(v):.1f} ms x{len(v)}"
                          for k, v in stages.items())
        print(f"frame {i} {kind}: {wall:.1f} ms; {parts}", flush=True)

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def kernel_events(prof):
        # kernel events only: an operator's row repeats its kernels' time
        return [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.self_device_time_total > 0]
    leaf_fn = pipe._inter_leaf_b
    wall, by_key = [], {}

    def profiled_leaf(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        with profile(activities=acts) as prof:
            r = leaf_fn(*a, **kw)
            torch.cuda.synchronize()
        wall.append((time.perf_counter() - t) * 1e3)
        for e in kernel_events(prof):
            us, cnt = by_key.get(e.key, (0.0, 0))
            by_key[e.key] = (us + e.self_device_time_total,
                             cnt + e.count)
        return r
    pipe._inter_leaf_b = profiled_leaf
    enc.encode_frame(*frames[-1])
    busy = sum(us for us, _ in by_key.values()) / 1e3
    print(f"profile inter leaf B (frame {len(frames) - 1}, {len(wall)} "
          f"sizes): kernels busy {busy:.3f} ms, "
          f"{sum(c for _, c in by_key.values())} kernel launches, "
          f"host wall {sum(wall):.1f} ms profiled", flush=True)
    for key, (us, cnt) in sorted(by_key.items(),
                                 key=lambda kv: -kv[1][0])[:8]:
        print(f"  {us / 1e3:9.3f} ms x{cnt:7d}  {key[:90]}", flush=True)
    for key, (us, cnt) in sorted(by_key.items()):
        if "me_eval_kernel" in key or "me_refine_kernel" in key:
            print(f"  hand kernel {us / 1e3:9.3f} ms x{cnt:5d}  "
                  f"{key[:60]}", flush=True)
    enc2 = Encoder(Config(width=w, height=h))
    for i, f in enumerate([] if leaf_only else frames[:min(2, len(walls))]):
        torch.cuda.synchronize()
        t = time.perf_counter()
        with profile(activities=acts) as prof:
            enc2.encode_frame(*f)
            torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
        ev = kernel_events(prof)
        dev_us = sum(e.self_device_time_total for e in ev)
        launches = sum(e.count for e in ev)
        kind = "IDR" if i == 0 else "B"
        # the profiler slows the host; the busy share is taken against
        # the same frame's unprofiled wall time from the loop above
        busy_ms = dev_us / 1e3
        print(f"profile {kind}: wall {wall_us / 1e3:.1f} ms profiled, "
              f"{walls[i]:.1f} ms unprofiled; kernels busy {busy_ms:.1f} "
              f"ms = {100 * busy_ms / walls[i]:.1f}% of the unprofiled "
              f"frame, {launches} kernel launches", flush=True)
        for e in sorted(ev, key=lambda e: -e.self_device_time_total)[:12]:
            print(f"  {e.self_device_time_total / 1e3:9.2f} ms "
                  f"x{e.count:7d}  {e.key[:90]}", flush=True)
    import subprocess
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)


WAVE_STEPS = 24


def profile_steps(pipe, run) -> None:
    """Run run() with the first WAVE_STEPS wave steps of pipe's wavefront
    under torch.profiler; print their kernel launches and kernel-busy ms
    a step, the host wall ms and the top kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    ready = pipe._class_ready
    calls = [0]
    state = {"t": 0.0}

    def counted(*a, **kw):
        if calls[0] == 0:
            torch.cuda.synchronize()
            prof.start()
            state["t"] = time.perf_counter()
        if calls[0] == WAVE_STEPS * len(pipe.SIZES):
            torch.cuda.synchronize()
            state["t"] = time.perf_counter() - state["t"]
            prof.stop()
        calls[0] += 1
        return ready(*a, **kw)
    pipe._class_ready = counted
    run()
    pipe._class_ready = ready
    ev = [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA
          and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in ev) / 1e3
    launches = sum(e.count for e in ev)
    print(f"  {WAVE_STEPS} profiled wave steps: {launches} kernel "
          f"launches = {launches / WAVE_STEPS:.1f} a step, kernels "
          f"busy {busy:.3f} ms = {busy / WAVE_STEPS:.4f} ms a step, "
          f"host wall {state['t'] * 1e3:.1f} ms profiled", flush=True)
    for e in sorted(ev, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms "
              f"x{e.count:7d}  {e.key[:80]}", flush=True)


def wave_profile(other: str = "default") -> None:
    """The tool row's IDR against `other`'s: "default" (no tools) or
    "medium" (--preset medium's intra frame at QP 27)."""
    import torch
    from chip_smoke import TOOL_ROW, mixed_frames, smi, wrap_timed
    from kvazaar_tpu_torch.api import Encoder
    from kvazaar_tpu_torch.cfg import PRESETS, Config
    w, h = 1920, 1080
    frame = mixed_frames(1, w, h)[0]
    cfgs = {"default": dict(qp=27, intra_period=1),
            "tool row": dict(TOOL_ROW, intra_period=1),
            "medium": dict(PRESETS["medium"], qp=27, intra_period=1)}
    Encoder(Config(width=w, height=h, **cfgs[other])).encode_frame(
        *frame)                                   # warm-up, not counted
    print(smi("name,power.limit"), flush=True)
    order = ((other, "tool row", "tool row", other) if other == "default"
             else ("tool row", other, other, "tool row"))
    for label in order:
        enc = Encoder(Config(width=w, height=h, **cfgs[label]))
        pipe = enc._pipeline
        times: dict = {}
        wrap_timed(torch, pipe, {k: k for k in ("submit", "_recon_md",
                                                "_sao")}, times)
        _, info = enc.encode_frame(*frame)
        steps = -(-int(info["n_waves"]) // pipe.WAVE_CHECK) \
            * pipe.WAVE_CHECK
        wave_ms = times["_recon_md"][0]
        codes, cnt = np.unique(enc._last_decisions["size_map8"],
                               return_counts=True)
        print(f"{label}: IDR {info['bytes']} bytes, cells by size code "
              f"{dict(zip(codes.tolist(), cnt.tolist()))}, waves "
              f"{info['n_waves']} ({steps} wave steps); submit "
              f"{times['submit'][0]:.1f} ms, wavefront {wave_ms:.1f} ms "
              f"({wave_ms / steps:.2f} ms a step), SAO "
              f"{times.get('_sao', [0.0])[0]:.2f} ms", flush=True)
        # profile the first WAVE_STEPS steps of a second encode
        profile_steps(pipe, lambda: enc.encode_frame(*frame))


def wave_batch_profile(n: int = 2) -> None:
    """--wave batch: n 1080p IDR frames at QP 22 one submit call a frame
    against one submit_many call for all of them, in turns."""
    import torch
    from chip_smoke import mixed_frames, smi, wrap_timed
    from kvazaar_tpu_torch.api import Encoder
    from kvazaar_tpu_torch.cfg import Config
    w, h = 1920, 1080
    cfg = Config(width=w, height=h, qp=22, intra_period=1)
    enc = Encoder(cfg)
    frames = [enc._pad(*f) for f in mixed_frames(n, w, h)]
    enc._pipeline.submit(*frames[0])              # warm-up, not counted
    torch.cuda.synchronize()
    print(smi("name,power.limit"), flush=True)
    for label in ("unbatched", "batched", "batched", "unbatched"):
        pipe = Encoder(cfg)._pipeline

        def run():
            if label == "batched":
                return pipe.submit_many(*zip(*frames))
            return [pipe.submit(*f) for f in frames]
        times: dict = {}
        wrap_timed(torch, pipe, {"submit": "submit",
                                 "submit_many": "submit",
                                 "_recon_md": "wavefront"}, times)
        waves = [int(o["n_waves"]) for o in run()]
        steps = [-(-v // pipe.WAVE_CHECK) * pipe.WAVE_CHECK for v in
                 ([max(waves)] if label == "batched" else waves)]
        sub = sum(times["submit"])
        print(f"{label}: {n} IDR frames, waves {waves} ({steps} wave steps);"
              f" submit calls ms {[round(x, 1) for x in times['submit']]} "
              f"= {sub:.1f} ms, {n / sub * 1e3:.4f} fps; wavefront calls ms "
              f"{[round(x, 1) for x in times['wavefront']]} ("
              f"{sum(times['wavefront']) / sum(steps):.2f} ms a step)",
              flush=True)
        # profile the first WAVE_STEPS steps of a second run
        profile_steps(pipe, run)


def grid_profile(w: int = 1920, h: int = 1080) -> None:
    """The grid pipelines' wavefront and P search at w x h (--grid)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from chip_smoke import GRID, TOOL_ROW, mixed_frames, smi, wrap_timed
    from kvazaar_tpu_torch.api import Encoder
    from kvazaar_tpu_torch.cfg import Config
    frames = mixed_frames(2, w, h)
    cfgs = {"default": GRID,
            "tool row": dict(TOOL_ROW, ctu_size=16, signhide_enable=True)}
    enc = Encoder(Config(width=w, height=h, **GRID))
    for f in frames:                              # warm-up, not counted
        enc.encode_frame(*f)
    print(smi("name,power.limit"), flush=True)
    for label in ("default", "tool row", "tool row", "default"):
        enc = Encoder(Config(width=w, height=h, **cfgs[label]))
        pipe = enc._pipeline
        times: dict = {}
        wrap_timed(torch, pipe, {"submit_many": "submit",
                                 "submit_inter": "submit",
                                 "_wave_loop": "wavefront"}, times)
        infos = [enc.encode_frame(*f)[1] for f in frames]
        print(f"{label}: " + "; ".join(
            f"{k} {i['bytes']} bytes, waves {i['n_waves']}, submit "
            f"{s_:.1f} ms, wavefront {wv:.1f} ms ({wv / i['n_waves']:.2f} "
            "ms a wave)" for k, i, s_, wv in zip(
                ("IDR", "P"), infos, times["submit"], times["wavefront"])),
            flush=True)
        enc = Encoder(Config(width=w, height=h, **cfgs[label]))
        pipe = enc._pipeline
        rows = []

        def profiled(name, fn):
            def run(*a, **kw):
                prof = profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA])
                torch.cuda.synchronize()
                prof.start()
                t = time.perf_counter()
                r = fn(*a, **kw)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t) * 1e3
                prof.stop()
                ev = [e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and e.self_device_time_total > 0]
                rows.append((name, sum(e.count for e in ev),
                             sum(e.self_device_time_total for e in ev) / 1e3,
                             wall))
                return r
            return run
        pipe._wave_loop = profiled("wavefront", pipe._wave_loop)
        pipe._best_uni = profiled("search (_best_uni)", pipe._best_uni)
        for f in frames:
            enc.encode_frame(*f)
        for (name, n, busy, wall), k in zip(rows, ("IDR", "P", "P")):
            per = (f" = {n / pipe.n_waves:.1f} a wave" if name ==
                   "wavefront" else "")
            print(f"  profiled {k} {name}: {n} kernel launches{per}, "
                  f"kernels busy {busy:.3f} ms, host wall {wall:.1f} ms",
                  flush=True)


def recon_compare() -> None:
    import torch
    from chip_smoke import TOOL_LDB, mixed_frames, smi, wrap_timed
    from kvazaar_tpu_torch.api import Encoder, encode_sequence
    from kvazaar_tpu_torch.cfg import Config
    w, h = 1920, 1080
    frames = mixed_frames(3, w, h)
    cfgs = {"default": dict(qp=TOOL_LDB["qp"]), "tools": TOOL_LDB}
    encode_sequence(Config(width=w, height=h), frames[:2])   # warm-up
    print(smi("name,power.limit"), flush=True)
    stages = ("submit", "submit_inter_b", "_partition_inter_b",
              "_inter_recon_batch", "_recon_md", "_sao")
    for label in ("default", "tools", "tools", "default"):
        enc = Encoder(Config(width=w, height=h, **cfgs[label]))
        times: dict = {}
        wrap_timed(torch, enc._pipeline, {k: k for k in stages}, times)
        for i, f in enumerate(frames):
            times.clear()
            _, info = enc.encode_frame(*f)
            parts = ", ".join(f"{k} {times[k][0]:.1f}" for k in stages
                              if k in times)
            print(f"{label} frame {i} ({info['bytes']} bytes, waves "
                  f"{info['n_waves']}): {parts} ms", flush=True)


def p_profile() -> None:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from chip_smoke import P_SMP, smi, split_motion_frames, wrap_timed
    from kvazaar_tpu_torch.api import Encoder, encode_sequence
    from kvazaar_tpu_torch.cfg import Config
    w, h = 1920, 1080
    frames = split_motion_frames(4, w, h, edges=tuple(range(48, h, 64)),
                                 patch=True)
    cfgs = {"SMP/AMP": P_SMP,
            "plain": {k: v for k, v in P_SMP.items()
                      if k not in ("smp_enable", "amp_enable")}}
    encode_sequence(Config(width=w, height=h, **cfgs["plain"]), frames[:2])
    print(smi("name,power.limit"), flush=True)
    stages = ("submit", "submit_inter", "_partition_inter_p",
              "_inter_leaf_p", "_smp_leaf", "_inter_recon_batch",
              "_recon_md")
    for label in ("SMP/AMP", "plain", "plain", "SMP/AMP"):
        enc = Encoder(Config(width=w, height=h, **cfgs[label]))
        times: dict = {}
        wrap_timed(torch, enc._pipeline, {k: k for k in stages}, times)
        wrap_timed(torch, enc, {"finalize_frame": "host entropy"}, times)
        for i, f in enumerate(frames[:3]):
            times.clear()
            _, info = enc.encode_frame(*f)
            parts = ", ".join(f"{k} {sum(v):.1f}" + (f" x{len(v)}"
                                                     if len(v) > 1 else "")
                              for k, v in times.items())
            print(f"{label} frame {i} ({info['bytes']} bytes, waves "
                  f"{info['n_waves']}): {parts} ms", flush=True)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def kernel_events(prof):
        return [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.self_device_time_total > 0]
    enc = Encoder(Config(width=w, height=h, **P_SMP))
    pipe = enc._pipeline
    smp_leaf = pipe._smp_leaf

    def profiled_smp(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        with profile(activities=acts) as prof:
            r = smp_leaf(*a, **kw)
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
        ev = kernel_events(prof)
        print(f"profile SMP search n={a[-1]}: {sum(e.count for e in ev)} "
              f"kernel launches, kernels busy "
              f"{sum(e.self_device_time_total for e in ev) / 1e3:.3f} ms, "
              f"host wall {wall:.1f} ms profiled", flush=True)
        for e in sorted(ev, key=lambda e: -e.self_device_time_total)[:6]:
            print(f"  {e.self_device_time_total / 1e3:9.3f} ms "
                  f"x{e.count:7d}  {e.key[:80]}", flush=True)
        return r
    enc.encode_frame(*frames[0])
    pipe._smp_leaf = profiled_smp
    enc.encode_frame(*frames[1])
    pipe._smp_leaf = smp_leaf
    # frame 2 unprofiled (the first encoder), then profiled (a second
    # one, which codes it the same way)
    torch.cuda.synchronize()
    t = time.perf_counter()
    enc.encode_frame(*frames[2])
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) * 1e3
    enc2 = Encoder(Config(width=w, height=h, **P_SMP))
    for f in frames[:2]:
        enc2.encode_frame(*f)
    with profile(activities=acts) as prof:
        enc2.encode_frame(*frames[2])
        torch.cuda.synchronize()
    ev = kernel_events(prof)
    busy = sum(e.self_device_time_total for e in ev) / 1e3
    print(f"profile P frame 2 (SMP/AMP): {sum(e.count for e in ev)} kernel "
          f"launches, kernels busy {busy:.1f} ms = {100 * busy / wall:.1f}% "
          f"of its unprofiled {wall:.1f} ms", flush=True)
    for e in sorted(ev, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"  {e.self_device_time_total / 1e3:9.2f} ms x{e.count:7d}  "
              f"{e.key[:80]}", flush=True)


if __name__ == "__main__":
    if "--p" in sys.argv[1:]:
        p_profile()
    elif "--wave" in sys.argv[1:] and "batch" in sys.argv[1:]:
        wave_batch_profile()
    elif "--wave" in sys.argv[1:]:
        wave_profile("medium" if "medium" in sys.argv[1:] else "default")
    elif "--grid" in sys.argv[1:]:
        grid_profile()
    elif "--recon" in sys.argv[1:]:
        recon_compare()
    else:
        main(*(int(a) for a in sys.argv[1:] if a != "--leaf"),
             leaf_only="--leaf" in sys.argv[1:])
