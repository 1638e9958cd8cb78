#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (kvazaar_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero):
1. device: the card's name and power limit, TF32 off;
2. build: both CUDA kernels (one nvcc per source, in parallel) and the
   native entropy library, from the sources in this checkout;
3. kernel parity: me_refine and me_eval against their plain PyTorch
   versions at the 1080p shapes of the main path, bit-exact (tolerance
   0), on synthetic frames and on tie-heavy planes; me_refine's time,
   bound and blocks per SM per block size; then the time of one B
   frame's launches of each kernel, and of its plain version. Bounds
   take each kernel's operations at the rate of the pipe that runs them
   (PIPE_LANES: float32 for me_refine, int32 for me_eval), from the
   card's SM count and maximum SM clock;
4. main path: 1 IDR + 3 B frames of a 1920x1080 synthetic sequence
   through kvazaar_tpu_torch.api.encode_sequence on cuda, with the kernel
   launch counters read around it; every B frame must code intra leaves
   (run the wavefront) as well as inter leaves; the stream must decode
   hash-exactly in the port's decoder;
5. device parity: IDR + 1 B of the same sequence encoded on cuda and on
   the CPU (plain versions, held against the JAX package by the tests)
   give the same stream and the same decision maps.
The last lines are a JSON object of per-kernel numbers, the nvidia-smi
name/power-limit line, and {"ok": true, "device": {...}}.

The helpers mixed_frames, kernel_inputs, tie_planes, tie_inputs,
kernel_errors, compare_devices, open_device and phase_kernels are shared
with tests/test_torch_cuda.py and tools/ (tools/me_bench.py runs phases
1-3 alone).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

# published H100 SXM HBM bandwidth (NVIDIA data sheet)
PEAK_BYTES_S = 3.35e12
# Lanes per SM of a GH100 SM (Hopper architecture white paper) on the pipe
# that runs each kernel's counted work, a multiply-add counted as 2:
# me_refine does its filter, rounding, Hadamard and SAD arithmetic in
# float32 (128 FP32 lanes, which is also the most an SM issues a clock on
# any pipe), me_eval in int32 (64 INT32 lanes)
PIPE_LANES = {"me_refine": ("fp32", 128), "me_eval": ("int32", 64)}
# the main path's picture size
W, H = 1920, 1080


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def smi(query: str, units: bool = True) -> str:
    """First line of nvidia-smi --query-gpu=<query> (csv, no header)."""
    fmt = "csv,noheader" + ("" if units else ",nounits")
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          f"--format={fmt}"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip() if out else ""


def ops_rates(torch) -> dict:
    """Per kernel, the card's rate in operations a second on the pipe of
    PIPE_LANES: SMs x lanes x 2 (a multiply-add counts as 2, as in
    refine_work) x the SM's maximum clock (nvidia-smi clocks.max.sm)."""
    mhz = float(smi("clocks.max.sm", units=False))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return {name: sms * lanes * 2 * mhz * 1e6
            for name, (_, lanes) in PIPE_LANES.items()}


def synth_frames(n, w, h):
    """Synthetic 4:2:0 frames (the formula of bench.py)."""
    rng = np.random.RandomState(7)
    xx, yy = np.meshgrid(np.arange(w), np.arange(h))
    noise = rng.randint(-12, 12, (h, w))
    frames = []
    for i in range(n):
        y = np.clip(128 + 80 * np.sin(xx / 23 + i * 0.3) * np.cos(yy / 17)
                    + 20 * np.sin((xx + yy) / 7) + noise, 0, 255) \
            .astype(np.uint8)
        cb = (128 + 40 * np.sin(xx[:h // 2, :w // 2] / 31)).astype(np.uint8)
        cr = (128 + 40 * np.cos(yy[:h // 2, :w // 2] / 29)).astype(np.uint8)
        frames.append((y, cb, cr))
    return frames


def mixed_frames(n, w, h):
    """synth_frames plus, per frame, a fresh random-texture patch and a
    gradient whose brightness changes (both in the top-left 128x64):
    content without a temporal match, so B frames mix intra and inter
    leaves of several sizes. Needs w >= 128 and h >= 64."""
    rng = np.random.RandomState(8)
    out = []
    for i, (y, cb, cr) in enumerate(synth_frames(n, w, h)):
        py, px = 8 + 8 * i, 16 + 24 * i
        y[py:py + 24, px:px + 40] = rng.randint(0, 256, (24, 40))
        cb[py // 2:py // 2 + 12, px // 2:px // 2 + 20] = \
            rng.randint(60, 200, (12, 20))
        y[40:64, 80:128] = np.clip(np.add.outer(np.arange(24) * 4,
                                                np.arange(48) * 2) + 40 * i,
                                   0, 255)
        out.append((y, cb, cr))
    return out


# ---------------------------------------------------------------------
# kernel parity and CUDA-vs-CPU stream comparison
# ---------------------------------------------------------------------

def kernel_inputs(ref, src, n, K, gen):
    """The n x n blocks of src in raster order, K random full-pel
    candidates per block reaching +-100 px and one random qpel MV per
    block reaching +-100 px (both far outside the picture, so the index
    clamping is exercised), on ref's device. Returns (blocks, cands, mvs,
    cols)."""
    import torch
    rows, cols = src.shape[0] // n, src.shape[1] // n
    L = rows * cols
    blocks = src.reshape(rows, n, cols, n).permute(0, 2, 1, 3) \
        .reshape(L, n, n).contiguous()
    cands = torch.randint(-100, 101, (L, K, 2), generator=gen,
                          dtype=torch.int32).to(ref.device)
    mvs = torch.randint(-400, 401, (L, 2), generator=gen,
                        dtype=torch.int32).to(ref.device)
    return blocks, cands, mvs, cols


def tie_planes(h, w):
    """Tie-heavy (name, plane, lam64) cases for me_refine, where many of
    the 49 integer and 49 quarter-pel offsets cost exactly the same, so
    the strict-< scan order decides: a flat plane with lam64 0, and
    vertical stripes (period 2 across, 1 down) with lam64 0 and 153 (the
    prior then ties the mirrored offsets only). The source is the plane
    itself."""
    xx = np.arange(w)[None, :].repeat(h, 0)
    stripes = (60 + 120 * (xx & 1)).astype(np.int32)
    return [("flat", np.full((h, w), 117, np.int32), 0),
            ("stripes", stripes, 0), ("stripes_lam", stripes, 153)]


def tie_inputs(plane, n, K, gen, device):
    """kernel_inputs on a tie_planes plane (as reference and source) with
    every block's candidates coinciding in pairs (cands[:, 2j + 1] =
    cands[:, 2j]), so whole candidates tie too. Returns (ref, blocks,
    cands, mvs, cols)."""
    import torch
    ref = torch.from_numpy(plane).to(device)
    blocks, cands, mvs, cols = kernel_inputs(ref, ref, n, K, gen)
    cands[:, 1::2] = cands[:, 0:K - K % 2:2]
    return ref, blocks, cands, mvs, cols


def kernel_errors(me, ref, blocks, cands, mvs, lam, n, cols):
    """Largest absolute difference between each kernel's outputs and its
    plain version's on the same inputs (me_eval with hi off and on)."""
    import torch

    def diff(got, want):
        torch.cuda.synchronize()
        return max(int((a - b).abs().max()) for a, b in zip(got, want))
    err = {"me_refine": diff(
        me.me_refine(ref, blocks, cands, lam, n=n, cols=cols),
        me.me_refine_plain(ref, blocks, cands, lam, n, cols))}
    err["me_eval"] = max(diff(
        me.me_eval(ref, blocks, mvs, n=n, cols=cols, hi=hi),
        me.me_eval_plain(ref, blocks, mvs, n, cols, hi))
        for hi in (False, True))
    return err


def compare_devices(frames, w, h):
    """Encode frames with the default configuration on cuda and on the
    CPU, where the kernels' plain versions run. Returns the cuda stream
    and, per frame, whether both chunks are identical, the decision maps
    that differ, and the waves of the wavefront on each device."""
    from kvazaar_tpu_torch.api import Encoder
    from kvazaar_tpu_torch.cfg import Config
    res = {}
    for dev in ("cuda", "cpu"):
        enc = Encoder(Config(width=w, height=h), device=dev)
        res[dev] = []
        for f in frames:
            chunk, info = enc.encode_frame(*f)
            maps = {k: (v.cpu().numpy() if hasattr(v, "cpu")
                        else np.asarray(v))
                    for k, v in enc._last_decisions.items()}
            res[dev].append((chunk, maps, int(info["n_waves"])))
    rows = [{"same_stream": ca == cb,
             "differing_maps": [k for k in ma if k in mb
                                and not np.array_equal(ma[k], mb[k])],
             "waves": (wa, wb)}
            for (ca, ma, wa), (cb, mb, wb) in zip(res["cuda"], res["cpu"])]
    return b"".join(c for c, _, _ in res["cuda"]), rows


# ---------------------------------------------------------------------
# work counts of one kernel call (for the bound): every input read once,
# every output written once; integer operations of the algorithm
# ---------------------------------------------------------------------

def refine_work(n, L, K, hp, wp):
    nbytes = 4 * (hp * wp + L * n * n + L * K * 2 + 1
                  + L * 2 + L + L * n * n)
    per_block = (K * 49 * n * n * 3             # SAD: sub, abs, add
                 + 7 * (n + 8) * n * 16         # 7 horizontal 8-tap passes
                 + 49 * n * n * (20 + 9)        # vertical pass + SATD
                 + n * n * 20)                  # winning prediction
    return nbytes, L * per_block


def eval_work(n, L, hp, wp):
    nbytes = 4 * (hp * wp + L * n * n + L * 2 + L + L * n * n)
    per_block = (n + 7) * n * 16 + n * n * (20 + 9)
    return nbytes, L * per_block


def bound_ms(works, ops_rate):
    """Least time of a set of calls: per call the larger of bytes over
    the memory rate and operations over ops_rate (from ops_rates)."""
    tot, by_bytes, by_ops = 0.0, 0.0, 0.0
    for nbytes, ops in works:
        tb, to = nbytes / PEAK_BYTES_S, ops / ops_rate
        tot += max(tb, to)
        by_bytes += tb
        by_ops += to
    return tot * 1e3, ("bytes" if by_bytes >= by_ops else "operations")


def cuda_ms(fn, reps: int) -> float:
    """Mean ms of fn() over reps runs after one warm-up, CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def phase_kernels(me, torch, rates):
    """Bit-exact parity of both kernels with their plain versions at the
    slice's 1080p shapes, on the synthetic frames and on the tie-heavy
    planes; me_refine's time, bound and blocks per SM per block size;
    then both kernels' times for one B frame's launches (me_refine's as
    the sum of its per-size times). rates: ops_rates."""
    hp, wp = H + (-H) % 64, W + (-W) % 64
    frames = synth_frames(2, wp, hp)
    ref = torch.from_numpy(frames[0][0].astype(np.int32)).cuda()
    src = torch.from_numpy(frames[1][0].astype(np.int32)).cuda()
    lam = torch.tensor([153], dtype=torch.int32, device="cuda")
    gen = torch.Generator(device="cpu").manual_seed(1)
    err = {"me_refine": 0, "me_eval": 0}
    ref_calls, eval_calls = [], []
    for n in (8, 16, 32, 64):
        K = 2 if n <= 16 else 5
        blocks, cands, mvs, cols = kernel_inputs(ref, src, n, K, gen)
        e = kernel_errors(me, ref, blocks, cands, mvs, lam, n, cols)
        err = {k: max(v, e[k]) for k, v in err.items()}
        print(f"parity n={n} L={blocks.shape[0]} K={K}: max_abs_err "
              f"me_refine {e['me_refine']}, me_eval (hi off and on) "
              f"{e['me_eval']}", flush=True)
        for name, plane, lam_t in tie_planes(hp, wp):
            t_ref, t_blocks, t_cands, t_mvs, _ = tie_inputs(
                plane, n, K, gen, "cuda")
            e = kernel_errors(me, t_ref, t_blocks, t_cands, t_mvs,
                              torch.tensor([lam_t], dtype=torch.int32,
                                           device="cuda"), n, cols)
            err = {k: max(v, e[k]) for k, v in err.items()}
            print(f"parity n={n} tie-heavy {name} (lam64 {lam_t}): "
                  f"max_abs_err me_refine {e['me_refine']}, me_eval "
                  f"{e['me_eval']}", flush=True)
        # one B frame: me_refine per list (2) and size; me_eval 12 per size
        ref_calls += [(n, cols, blocks, cands)] * 2
        eval_calls += [(n, cols, blocks, mvs)] * 12
    if any(err.values()):
        fail(f"kernel/plain mismatch {err}")
    refine_ms = 0.0
    for n in (8, 16, 32, 64):
        calls = [c for c in ref_calls if c[0] == n]

        def k():
            for _, cols, blocks, c in calls:
                me.me_refine(ref, blocks, c, lam, n=n, cols=cols)
        ms = cuda_ms(k, 10)
        refine_ms += ms
        b_ms, b_by = bound_ms([refine_work(n, b.shape[0], c.shape[1], hp, wp)
                               for _, _, b, c in calls], rates["me_refine"])
        occ = me.me_refine_occupancy(n)
        print(f"me_refine n={n}: {len(calls)} launches {ms:.4f} ms, bound "
              f"{b_ms:.4f} ms by {b_by}; {occ['blocks_per_sm']} blocks per "
              f"SM of {occ['threads']} threads ({occ['sources']} source "
              f"blocks each), {occ['smem']} B shared, {occ['regs']} "
              f"registers, {occ['local']} B local", flush=True)

    def refine_plain():
        for n, cols, blocks, c in ref_calls:
            me.me_refine_plain(ref, blocks, c, lam, n, cols)

    def eval_kernel():
        for n, cols, blocks, m in eval_calls:
            me.me_eval(ref, blocks, m, n=n, cols=cols, hi=True)

    def eval_plain():
        for n, cols, blocks, m in eval_calls:
            me.me_eval_plain(ref, blocks, m, n, cols, True)
    timed = {
        "me_refine": (refine_ms, refine_plain,
                      [refine_work(n, blocks.shape[0], c.shape[1], hp, wp)
                       for n, _, blocks, c in ref_calls]),
        "me_eval": (cuda_ms(eval_kernel, 10), eval_plain,
                    [eval_work(n, blocks.shape[0], hp, wp)
                     for n, _, blocks, _ in eval_calls])}
    out = {}
    for name, (ms, plain, works) in timed.items():
        plain_ms = cuda_ms(plain, 1)
        b_ms, b_by = bound_ms(works, rates[name])
        out[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by, max_abs_err=err[name],
                         calls=len(works))
        print(f"time {name}: one B frame's {len(works)} launches "
              f"{ms:.3f} ms (plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms "
              f"by {b_by}, {PIPE_LANES[name][0]} rate)", flush=True)
    return out


def phase_main(torch, me):
    """1 IDR + 3 B frames at 1920x1080 through encode_sequence on cuda."""
    from kvazaar_tpu_torch.api import Encoder, encode_sequence
    from kvazaar_tpu_torch.cfg import Config
    frames = mixed_frames(4, W, H)
    # warm-up encode (library initialisation, allocator), not counted
    encode_sequence(Config(width=W, height=H), frames[:2], device="cuda")
    torch.cuda.synchronize()
    enc = Encoder(Config(width=W, height=H), device="cuda")
    pipe = enc._pipeline
    times = {"idr": [], "b": [], "wavefront": [], "host": []}

    def timed(fn, key):
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            r = fn(*a, **kw)
            torch.cuda.synchronize()
            times[key].append((time.perf_counter() - t) * 1e3)
            return r
        return wrapper
    pipe.submit = timed(pipe.submit, "idr")
    pipe.submit_inter_b = timed(pipe.submit_inter_b, "b")
    pipe._recon_md = timed(pipe._recon_md, "wavefront")
    enc.finalize_frame = timed(enc.finalize_frame, "host")
    me.me_refine.launches = 0
    me.me_eval.launches = 0
    t0 = time.perf_counter()
    stream, infos = encode_sequence(enc.cfg, frames, encoder=enc)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"me_refine": me.me_refine.launches,
                "me_eval": me.me_eval.launches}
    n_b = sum(1 for i in infos if i["slice_type"] == 0)
    # per B frame: me_refine per list and size (2 x 4); me_eval 12 per
    # size (2 uni, 8 merge candidates, 2 final) x 4 sizes
    expect = {"me_refine": 8 * n_b, "me_eval": 48 * n_b}
    print(f"main path: {len(infos)} frames ({n_b} B) in {wall:.3f} s = "
          f"{len(infos) / wall:.4f} fps, {len(stream)} bytes, launches "
          f"{launches} (expected {expect}), native slices "
          f"{enc.native_slices}", flush=True)
    for i in infos:
        kind = "IDR" if i["slice_type"] == 2 else "B"
        print(f"  POC {i['poc']} {kind}: {i['bytes']} bytes, PSNR Y "
              f"{i['psnr'][0]:.4f} U {i['psnr'][1]:.4f} V "
              f"{i['psnr'][2]:.4f}, waves {i['n_waves']}", flush=True)
    print(f"  submit wall ms per frame (host clock, synchronized): IDR "
          f"{times['idr']}, B {times['b']}; of which wavefront ms "
          f"{times['wavefront']}; host entropy coding ms {times['host']}",
          flush=True)
    if launches != expect:
        fail(f"kernel launches {launches} != {expect}")
    if enc.native_slices != len(infos):
        fail("the native slice writers were not used for every frame")
    if any(int(i["n_waves"]) == 0 for i in infos if i["slice_type"] == 0):
        fail("a B frame coded no intra leaf: its wavefront did not run")
    from kvazaar_tpu_torch.decoder.decoder import HEVCDecoder
    t = time.perf_counter()
    pics = HEVCDecoder().decode(stream)
    ok = [p.hash_ok for p in pics]
    print(f"decode: {len(pics)} frames hash_ok {ok} "
          f"({time.perf_counter() - t:.1f} s)", flush=True)
    if len(pics) != len(frames) or not all(ok):
        fail("the 1080p stream does not decode hash-exactly")
    for p, i in zip(pics, infos):
        if not all(np.array_equal(a, b) for a, b in
                   zip(p.planes, i["recon_out"])):
            fail("decoded planes differ from the encoder's reconstruction")
    return launches


def phase_device_parity():
    """IDR + 1 B at 1920x1080 on cuda give the CPU path's stream and
    decision maps."""
    t = time.perf_counter()
    _, rows = compare_devices(mixed_frames(2, W, H), W, H)
    for i, r in enumerate(rows):
        print(f"device parity {W}x{H} frame {i}: stream identical "
              f"{r['same_stream']}, differing maps {r['differing_maps']}, "
              f"waves cuda/cpu {r['waves']}", flush=True)
    print(f"device parity: {time.perf_counter() - t:.1f} s", flush=True)
    if not all(r["same_stream"] and not r["differing_maps"] for r in rows):
        fail("cuda and CPU encodes differ")


def open_device(torch):
    """Fail where there is no card or no port beside this script; print
    the device line and each kernel's operations rate. Returns (me, kind,
    name_limit, rates), me being kvazaar_tpu_torch.ops.me and rates
    ops_rates."""
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import kvazaar_tpu_torch  # noqa: F401  (sets TF32 off)
        from kvazaar_tpu_torch.ops import me
    except ImportError as e:
        fail(f"kvazaar_tpu_torch is not importable here: {e}")
    name_limit = smi("name,power.limit") or "nvidia-smi: no output"
    kind = torch.cuda.get_device_name(0)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    print(f"device: {kind} ({name_limit}); torch {torch.__version__} cuda "
          f"{torch.version.cuda}; tf32 matmul/cudnn {tf32}", flush=True)
    if any(tf32):
        fail("TF32 must be off")
    rates = ops_rates(torch)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, (pipe, lanes) in PIPE_LANES.items():
        print(f"{pipe} rate ({name}): {rates[name]:.4e} operations/s ("
              f"{sms} SMs x {lanes} {pipe.upper()} lanes x 2 at "
              f"clocks.max.sm {smi('clocks.max.sm')})", flush=True)
    return me, kind, name_limit, rates


def main() -> None:
    import torch
    me, kind, name_limit, rates = open_device(torch)
    from kvazaar_tpu_torch import native

    t0 = time.perf_counter()
    errs = []

    def build_native():
        try:
            native.get_lib()
        except Exception as e:   # reported below, then the run fails
            errs.append(e)
    th = threading.Thread(target=build_native)
    th.start()
    me.build_kernels(force=True)
    th.join()
    if errs:
        fail(f"native entropy library build failed: {errs[0]}")
    print(f"build: me_refine.cu + me_eval.cu (nvcc, sm_90a) and the "
          f"native entropy coder in {time.perf_counter() - t0:.2f} s",
          flush=True)

    kern = phase_kernels(me, torch, rates)
    launches = phase_main(torch, me)
    phase_device_parity()

    src = {"me_refine": ("kvazaar_tpu_torch/csrc/me_refine.cu",
                         "kvazaar_tpu/ops/pallas_me.py:346"),
           "me_eval": ("kvazaar_tpu_torch/csrc/me_eval.cu",
                       "kvazaar_tpu/ops/pallas_me.py:467")}
    rows = []
    for name in ("me_refine", "me_eval"):
        k = kern[name]
        rows.append({"name": name, "route": "cuda", "source": src[name][0],
                     "replaces": src[name][1],
                     "launches": launches[name],
                     "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                     "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                     "bound_by": k["bound_by"], "library_ms": None})
    print(json.dumps({"kernels": rows}))
    print(name_limit)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
