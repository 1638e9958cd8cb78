#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (kvazaar_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero):
1. device: the card's name and power limit, TF32 off;
2. build: both CUDA kernels (one nvcc per source, in parallel) and the
   native entropy library, from the sources in this checkout;
3. kernel parity: me_refine and me_eval against their plain PyTorch
   versions at the 1080p shapes of the main path, bit-exact (tolerance
   0), on synthetic frames and on tie-heavy planes (me_eval with K = 1
   and 4 pairs on reference stacks of one and two pictures, and in its
   one-list mode with K = 1 and 5 on stacks of one, two and four
   pictures, every output flag, with random and coinciding indices);
   each kernel's time, bound and blocks per SM per block size for one B
   frame's launches with two reference pictures a list, their sum,
   me_eval's time on one picture, the one-list mode's time and bound for
   one P frame's launches on one, two and four pictures, and the plain
   versions' time. Bounds take each kernel's operations at the rate of
   the pipe that runs them (PIPE_LANES: float32 for both), from the
   card's SM count and maximum SM clock;
4. main path: 1 IDR + 3 B frames of a 1920x1080 synthetic sequence
   through kvazaar_tpu_torch.api.encode_sequence on cuda, with the kernel
   launch counters read around it; every B frame must code intra leaves
   (run the wavefront) as well as inter leaves; the stream must decode
   hash-exactly in the port's decoder;
5. device parity: IDR + 1 B of the same sequence encoded on cuda and on
   the CPU (plain versions, held against the JAX package by the tests)
   give the same stream and the same decision maps;
6. tool row (SAO, RDOQ, sign hiding; the kernel launch counters are read
   around each encode): (a) bench.py's scenario 1, 1 all-intra frame at
   1920x1080 and QP 27 with deblocking, SAO full and RDOQ; (b) IDR + 2 B
   at 1920x1080 and QP 27 with SAO full, RDOQ and sign hiding, 8
   me_refine and 12 me_eval launches a B frame; both streams decode
   hash-exactly to the encoder's reconstruction, per frame the bytes,
   PSNR, waves and the submit, wavefront and SAO times; (c) config (b)
   at 416x240 (IDR + 1 B) on cuda and on the CPU: the same stream and
   maps, SAO parameters included;
7. low-delay (bench scenario 2): the low-delay GOP lp-g4d3t1 with two
   references a list and scenario 1's tool row at QP 27, IDR + 5 B at
   1920x1080 (16 me_refine and 12 me_eval launches a B frame),
   hash-exact, some B frame predicting from a second reference picture
   and some B frame running its wavefront; per frame POC, QP, list 0,
   bytes, PSNR, waves and times; then the same configuration at 416x240
   (5 frames: every position of the GOP) on cuda and on the CPU: the same
   stream and maps;
8. the P program (--no-bipred) with SMP, AMP and --ref 2: IDR + 3 P of
   split-motion content at 1920x1080 (8 me_refine and 8 one-list
   me_eval launches a P frame), hash-exact, some P frame choosing a
   rectangular PU and some running its wavefront; per frame the bytes,
   PSNR, waves, cells by part id and the submit, wavefront and host
   entropy times (SMP slices are coded by the Python writer); then that
   configuration (IDR + 2 P) and lp-g4d3t1 --ref 2 --no-bipred with the
   tool row (5 frames) at 416x240 on cuda and on the CPU: the same
   streams and maps;
9. the GOP8 B pyramid (bench scenario 3, -p 24 --gop 8) with scenario
   1's tool row at QP 27: 12 frames at 1920x1080 fed in display order
   through push_frame/flush (IDR, P 8 with B 4 2 1 3 6 5 7, then P 10, B
   9, P 11: 76 me_refine, 96 pair and 24 one-list me_eval launches),
   hash-exact, decoded in display order, some B frame predicting from a
   future picture of list 1; per frame the display index, POC, slice and
   NAL type, QP, l0, l1, bytes, PSNR, waves and times; then --gop 8 -p 8
   --open-gop at 416x240 (10 frames: IDR, CRA 8 with seven RASL
   pictures, P 9) on cuda and on the CPU: the same stream and maps, with
   CRA, RASL_R and RASL_N pictures;
10. the preset ladder: --preset medium (NxN 4x4 leaves, GOP 16, --ref 4,
   SAO full and RDOQ; bench.py's comparison point) on 5 frames at
   1920x1080 and QP 22 fed through push_frame/flush (IDR, P 4, B 2 1 3:
   64 me_refine, 36 pair and 8 one-list me_eval launches), hash-exact,
   with NxN cells in the IDR; per frame as in phase 9 and the cells by
   size code (4 NxN, 8, 16, 32, 64); then, each on cuda and on the CPU
   with the same streams and maps: every intra depth (--pu-depth-intra
   0-4, --rd 3, the tool row with sign hiding) on one frame of half
   detailed, half flat content at 416x240, at least 2% of its cells NxN
   and 5% 64x64 leaves; and ultrafast, medium and placebo at 416x240 (3
   frames each);
11. WPP, rate control and delta QP: (i) the default configuration with
   --wpp --slices wpp, IDR + 2 B at 1920x1080 (17 slice segments a
   picture, the later ones dependent, through the Python writers),
   hash-exact, its maps equal to phase 4's on the same frames; (ii) the
   default configuration with --wpp --bitrate 10000000 (lambda rate
   control at the default 25 fps), IDR + 3 B at 1920x1080 (17
   substreams a slice from the native writers), hash-exact, with per
   frame the QP and bits, the QP moving; (iii) -p 1 --bitrate 10000000 --rc-algorithm oba --wpp
   (LCU rate control: a QP a CTB), 2 frames at 1920x1080, hash-exact,
   the first frame's CTB QPs not all equal (the second frame's lambda
   comes from OBA's initial model before the first frame's bits are
   known, as in the reference; on this content every CTB of it sits on
   the clip band's floor, which is printed); (iv) on cuda and on the CPU at
   416x240 with the same streams and maps: --vaq 8 --roi with the tool
   row (2 frames) and --gop 4 --wpp --slices wpp with OBA rate control
   and the intra bit allocation (5 frames: IDR, P 4, B 2 1 3);
12. the remaining intra variants: (i) --transform-skip --pu-depth-intra
   1-4 with the CPU tests' --fast-coeff-table at QP 27, IDR + 1 B of
   screen content at 1920x1080 (8 me_refine and 12 me_eval launches a B
   frame; the Python writers), hash-exact, transform skip chosen on some
   TU of the IDR; (ii) -p 1 --input-bitdepth 10 --scaling-list default
   with SAO full, RDOQ and sign hiding, 1 frame of 10-bit content at
   1920x1080 through the native writer, hash-exact, its SPS Main 10;
   (iii) on cuda and on the CPU at 416x240 with the same streams and
   maps, hash-exact: transform skip (IDR + 2 B), Main 10 with the tool
   row (2 frames), a --cqmfile (2 frames) and lossless coding (2 frames,
   the reconstruction the source);
13. selective encryption, field coding and tiles: (i) --crypto on with a
   --key, IDR + 2 B at 1920x1080 through the Python writers (8
   me_refine and 12 me_eval launches a B frame), hash-exact with the key,
   parsed into pictures that miss their hash without it; (ii)
   --source-scan-type tff, 2 frames as 4 field pictures of 1920x540
   (padded to 576; IDR + 3 B), an interlaced source in the SPS and a
   pic_timing SEI a picture, hash-exact; (iii) --tiles 2x2 --slices
   tiles with the tool row, 1 frame through TiledIntraPipeline, a slice
   segment a tile, hash-exact, each tile's waves and submit time; (iv)
   the multi-device dryrun's 4x4 grid of 320x192 tiles (its first frame)
   through MeshTiledIntraPipeline, one batched call a device's block of
   eight tiles, over cuda:0 twice (or the CUDA devices
   present where there are two or more), hash-exact and byte-identical
   to the tiled path's stream of the same frames on the CPU (coded in
   the CPU worker beside (i)-(iii)); (v) on cuda and on the CPU at
   416x240 with the same streams and maps, hash-exact: the three intra
   features of --crypto, bottom field first and 2x2 tiles with --vaq 8;
14. the 16x16-grid pipelines (--ctu 16) and the host route of CTB 32,
   the kernel launch counters read around each encode (the grid path
   launches neither kernel): (i) IDR + 3 P at 1920x1080 (padded to 1088),
   some inter block in every P frame; (ii) -p 24 --gop 8 with the tool
   row, 9 frames at 1080p through push_frame/flush (IDR, then P 8 and
   B 4 2 1 3 6 5 7 on a union stack of four references); (iii) -p 1 with
   frame_batch 2, 2 frames at 1080p through one pass of the waves, the
   stream equal to the unbatched one; per frame the bytes, PSNR, waves,
   inter share and the submit, wavefront and host ms; (iv) (i)-(iii) at
   416x240 on cuda and on the CPU: the same streams and maps; (v) CTB 32,
   2 frames at 416x240 on the host route (no pipeline);
15. the batched CTB-64 intra program (MdIntraPipeline.submit_many): (i)
   -p 1 with frame_batch 2, 2 frames at 1080p through one search and one
   wavefront, hash-exact, the stream and every map of each frame (its
   waves included) equal to the unbatched encode's of the same frames,
   per frame the waves, the batched submit ms and the two unbatched
   submit ms; (ii) the tool row with --pu-depth-intra 1-4 and frame_batch
   2, 3 frames at 416x240 (a full batch and a partial one) on cuda and on
   the CPU: the same streams and maps, hash-exact.
Phases 10, 14 and 15, and phases 12 and 13, run in two child processes of
their own (`--phases`, CHILD_GROUPS) beside phases 4-9 and 11, from the
end of phase 3 on, and their output is printed after phase 11's; phase
5's CPU half runs beside phases 3-4. The hash-exact decodes of each
process's encodes run in a worker process beside its later phases (phase
14's 1080p streams in one each) and are checked at its end; the CPU half
of every cuda-against-CPU run runs in another, beside its cuda half.
The last lines are a JSON object of per-kernel numbers (launches summed
over the encodes of phases 4 and 6-15; me_eval's pair
and one-list modes in rows of their own), the nvidia-smi name/power-limit
line, and {"ok": true, "device": {...}}.

The helpers mixed_frames, split_motion_frames, screen_frames,
main10_frames, kernel_inputs, tie_planes, tie_inputs, kernel_errors,
compare_devices, open_device and phase_kernels are shared
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
# that runs each kernel's counted work, a multiply-add counted as 2: both
# kernels do their filter, rounding, Hadamard and SAD arithmetic in
# float32 (128 FP32 lanes, which is also the most an SM issues a clock on
# any pipe)
PIPE_LANES = {"me_refine": ("fp32", 128), "me_eval": ("fp32", 128)}
# candidate pairs a block of me_eval's widest call on the main path (the
# merge candidates left, top, CTB corner and zero)
EVAL_K = 4
# candidates a block of me_eval's widest one-list call on the P path (the
# merge candidates left, top, CTB corner, global MV and zero)
EVAL_K_P = 5
# the main path's picture size
W, H = 1920, 1080
# the tool row of bench.py's scenario 1 (bench.py:40-42, QP 27 at :123),
# and the same with sign hiding on the generalized-B path
TOOL_ROW = dict(qp=27, deblock_enable=True, sao_type="full",
                rdoq_enable=True, signhide_enable=False)
TOOL_LDB = dict(qp=27, sao_type="full", rdoq_enable=True,
                signhide_enable=True)
# bench.py's scenario 2 (bench.py:232-233): the low-delay GOP lp-g4d3t1
# with two references a list, run with the tool row
LOWDELAY = dict(intra_period=0, gop_len=4, gop_lowdelay=True,
                gop_lp=(3, 1), ref_frames=2)
# the P program with SMP and AMP and two reference pictures
P_SMP = dict(bipred=False, smp_enable=True, amp_enable=True, ref_frames=2)
# bench.py's scenario 3 (bench.py:252): the GOP8 B pyramid, run with the
# tool row; and the open-GOP pyramid (a CRA picture every 8 frames)
GOP8 = dict(intra_period=24, gop_len=8)
OPEN_GOP = dict(intra_period=8, gop_len=8, open_gop=True)
# the presets of phase 10's 416x240 CUDA-vs-CPU runs: the ends of the
# ladder and medium (NxN, RDOQ, GOP 16); veryfast, fast and slow were cut
# to keep the smoke inside its time limit with phase 12
SMALL_PRESETS = ("ultrafast", "medium", "placebo")
# phase 10's intra leaves: every intra depth (64x64 leaves to NxN 4x4),
# the --rd ladder at its deepest and the tool row with sign hiding, at QP
# 27 on leaf_frames (the configuration and content of the CPU tests'
# golden "rd3", tools/torch_goldens.py PRESET_CONFIGS); each frame must
# code at least these shares of its 8x8 cells as NxN (size code 4) and
# as 64x64 leaves
INTRA_LEAVES = dict(qp=27, intra_period=1, pu_depth_intra=(0, 4), rd=3,
                    sao_type="full", rdoq_enable=True,
                    signhide_enable=True)
LEAF_SHARES = {4: 0.02, 64: 0.05}
# phase 11: WPP with a slice segment a CTB row; lambda rate control at 10
# Mbit/s (25 fps) with WPP; all-intra OBA rate control (a QP a CTB); at
# 416x240, VAQ with a ROI map (SMOKE_ROI: 4x3 delta QPs over the CTBs)
# and the tool row, and the B pyramid with WPP slices and OBA rate
# control (the CPU tests' golden "gop_oba", tools/torch_goldens.py)
WPP_SLICES = dict(wpp=True, slices="wpp")
WPP_RC = dict(wpp=True, target_bitrate=10_000_000)
LCU_OBA = dict(intra_period=1, target_bitrate=10_000_000,
               rc_algorithm="oba", wpp=True)
VAQ_ROI = dict(TOOL_ROW, vaq=8)
GOP_OBA = dict(gop_len=4, wpp=True, slices="wpp", target_bitrate=2_000_000,
               rc_algorithm="oba", intra_bits=True)
SMOKE_ROI = "4 3\n-4 0 3 6\n2 -2 5 -6\n1 1 -3 0\n"
# phase 12, the remaining intra variants: (i) transform skip with NxN
# leaves and the CPU tests' --fast-coeff-table (the learned weights at 1.5
# times, no 32x32 entry) at QP 27; (ii) Main 10 with the default scaling
# lists, SAO full, RDOQ and sign hiding, all-intra; (iii) at 416x240 the
# CPU tests' goldens "trskip_b", "main10", "cqm" and "lossless"
# (tools/torch_goldens.py VARIANT_CONFIGS), with their content
FCT_TABLE = os.path.join("tests", "data", "torch_fct_table.json")
CQM_FILE = os.path.join("tests", "data", "torch_cqm.txt")
TRSKIP_FCT = dict(qp=27, trskip_enable=True, pu_depth_intra=(1, 4),
                  fast_coeff_table=FCT_TABLE)
MAIN10_SCALING = dict(TOOL_LDB, intra_period=1, input_bitdepth=10,
                      scaling_list="default")
VARIANTS_416 = (("trskip_b", dict(trskip_enable=True), "mixed", 3),
                ("main10", dict(TOOL_LDB, qp=30, input_bitdepth=10),
                 "main10", 2),
                ("cqm", dict(cqmfile=CQM_FILE, qp=30), "mixed", 2),
                ("lossless", dict(lossless=True), "mixed", 2))
# phase 13, selective encryption, field coding and tiles: (i) every
# --crypto feature with a --key; (ii) top field first; (iii) a 2x2 tile
# grid with a slice segment a tile and the tool row; (iv) the dryrun's
# grid (4x4 tiles of 320x192) over two devices; (v) at 416x240 the three
# intra features of --crypto, bottom field first, and 2x2 tiles with
# --vaq 8
SMOKE_KEY = ",".join(str(17 * i + 3) for i in range(16))
CRYPTO_ON = dict(crypto="on", crypto_key=SMOKE_KEY)
FIELD_TFF = dict(source_scan_type="tff")
TILES_SLICES = dict(TOOL_ROW, tiles=(2, 2), slices="tiles")
EXTRAS_416 = (("crypto intra features",
               dict(crypto="intra_pred_modes+trans_coeffs+trans_coeff_signs",
                    crypto_key=SMOKE_KEY), 1),
              ("bff", dict(source_scan_type="bff"), 1),
              ("tiles 2x2 vaq", dict(tiles=(2, 2), vaq=8), 1))
# phase 14, the 16x16-grid pipelines (--ctu 16) and the host route of
# CTB 32: (i) IDR + 3 P; (ii) the B pyramid of bench.py's scenario 3 (-p
# 24 --gop 8) with the tool row; (iii) -p 1 with frame_batch 2; (iv) their
# 416x240 twins on cuda and on the CPU; (v) CTB 32, every frame intra on
# the host
GRID = dict(ctu_size=16)
GRID_GOP8 = dict(TOOL_ROW, **GOP8, ctu_size=16)
GRID_BATCH = dict(ctu_size=16, intra_period=1, frame_batch=2)
HOST32 = dict(ctu_size=32)
# phase 15, the batched CTB-64 intra program: (i) -p 1 with frame_batch 2
# against the same frames unbatched; (ii) the tool row with
# --pu-depth-intra 1-4 and frame_batch 2
MD_BATCH = dict(intra_period=1, frame_batch=2)
MD_BATCH_TOOLS = dict(TOOL_ROW, intra_period=1, pu_depth_intra=(1, 4),
                      frame_batch=2)
# NAL unit types (H.265 table 7-1) that phase 9 looks for
NAL_NAMES = {0: "TRAIL_N", 1: "TRAIL_R", 8: "RASL_N", 9: "RASL_R",
             19: "IDR_W_RADL", 21: "CRA_NUT"}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    for pool in _POOLS.values():
        pool.shutdown(wait=True, cancel_futures=True)
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
    leaves of several sizes. The patch moves 8 down and 24 across a
    frame, wrapping round inside the picture. Needs w >= 128 and
    h >= 64."""
    rng = np.random.RandomState(8)
    out = []
    for i, (y, cb, cr) in enumerate(synth_frames(n, w, h)):
        _fresh_patch(y, cb, i, rng)
        out.append((y, cb, cr))
    return out


def leaf_frames(n, w, h):
    """All-intra content where NxN 4x4 PUs and 64x64 leaves both win: in
    the left half a mosaic of 4x4 directional gradients (one 8x8 mode
    cannot fit its four quadrants), in the right half a flat top (every
    intra mode predicts it exactly: SATD ties) over a shallow ramp, with
    flat chroma beside a chroma ramp (tools/torch_goldens.py
    intra_frames("halfflat"))."""
    rng = np.random.RandomState(1234)
    out = []
    for i in range(n):
        y = np.zeros((h, w), np.int32)
        for by in range(0, h, 4):
            for bx in range(0, w, 4):
                k = rng.randint(4)
                g = np.add.outer(np.arange(4) * [13, -13, 0, 29][k],
                                 np.arange(4) * [0, 23, -23, -17][k])
                y[by:by + 4, bx:bx + 4] = rng.randint(0, 200) + g
        cb = np.full((h // 2, w // 2), 128, np.int32)
        cr = np.full((h // 2, w // 2), 128, np.int32)
        xs = np.arange(w - w // 2)
        y[:h // 2, w // 2:] = 117 + i
        y[h // 2:, w // 2:] = 90 + (xs // 3)[None, :] + 2 * i
        cr[:, w // 4:] = 100 + np.arange(w // 4)[None, :] // 2
        out.append((y.clip(0, 255).astype(np.uint8), cb.astype(np.uint8),
                    cr.astype(np.uint8)))
    return out


def screen_frames(n, w, h, seed=1234):
    """Screen content (the generator of tests/test_trskip.py,
    `_screen_frame`, with the seed of its `rng` fixture): in the top half
    sparse bright dots on a flat ground (isolated-spike residuals, where
    transform skip wins), below a smooth sine field; Cb with sparse dots
    in its top half, Cr its vertical mirror. Fresh dots every frame."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        y = np.full((h, w), 100, np.uint8)
        dots = rng.rand(h // 2, w) < 0.015
        y[:h // 2][dots] = 230
        xx, yy = np.meshgrid(np.arange(w), np.arange(h // 2))
        y[h // 2:] = (96 + 40 * np.sin(xx / 37) * np.cos(yy / 29)) \
            .astype(np.uint8)
        cb = np.full((h // 2, w // 2), 128, np.uint8)
        cdots = rng.rand(h // 4, w // 2) < 0.02
        cb[:h // 4][cdots] = 240
        out.append((y, cb, cb[::-1].copy()))
    return out


def main10_frames(n, w, h, seed=1234):
    """10-bit content spanning 0-1023 (the generator of
    tests/test_main10.py, `_frames10`, with the seed of its `rng`
    fixture): a wrapping luma ramp with random samples in the bottom-left
    quarter, a sine Cb and random Cr, as uint16."""
    rng = np.random.RandomState(seed)
    xx, yy = np.meshgrid(np.arange(w), np.arange(h))
    out = []
    for i in range(n):
        y = ((280 + xx + yy // 2 + 20 * i) % 1024).astype(np.uint16)
        y[h // 2:, :w // 2] = rng.randint(0, 1024, (h - h // 2, w // 2))
        cb = (512 + 80 * np.sin(xx[:h // 2, :w // 2] / 9)).astype(np.uint16)
        cr = rng.randint(0, 1024, (h // 2, w // 2)).astype(np.uint16)
        out.append((y, cb, cr))
    return out


def _fresh_patch(y, cb, i, rng) -> None:
    """mixed_frames' content of frame i without a temporal match, in
    place: a random-texture patch (luma and Cb) that moves 8 down and 24
    across a frame, and a gradient in the top-left 128x64 whose
    brightness changes."""
    h, w = y.shape
    py, px = 8 + 8 * i % (h - 31), 16 + 24 * i % (w - 55)
    y[py:py + 24, px:px + 40] = rng.randint(0, 256, (24, 40))
    cb[py // 2:py // 2 + 12, px // 2:px // 2 + 20] = \
        rng.randint(60, 200, (12, 20))
    y[40:64, 80:128] = np.clip(np.add.outer(np.arange(24) * 4,
                                            np.arange(48) * 2) + 40 * i,
                               0, 255)


def split_motion_frames(n, w, h, seed=1234, edges=(48,), patch=False):
    """Split-motion content (the generator of tests/test_smp.py, with
    the seed of its `rng` fixture): a textured picture cut into
    horizontal bands at the rows `edges` that pan 4 px a frame in turn
    right and left, so that motion boundaries fall inside CUs and
    rectangular PUs pay. With patch, mixed_frames' fresh content is added
    to every frame (needs w >= 128 and h >= 64)."""
    rng = np.random.RandomState(seed)
    xx, yy = np.meshgrid(np.arange(w), np.arange(h))
    base = np.clip(70 + 50 * np.sin(xx / 13) * np.cos(yy / 9)
                   + rng.randint(-12, 12, (h, w)), 0, 255).astype(np.int32)
    cb = (128 + 25 * np.sin(xx[:h // 2, :w // 2] / 11)).astype(np.uint8)
    cr = (128 + 25 * np.cos(yy[:h // 2, :w // 2] / 15)).astype(np.uint8)
    bounds = [0, *edges, h]
    prng = np.random.RandomState(8)
    out = []
    for i in range(n):
        y = base.copy()
        for j, (a, b) in enumerate(zip(bounds, bounds[1:])):
            y[a:b] = np.roll(base[a:b], 4 * i * (1 - 2 * (j & 1)), axis=1)
        y, fcb = y.astype(np.uint8), cb.copy()
        if patch:
            _fresh_patch(y, fcb, i, prng)
        out.append((y, fcb, cr.copy()))
    return out


# ---------------------------------------------------------------------
# kernel parity and CUDA-vs-CPU stream comparison
# ---------------------------------------------------------------------

def kernel_inputs(ref, src, n, K, gen):
    """The n x n blocks of src in raster order, K random full-pel
    candidates per block reaching +-100 px and EVAL_K_P random pairs of
    qpel MVs per block reaching +-100 px (both far outside the picture,
    so the index clamping is exercised), each MV with a random index
    into a stack of four reference pictures (taken mod 2 on stacks of
    two), on ref's device. Returns (blocks, cands, (mv0, mv1, r0, r1),
    cols)."""
    import torch
    rows, cols = src.shape[0] // n, src.shape[1] // n
    L = rows * cols
    blocks = src.reshape(rows, n, cols, n).permute(0, 2, 1, 3) \
        .reshape(L, n, n).contiguous()
    cands = torch.randint(-100, 101, (L, K, 2), generator=gen,
                          dtype=torch.int32).to(ref.device)
    mvs = tuple(torch.randint(-400, 401, (L, EVAL_K_P, 2), generator=gen,
                              dtype=torch.int32).to(ref.device)
                for _ in range(2))
    refs = tuple(torch.randint(0, 4, (L, EVAL_K_P), generator=gen,
                               dtype=torch.int32).to(ref.device)
                 for _ in range(2))
    return blocks, cands, mvs + refs, cols


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
    cands[:, 2j]), so whole candidates tie too, and me_eval's list 1 MVs
    and reference indices equal to list 0's. Returns (ref, blocks, cands,
    mvs, cols)."""
    import torch
    ref = torch.from_numpy(plane).to(device)
    blocks, cands, (mv0, _, r0, _), cols = kernel_inputs(ref, ref, n, K,
                                                          gen)
    cands[:, 1::2] = cands[:, 0:K - K % 2:2]
    return ref, blocks, cands, (mv0, mv0.clone(), r0, r0.clone()), cols


# me_eval's calls on the main path, per block size of a B frame: (pairs,
# want_satd, want_pred) of the first evaluation of the per-list winners,
# the merge candidates, and the final prediction
EVAL_CALLS = ((1, True, False), (EVAL_K, True, False), (1, False, True))
# and its one-list calls per block size of a P frame: the merge
# candidates and the final prediction
EVAL_CALLS_P = ((EVAL_K_P, True, False), (1, False, True))


def _max_diff(got, want):
    import torch
    torch.cuda.synchronize()
    return max(int((a - b).abs().max()) for a, b in zip(got, want))


def eval_stacks(torch, ref, ref1):
    """Reference stacks of one, two and four pictures made of ref and
    ref1 (the last two pictures shifted copies of them)."""
    return (ref[None], torch.stack([ref, ref1]),
            torch.stack([ref, ref1, ref.roll(3, 1), ref1.roll(5, 0)]))


def eval_errors(me, ref, blocks, mvs, n, cols, ref1):
    """Largest absolute difference between me_eval's outputs and its plain
    version's on the same inputs, with both outputs and in each call
    pattern: of EVAL_CALLS on three pairs of reference stacks, [ref] for
    both lists (indices 0), [ref, ref1] for both lists, [ref, ref1] for
    list 0 and [ref1, ref] for list 1, the last two with the per-pair
    indices of mvs = (mv0, mv1, r0, r1) mod 2 (12 launches); then of
    EVAL_CALLS_P in the one-list mode (mv0 and r0) on stacks of one, two
    and four pictures (eval_stacks; indices 0, r0 mod 2, r0; 9
    launches)."""
    import torch

    def flat(out):
        return [t for part in out if part is not None for t in part]
    mv0, mv1, r0, r1 = mvs
    one, two, four = eval_stacks(torch, ref, ref1)
    zero = torch.zeros_like(r0)
    p0, p1 = r0 % 2, r1 % 2
    cases = [((s0, s1, blocks, mv0, mv1, i0, i1), EVAL_CALLS)
             for s0, s1, i0, i1 in ((one, one, zero, zero), (two, two, p0, p1),
                                    (two, two.flip(0), p0, p1))]
    cases += [((st, None, blocks, mv0, None, i0, None), EVAL_CALLS_P)
              for st, i0 in ((one, zero), (two, p0), (four, r0))]
    err = 0
    for args, calls in cases:
        for k, want_satd, want_pred in calls + ((1, True, True),):
            a = args[:3] + tuple(None if x is None else x[:, :k].contiguous()
                                 for x in args[3:])
            kw = dict(n=n, cols=cols, want_satd=want_satd,
                      want_pred=want_pred)
            err = max(err, _max_diff(flat(me.me_eval(*a, **kw)),
                                     flat(me.me_eval_plain(*a, **kw))))
    return err


def kernel_errors(me, ref, blocks, cands, mvs, lam, n, cols, ref1):
    """Largest absolute difference between each kernel's outputs and its
    plain version's on the same inputs (me_eval as in eval_errors)."""
    return {"me_refine": _max_diff(
        me.me_refine(ref, blocks, cands, lam, n=n, cols=cols),
        me.me_refine_plain(ref, blocks, cands, lam, n, cols)),
        "me_eval": eval_errors(me, ref, blocks, mvs, n, cols, ref1)}


def encode_coded(frames, w, h, dev, cfg):
    """(chunk, decision maps as numpy arrays, waves) per coded frame of
    frames encoded through encode_sequence on dev with cfg."""
    from kvazaar_tpu_torch.api import Encoder, encode_sequence, field_config
    from kvazaar_tpu_torch.cfg import Config
    frame_cfg = Config(width=w, height=h, **cfg)
    enc = Encoder(field_config(frame_cfg), device=dev)
    coded = []

    def record(meta, finalize=enc.finalize_frame):
        chunk, info = finalize(meta)
        maps = {k: (v.cpu().numpy() if hasattr(v, "cpu")
                    else np.asarray(v))
                for k, v in enc._last_decisions.items()}
        coded.append((chunk, maps, int(info["n_waves"])))
        return chunk, info
    enc.finalize_frame = record
    encode_sequence(frame_cfg, frames, encoder=enc)
    return coded


def compare_devices(frames, w, h, cpu=None, **cfg):
    """Encode display-order frames through encode_sequence with the
    configuration cfg (Config options; the defaults when empty) on cuda
    and on the CPU, where the kernels' plain versions run; the CPU encode
    runs in the "cpu" worker process beside the cuda one (cpu: its future
    where it was submitted earlier). Returns the cuda stream and, per
    coded frame (coding order), whether both chunks are identical, the
    decision maps that differ, the waves of the wavefront on each device,
    and the cuda encode's 8x8 cells inside the picture by size code (CTB
    64)."""
    if cpu is None:
        cpu = worker_pool("cpu").submit(encode_coded, frames, w, h, "cpu",
                                        cfg)
    res = {"cuda": encode_coded(frames, w, h, "cuda", cfg),
           "cpu": cpu.result()}
    rows = [{"same_stream": ca == cb,
             "differing_maps": [k for k in ma if k in mb
                                and not np.array_equal(ma[k], mb[k])],
             "waves": (wa, wb),
             "sizes": dict(zip(*(a.tolist() for a in np.unique(
                 ma["size_map8"][:-(-h // 8), :-(-w // 8)],
                 return_counts=True)))) if "size_map8" in ma else {}}
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


def eval_work(n, L, K, hp, wp, planes, want_satd, want_pred, lists=2):
    """One me_eval call of K pairs a block (K candidates of one list when
    lists is 1) that reads `planes` distinct reference pictures
    (eval_pictures): the MVs and reference indices of each list; per list
    the horizontal and vertical 8-tap passes and the rounding; with
    want_satd, for pairs the bi-average and three SATDs (difference, 2-D
    butterflies, |t|, sum), for one list one SATD."""
    sats = 3 if lists == 2 else 1
    nbytes = 4 * (planes * hp * wp + L * n * n + lists * L * K * 3
                  + (sats * L * K if want_satd else 0)
                  + (lists * L * n * n if want_pred else 0))
    per_pair = lists * ((n + 7) * n * 16 + n * n * 20)
    if want_satd:
        per_pair += (n * n * 4 if lists == 2 else 0) + sats * 9 * n * n
    return nbytes, L * K * per_pair


def eval_pictures(args) -> int:
    """Distinct reference pictures that an me_eval call (ref0, ref1,
    blocks, mv0, mv1, r0, r1) reads: the planes its indices name, counted
    once where both lists share one stack (list 0's alone in the one-list
    mode)."""
    import torch
    s0, s1, _, _, _, r0, r1 = args
    if s1 is None:
        return int(r0.unique().numel())
    if s0 is s1:
        return int(torch.cat([r0.reshape(-1), r1.reshape(-1)])
                   .unique().numel())
    return int(r0.unique().numel() + r1.unique().numel())


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


def wrap_timed(torch, obj, keys: dict, store: dict) -> None:
    """Replace methods of obj (attribute name -> key of store) by
    wrappers that append each call's host-clock ms, synchronized before
    and after, to the list store[key]."""
    def wrap(fn, key):
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            r = fn(*a, **kw)
            torch.cuda.synchronize()
            store.setdefault(key, []).append((time.perf_counter() - t) * 1e3)
            return r
        return wrapper
    for attr, key in keys.items():
        if hasattr(obj, attr):
            setattr(obj, attr, wrap(getattr(obj, attr), key))


def time_calls(fn, reps: int) -> tuple:
    """(device ms, wall ms) per fn() over reps runs after one warm-up.
    Wall: host clock around the runs and a synchronize, the longer of
    the host's issue time and the device's. Device: CUDA events around
    the same runs queued behind a spin kernel (torch.cuda._sleep) that
    lasts twice the wall time, so the events enclose the device's work
    back to back and not the host's launch rate."""
    import torch
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * wall_s * 2e9) + 1_000_000)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps, wall_s * 1e3 / reps



def phase_kernels(me, torch, rates):
    """Bit-exact parity of both kernels with their plain versions at the
    slice's 1080p shapes, on the synthetic frames and on the tie-heavy
    planes (me_eval on reference stacks with random and coinciding
    per-pair indices, in both modes, eval_errors); then per block size
    each kernel's time, bound and blocks per SM for one B frame's
    launches with two reference pictures a list, list 1 being list 0
    (the low-delay GOP's pattern: me_refine once per list and picture;
    me_eval as EVAL_CALLS on the two-picture stack with random per-pair
    indices), the B frame's time as their sum, the plain versions' time
    for the same launches, and me_eval's time for the same calls on one
    picture (the default configuration's pattern); then the same for
    me_eval's one-list mode in one P frame's pattern (EVAL_CALLS_P) on
    stacks of one, two and four pictures. rates: ops_rates."""
    hp, wp = H + (-H) % 64, W + (-W) % 64
    ref, src, ref1 = (torch.from_numpy(f[0].astype(np.int32)).cuda()
                      for f in synth_frames(3, wp, hp))
    one, stack, four = eval_stacks(torch, ref, ref1)
    lam = torch.tensor([153], dtype=torch.int32, device="cuda")
    gen = torch.Generator(device="cpu").manual_seed(1)
    err = {"me_refine": 0, "me_eval": 0}
    calls = {"me_refine": {}, "me_eval": {}}
    calls_one = {}
    # one P frame's one-list launches per stack depth
    calls_p = {1: {}, 2: {}, 4: {}}
    for n in (8, 16, 32, 64):
        K = 2 if n <= 16 else 5
        blocks, cands, mvs, cols = kernel_inputs(ref, src, n, K, gen)
        e = kernel_errors(me, ref, blocks, cands, mvs, lam, n, cols, ref1)
        err = {k: max(v, e[k]) for k, v in err.items()}
        print(f"parity n={n} L={blocks.shape[0]} K={K}: max_abs_err "
              f"me_refine {e['me_refine']}, me_eval (pairs: K = 1 and "
              f"{EVAL_K}, stacks of one and two pictures; one list: K = 1 "
              f"and {EVAL_K_P}, stacks of one, two and four pictures; "
              f"every output, random indices) {e['me_eval']}", flush=True)
        for name, plane, lam_t in tie_planes(hp, wp):
            t_ref, t_blocks, t_cands, t_mvs, _ = tie_inputs(
                plane, n, K, gen, "cuda")
            e = kernel_errors(me, t_ref, t_blocks, t_cands, t_mvs,
                              torch.tensor([lam_t], dtype=torch.int32,
                                           device="cuda"), n, cols,
                              t_ref.roll(1, 1).contiguous())
            err = {k: max(v, e[k]) for k, v in err.items()}
            print(f"parity n={n} tie-heavy {name} (lam64 {lam_t}): "
                  f"max_abs_err me_refine {e['me_refine']}, me_eval "
                  f"(coinciding indices) {e['me_eval']}", flush=True)
        # one B frame at this size with two pictures a list, list 1 being
        # list 0: me_refine per list and picture; me_eval in the main
        # path's pattern on the stack
        calls["me_refine"][n] = [
            ((r, blocks, cands, lam), dict(n=n, cols=cols))
            for r in (ref, ref1)] * 2
        mv0, mv1, r0, r1 = mvs
        zero = torch.zeros_like(r0)

        def pattern(st, i0, i1):
            return [((st, st, blocks) + tuple(
                a[:, :k].contiguous() for a in (mv0, mv1, i0, i1)),
                dict(n=n, cols=cols, maxv=255, want_satd=want_satd,
                     want_pred=want_pred))
                for k, want_satd, want_pred in EVAL_CALLS]
        calls["me_eval"][n] = pattern(stack, r0 % 2, r1 % 2)
        calls_one[n] = pattern(one, zero, zero)
        for st, i0 in ((one, zero), (stack, r0 % 2), (four, r0)):
            calls_p[st.shape[0]][n] = [
                ((st, None, blocks, mv0[:, :k].contiguous(), None,
                  i0[:, :k].contiguous(), None),
                 dict(n=n, cols=cols, maxv=255, want_satd=want_satd,
                      want_pred=want_pred))
                for k, want_satd, want_pred in EVAL_CALLS_P]
    if any(err.values()):
        fail(f"kernel/plain mismatch {err}")

    def work(name, args, kw):
        if name == "me_refine":
            return refine_work(kw["n"], args[1].shape[0], args[2].shape[1],
                               hp, wp)
        return eval_work(kw["n"], args[2].shape[0], args[3].shape[1], hp,
                         wp, eval_pictures(args), kw["want_satd"],
                         kw["want_pred"], 1 if args[1] is None else 2)

    def timed(kernel, cs):
        def run():
            for args, kw in cs:
                kernel(*args, **kw)
        return time_calls(run, 10)[0]
    # the kernels alone: me_eval's launches go through me.launch_eval,
    # without the wrapper's index check (it waits for the device); the
    # parity runs above checked the same arguments
    kernels = {"me_refine": me.me_refine, "me_eval": me.launch_eval}
    out = {}
    for name, per_size in calls.items():
        kernel, plain = kernels[name], getattr(me, f"{name}_plain")
        total_ms, works = 0.0, []
        for n, cs in per_size.items():
            ms = timed(kernel, cs)
            total_ms += ms
            ws = [work(name, args, kw) for args, kw in cs]
            works += ws
            b_ms, b_by = bound_ms(ws, rates[name])
            occ = me.kernel_occupancy(name, n)
            print(f"{name} n={n}: {len(cs)} launches {ms:.4f} ms, bound "
                  f"{b_ms:.4f} ms by {b_by}; {occ['blocks_per_sm']} blocks "
                  f"per SM of {occ['threads']} threads ({occ['sources']} "
                  f"source blocks each), {occ['smem']} B shared, "
                  f"{occ['regs']} registers, {occ['local']} B local",
                  flush=True)

        def run_plain():
            for cs in per_size.values():
                for args, kw in cs:
                    if name == "me_refine":
                        plain(*args, kw["n"], kw["cols"])
                    else:
                        plain(*args, **kw)
        plain_ms = time_calls(run_plain, 1)[0]
        b_ms, b_by = bound_ms(works, rates[name])
        out[name] = dict(ms=total_ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by, max_abs_err=err[name],
                         calls=len(works))
        print(f"time {name}: one two-reference B frame's {len(works)} "
              f"launches {total_ms:.4f} ms (plain {plain_ms:.3f} ms, bound "
              f"{b_ms:.4f} ms by {b_by}, {PIPE_LANES[name][0]} rate)",
              flush=True)
    one_ms = {n: timed(me.launch_eval, cs) for n, cs in calls_one.items()}
    works = [work("me_eval", a, kw) for cs in calls_one.values()
             for a, kw in cs]
    b_ms, b_by = bound_ms(works, rates["me_eval"])
    out["me_eval"]["one_ref_ms"] = sum(one_ms.values())
    print(f"time me_eval: the same {len(works)} launches on one picture "
          f"(default configuration) {sum(one_ms.values()):.4f} ms ("
          + " / ".join(f"{v:.4f}" for v in one_ms.values())
          + f" by size), bound {b_ms:.4f} ms by {b_by}", flush=True)
    # the one-list mode: one P frame's launches (EVAL_CALLS_P a size) on
    # stacks of one, two (the P phase's --ref 2) and four pictures
    for R, per_size in calls_p.items():
        p_ms = {n: timed(me.launch_eval, cs) for n, cs in per_size.items()}
        works = [work("me_eval", a, kw) for cs in per_size.values()
                 for a, kw in cs]
        b_ms, b_by = bound_ms(works, rates["me_eval"])

        def run_plain(per_size=per_size):
            for cs in per_size.values():
                for args, kw in cs:
                    me.me_eval_plain(*args, **kw)
        plain_ms = time_calls(run_plain, 1)[0]
        for n in per_size:
            occ = me.kernel_occupancy("me_eval", n, lists=1)
            nb, nw = bound_ms([work("me_eval", a, kw)
                               for a, kw in per_size[n]], rates["me_eval"])
            print(f"me_eval one-list n={n} ({R} pictures): "
                  f"{len(per_size[n])} launches {p_ms[n]:.4f} ms, bound "
                  f"{nb:.4f} ms by {nw}; {occ['blocks_per_sm']} blocks per "
                  f"SM of {occ['threads']} threads ({occ['sources']} source "
                  f"blocks each), {occ['smem']} B shared, {occ['regs']} "
                  f"registers, {occ['local']} B local", flush=True)
        print(f"time me_eval one-list: one P frame's {len(works)} launches "
              f"on {R} pictures {sum(p_ms.values()):.4f} ms (plain "
              f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms by {b_by})",
              flush=True)
        if R == 2:
            out["me_eval_one_list"] = dict(
                ms=sum(p_ms.values()), plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, max_abs_err=err["me_eval"],
                calls=len(works))
    return out


def encode_timed(torch, me, cfg, frames, label, native=True,
                 decoder_kw=None):
    """Encode display-order frames through encode_sequence on cuda with
    the Config options cfg, the kernel launch counters set to 0 just
    before and read just after. Prints the run and, per coded frame
    (coding order), its display index, POC, slice and NAL type, QP, list
    0 and list 1, bytes, PSNR, waves, the cells of each SMP part id (P
    frames with SMP) and the host-clock times (synchronized) of the
    frame's submit, its wavefront, its SAO and its host entropy coding.
    Fails unless every frame without SMP PUs was coded by the native
    slice writers (SMP slices take the Python writer; with native False,
    for --slices and delta QP, every frame the Python writers), each B
    frame launched me_refine 8 times a reference picture of its stacks
    (4 sizes x 2 lists) and me_eval 12 times, each P frame me_refine 4
    times a picture of its stack and me_eval 8 times in its one-list
    mode.
    With tiles the wavefront and SAO times are the sums over the frame's
    tiles, and each tile's waves and submit time are printed too.
    Queues the stream's decode (decode_check, with the HEVCDecoder
    options decoder_kw), which check_decodes requires to be hash-exact,
    in display order and equal to the encoder's reconstruction; field
    coding's encoder is built on the field configuration, and its coded
    pictures are fields. Returns (launches, infos, per coded frame the
    maps size_map8, inter8, dir8, ref8, ref8b, part8, qp_ctb and ts8
    where present, with the frame's chunk and plan: disp, l0, l1, nal)."""
    from kvazaar_tpu_torch.api import Encoder, encode_sequence, field_config
    from kvazaar_tpu_torch.cfg import Config
    h, w = frames[0][0].shape
    frame_cfg = Config(width=w, height=h, **cfg)
    enc = Encoder(field_config(frame_cfg), device="cuda")
    times = {"submit": [], "wavefront": [], "sao": [], "host": []}
    steps = {"_recon_md": "wavefront", "_sao": "sao"}
    tile_pipes = list(getattr(enc._pipeline, "pipes", {}).values())
    for p in tile_pipes:
        wrap_timed(torch, p, {"submit": "tile_submit",
                              **{k: "tile_" + v for k, v in steps.items()}},
                   times)
    wrap_timed(torch, enc._pipeline,
               {"submit": "submit", "submit_inter_b": "submit",
                "submit_inter": "submit", **steps}, times)
    wrap_timed(torch, enc, {"finalize_frame": "host"}, times)
    maps = []
    finalize = enc.finalize_frame

    def record(meta):
        out = finalize(meta)
        m = {k: np.asarray(enc._last_decisions[k])
             for k in ("size_map8", "inter8", "dir8", "ref8", "ref8b",
                       "part8", "qp_ctb", "ts8")
             if k in enc._last_decisions}
        m.update(chunk=out[0], disp=meta["frame_num"], l0=list(meta["l0"]),
                 l1=list(meta["l1"]),
                 nal="IDR" if meta["is_idr"] else meta["nal"]
                 or ("TRAIL_R" if meta["is_ref"] else "TRAIL_N"))
        maps.append(m)
        return out
    enc.finalize_frame = record
    me.me_refine.launches = 0
    me.me_eval.launches = 0
    me.me_eval.one_list_launches = 0
    t0 = time.perf_counter()
    stream, infos = encode_sequence(frame_cfg, frames, encoder=enc)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if tile_pipes:
        n_t = enc.tile_grid.n_tiles
        for k in ("wavefront", "sao"):
            per = times.get("tile_" + k, [])
            times[k] = [sum(per[i:i + n_t]) for i in range(0, len(per), n_t)]
    launches = {"me_refine": me.me_refine.launches,
                "me_eval": me.me_eval.launches,
                "me_eval_one_list": me.me_eval.one_list_launches}
    n_b = sum(1 for i in infos if i["slice_type"] == 0)
    n_p = sum(1 for i in infos if i["slice_type"] == 1)
    # per B frame: me_refine per list, picture and size (2 x R x 4);
    # me_eval per size as EVAL_CALLS (the winners' pair, the merge
    # candidates, the final prediction) x 4 sizes. Per P frame: me_refine
    # per picture and size (R x 4); me_eval per size as EVAL_CALLS_P (the
    # merge candidates, the final prediction) x 4 sizes, one list
    pipe = enc._pipeline
    one_list = 4 * len(EVAL_CALLS_P) * n_p
    expect = {"me_refine": (8 * getattr(pipe, "n_refs_b", 1) * n_b
                            + 4 * getattr(pipe, "n_refs", 1) * n_p),
              "me_eval": 4 * len(EVAL_CALLS) * n_b + one_list,
              "me_eval_one_list": one_list}
    smp = sum("part8" in m for m in maps)
    print(f"{label}: {len(infos)} frames ({n_b} B, {n_p} P) at {w}x{h} in "
          f"{wall:.3f} s = {len(infos) / wall:.4f} fps, {len(stream)} "
          f"bytes, launches {launches} (expected {expect}), native slices "
          f"{enc.native_slices}, SMP slices (Python writer) {smp}",
          flush=True)
    sao = times["sao"] or [None] * len(infos)
    for k, (i, sub, wav, sao_ms, host, m) in enumerate(zip(
            infos, times["submit"], times["wavefront"], sao,
            times["host"], maps)):
        kind = {2: "IDR", 1: "P", 0: "B"}[i["slice_type"]]
        parts = ""
        if "part8" in m:
            ids, cnt = np.unique(m["part8"][m["inter8"].astype(bool)],
                                 return_counts=True)
            parts = (", inter cells by part id "
                     + str(dict(zip(ids.tolist(), cnt.tolist()))))
        print(f"  frame {k} {kind} (display {m['disp']}, POC {i['poc']}, "
              f"{m['nal']}, QP {i['qp']}, l0 {m['l0']}, l1 {m['l1']}): "
              f"{i['bytes']} bytes, PSNR Y "
              f"{i['psnr'][0]:.4f} U {i['psnr'][1]:.4f} V "
              f"{i['psnr'][2]:.4f}, waves {i['n_waves']}{parts}, "
              f"substreams {i['substreams']} in {i['slices']} slice "
              f"segment(s); submit "
              f"wall {sub:.1f} ms, wavefront {wav:.1f} ms, SAO "
              f"{'off' if sao_ms is None else f'{sao_ms:.2f} ms'}, host "
              f"entropy coding {host:.1f} ms", flush=True)
        if tile_pipes:
            sub = times["tile_submit"][k * n_t:(k + 1) * n_t]
            print(f"    tiles: waves {i['tile_waves']}, submit wall ms "
                  f"{[round(x, 1) for x in sub]}", flush=True)
    if launches != expect:
        fail(f"{label}: kernel launches {launches} != {expect}")
    if native and enc.native_slices != len(infos) - smp:
        fail(f"{label}: the native slice writers were not used for every "
             "frame without SMP")
    if not native and enc.native_slices:
        fail(f"{label}: a native slice writer coded a frame that the "
             "Python writers must code")
    recon = [tuple(np.asarray(a) for a in i["recon_out"]) for i in infos]
    _DECODES.append((label, len(infos), worker_pool("decode").submit(
        decode_check, stream, recon, [m["disp"] for m in maps],
        decoder_kw)))
    return launches, infos, maps


# The hash-exact decodes of the encode_timed and encode_grid runs (the
# Python decoder, 1-15 s a 1080p frame) run in one worker process
# ("decode"; phase 14's 1080p streams in one each) beside the next
# phases; main() waits for them and checks them before it reports.
# The CPU halves of compare_devices run in another ("cpu", CPU_THREADS
# intra-op threads) beside their cuda halves.
_DECODES: list = []
_GARBLED: list = []
_POOLS: dict = {}
CPU_THREADS = 4


def _cpu_worker_init():
    import torch
    torch.set_num_threads(CPU_THREADS)


def worker_pool(name: str):
    """The one-process pool (spawn) of that name: "decode" (and phase
    14's "decode_grid_*") or "cpu"."""
    if name not in _POOLS:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        _POOLS[name] = ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn"),
            initializer=_cpu_worker_init if name == "cpu" else None)
    return _POOLS[name]


def decode_check(stream, recon, disp, decoder_kw=None):
    """Decode stream (coded in the order of recon, the encoder's cropped
    planes per coded frame, and disp, their display indices) with the
    HEVCDecoder options decoder_kw (an encrypted stream's key): returns
    each picture's hash_ok, the display indices in output order, whether
    every decoded picture equals the encoder's reconstruction, and the
    seconds it took."""
    from kvazaar_tpu_torch.decoder.decoder import HEVCDecoder
    t = time.perf_counter()
    pics = HEVCDecoder(**(decoder_kw or {})).decode(stream)
    same = len(pics) == len(recon) and all(
        np.array_equal(a, b)
        for p, r in zip(pics, recon) for a, b in zip(p.planes, r))
    return ([p.hash_ok for p in pics], output_order(pics, disp), same,
            time.perf_counter() - t)


def check_decodes() -> None:
    """Wait for the decodes of the encode_timed runs, print them, and fail
    unless each stream decodes hash-exactly, in display order, to the
    encoder's reconstruction; and unless each encrypted stream decoded
    without its key (_GARBLED) parses every picture and misses some
    picture's hash."""
    t = time.perf_counter()
    for label, n, fut in _GARBLED:
        ok, _, same, secs = fut.result()
        print(f"{label} decode without the key: {len(ok)} frames hash_ok "
              f"{ok} ({secs:.1f} s in the decode worker)", flush=True)
        if len(ok) != n or all(ok) or same:
            fail(f"{label}: without the key the stream does not parse "
                 "into garbled pictures")
    for label, n, fut in _DECODES:
        ok, shown, same, secs = fut.result()
        print(f"{label} decode: {len(ok)} frames hash_ok {ok} ({secs:.1f} "
              "s in the decode worker)", flush=True)
        if len(ok) != n or not all(ok):
            fail(f"{label}: the stream does not decode hash-exactly")
        if shown != list(range(n)):
            fail(f"{label}: decoded output order {shown} is not display "
                 "order")
        if not same:
            fail(f"{label}: decoded planes differ from the encoder's "
                 "reconstruction")
    for pool in _POOLS.values():
        pool.shutdown()
    print(f"decodes: waited {time.perf_counter() - t:.1f} s after the last "
          "phase", flush=True)


def output_order(pics, disp) -> list:
    """The display indices (disp, per coded frame) of the decoded
    pictures pics (decoding order) in output order: by POC within each
    coded video sequence, which an IDR picture (POC 0) starts."""
    seq, keys = -1, []
    for p in pics:
        seq += p.poc == 0
        keys.append((seq, p.poc))
    return [disp[k] for k in sorted(range(len(pics)), key=keys.__getitem__)]


def nal_types(stream: bytes) -> list:
    """The nal_unit_type of every NAL unit of an Annex-B stream."""
    out, i = [], stream.find(b"\x00\x00\x01")
    while i >= 0:
        out.append((stream[i + 3] >> 1) & 0x3F)
        i = stream.find(b"\x00\x00\x01", i + 3)
    return out


def future_l1_blocks(m: dict, poc: int) -> int:
    """8x8 cells of a B frame's maps that predict from list 1 (dir8 2 or
    3) on a picture after the frame itself (POC above poc)."""
    if not m["l1"]:
        return 0
    l1 = np.asarray(m["l1"])
    ref = l1[np.minimum(m["ref8b"].astype(np.int64), len(l1) - 1)]
    return int((m["inter8"].astype(bool) & ((m["dir8"] & 2) != 0)
                & (ref > poc)).sum())


def second_ref_blocks(m: dict) -> int:
    """8x8 cells of a B frame's maps whose inter prediction uses picture
    1 of list 0 or of list 1."""
    inter, d = m["inter8"].astype(bool), m["dir8"]
    return int((inter & (((d & 1) != 0) & (m["ref8"] == 1)
                         | ((d & 2) != 0) & (m["ref8b"] == 1))).sum())


def phase_main(torch, me):
    """1 IDR + 3 B frames at 1920x1080 through encode_sequence on cuda
    with the default configuration; every B frame must run the
    wavefront. Returns the launches and the frames' maps."""
    from kvazaar_tpu_torch.api import encode_sequence
    from kvazaar_tpu_torch.cfg import Config
    frames = mixed_frames(4, W, H)
    # warm-up encode (library initialisation, allocator), not counted
    encode_sequence(Config(width=W, height=H), frames[:2], device="cuda")
    torch.cuda.synchronize()
    launches, infos, maps = encode_timed(torch, me, {}, frames,
                                         "main path")
    if any(int(i["n_waves"]) == 0 for i in infos if i["slice_type"] == 0):
        fail("a B frame coded no intra leaf: its wavefront did not run")
    return launches, maps


def phase_tools(torch, me):
    """The tool row: (a) bench scenario 1, 1 all-intra frame at 1080p;
    (b) IDR + 2 B at 1080p with sign hiding too; (c) config (b) at
    416x240 on cuda and on the CPU. Returns the launches of (a) and (b)."""
    la = encode_timed(torch, me, dict(TOOL_ROW, intra_period=1),
                      mixed_frames(1, W, H), "tool row (a) all-intra")[0]
    lb = encode_timed(torch, me, TOOL_LDB, mixed_frames(3, W, H),
                      "tool row (b) IDR + B")[0]
    t = time.perf_counter()
    _, rows = compare_devices(mixed_frames(2, 416, 240), 416, 240,
                              **TOOL_LDB)
    parity_rows("tool row (c)", rows, t)
    return {k: la[k] + lb[k] for k in la}


def phase_lowdelay(torch, me):
    """Bench scenario 2 with the tool row: 6 frames (IDR + 5 B: the
    padded POC 1, every layer of lp-g4d3t1, both references from POC 2
    on) at 1080p through encode_sequence on cuda, hash-exact; some B
    frame must predict from a second reference picture (outside POC 1,
    whose lists repeat one picture) and some B frame must run its
    wavefront. Then the same configuration at 416x240 (5 frames) on cuda
    and on the CPU: the same stream and maps. Returns the launches of the
    1080p encode."""
    cfg = dict(TOOL_ROW, **LOWDELAY)
    launches, infos, maps = encode_timed(
        torch, me, cfg, mixed_frames(6, W, H), "low-delay (bench scenario 2)")
    second = {i["poc"]: second_ref_blocks(m) for i, m in zip(infos, maps)
              if i["slice_type"] == 0}
    print(f"  8x8 cells predicted from a second reference picture, by "
          f"POC: {second}", flush=True)
    if not any(v for p, v in second.items() if p != 1):
        fail("low-delay: no B frame predicts from a second reference")
    if not any(int(i["n_waves"]) for i in infos if i["slice_type"] == 0):
        fail("low-delay: no B frame coded an intra leaf (no wavefront)")
    t = time.perf_counter()
    _, rows = compare_devices(mixed_frames(5, 416, 240), 416, 240, **cfg)
    parity_rows("low-delay", rows, t)
    return launches


def phase_p(torch, me):
    """The P program (--no-bipred) with SMP, AMP and two reference
    pictures: IDR + 3 P of split_motion_frames at 1920x1080 (bands of 64
    rows whose edges fall at y = 48 mod 64, inside CUs, plus fresh
    content) through encode_sequence on cuda, hash-exact, with 8
    me_refine and 8 me_eval launches a P frame; some P frame must choose
    a rectangular PU and some P frame must run its wavefront. Then the
    same configuration at 416x240 (IDR + 2 P) and lp-g4d3t1 --ref 2
    --no-bipred with the tool row (5 frames of mixed_frames at 416x240)
    on cuda and on the CPU: the same streams and maps. Returns the
    launches of the 1080p encode."""
    def frames(n, w, h):
        return split_motion_frames(n, w, h, edges=tuple(range(48, h, 64)),
                                   patch=True)
    launches, infos, maps = encode_timed(torch, me, P_SMP, frames(4, W, H),
                                         "P program (SMP/AMP, --ref 2)")
    rect = {i["poc"]: int(((m["part8"] != 0) & m["inter8"]).sum())
            for i, m in zip(infos, maps) if "part8" in m}
    print(f"  8x8 cells in rectangular PUs, by POC: {rect}", flush=True)
    if not any(rect.values()):
        fail("P program: no P frame chose a rectangular PU")
    if not any(int(i["n_waves"]) for i in infos if i["slice_type"] == 1):
        fail("P program: no P frame coded an intra leaf (no wavefront)")
    for label, cfg, fr in (
            ("P SMP/AMP", P_SMP, frames(3, 416, 240)),
            ("P low-delay", dict(TOOL_ROW, bipred=False, **LOWDELAY),
             mixed_frames(5, 416, 240))):
        t = time.perf_counter()
        _, rows = compare_devices(fr, 416, 240, **cfg)
        parity_rows(label, rows, t)
    return launches


def phase_gop(torch, me):
    """Bench scenario 3 with the tool row: 12 frames of mixed_frames at
    1080p through encode_sequence on cuda (push_frame/flush), hash-exact
    and decoded in display order; some B frame must predict from a
    future picture of list 1. Then --gop 8 -p 8 --open-gop at 416x240
    (10 frames) on cuda and on the CPU: the same stream and maps, with
    CRA, RASL_R and RASL_N pictures. Returns the launches of the 1080p
    encode."""
    launches, infos, maps = encode_timed(
        torch, me, dict(TOOL_ROW, **GOP8), mixed_frames(12, W, H),
        "GOP8 (bench scenario 3)")
    fut = {i["poc"]: future_l1_blocks(m, i["poc"])
           for i, m in zip(infos, maps) if i["slice_type"] == 0}
    print(f"  8x8 cells predicted from a future picture of list 1, by "
          f"POC: {fut}", flush=True)
    if not any(fut.values()):
        fail("GOP8: no B frame predicts from a future picture")
    t = time.perf_counter()
    stream, rows = compare_devices(mixed_frames(10, 416, 240), 416, 240,
                                   **OPEN_GOP)
    for i, r in enumerate(rows):
        print(f"open GOP device parity 416x240 frame {i}: stream "
              f"identical {r['same_stream']}, differing maps "
              f"{r['differing_maps']}, waves cuda/cpu {r['waves']}",
              flush=True)
    kinds = [NAL_NAMES[t] for t in nal_types(stream) if t in NAL_NAMES]
    print(f"open GOP device parity: {time.perf_counter() - t:.1f} s; "
          f"slice NAL types {kinds}", flush=True)
    if not all(r["same_stream"] and not r["differing_maps"] for r in rows):
        fail("open GOP: cuda and CPU encodes differ")
    if not {"CRA_NUT", "RASL_R", "RASL_N"} <= set(kinds):
        fail("open GOP: no CRA, RASL_R or RASL_N picture")
    return launches


def phase_presets(torch, me):
    """The preset ladder: --preset medium, 5 frames of mixed_frames at
    1080p through encode_sequence on cuda (IDR, P 4, B 2 1 3), hash-exact,
    with NxN cells in the IDR; per frame the cells by size code. Then
    INTRA_LEAVES on one frame of leaf_frames at 416x240 and SMALL_PRESETS
    at 416x240 (3 frames each), each on cuda and on the CPU: the same
    streams and maps, with LEAF_SHARES of NxN and 64x64 cells in the
    first. Returns the launches of the 1080p encode."""
    from kvazaar_tpu_torch.cfg import PRESETS
    launches, infos, maps = encode_timed(
        torch, me, dict(PRESETS["medium"]), mixed_frames(5, W, H),
        "preset medium")
    for i, m in zip(infos, maps):
        codes, cnt = np.unique(m["size_map8"], return_counts=True)
        print(f"  POC {i['poc']}: 8x8 cells by size code "
              f"{dict(zip(codes.tolist(), cnt.tolist()))}", flush=True)
    idr = maps[0]["size_map8"]
    if not (idr == 4).any():
        fail("preset medium: the IDR coded no NxN cell")
    t = time.perf_counter()
    _, rows = compare_devices(leaf_frames(1, 416, 240), 416, 240,
                              **INTRA_LEAVES)
    for i, r in enumerate(rows):
        cells = sum(r["sizes"].values())
        print(f"intra leaves device parity 416x240 frame {i}: stream "
              f"identical {r['same_stream']}, differing maps "
              f"{r['differing_maps']}, waves cuda/cpu {r['waves']}, 8x8 "
              f"cells by size code {r['sizes']} of {cells}", flush=True)
        for code, share in LEAF_SHARES.items():
            if r["sizes"].get(code, 0) < share * cells:
                fail(f"intra leaves: frame {i} codes fewer than {share:.0%}"
                     f" of its cells with size code {code}")
    print(f"intra leaves device parity: {time.perf_counter() - t:.1f} s",
          flush=True)
    if not all(r["same_stream"] and not r["differing_maps"] for r in rows):
        fail("intra leaves: cuda and CPU encodes differ")
    for name in SMALL_PRESETS:
        t = time.perf_counter()
        _, rows = compare_devices(mixed_frames(3, 416, 240), 416, 240,
                                  **PRESETS[name])
        parity_rows(f"preset {name}", rows, t)
    return launches


def parity_rows(label, rows, t) -> None:
    """Print compare_devices' rows; fail unless every frame's stream and
    maps are the same on cuda and on the CPU."""
    for i, r in enumerate(rows):
        print(f"{label} device parity 416x240 frame {i}: stream identical "
              f"{r['same_stream']}, differing maps {r['differing_maps']}, "
              f"waves cuda/cpu {r['waves']}", flush=True)
    print(f"{label} device parity: {time.perf_counter() - t:.1f} s",
          flush=True)
    if not all(r["same_stream"] and not r["differing_maps"] for r in rows):
        fail(f"{label}: cuda and CPU encodes differ")


def phase_rc(torch, me, main_maps):
    """WPP, rate control and delta QP: (i) WPP_SLICES, IDR + 2 B of
    mixed_frames at 1080p, 17 slice segments a picture, the maps those
    of the main path's first three frames; (ii) WPP_RC, IDR + 3 B at
    1080p, 17 substreams a slice, the QP moving; (iii) LCU_OBA, 2 frames
    at 1080p, the first frame's CTB QPs not all equal; all hash-exact. (iv)
    VAQ_ROI (2 frames) and GOP_OBA (5 frames) at 416x240 on cuda and on
    the CPU: the same streams and maps. Returns the launches of (i) to
    (iii)."""
    import tempfile
    rows_ctb = -(-H // 64)
    li, infos, maps = encode_timed(torch, me, WPP_SLICES,
                                   mixed_frames(3, W, H),
                                   "WPP slices (i)", native=False)
    if any((i["slices"], i["substreams"]) != (rows_ctb, rows_ctb)
           for i in infos):
        fail(f"WPP slices: not {rows_ctb} slice segments a picture")
    for k, (m, mm) in enumerate(zip(maps, main_maps)):
        bad = [key for key, v in m.items() if key in mm
               and isinstance(v, np.ndarray)
               and not np.array_equal(v, mm[key])]
        print(f"  frame {k}: maps that differ from the main path's {bad}",
              flush=True)
        if bad:
            fail("WPP slices: maps differ from the main path's")
    lii, infos, _ = encode_timed(torch, me, WPP_RC, mixed_frames(4, W, H),
                                 "WPP + lambda RC (ii)")
    qps = [i["qp"] for i in infos]
    print(f"  QP {qps}, bits {[8 * i['bytes'] for i in infos]}",
          flush=True)
    if len(set(qps)) < 2:
        fail("WPP + lambda RC: the QP never moved")
    if any((i["slices"], i["substreams"]) != (1, rows_ctb) for i in infos):
        fail(f"WPP + lambda RC: not {rows_ctb} substreams in one slice")
    liii, infos, maps = encode_timed(torch, me, LCU_OBA,
                                     mixed_frames(2, W, H),
                                     "LCU OBA RC (iii)", native=False)
    for k, (i, m) in enumerate(zip(infos, maps)):
        q = m["qp_ctb"]
        vals, cnt = np.unique(q, return_counts=True)
        print(f"  frame {k}: frame QP {i['qp']}, CTB QPs "
              f"{int(q.min())}..{int(q.max())}, CTBs by QP "
              f"{dict(zip(vals.tolist(), cnt.tolist()))}", flush=True)
    if maps[0]["qp_ctb"].min() == maps[0]["qp_ctb"].max():
        fail("LCU OBA RC: the first frame's CTB QPs are all equal")
    with tempfile.TemporaryDirectory() as tmp:
        roi = os.path.join(tmp, "roi.txt")
        with open(roi, "w") as f:
            f.write(SMOKE_ROI)
        for label, cfg, n in (
                ("VAQ + ROI (iv)", dict(VAQ_ROI, roi_file=roi), 2),
                ("GOP 4 WPP slices OBA (iv)", GOP_OBA, 5)):
            t = time.perf_counter()
            _, rows = compare_devices(mixed_frames(n, 416, 240), 416, 240,
                                      **cfg)
            parity_rows(label, rows, t)
    return {k: li[k] + lii[k] + liii[k] for k in li}


def stream_sps(stream: bytes):
    """The SPS of an Annex-B stream, through the port's parser."""
    from kvazaar_tpu_torch.bitstream import (NAL_SPS, ebsp_to_rbsp,
                                             split_annexb)
    from kvazaar_tpu_torch.hevc.headers import parse_sps
    for nal_type, _, ebsp in split_annexb(stream):
        if nal_type == NAL_SPS:
            return parse_sps(ebsp_to_rbsp(ebsp))
    fail("no SPS in the stream")


def phase_variants(torch, me):
    """The remaining intra variants: (i) TRSKIP_FCT, IDR + 1 B of
    screen_frames at 1080p through the Python writers, hash-exact, with
    transform skip chosen in the IDR (its ts8 map) and 8 me_refine and 12
    me_eval launches a B frame; (ii) MAIN10_SCALING, 1 frame of
    main10_frames at 1080p through the native writer, hash-exact, its SPS
    Main 10 with scaling lists; (iii) VARIANTS_416 at 416x240 on cuda and
    on the CPU: the same streams and maps, hash-exact, the lossless
    reconstruction the source. Returns the launches of (i) and (ii)."""
    from kvazaar_tpu_torch.decoder.decoder import HEVCDecoder
    li, infos, maps = encode_timed(torch, me, TRSKIP_FCT,
                                   screen_frames(2, W, H),
                                   "transform skip + fct (i)", native=False)
    ts8 = maps[0]["ts8"]
    print(f"  IDR transform-skip TUs: NxN luma {int(ts8[..., :4].sum())}, "
          f"Cb {int(ts8[..., 4].sum())}, Cr {int(ts8[..., 5].sum())}; "
          f"NxN cells {int((maps[0]['size_map8'] == 4).sum())}", flush=True)
    if not ts8.any():
        fail("transform skip: the IDR chose it on no TU")
    lii, infos, maps = encode_timed(torch, me, MAIN10_SCALING,
                                    main10_frames(1, W, H),
                                    "Main 10 + scaling lists (ii)")
    sps = stream_sps(maps[0]["chunk"])
    rec_y = infos[0]["recon_out"][0]
    print(f"  SPS: profile {sps.ptl.general_profile_idc}, bit depth "
          f"{sps.bit_depth_luma}/{sps.bit_depth_chroma}, scaling lists "
          f"{sps.scaling_list_enabled}; reconstructed luma "
          f"{int(rec_y.min())}..{int(rec_y.max())}", flush=True)
    if (sps.ptl.general_profile_idc, sps.bit_depth_luma,
            sps.scaling_list_enabled) != (2, 10, 1):
        fail("Main 10: the SPS is not Main 10 with scaling lists")
    for name, cfg, kind, n in VARIANTS_416:
        t = time.perf_counter()
        frames = (main10_frames(n, 416, 240) if kind == "main10"
                  else mixed_frames(n, 416, 240))
        stream, rows = compare_devices(frames, 416, 240, **cfg)
        parity_rows(f"{name} (iii)", rows, t)
        pics = HEVCDecoder().decode(stream)
        if len(pics) != n or not all(p.hash_ok for p in pics):
            fail(f"{name}: the stream does not decode hash-exactly")
        if name == "lossless" and not all(
                np.array_equal(a, b) for p, f in zip(pics, frames)
                for a, b in zip(p.planes, f)):
            fail("lossless: the reconstruction is not the source")
    return {k: li[k] + lii[k] for k in li}


def smoke_key() -> bytes:
    """The --key bytes as the encoder reads them (each value & 0xff)."""
    return bytes(int(t) & 0xff for t in SMOKE_KEY.split(","))


def pic_structs(stream: bytes) -> list:
    """pic_struct of every pic_timing SEI of an Annex-B stream."""
    from kvazaar_tpu_torch.bitstream import (NAL_PREFIX_SEI, ebsp_to_rbsp,
                                             split_annexb)
    return [ebsp_to_rbsp(e)[2] >> 4 for t, _, e in split_annexb(stream)
            if t == NAL_PREFIX_SEI and ebsp_to_rbsp(e)[0] == 1]


def phase_extras(torch, me):
    """Selective encryption, field coding and tiles at 1080p: (i)
    CRYPTO_ON, IDR + 2 B of mixed_frames through the Python writers,
    hash-exact with the key, parsed but not hash-exact without it; (ii)
    FIELD_TFF, 2 frames as 4 fields of 1920x540 (padded to 576; IDR + 3
    B), an interlaced source in the SPS, a pic_timing SEI a picture (top,
    bottom, top, bottom), hash-exact 540-line pictures; (iii)
    TILES_SLICES, 1 frame through TiledIntraPipeline, a slice segment a
    tile, hash-exact, each tile's waves and submit time; (iv) the
    dryrun's 4x4 grid at 1280x768 (its first frame) through
    MeshTiledIntraPipeline over cuda:0 twice (or the CUDA devices present
    where there are two or more), hash-exact and byte-identical to
    TiledIntraPipeline's stream of the same frames on the CPU (coded in
    the "cpu" worker from the start of the phase); (v) EXTRAS_416 at
    416x240 on cuda and on the CPU: the same streams and maps,
    hash-exact. Returns the launches of (i) to (iii)."""
    from kvazaar_tpu_torch.decoder.decoder import HEVCDecoder
    from kvazaar_tpu_torch.parallel import dryrun
    t13 = time.perf_counter()
    tiled_cpu = worker_pool("cpu").submit(dryrun.tiled_stream, 4, "cpu", 1)
    t = time.perf_counter()
    frames = mixed_frames(3, W, H)
    key = dict(crypto="on", crypto_key=smoke_key())
    li, infos, maps = encode_timed(torch, me, CRYPTO_ON, frames,
                                   "crypto on (i)", native=False,
                                   decoder_kw=key)
    stream = b"".join(m["chunk"] for m in maps)
    _GARBLED.append(("crypto on (i)", len(infos), worker_pool(
        "decode").submit(decode_check, stream,
                         [tuple(np.asarray(a) for a in i["recon_out"])
                          for i in infos], list(range(len(infos))))))
    print(f"crypto on (i): {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    lii, infos, maps = encode_timed(torch, me, FIELD_TFF,
                                    mixed_frames(2, W, H), "fields tff (ii)")
    stream = b"".join(m["chunk"] for m in maps)
    sps, structs = stream_sps(stream), pic_structs(stream)
    shapes = [i["recon_out"][0].shape for i in infos]
    src = (sps.ptl.general_interlaced_source_flag,
           sps.ptl.general_progressive_source_flag)
    print(f"  SPS interlaced/progressive source {src}, coded "
          f"{sps.width}x{sps.height}, conformance window {sps.conf_win}; "
          f"pic_struct {structs}; pictures {shapes}; "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    if (src, structs, shapes) != ((1, 0), [1, 2, 1, 2], [(H // 2, W)] * 4):
        fail("fields: not four 540-line field pictures with pic_timing")
    t = time.perf_counter()
    liii, infos, _ = encode_timed(torch, me, TILES_SLICES,
                                  mixed_frames(1, W, H),
                                  "tiles 2x2 slices tiles (iii)",
                                  native=False)
    print(f"tiles (iii): {time.perf_counter() - t:.1f} s", flush=True)
    if any((i["slices"], i["substreams"]) != (4, 4) for i in infos):
        fail("tiles: not a slice segment a tile")
    t = time.perf_counter()
    devs = dryrun.dryrun_devices(max(2, torch.cuda.device_count()), "cuda")
    stream, infos, mesh, mesh_s = dryrun.mesh_stream(devs, 4, 1)
    ref, cpu_s = tiled_cpu.result()
    print(f"mesh (iv): devices {[str(d) for d in devs]}, mesh {mesh}, "
          f"{len(infos)} frames, {len(stream)} bytes, tiles a frame "
          f"{[len(i['tile_waves']) for i in infos]}, mesh encode "
          f"{mesh_s:.1f} s; the CPU's TiledIntraPipeline stream "
          f"{len(ref)} bytes in {cpu_s:.1f} s, identical "
          f"{stream == ref}; {time.perf_counter() - t:.1f} s", flush=True)
    if stream != ref:
        fail("mesh: the stream differs from TiledIntraPipeline's")
    _DECODES.append(("mesh (iv)", len(infos), worker_pool("decode").submit(
        decode_check, stream,
        [tuple(np.asarray(a) for a in i["recon_out"]) for i in infos],
        list(range(len(infos))))))
    for label, cfg, n in EXTRAS_416:
        t = time.perf_counter()
        frames = mixed_frames(n, 416, 240)
        stream, rows = compare_devices(frames, 416, 240, **cfg)
        parity_rows(f"{label} (v)", rows, t)
        kw = ({"crypto": cfg["crypto"], "crypto_key": smoke_key()}
              if "crypto" in cfg else {})
        pics = HEVCDecoder(**kw).decode(stream)
        if len(pics) != len(rows) or not all(p.hash_ok for p in pics):
            fail(f"{label}: the stream does not decode hash-exactly")
    print(f"phase 13: {time.perf_counter() - t13:.1f} s", flush=True)
    return {k: li[k] + lii[k] + liii[k] for k in li}


def encode_grid(torch, me, cfg, frames, label, decode="decode"):
    """Encode display-order frames through encode_sequence on cuda (the
    host route of CTB 32 runs nothing there) with the Config options cfg,
    the kernel launch counters set to 0 just before and read just after:
    the grid pipelines launch neither kernel. Prints per coded frame its
    kind, display index, POC, QP, bytes, PSNR, waves, and the host-clock
    ms (synchronized) of its submit call (frame_batch: one call a batch),
    its wavefront and its host entropy coding; queues the stream's
    hash-exact decode (check_decodes) in the worker pool named decode
    (None: no decode). Returns (launches, stream, infos, per coded frame
    the chunk, display index and inter share)."""
    from kvazaar_tpu_torch.api import Encoder, encode_sequence, field_config
    from kvazaar_tpu_torch.cfg import Config
    h, w = frames[0][0].shape
    frame_cfg = Config(width=w, height=h, **cfg)
    enc = Encoder(field_config(frame_cfg), device="cuda")
    times: dict = {}
    if enc._pipeline is not None:
        wrap_timed(torch, enc._pipeline,
                   {"submit_many": "submit", "submit_inter": "submit",
                    "submit_inter_b": "submit", "_wave_loop": "wavefront"},
                   times)
    wrap_timed(torch, enc, {"finalize_frame": "host"}, times)
    coded = []
    finalize = enc.finalize_frame

    def record(meta):
        out = finalize(meta)
        d = enc._last_decisions or {}
        coded.append({"chunk": out[0], "disp": meta["frame_num"],
                      "inter": (float(np.mean(d["is_inter"]))
                                if "is_inter" in d else None)})
        return out
    enc.finalize_frame = record
    me.me_refine.launches = 0
    me.me_eval.launches = 0
    me.me_eval.one_list_launches = 0
    t0 = time.perf_counter()
    stream, infos = encode_sequence(frame_cfg, frames, encoder=enc)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"me_refine": me.me_refine.launches,
                "me_eval": me.me_eval.launches,
                "me_eval_one_list": me.me_eval.one_list_launches}
    print(f"{label}: {len(infos)} frames at {w}x{h} in {wall:.3f} s = "
          f"{len(infos) / wall:.4f} fps, {len(stream)} bytes, pipeline "
          f"{type(enc._pipeline).__name__}, launches {launches}, native "
          f"slices {enc.native_slices}; submit calls ms "
          f"{[round(x, 1) for x in times.get('submit', [])]}", flush=True)
    for k, (i, c) in enumerate(zip(infos, coded)):
        kind = {2: "IDR", 1: "P", 0: "B"}[i["slice_type"]]
        wav = times.get("wavefront", [])
        host = times["host"][k]
        print(f"  frame {k} {kind} (display {c['disp']}, POC {i['poc']}, "
              f"QP {i['qp']}): {i['bytes']} bytes, PSNR Y "
              f"{i['psnr'][0]:.4f} U {i['psnr'][1]:.4f} V "
              f"{i['psnr'][2]:.4f}, waves {i['n_waves']}, inter blocks "
              f"{c['inter']}, substreams "
              f"{i['substreams']} in {i['slices']} slice segment(s); "
              + (f"wavefront {wav[k]:.1f} ms, " if k < len(wav) else "")
              + f"host {host:.1f} ms", flush=True)
    if any(launches.values()):
        fail(f"{label}: the grid path launched a kernel: {launches}")
    if decode:
        recon = [tuple(np.asarray(a) for a in i["recon_out"])
                 for i in infos]
        _DECODES.append((label, len(infos), worker_pool(decode).submit(
            decode_check, stream, recon, [c["disp"] for c in coded])))
    return launches, stream, infos, coded


def phase_grid(torch, me):
    """The 16x16-grid pipelines (--ctu 16) and the host route of CTB 32:
    (i) GRID, IDR + 3 P of mixed_frames at 1920x1080 (padded to 1088 with
    a conformance window), some P block inter and some intra; (ii)
    GRID_GOP8, 9 frames at 1080p through push_frame/flush (IDR, P 8, B 4
    2 1 3 6 5 7); (iii) GRID_BATCH, 2 frames at 1080p through one pass of
    the waves, the stream equal to the unbatched one; each hash-exact;
    (iv) (i)-(iii) at 416x240 on cuda and on the CPU: the same streams and
    maps; (v) HOST32, 2 frames at 416x240 on the host, hash-exact. Returns
    the launches (none)."""
    from kvazaar_tpu_torch.decoder.decoder import HEVCDecoder
    t14 = time.perf_counter()
    twins = [(label, cfg, n, worker_pool("cpu").submit(
        encode_coded, mixed_frames(n, 416, 240), 416, 240, "cpu", cfg))
        for label, cfg, n in (("ctu 16 P (iv)", GRID, 4),
                              ("ctu 16 gop 8 (iv)", GRID_GOP8, 9),
                              ("ctu 16 batch (iv)", GRID_BATCH, 2))]
    runs = []
    # (ii) first: its decode is the longest (about 70 s a 1080p GOP); each
    # 1080p decode runs in a worker of its own beside the phase
    t = time.perf_counter()
    lii, _, infos, coded = encode_grid(torch, me, GRID_GOP8,
                                       mixed_frames(9, W, H),
                                       "ctu 16 gop 8 tool row (ii)",
                                       decode="decode_grid_ii")
    runs.append(lii)
    order = [c["disp"] for c in coded]
    print(f"ctu 16 (ii): coding order {order}; "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    if order != [0, 8, 4, 2, 1, 3, 6, 5, 7] or \
            sum(i["slice_type"] == 0 for i in infos) != 7:
        fail("ctu 16 (ii): not the GOP 8 pyramid's coding order")
    t = time.perf_counter()
    li, _, infos, coded = encode_grid(torch, me, GRID,
                                      mixed_frames(4, W, H),
                                      "ctu 16 IDR + 3 P (i)",
                                      decode="decode_grid_i")
    runs.append(li)
    print(f"ctu 16 (i): {time.perf_counter() - t:.1f} s", flush=True)
    if [i["slice_type"] for i in infos] != [2, 1, 1, 1]:
        fail("ctu 16 (i): not IDR + 3 P")
    if not all(c["inter"] for c in coded[1:]):
        fail("ctu 16 (i): a P frame coded no inter block")
    t = time.perf_counter()
    frames = mixed_frames(2, W, H)
    liii, batched, _, _ = encode_grid(torch, me, GRID_BATCH, frames,
                                      "ctu 16 frame_batch 2 (iii)",
                                      decode="decode_grid_iii")
    runs.append(liii)
    # equal to the batched stream, which is decoded
    _, single, _, _ = encode_grid(torch, me, dict(GRID_BATCH,
                                                  frame_batch=0), frames,
                                  "ctu 16 unbatched (iii)", decode=None)
    print(f"ctu 16 (iii): batched stream equal to the unbatched one "
          f"{batched == single}; {time.perf_counter() - t:.1f} s",
          flush=True)
    if batched != single:
        fail("ctu 16 (iii): frame_batch changed the stream")
    for label, cfg, n, cpu in twins:
        t = time.perf_counter()
        stream, rows = compare_devices(mixed_frames(n, 416, 240), 416, 240,
                                       cpu=cpu, **cfg)
        parity_rows(label, rows, t)
        pics = HEVCDecoder().decode(stream)
        if len(pics) != n or not all(p.hash_ok for p in pics):
            fail(f"{label}: the stream does not decode hash-exactly")
    t = time.perf_counter()
    lv, _, infos, _ = encode_grid(torch, me, HOST32,
                                  mixed_frames(2, 416, 240),
                                  "ctu 32 host route (v)")
    runs.append(lv)
    print(f"ctu 32 (v): {time.perf_counter() - t:.1f} s", flush=True)
    print(f"phase 14: {time.perf_counter() - t14:.1f} s", flush=True)
    return {k: sum(r[k] for r in runs) for k in li}


def encode_batched(torch, cfg, frames, label):
    """Encode all-intra frames through encode_sequence on cuda with the
    Config options cfg (CTB 64). Prints the run: the frames' waves and
    the host-clock ms (synchronized) of each submit call (submit_many:
    one call a batch) and of each wavefront. Returns (stream, infos, per
    coded frame every decision map as numpy, the ms by "submit" and
    "wavefront")."""
    from kvazaar_tpu_torch.api import Encoder, encode_sequence
    from kvazaar_tpu_torch.cfg import Config
    h, w = frames[0][0].shape
    frame_cfg = Config(width=w, height=h, **cfg)
    enc = Encoder(frame_cfg, device="cuda")
    times: dict = {}
    wrap_timed(torch, enc._pipeline, {"submit": "submit",
                                      "submit_many": "submit",
                                      "_recon_md": "wavefront"}, times)
    maps = []
    finalize = enc.finalize_frame

    def record(meta):
        out = finalize(meta)
        maps.append({k: (v.cpu().numpy() if hasattr(v, "cpu")
                         else np.asarray(v))
                     for k, v in enc._last_decisions.items()})
        return out
    enc.finalize_frame = record
    t0 = time.perf_counter()
    stream, infos = encode_sequence(frame_cfg, frames, encoder=enc)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"{label}: {len(infos)} frames at {w}x{h} in {wall:.3f} s = "
          f"{len(infos) / wall:.4f} fps, {len(stream)} bytes, PSNR Y "
          f"{[round(float(i['psnr'][0]), 4) for i in infos]}, waves "
          f"{[i['n_waves'] for i in infos]}; submit calls ms "
          f"{[round(x, 1) for x in times['submit']]}, wavefront calls ms "
          f"{[round(x, 1) for x in times['wavefront']]}", flush=True)
    return stream, infos, maps, times


def phase_batch(torch, me):
    """The batched CTB-64 intra program: (i) MD_BATCH, 2 frames of
    mixed_frames at 1080p through one search and one wavefront
    (MdIntraPipeline.submit_many), then the same frames unbatched
    (frame_batch 0): the same stream and every map of each frame equal
    (the waves included), the batched stream hash-exact; (ii)
    MD_BATCH_TOOLS, 3 frames at 416x240 on cuda and on the CPU (a full
    batch, then a partial one): the same streams and maps, hash-exact.
    Returns the kernel launches of (i): all-intra frames launch neither
    kernel."""
    from kvazaar_tpu_torch.decoder.decoder import HEVCDecoder
    t15 = time.perf_counter()
    twin = worker_pool("cpu").submit(encode_coded, mixed_frames(3, 416, 240),
                                     416, 240, "cpu", MD_BATCH_TOOLS)
    frames = mixed_frames(2, W, H)
    me.me_refine.launches = 0
    me.me_eval.launches = 0
    me.me_eval.one_list_launches = 0
    b_stream, b_infos, b_maps, b_t = encode_batched(
        torch, MD_BATCH, frames, "ctb 64 frame_batch 2 (i)")
    s_stream, s_infos, s_maps, s_t = encode_batched(
        torch, dict(MD_BATCH, frame_batch=0), frames,
        "ctb 64 unbatched (i)")
    launches = {"me_refine": me.me_refine.launches,
                "me_eval": me.me_eval.launches,
                "me_eval_one_list": me.me_eval.one_list_launches}
    differ = sorted({k for b, u in zip(b_maps, s_maps) for k in b
                     if k not in u or not np.array_equal(b[k], u[k])})
    waves = ([i["n_waves"] for i in b_infos], [i["n_waves"] for i in s_infos])
    print(f"ctb 64 (i): batched stream equal to the unbatched one "
          f"{b_stream == s_stream}, differing maps {differ}, waves a frame "
          f"batched {waves[0]} unbatched {waves[1]}; submit ms batched "
          f"{b_t['submit'][0]:.1f} (both frames) against unbatched "
          f"{s_t['submit'][0]:.1f} + {s_t['submit'][1]:.1f} = "
          f"{sum(s_t['submit']):.1f}; launches {launches}; "
          f"{time.perf_counter() - t15:.1f} s", flush=True)
    if b_stream != s_stream or differ or waves[0] != waves[1]:
        fail("ctb 64 (i): frame_batch changed the stream or a map")
    if len(b_t["submit"]) != 1 or len(s_t["submit"]) != 2:
        fail("ctb 64 (i): not one submit call a batch")
    if any(launches.values()):
        fail(f"ctb 64 (i): an all-intra encode launched a kernel: "
             f"{launches}")
    _DECODES.append(("ctb 64 frame_batch 2 (i)", len(b_infos),
                     worker_pool("decode").submit(
                         decode_check, b_stream,
                         [tuple(np.asarray(a) for a in i["recon_out"])
                          for i in b_infos], list(range(len(b_infos))))))
    t = time.perf_counter()
    stream, rows = compare_devices(mixed_frames(3, 416, 240), 416, 240,
                                   cpu=twin, **MD_BATCH_TOOLS)
    parity_rows("ctb 64 frame_batch 2 tool row (ii)", rows, t)
    pics = HEVCDecoder().decode(stream)
    if len(pics) != 3 or not all(p.hash_ok for p in pics):
        fail("ctb 64 (ii): the stream does not decode hash-exactly")
    print(f"phase 15: {time.perf_counter() - t15:.1f} s", flush=True)
    return launches


def phase_device_parity(cpu):
    """IDR + 1 B at 1920x1080 on cuda give the CPU path's stream and
    decision maps; cpu: the CPU half's future (encode_coded in the "cpu"
    worker, submitted before phase 3 so that it runs beside phases 3-4)."""
    t = time.perf_counter()
    _, rows = compare_devices(mixed_frames(2, W, H), W, H, cpu=cpu)
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


# phases run in child processes beside the main chain once the kernel
# timings of phase 3 are taken: the card is mostly idle during the
# wavefronts (launch-bound eager ops), so the phases' host dispatch runs
# in parallel; each group a process, its phases in order
CHILD_PHASES = {"presets": "phase_presets", "variants": "phase_variants",
                "extras": "phase_extras", "grid": "phase_grid",
                "batch": "phase_batch"}
CHILD_GROUPS = (("presets", "grid", "batch"), ("variants", "extras"))
_CHILDREN: list = []


def run_child(names) -> None:
    """The child process of start_children: open the card, run the named
    phases (CHILD_PHASES) with the CPU halves of their cuda-against-CPU
    runs on 2 intra-op threads, check their decodes, and print their
    summed kernel launches as a JSON line last."""
    import torch
    global CPU_THREADS
    CPU_THREADS = 2
    me = open_device(torch)[0]
    runs = [globals()[CHILD_PHASES[n]](torch, me) for n in names]
    check_decodes()
    print(json.dumps({"launches": {k: sum(r[k] for r in runs)
                                   for k in runs[0]}}), flush=True)


def start_children() -> None:
    """Start a child process a group of CHILD_GROUPS, each in a session
    of its own (with its worker processes), its output to a temporary
    file; atexit stops any still running, workers included."""
    import atexit
    import tempfile
    here = os.path.dirname(os.path.abspath(__file__))
    atexit.register(_stop_children)
    for names in CHILD_GROUPS:
        log = tempfile.TemporaryFile()
        proc = subprocess.Popen(
            [sys.executable, os.path.join(here, "chip_smoke.py"),
             "--phases", ",".join(names)], cwd=here, stdout=log,
            stderr=subprocess.STDOUT, start_new_session=True)
        _CHILDREN.append((names, proc, log))


def _stop_children() -> None:
    import signal
    for _, proc, _ in _CHILDREN:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()


def join_children() -> list:
    """Wait for the child processes, print their output, fail unless each
    exited 0; returns their kernel launches."""
    t = time.perf_counter()
    runs = []
    for names, proc, log in _CHILDREN:
        rc = proc.wait()
        log.seek(0)
        out = log.read().decode(errors="replace").rstrip("\n").split("\n")
        print(f"--- phases {', '.join(names)} (a child process) ---",
              flush=True)
        print("\n".join(out), flush=True)
        if rc != 0:
            fail(f"the child process of phases {names} exited {rc}")
        runs.append(json.loads(out[-1])["launches"])
    print(f"children: waited {time.perf_counter() - t:.1f} s after the "
          "main chain", flush=True)
    return runs


def main() -> None:
    import torch
    if "--phases" in sys.argv:
        run_child(sys.argv[sys.argv.index("--phases") + 1].split(","))
        return
    t_start = time.perf_counter()
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

    # phase 5's CPU half (about a minute) runs beside phases 3-4
    parity_cpu = worker_pool("cpu").submit(encode_coded,
                                           mixed_frames(2, W, H), W, H,
                                           "cpu", {})
    kern = phase_kernels(me, torch, rates)
    start_children()
    main_launches, main_maps = phase_main(torch, me)
    runs = [main_launches]
    phase_device_parity(parity_cpu)
    runs.append(phase_tools(torch, me))
    runs.append(phase_lowdelay(torch, me))
    runs.append(phase_p(torch, me))
    runs.append(phase_gop(torch, me))
    runs.append(phase_rc(torch, me, main_maps))
    check_decodes()
    runs.extend(join_children())
    launches = {k: sum(r[k] for r in runs) for k in runs[0]}
    print(f"smoke: {time.perf_counter() - t_start:.1f} s; kernel launches "
          f"of the encodes {launches}", flush=True)

    src = {"me_refine": ("kvazaar_tpu_torch/csrc/me_refine.cu",
                         "kvazaar_tpu/ops/pallas_me.py:346"),
           "me_eval": ("kvazaar_tpu_torch/csrc/me_eval.cu",
                       "kvazaar_tpu/ops/pallas_me.py:467")}
    # me_eval's two modes are two rows: its pair mode (B frames; the
    # numbers of one two-reference B frame's launches) and its one-list
    # mode (P frames; one P frame's launches on two pictures)
    counts = {"me_refine": launches["me_refine"],
              "me_eval": launches["me_eval"] - launches["me_eval_one_list"],
              "me_eval_one_list": launches["me_eval_one_list"]}
    modes = {"me_refine": "one picture a launch",
             "me_eval": "pairs (B frames)",
             "me_eval_one_list": "one list (P frames)"}
    src["me_eval_one_list"] = src["me_eval"]
    rows = []
    for name in ("me_refine", "me_eval", "me_eval_one_list"):
        k = kern[name]
        rows.append({"name": name, "route": "cuda", "source": src[name][0],
                     "replaces": src[name][1], "mode": modes[name],
                     "launches": counts[name],
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
