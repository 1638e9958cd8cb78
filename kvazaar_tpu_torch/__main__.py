"""Command-line encoder of the PyTorch/CUDA port, kvazaar flag names.

Usage:  python -m kvazaar_tpu_torch -i in.yuv --input-res 1920x1080 \
            -o out.hevc [--qp 22] [--preset medium] [--frames N] \
            [--device cuda]

Same options as python -m kvazaar_tpu, plus --transform-skip and
--device; the ones outside the ported configuration raise
NotImplementedError (see ROADMAP.md). --preset is
applied after the other flags, so its knobs override theirs.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from .api import Encoder
from .cfg import Config, PRESETS, apply_preset
from .utils.yuv import YUVReader


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="kvazaar_tpu_torch",
                                description="PyTorch/CUDA HEVC encoder")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("--input-res", default=None,
                   help="WxH (required for raw .yuv)")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("-q", "--qp", type=int, default=22)
    p.add_argument("-p", "--period", type=int, default=64)
    p.add_argument("--bitrate", type=int, default=0,
                   help="target bitrate in bits/s (enables ABR rate "
                        "control; 0 = constant QP)")
    p.add_argument("--preset", choices=sorted(PRESETS), default=None)
    p.add_argument("--frames", "-n", type=int, default=0,
                   help="number of frames to encode (0 = all)")
    p.add_argument("--seek", type=int, default=0)
    p.add_argument("--wpp", action="store_true")
    p.add_argument("--no-wpp", dest="wpp", action="store_false")
    p.add_argument("--signhide", action="store_true")
    p.add_argument("--rdoq", action="store_true")
    p.add_argument("--gop", default="0",
                   help="hierarchical B GOP length 0/1/2/4/8/16, or "
                        "lp-gGdDtT for a layered low-delay structure")
    p.add_argument("--open-gop", dest="open_gop", action="store_true",
                   help="CRA + RASL at period boundaries (no IDR reset)")
    p.add_argument("--ref", type=int, default=1,
                   help="reference frames per list")
    p.add_argument("--sao", choices=["off", "edge", "band", "full"],
                   default="off")
    p.add_argument("--no-deblock", dest="deblock", action="store_false",
                   default=True)
    p.add_argument("--hash", choices=["checksum", "md5", "none"],
                   default="checksum")
    p.add_argument("--ctu", type=int, default=None, choices=[16, 64],
                   help="CTU size (default 64 = the quadtree pipelines; "
                        "16 = the fixed 16x16 grid pipelines)")
    p.add_argument("--aud", dest="aud", action="store_true",
                   help="write access unit delimiters")
    p.add_argument("--vps-period", dest="vps_period", type=int, default=0,
                   help="re-send parameter sets every N intra periods")
    p.add_argument("--tiles", default=None,
                   help="tile grid CxR (e.g. 2x2); all-intra, ctu 64")
    p.add_argument("--vaq", type=int, default=0,
                   help="variance adaptive QP strength")
    p.add_argument("--roi", default="",
                   help="ROI delta-QP file ('w h' + w*h integers)")
    p.add_argument("--input-bitdepth", type=int, default=8,
                   choices=[8, 10])
    p.add_argument("--lossless", action="store_true")
    p.add_argument("--transform-skip", dest="transform_skip",
                   action="store_true",
                   help="transform skip on 4x4 TUs (an RD choice per TU)")
    p.add_argument("--scaling-list", dest="scaling_list",
                   choices=["off", "default"], default="off")
    p.add_argument("--rc-algorithm", dest="rc_algorithm",
                   choices=["no-rc", "lambda", "oba"], default="lambda")
    p.add_argument("--source-scan-type", dest="source_scan_type",
                   choices=["progressive", "tff", "bff"],
                   default="progressive")
    p.add_argument("--pu-depth-intra", dest="pu_depth_intra",
                   default=None, help="min-max (1=32x32 .. 3=8x8)")
    p.add_argument("--level", type=int, default=0,
                   help="HEVC level x10 (e.g. 40 = 4.0); 0 = auto")
    p.add_argument("--psnr", action="store_true", default=True)
    p.add_argument("--no-psnr", dest="psnr", action="store_false")
    p.add_argument("--stats-file-prefix", dest="stats_file_prefix",
                   default="", help="write per-frame poc/qp/lambda/bits/"
                   "PSNR lines to <prefix>frames.txt")
    p.add_argument("--me", choices=["hexbs", "tz", "full", "dia",
                                    "full8", "full16", "full32",
                                    "full64"], default="hexbs",
                   help="integer ME pattern (accepted for parity; the "
                        "TPU engine always runs one exhaustive batched "
                        "hierarchical sweep)")
    p.add_argument("--subme", type=int, default=4, choices=range(5),
                   help="fractional-pel depth: 0 int, 1-2 half, 3-4 qpel")
    p.add_argument("--bipred", dest="bipred", action="store_true",
                   default=True)
    p.add_argument("--no-bipred", dest="bipred", action="store_false")
    p.add_argument("--mv-constraint", dest="mv_constraint",
                   choices=["none", "frametile", "frametilemargin"],
                   default="none")
    p.add_argument("--cqmfile", default="",
                   help="custom quantization matrices (HM format)")
    p.add_argument("--fast-coeff-table", dest="fast_coeff_table",
                   default="", help="learned coefficient-rate table "
                   "(JSON, see tools/rdcost_weights.py)")
    p.add_argument("--debug", default="",
                   help="write reconstructed YUV to this file "
                        "(kvazaar --debug, encmain.c:294)")
    p.add_argument("--slices", choices=["none", "tiles", "wpp"],
                   default="none",
                   help="one slice segment per tile / WPP row")
    p.add_argument("--crypto", default="off",
                   help="selective encryption: off | on | '+'-joined "
                        "features (mvs, mv_signs, trans_coeffs, "
                        "trans_coeff_signs, intra_pred_modes)")
    p.add_argument("--key", default="",
                   help="16 comma-separated bytes for --crypto")
    p.add_argument("--device", default="cuda",
                   help="torch device of the pipelines (cuda or cpu)")
    return p


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    w = h = 0
    if args.input_res:
        w, h = (int(v) for v in args.input_res.split("x"))
    reader = YUVReader(args.input, w, h,
                       bit_depth=args.input_bitdepth)
    cfg = Config(width=reader.width, height=reader.height, qp=args.qp,
                 intra_period=args.period, wpp=args.wpp,
                 signhide_enable=args.signhide, hash=args.hash,
                 target_bitrate=args.bitrate,
                 rdoq_enable=args.rdoq, open_gop=args.open_gop,
                 ref_frames=args.ref, sao_type=args.sao,
                 deblock_enable=args.deblock, vaq=args.vaq,
                 roi_file=args.roi, input_bitdepth=reader.bit_depth,
                 lossless=args.lossless, scaling_list=args.scaling_list,
                 trskip_enable=args.transform_skip,
                 rc_algorithm=args.rc_algorithm,
                 source_scan_type=args.source_scan_type,
                 aud_enable=args.aud, vps_period=args.vps_period,
                 level=args.level,
                 stats_file_prefix=args.stats_file_prefix,
                 me=args.me, subme=args.subme, bipred=args.bipred,
                 mv_constraint=args.mv_constraint, cqmfile=args.cqmfile,
                 fast_coeff_table=args.fast_coeff_table,
                 slices=args.slices, crypto=args.crypto,
                 crypto_key=args.key)
    cfg.parse("gop", args.gop)
    if args.pu_depth_intra:
        cfg.parse("pu-depth-intra", args.pu_depth_intra)
    if args.tiles:
        cfg.parse("tiles", args.tiles)
    if args.preset:
        apply_preset(cfg, args.preset)
    cfg.ctu_size = args.ctu or 64
    if args.tiles or args.vaq or args.roi or args.lossless \
            or reader.bit_depth > 8 or args.scaling_list != "off":
        cfg.ctu_size = 64      # these tools ride the quadtree pipeline
    enc = Encoder(cfg, device=args.device)
    if args.seek:
        reader.seek(args.seek)

    out = open(args.output, "wb")
    dbg = open(args.debug, "wb") if args.debug else None

    def _write_dbg(info):
        # reconstructed YUV dump (kvazaar --debug, encmain.c:294-326)
        if dbg is None:
            return
        for pl in info["recon_out"]:
            a = np.asarray(pl)
            dt = np.uint16 if reader.bit_depth > 8 else np.uint8
            dbg.write(np.ascontiguousarray(a, dt).tobytes())

    n = 0
    psnr_acc = np.zeros(3)
    bits = 0
    t0 = time.time()
    # frame N+1's device work is queued before frame N's entropy coding;
    # the host route (CTB 32) codes frame by frame
    overlap = enc.use_device
    pending = None

    def _emit_done(pair):
        nonlocal n, bits, psnr_acc
        chunk, info = pair
        out.write(chunk)
        _write_dbg(info)
        bits += len(chunk) * 8
        psnr_acc += info["psnr"]
        n += 1
        print(f"POC {info['poc']:4d} ({len(chunk):6d} bytes) "
              f"PSNR Y {info['psnr'][0]:.4f} U {info['psnr'][1]:.4f} "
              f"V {info['psnr'][2]:.4f}", file=sys.stderr)

    def _emit(meta):
        _emit_done(enc.finalize_frame(meta))

    submitted = 0
    while True:
        if args.frames and submitted >= args.frames:
            break
        frame = reader.read_frame()
        if frame is None:
            break
        submitted += 1
        if enc.gop_enabled:
            # B pyramid: frames are buffered and coded span by span
            for pair in enc.push_frame(*frame):
                _emit_done(pair)
            continue
        meta = enc.submit_frame(*frame)
        if pending is not None:
            _emit(pending)
        if overlap:
            pending = meta
        else:
            _emit(meta)
    if enc.gop_enabled:
        for pair in enc.flush():
            _emit_done(pair)
    if pending is not None:
        _emit(pending)
    dt = time.time() - t0
    out.close()
    if dbg is not None:
        dbg.close()
    reader.close()
    if n:
        print(f" Processed {n} frames, {bits} bits", file=sys.stderr)
        if args.psnr:
            p = psnr_acc / n
            print(f" AVG PSNR Y {p[0]:.4f} U {p[1]:.4f} V {p[2]:.4f}",
                  file=sys.stderr)
        print(f" FPS: {n / dt:.2f}", file=sys.stderr)
    return 0 if n else 1


if __name__ == "__main__":
    sys.exit(main())
