"""Public encoder API of the PyTorch/CUDA port.

Same 1-in/N-out contract as kvazaar_tpu.api (an `Encoder` fed frames one
at a time, returning Annex-B chunks), routed by the CTB size as the
reference routes it:

- CTB 64 (the quadtree pipelines): deblocking, SAO, RDOQ and sign-data
  hiding, transform skip (--transform-skip), a --fast-coeff-table rate
  model, Main 10 (--input-bitdepth 10), scaling lists (--scaling-list,
  --cqmfile) and lossless coding (--lossless: deblocking, SAO, sign
  hiding and RDOQ off), WPP (--wpp; --slices wpp codes a slice segment a
  CTB row), rate control (--bitrate with --rc-algorithm lambda or oba: a
  QP a frame, and on all-intra streams a QP a CTB), delta QP (--vaq,
  --roi: every frame intra, a QP a CTB; 10-bit, scaling lists and
  lossless code every frame intra as well), an IDR every `intra_period`
  frames and low-delay frames in between with 1-4 reference pictures
  (--ref): generalized-B slices (list 1 = list 0, bi-prediction on; the B
  program searches the first two of each list) or, with --no-bipred, P
  slices (SMP/AMP rectangular PUs with --smp/--amp), and the low-delay
  GOP (--gop lp-gGdDtT: per-layer QP offsets, keyframe references and
  selective retention of reference pictures); the B pyramid (--gop
  2/4/8/16, closed or --open-gop): display-order frames fed through
  push_frame/flush are coded span by span in coding order (engine/gop.py's
  GopScheduler), a P anchor (or an open-GOP CRA picture) then the dyadic
  B pictures with past pictures in list 0 and future ones in list 1;
  selective encryption (--crypto, --key: the Python writers code every
  picture), field coding (--source-scan-type tff|bff: encode_sequence
  codes each frame as two fields) and tiles (--tiles, --slices tiles:
  every frame intra, tile by tile, or over the CUDA devices for a uniform
  grid, one batched call a device's block of tiles); through
  Config.frame_batch, all-intra frames batched through one search and
  one pass of the wavefront.
- CTB 16 (--ctu 16, the fixed 16x16 grid pipelines of models/
  intra_pipeline.py and inter_pipeline.py): intra frames, P frames (low
  delay, --ref 1-4, the lp GOP; no generalized B) and the B pyramid on a
  union stack of four references, with deblocking, SAO, RDOQ, sign hiding,
  WPP, --slices wpp, frame-level rate control (OBA falls back to lambda)
  and, through Config.frame_batch, all-intra frames batched through one
  pass of the wavefront.
- CTB 32 (Config.ctu_size = 32), or any CTB size with Config.device set
  to False: the host route, every frame intra through the Python
  IntraFrameEncoder with the host deblocking filter; no pipeline is
  built.

Options outside a route raise as the reference raises.

Rate control chooses a frame's QP when its device work is submitted and
learns from its bits when it is finalized, so in the pipelined loops
(encode_sequence, push_frame's spans, the CLI, capi.py's ring) frame N+1's
QP is chosen before frame N's bits are known, as in the reference; the
host route codes frame by frame.

Device work runs on `device` (default "cuda"); reconstructed planes stay
there as the reference pictures; the native C++ slice writers code the
decisions on the host where the reference uses them.
"""
from __future__ import annotations

import numpy as np

from .bitstream import (BitWriter, NAL_CRA_NUT, NAL_IDR_W_RADL, NAL_PPS,
                        NAL_RASL_N, NAL_RASL_R, NAL_SPS, NAL_SUFFIX_SEI,
                        NAL_TRAIL_N, NAL_TRAIL_R, NAL_VPS, nal_unit,
                        rbsp_to_ebsp)
from .cabac import CabacEncoder, ContextSet
from .cfg import Config
from .engine.gop import (FrameSpec, GopScheduler, intra_qp_offset,
                         lp_gop_table)
from .hevc.headers import write_pps, write_slice_header, write_sps, write_vps
from .hevc.params import PPS, SPS, ShortTermRPS, SliceHeader
from .hevc.sei import HASH_CHECKSUM, HASH_MD5, write_hash_sei


def build_sps(cfg: Config) -> SPS:
    import math
    sps = SPS()
    sps.width = cfg.width
    sps.height = cfg.height
    sps.bit_depth_luma = sps.bit_depth_chroma = cfg.input_bitdepth
    if cfg.input_bitdepth > 8:
        sps.ptl.general_profile_idc = 2      # Main 10
    ctb_log2 = int(math.log2(cfg.ctu_size))
    min_cb_log2 = int(math.log2(cfg.min_cu_size))
    sps.log2_min_cb_size = min_cb_log2
    sps.log2_diff_max_min_cb_size = ctb_log2 - min_cb_log2
    sps.log2_min_tb_size = 2
    sps.log2_diff_max_min_tb_size = min(cfg.max_tb_log2, ctb_log2) - 2
    sps.max_transform_hierarchy_depth_intra = cfg.tr_depth_intra
    sps.max_transform_hierarchy_depth_inter = 0
    sps.sao_enabled = 0 if cfg.sao_type == "off" else 1
    sps.scaling_list_enabled = 0 if cfg.scaling_list == "off" else 1
    sps.amp_enabled = 1 if cfg.amp_enable else 0
    sps.strong_intra_smoothing = 1 if cfg.strong_intra_smoothing else 0
    # TMVP with inter coding, not with tiles (the reference disables it
    # there: cross-tile collocated reads, src/cfg.c:922)
    sps.temporal_mvp_enabled = (1 if cfg.intra_period != 1
                                and tuple(cfg.tiles) == (1, 1) else 0)
    if cfg.gop_len > 1:
        # up to 4 retained references + the current picture
        sps.max_dec_pic_buffering_minus1 = 4
        sps.max_num_reorder_pics = cfg.gop_len - 1
    else:
        sps.max_dec_pic_buffering_minus1 = max(1, cfg.ref_frames)
        sps.max_num_reorder_pics = 0
    sps.vui_timing = (cfg.framerate_denom, cfg.framerate_num)
    from .hevc.levels import select_level
    if cfg.level:
        sps.ptl.general_level_idc = cfg.level * 3
    else:
        fps = cfg.framerate_num / max(cfg.framerate_denom, 1)
        sps.ptl.general_level_idc, sps.ptl.general_tier_flag = \
            select_level(cfg.width, cfg.height, fps, cfg.target_bitrate)
    return sps


def build_pps(cfg: Config) -> PPS:
    pps = PPS()
    pps.init_qp = cfg.qp
    pps.sign_data_hiding_enabled = 1 if cfg.signhide_enable else 0
    pps.transform_skip_enabled = 1 if cfg.trskip_enable else 0
    pps.transquant_bypass_enabled = 1 if cfg.lossless else 0
    pps.entropy_coding_sync_enabled = 1 if cfg.wpp else 0
    pps.deblocking_filter_control_present = 1
    pps.deblocking_filter_disabled = 0 if cfg.deblock_enable else 1
    pps.beta_offset_div2 = cfg.deblock_beta
    pps.tc_offset_div2 = cfg.deblock_tc
    pps.loop_filter_across_slices = 1
    if cfg.slices != "none":
        # a slice segment a tile or WPP row, the later ones dependent
        # (spec 7.4.7.1)
        pps.dependent_slice_segments_enabled = 1
    return pps


def parse_crypto(cfg: Config) -> tuple[int, bytes | None]:
    """The selective-encryption features of --crypto and the 16-byte
    --key (None: the default key); ValueError for a malformed spec or
    key."""
    from .extras.crypto import parse_crypto_spec
    features = parse_crypto_spec(cfg.crypto)
    key = None
    if cfg.crypto_key:
        key = bytes(int(t) & 0xff for t in cfg.crypto_key.split(","))
        if len(key) != 16:
            raise ValueError("--key needs 16 comma-separated bytes")
    return features, key


def _routes(cfg: Config) -> tuple[bool, bool, bool, bool]:
    """(use_md, use_device, inter_md, inter_enabled) as the reference
    routes a configuration: the quadtree pipelines at CTB 64, the 16x16
    grid pipelines at CTB 16, the host encoder otherwise (CTB 32, or
    Config.device False); inter frames on the quadtree path unless the
    options force every frame intra, on the grid unless --period 1."""
    dev_ok = getattr(cfg, "device", True)
    use_md = bool(dev_ok and cfg.ctu_size == 64)
    use_device = bool(dev_ok and cfg.ctu_size == 16) or use_md
    inter_md = use_md and cfg.intra_period != 1 and _inter_coding(cfg)
    inter_enabled = ((use_device and not use_md and cfg.intra_period != 1)
                     or inter_md)
    return use_md, use_device, inter_md, inter_enabled


def _inter_coding(cfg: Config) -> bool:
    """Whether the options allow inter frames on the quadtree path: not
    with tiles, VAQ, ROI, 10-bit, lossless or a scaling list (the
    reference's `inter_md`)."""
    return not (tuple(cfg.tiles) != (1, 1) or cfg.vaq or cfg.roi_file
                or cfg.lossless or cfg.input_bitdepth != 8
                or cfg.scaling_list != "off")


def check_config(cfg: Config) -> None:
    """Raise where the reference encoder refuses the options: ValueError,
    or NotImplementedError for what it does not implement (off CTB 64:
    10-bit, transform skip, crypto of the intra modes, tiles, VAQ and ROI;
    SMP/AMP and GOPs without inter frames; lossless and scaling lists on
    the all-intra grid; SAO on the host route)."""
    if cfg.slices not in ("none", "tiles", "wpp"):
        raise ValueError("--slices must be tiles or wpp")
    if cfg.slices == "wpp" and not cfg.wpp:
        raise ValueError("--slices wpp requires --wpp")
    if cfg.slices == "tiles" and tuple(cfg.tiles) == (1, 1):
        raise ValueError("--slices tiles requires a tile grid")
    features, _ = parse_crypto(cfg)
    use_md, use_device, inter_md, inter_enabled = _routes(cfg)
    if not use_md:
        from .extras.crypto import CRYPTO_INTRA_MODE
        for bad, what in (
                (cfg.input_bitdepth > 8, "10-bit"),
                (cfg.trskip_enable, "--transform-skip"),
                (features & CRYPTO_INTRA_MODE, "crypto intra_pred_modes"),
                (tuple(cfg.tiles) != (1, 1), "tiles"),
                (cfg.vaq or cfg.roi_file, "vaq/roi")):
            if bad:
                raise NotImplementedError(
                    f"{what} requires the quadtree device path (ctu-size "
                    "64)")
    if cfg.trskip_enable and tuple(cfg.tiles) != (1, 1):
        raise NotImplementedError(
            "--transform-skip with tiles is not wired up yet")
    # every frame is coded intra with --period 1 and (as in the
    # reference, kvazaar_tpu/api.py:244-263) at CTB 64 with tiles, VAQ,
    # ROI, 10-bit, lossless or a scaling list: no GOP then, nor SMP/AMP
    if (cfg.smp_enable or cfg.amp_enable) and not inter_md \
            and cfg.intra_period != 1:
        raise NotImplementedError(
            "SMP/AMP requires the quadtree inter path (ctu-size 64)")
    if cfg.gop_len > 1 and not inter_enabled:
        raise NotImplementedError(
            "a GOP (--gop) needs inter frames: not with --period 1, "
            "tiles, --vaq, --roi, 10-bit, --lossless, a scaling list or "
            "the host route")
    if use_device and not use_md and not inter_enabled:
        if cfg.lossless:
            raise NotImplementedError(
                "lossless requires the quadtree device path (ctu-size 64)")
        if cfg.scaling_list != "off":
            raise NotImplementedError(
                "scaling lists require the quadtree device path "
                "(ctu-size 64)")
    if cfg.sao_type != "off" and not use_device:
        raise NotImplementedError(
            "SAO requires a device pipeline (ctu-size 16 or 64)")


class Encoder:
    """HEVC encoder. CTB 64: the quadtree pipelines, IDR + low-delay
    generalized-B or (--no-bipred) P frames, optionally in the lp GOP
    (submit_frame / finalize_frame), or the B pyramid (push_frame /
    flush); all-intra with --period 1, tiles, --vaq or --roi. CTB 16: the
    16x16 grid pipelines, IDR + P frames or the B pyramid. CTB 32: every
    frame intra on the host."""

    def __init__(self, cfg: Config, device="cuda",
                 tile_devices=None) -> None:
        """device: the torch device of the pipelines. tile_devices: the
        devices a uniform tile grid runs over (MeshTiledIntraPipeline;
        one may repeat), by default the CUDA devices present when device
        is a CUDA device."""
        import torch
        if getattr(cfg, "_fields_split", False):
            # a field picture's configuration (encode_sequence's split):
            # the frame's dimensions are what must be multiples of 8, a
            # field of 1080 lines has 540 and pads to the CTB
            import copy
            frame = copy.copy(cfg)
            frame.height = 2 * cfg.height
            frame.validate()
        else:
            cfg.validate()
        if cfg.lossless:
            # transquant bypass: the loop filters never touch bypass
            # samples, and RDOQ and sign hiding have nothing to act on
            cfg.deblock_enable = False
            cfg.sao_type = "off"
            cfg.signhide_enable = False
            cfg.rdoq_enable = False
        check_config(cfg)
        self.cfg = cfg
        # selective encryption (extras/crypto.py): the features and key
        self.crypto_features, self.crypto_key = parse_crypto(cfg)
        self.device = torch.device(device)
        self.use_md, self.use_device, self.inter_md, self.inter_enabled = \
            _routes(cfg)
        if (self.use_device and self.device.type == "cuda"
                and not torch.cuda.is_available()):
            raise RuntimeError("Encoder(device='cuda') needs a CUDA device; "
                               "pass device='cpu' to run on the CPU")
        align = 64 if self.use_md else 16 if self.use_device else 8
        self.pad_w = (-cfg.width) % align
        self.pad_h = (-cfg.height) % align
        self.sps = build_sps(cfg)
        self.sps.width = cfg.width + self.pad_w
        self.sps.height = cfg.height + self.pad_h
        if self.pad_w or self.pad_h:
            self.sps.conf_win = (0, self.pad_w // 2, 0, self.pad_h // 2)
        # field coding (kvazaar_field_encoding_adapter, src/kvazaar.c:
        # 311-392): each picture is a field of half the frame's height
        self.field_mode = cfg.source_scan_type in ("tff", "bff")
        if self.field_mode:
            self.sps.field_seq_flag = 1
            self.sps.ptl.general_interlaced_source_flag = 1
            self.sps.ptl.general_progressive_source_flag = 0
            self.sps.ptl.general_frame_only_constraint_flag = 0
        self.pps = build_pps(cfg)
        # tiles: independent rectangles, the loop filters not crossing
        # their edges (PPS loop_filter_across_tiles_enabled_flag 0, src/
        # encoder_state-bitstream.c:545); they disable WPP (src/cfg.c:927)
        # and code every frame intra
        self.tile_grid = None
        if tuple(cfg.tiles) != (1, 1):
            if cfg.wpp:
                import sys
                print("Disabling WPP because tiles were enabled.",
                      file=sys.stderr)
                cfg.wpp = False
                self.pps.entropy_coding_sync_enabled = 0
            from .hevc.tiles import TileGrid
            cols, rows = cfg.tiles
            self.tile_grid = TileGrid.make(
                self.sps.width_in_ctbs, self.sps.height_in_ctbs, cols, rows)
            self.pps.tiles_enabled = 1
            self.pps.num_tile_columns = cols
            self.pps.num_tile_rows = rows
            self.pps.uniform_spacing = 1
            self.pps.loop_filter_across_tiles = 0
        self.frame_num = 0
        self.poc = 0
        # VAQ / ROI code every frame intra with a QP a CTB (10-bit,
        # lossless and scaling lists every frame intra at one QP); rate
        # control adds a QP a CTB (LCU RC) on the quadtree's all-intra
        # streams only, and a QP a frame everywhere. QG == CTB
        # (diff_cu_qp_delta_depth 0).
        self.lcu_rc = (cfg.target_bitrate > 0 and self.use_md
                       and not self.inter_md)
        self.dqp_enabled = bool(cfg.vaq or cfg.roi_file) or self.lcu_rc
        self._roi = None
        if self.dqp_enabled:
            self.pps.cu_qp_delta_enabled = 1
            self.pps.diff_cu_qp_delta_depth = 0
            if cfg.roi_file:
                with open(cfg.roi_file) as f:
                    vals = f.read().split()
                rw, rh = int(vals[0]), int(vals[1])
                arr = np.asarray(vals[2:2 + rw * rh],
                                 np.int32).reshape(rh, rw)
                self._roi = (rw, rh, arr)
        # the B pyramid (--gop 2/4/8/16): display-order frames wait in
        # _gop_buf until a span is complete, then are coded in coding
        # order (kvazaar's input_frame_buffer reorder)
        self.gop_enabled = (cfg.gop_len > 1 and self.inter_enabled
                            and not cfg.gop_lowdelay)
        self.n_refs = max(1, min(cfg.ref_frames, 4))
        kw = dict(deblock=cfg.deblock_enable, deblock_beta=cfg.deblock_beta,
                  deblock_tc=cfg.deblock_tc, sao=cfg.sao_type,
                  rdoq=cfg.rdoq_enable, sign_hiding=cfg.signhide_enable,
                  device=self.device)
        args = (self.sps.height, self.sps.width, cfg.qp)
        self._pipeline = None
        if self.inter_md:
            from .models.inter_md import MdInterPipeline
            self._pipeline = MdInterPipeline(
                *args, n_refs=self.n_refs,
                pu_depth_inter=tuple(cfg.pu_depth_inter), subme=cfg.subme,
                smp=cfg.smp_enable or cfg.amp_enable, amp=cfg.amp_enable,
                bipred=cfg.bipred, pu_depth=tuple(cfg.pu_depth_intra),
                rd=cfg.rd, fast_coeff_table=cfg.fast_coeff_table,
                trskip=cfg.trskip_enable, **kw)
        elif self.inter_enabled:
            from .models.inter_pipeline import InterPipeline
            if self.gop_enabled:
                # the union of list 0 and list 1: up to 2 past + 2 future
                self.n_refs = 4
            self._pipeline = InterPipeline(*args, n_refs=self.n_refs, **kw)
        elif self.use_md:
            scaling = None
            if cfg.scaling_list != "off":
                from .hevc.scaling import ScalingLists, load_cqmfile
                if cfg.cqmfile:
                    # a custom matrix set is signalled in the SPS
                    scaling = self.sps.scaling_lists = load_cqmfile(
                        cfg.cqmfile)
                else:
                    scaling = ScalingLists()
            kw.update(delta_qp=self.dqp_enabled, wpp=bool(cfg.wpp),
                      bit_depth=cfg.input_bitdepth, scaling=scaling,
                      lossless=cfg.lossless,
                      pu_depth=tuple(cfg.pu_depth_intra), rd=cfg.rd,
                      fast_coeff_table=cfg.fast_coeff_table,
                      trskip=cfg.trskip_enable)
            if self.tile_grid is None:
                from .models.intra_md import MdIntraPipeline
                self._pipeline = MdIntraPipeline(*args, **kw)
            else:
                self._pipeline = self._tile_pipeline(args, kw,
                                                     tile_devices)
        elif self.use_device:
            from .models.intra_pipeline import IntraPipeline
            self._pipeline = IntraPipeline(*args, **kw)
        # the low-delay GOP's per-position plan (--gop lp-gGdDtT)
        self._lp = None
        if cfg.gop_lowdelay and self.inter_enabled:
            self._lp = lp_gop_table(cfg.gop_len, *cfg.gop_lp,
                                    max(1, cfg.ref_frames))
        if self.gop_enabled:
            self._sched = GopScheduler(cfg.gop_len, cfg.intra_period,
                                       base_qp=cfg.qp)
            self._gop_buf: list[tuple] = []   # display-order pending
            self._idr_disp = 0                # display index of POC 0
            self._gop_lo = 0                  # POC of the last anchor
            self._next_disp = 0
        # DPB: newest-first reconstructed reference pictures (device)
        self._dpb: list[dict] = []
        # TMVP collocated motion fields per coded reference frame
        self._motion_fields: dict[int, dict] = {}
        # slices coded by the native (C++) writers, for run reports
        self.native_slices = 0
        # rate control; --rc-algorithm no-rc keeps the QP constant even
        # with a bitrate. Every frame is an IDR without inter frames, so
        # the RC then counts the stream as all-intra (no IDR boost).
        self._rc = None
        if cfg.target_bitrate > 0 and cfg.rc_algorithm != "no-rc":
            from .engine.rate_control import OBARateControl, RateControl
            if cfg.rc_algorithm == "oba" and not self.use_md:
                import sys
                print("OBA rate control needs the quadtree path "
                      "(ctu-size 64); falling back to lambda RC.",
                      file=sys.stderr)
                cfg.rc_algorithm = "lambda"
            rc_cls = (OBARateControl if cfg.rc_algorithm == "oba"
                      else RateControl)
            self._rc = rc_cls(self.sps.width, self.sps.height,
                              cfg.target_bitrate,
                              cfg.framerate_num / cfg.framerate_denom,
                              1 if not self.inter_enabled
                              else cfg.intra_period,
                              intra_bits=cfg.intra_bits,
                              gop_len=max(cfg.gop_len, 1), rdo=cfg.rd)

    def _tile_pipeline(self, args, kw, devices):
        """The tiles' pipeline, as the reference routes it: a uniform grid
        of more than one tile without delta QP runs over the devices
        (MeshTiledIntraPipeline) where mesh_shape_for maps it onto them,
        every other grid tile by tile (TiledIntraPipeline)."""
        import torch
        from .parallel.mesh import (MeshTiledIntraPipeline,
                                    grid_is_uniform, mesh_shape_for)
        from .parallel.tiled import TiledIntraPipeline
        g = self.tile_grid
        if devices is None:
            devices = ([torch.device("cuda", i)
                        for i in range(torch.cuda.device_count())]
                       if self.device.type == "cuda" else [self.device])
        if (not self.dqp_enabled and self.cfg.mesh_tiles != "off"
                and grid_is_uniform(g) and g.n_tiles > 1
                and mesh_shape_for(g, len(devices)) is not None):
            kw = {k: v for k, v in kw.items() if k != "device"}
            return MeshTiledIntraPipeline(list(devices), *args, g, ctb=64,
                                          **kw)
        return TiledIntraPipeline(*args, g, ctb=64, **kw)

    def _push_ref(self, entry: dict, keep: set | None = None) -> None:
        """Add a reference picture: the DPB then keeps the n_refs newest,
        or the POCs of `keep` (the lp GOP's retention set)."""
        self._dpb.insert(0, entry)
        if keep is None:
            del self._dpb[self.n_refs:]
        else:
            kept = set(keep) | {entry["poc"]}
            self._dpb = [e for e in self._dpb if e["poc"] in kept]

    def headers(self) -> bytes:
        out = nal_unit(write_vps(self.sps), NAL_VPS)
        out += nal_unit(write_sps(self.sps), NAL_SPS)
        out += nal_unit(write_pps(self.pps), NAL_PPS)
        return out

    # -- frames ----------------------------------------------------------

    def submit_frame(self, y: np.ndarray, cb: np.ndarray,
                     cr: np.ndarray) -> dict:
        """Dispatch a low-delay frame's device work; returns a pending
        token for finalize_frame (see push_frame for the B pyramid)."""
        cfg = self.cfg
        is_idr = (cfg.intra_period == 1
                  or (cfg.intra_period > 1
                      and self.frame_num % cfg.intra_period == 0)
                  or not self._dpb or not self.inter_enabled)
        if is_idr:
            self.poc = 0
            self._dpb.clear()
        # generalized B (list 1 = list 0) on the quadtree path, or P with
        # --no-bipred; the grid codes P slices
        use_b = not is_idr and self.inter_md and cfg.bipred
        if self._lp is not None and not is_idr:
            # low-delay GOP: layered QP, the nearest lower-layer picture
            # and earlier keyframes as references, selective retention
            g = cfg.gop_len
            ent = self._lp[(self.poc - 1) % g]
            dpb_pocs = [e["poc"] for e in self._dpb]
            l0 = []
            for delta in ent["ref_neg"]:
                p = self.poc - delta
                if p >= 0 and p in dpb_pocs and p not in l0:
                    l0.append(p)
            if not l0 and dpb_pocs:
                l0 = dpb_pocs[:1]
            keys = sorted((p for p in dpb_pocs if p % g == 0),
                          reverse=True)[:cfg.ref_frames]
            keep = set(keys) | set(l0) | set(dpb_pocs[:1])
            l0 = l0[:max(1, cfg.ref_frames)]
            spec = FrameSpec(disp_idx=self.frame_num, poc=self.poc,
                             is_ref=bool(ent["is_ref"]),
                             slice_type=0 if use_b else 1,
                             layer=ent["layer"], qp_offset=ent["qp_offset"],
                             l0=l0, l1=list(l0) if use_b else [], keep=keep)
        else:
            l0 = [] if is_idr else [e["poc"] for e in self._dpb]
            spec = FrameSpec(
                disp_idx=self.frame_num, poc=self.poc, is_idr=is_idr,
                slice_type=2 if is_idr else 0 if use_b else 1,
                qp_offset=(intra_qp_offset(cfg.gop_len)
                           if is_idr and self._lp is not None else 0),
                l0=l0, l1=list(l0) if use_b else [], keep=None)
        self.frame_num += 1
        self.poc += 1
        return self._submit_spec(spec, y, cb, cr)

    def _pad(self, y, cb, cr) -> tuple:
        """The planes padded to the CTB grid by edge replication."""
        if self.pad_w or self.pad_h:
            y = np.pad(y, ((0, self.pad_h), (0, self.pad_w)), mode="edge")
            cb = np.pad(cb, ((0, self.pad_h // 2), (0, self.pad_w // 2)),
                        mode="edge")
            cr = np.pad(cr, ((0, self.pad_h // 2), (0, self.pad_w // 2)),
                        mode="edge")
        return y, cb, cr

    def submit_frames(self, frames) -> list[dict]:
        """Batched all-intra submission: B frames through one search and
        one pass of the wavefront (the pipeline's submit_many: the 16x16
        grid's IntraPipeline at CTB 16, MdIntraPipeline at CTB 64) at the
        configured QP, each coded as an IDR picture; returns their pending
        tokens. encode_sequence takes this path with Config.frame_batch >
        1 where the reference does (constant QP, no inter frames, no delta
        QP, a pipeline with submit_many: not the tiled ones)."""
        cfg = self.cfg
        padded = [self._pad(*f) for f in frames]
        devs = self._pipeline.submit_many([p[0] for p in padded],
                                          [p[1] for p in padded],
                                          [p[2] for p in padded], qp=cfg.qp)
        metas = []
        for (y, cb, cr), dev in zip(padded, devs):
            metas.append({"is_idr": True, "poc": 0, "qp": cfg.qp,
                          "frame_num": self.frame_num, "y": y, "cb": cb,
                          "cr": cr, "slice_type": 2, "is_ref": True,
                          "l0": [], "l1": [], "union": [], "keep": None,
                          "nal": "", "layer": 0, "dev": dev,
                          "dpb_pocs": []})
            self.frame_num += 1
        return metas

    def _submit_spec(self, spec: FrameSpec, y, cb, cr) -> dict:
        """Dispatch the device work of one planned frame: the IDR or CRA
        picture through the intra program, a P frame on the union stack
        (truncated to n_refs), a B frame on its list 0 and list 1 stacks;
        then the reconstruction joins the DPB (the spec's retention set,
        or the n_refs newest). On the host route nothing is dispatched.
        Returns the pending token."""
        y, cb, cr = self._pad(y, cb, cr)
        # the rate control's QP (its model learns from the frames
        # finalized so far), plus the GOP's offset
        qp = (self._rc.frame_qp(spec.is_idr, y_plane=y, layer=spec.layer)
              if self._rc else self.cfg.qp) + spec.qp_offset
        # the union of both lists, list 0 first: the P stack, and what the
        # slice writers map a one-list reference index through
        union = list(spec.l0) + [p for p in spec.l1 if p not in spec.l0]
        meta = {"is_idr": spec.is_idr, "poc": spec.poc, "qp": qp,
                "frame_num": spec.disp_idx, "y": y, "cb": cb, "cr": cr,
                "slice_type": spec.slice_type, "is_ref": spec.is_ref,
                "l0": list(spec.l0), "l1": list(spec.l1), "union": union,
                "keep": spec.keep, "nal": spec.nal, "layer": spec.layer}
        by_poc = {e["poc"]: e for e in self._dpb}

        def stack(pocs):
            refs = [by_poc[p] for p in pocs]
            return ([e["y"] for e in refs], [e["cb"] for e in refs],
                    [e["cr"] for e in refs])
        if spec.slice_type == 0:
            s0 = stack(spec.l0)
            # one set of planes serves both lists when they are equal
            s1 = s0 if spec.l1 == spec.l0 else stack(spec.l1)
            meta["dev"] = self._pipeline.submit_inter_b(
                y, cb, cr, s0, s1, spec.l0, spec.l1, qp=qp)
        elif spec.slice_type == 1 and self.inter_md:
            meta["dev"] = self._pipeline.submit_inter(
                y, cb, cr, *stack(union), ref_pocs=union, qp=qp)
        elif spec.slice_type == 1:
            meta["dev"] = self._pipeline.submit_inter(y, cb, cr,
                                                      *stack(union), qp=qp)
        elif self._pipeline is None:
            meta["dev"] = None
        elif self.dqp_enabled:
            meta["dev"] = self._pipeline.submit(
                y, cb, cr, qp=qp,
                qp_map=self._qp_map_for(y, cb, cr, qp, spec.is_idr))
        else:
            meta["dev"] = self._pipeline.submit(y, cb, cr, qp=qp)
        if self.inter_enabled and spec.is_ref:
            self._push_ref({"poc": spec.poc, "y": meta["dev"]["rec_y"],
                            "cb": meta["dev"]["rec_cb"],
                            "cr": meta["dev"]["rec_cr"]}, spec.keep)
        # the RPS names the retained DPB (after this frame) and the
        # frame's own references
        meta["dpb_pocs"] = [e["poc"] for e in self._dpb]
        return meta

    def _qp_map_for(self, y, cb, cr, base_qp: int,
                    is_idr: bool = True) -> np.ndarray:
        """The QP of each CTB: LCU rate control's allocation, or the
        frame's QP, plus the ROI map's deltas and the VAQ offsets from
        each CTB's variance against the frame's (kvazaar
        src/encoderstate.c:1444-1526, rate_control.c:1082)."""
        cfg = self.cfg
        rc = self.sps.height // 64
        cc = self.sps.width // 64
        if self.lcu_rc and self._rc is not None:
            qp = self._rc.lcu_qp_map((rc, cc), base_qp, is_idr,
                                     y_plane=y).astype(np.float64)
        else:
            qp = np.full((rc, cc), base_qp, np.float64)
        if self._roi is not None:
            rw, rh, arr = self._roi
            rx = np.arange(cc) * rw // cc
            ry = np.arange(rc) * rh // rc
            qp += arr[ry[:, None], rx[None, :]]
        if cfg.vaq:
            d = cfg.vaq * 0.1
            yf = np.asarray(y, np.float64)
            cbf_ = np.asarray(cb, np.float64)
            crf = np.asarray(cr, np.float64)
            fvar = yf.var() + cbf_.var() + crf.var()

            def blkvar(p, n):
                return p.reshape(rc, n, cc, n).var(axis=(1, 3))

            lvar = blkvar(yf, 64) + blkvar(cbf_, 32) + blkvar(crf, 32)
            with np.errstate(divide="ignore"):
                aq = d * (np.log(lvar) - np.log(fvar))
            off = np.sign(aq) * np.floor(np.abs(aq) + 0.5)  # C round()
            # half the spec's delta range, as the reference clips
            # (rate_control.c:1163-1166)
            qp += np.clip(np.nan_to_num(off, nan=0.0, neginf=-13.0),
                          -13, 12)
        return np.clip(qp, 0, 51).astype(np.int32)

    # -- the B pyramid's feed --------------------------------------------

    def push_frame(self, y: np.ndarray, cb: np.ndarray,
                   cr: np.ndarray) -> list[tuple[bytes, dict]]:
        """Feed one display-order frame; returns zero or more coded
        frames in coding order. Without a B pyramid this encodes at
        once."""
        if not self.gop_enabled:
            return [self.encode_frame(y, cb, cr)]
        cfg = self.cfg
        d = self._next_disp
        self._next_disp += 1
        if d == 0 or (not cfg.open_gop and cfg.intra_period > 0
                      and d - self._idr_disp == cfg.intra_period):
            # a closed GOP's period boundary is an IDR reset (frames
            # still buffered are coded after it, relative to it, as the
            # JAX package does: ROADMAP.md queue 3); with --open-gop the
            # boundary is a CRA anchor inside plan_span instead
            spec = self._sched.plan_idr(d)
            self._idr_disp = d
            self._gop_lo = 0
            self._dpb.clear()
            return [self.finalize_frame(self._submit_spec(spec, y, cb, cr))]
        self._gop_buf.append((y, cb, cr))
        if len(self._gop_buf) == cfg.gop_len:
            return self._encode_span()
        return []

    def flush(self) -> list[tuple[bytes, dict]]:
        """Encode the buffered tail as a run of power-of-two pyramids (7
        frames: spans of 4, 2 and 1), so that no anchor lies a whole tail
        away from its reference."""
        if not self.gop_enabled or not self._gop_buf:
            return []
        out: list[tuple[bytes, dict]] = []
        while self._gop_buf:
            k = 1
            while k * 2 <= len(self._gop_buf):
                k *= 2
            rest = self._gop_buf[k:]
            self._gop_buf = self._gop_buf[:k]
            out.extend(self._encode_span())
            self._gop_buf = rest
        return out

    def _encode_span(self) -> list[tuple[bytes, dict]]:
        """Code the buffered frames as one span after the last anchor:
        every frame's device work is queued first (the B frames take the
        anchor's reconstruction on the device), then each is entropy
        coded in coding order."""
        cfg = self.cfg
        lo = self._gop_lo
        hi = lo + len(self._gop_buf)
        intra_anchor = (cfg.open_gop and cfg.intra_period > 0
                        and hi % cfg.intra_period == 0)
        specs = self._sched.plan_span(self._idr_disp, lo, hi,
                                      intra_anchor=intra_anchor)
        frames = {lo + 1 + i: f for i, f in enumerate(self._gop_buf)}
        self._gop_buf = []
        self._gop_lo = hi
        metas = [self._submit_spec(s, *frames[s.poc]) for s in specs]
        return [self.finalize_frame(m) for m in metas]

    def encode_frame(self, y, cb, cr) -> tuple[bytes, dict]:
        """Encode one frame; returns (annexb bytes, info dict)."""
        return self.finalize_frame(self.submit_frame(y, cb, cr))

    def _slice_header(self, meta: dict) -> SliceHeader:
        sh = SliceHeader()
        sh.pps_id = 0
        sh.slice_type = meta["slice_type"]
        sh.qp = meta["qp"]
        sh.first_slice_in_pic = 1
        if self.sps.sao_enabled:
            sh.sao_luma = 1
            sh.sao_chroma = 1
        if not meta["is_idr"]:
            poc = meta["poc"]
            l0, l1 = meta["l0"], meta["l1"]
            sh.pic_order_cnt_lsb = poc & ((1 << self.sps.log2_max_poc_lsb)
                                          - 1)
            rps_set = set(meta["dpb_pocs"]) | set(l0) | set(l1)
            rps_set.discard(poc)
            past = sorted((p for p in rps_set if p < poc), reverse=True)
            fut = sorted(p for p in rps_set if p > poc)
            sh.short_term_rps = ShortTermRPS(
                delta_pocs_s0=[p - poc for p in past],
                used_s0=[1 if p in l0 else 0 for p in past],
                delta_pocs_s1=[p - poc for p in fut],
                used_s1=[1 if p in l1 else 0 for p in fut])
            sh.short_term_rps_sps_flag = 0
            # a P slice has no list 1 to count
            is_b = meta["slice_type"] == 0
            if (len(l0) != self.pps.num_ref_idx_l0_default_minus1 + 1
                    or (is_b and len(l1)
                        != self.pps.num_ref_idx_l1_default_minus1 + 1)):
                sh.num_ref_idx_active_override = 1
                sh.num_ref_idx_l0_active_minus1 = len(l0) - 1
                if is_b:
                    sh.num_ref_idx_l1_active_minus1 = len(l1) - 1
        return sh

    def _slice_data(self, meta, sh, decisions):
        """Entropy-code the slice: the native C++ writers, or the Python
        writers where the library cannot be built, for SMP/AMP slices
        (the native writer has no part_mode syntax), under delta QP, with
        --slices, tiles, selective encryption, transform skip and
        lossless coding (as the reference routes them; 10-bit and scaling
        lists stay native). With WPP each CTB row is a substream that
        starts from the contexts saved after the row above's second CTB,
        with the QP chain reset; with tiles each tile is one, in tile-scan
        order, from fresh contexts. Under encryption one keystream serves
        the picture's substreams in write order. Returns (substreams,
        motion field for TMVP or None, the bits of each CTB under LCU
        rate control or None, the host encoder or None).

        Intra frames off CTB 64 take the reference's routes: the grid's
        decisions the native grid writer, or (with SAO, --slices or
        encryption) the Python IntraFrameEncoder, which on the host route
        also makes the decisions; the grid's P and B slices the Python
        PSliceWriter."""
        from . import native
        slice_type = meta["slice_type"]
        sdh = bool(self.pps.sign_data_hiding_enabled)
        sao = self.sps.sao_enabled
        wpp = bool(self.pps.entropy_coding_sync_enabled)
        seg_mode = self.cfg.slices != "none"
        n_y, n_x = self.sps.height_in_ctbs, self.sps.width_in_ctbs
        crypto_res = None
        if self.crypto_features:
            from .extras.crypto import CryptoHandle
            crypto_res = (CryptoHandle(self.crypto_key),
                          self.crypto_features)
        python_only = (self.dqp_enabled or seg_mode or self.cfg.lossless
                       or self.cfg.trskip_enable or crypto_res is not None
                       or self.tile_grid is not None)

        def split(data, sizes):
            out, off = [], 0
            for n in sizes:
                out.append(data[off:off + n])
                off += n
            return out
        host_enc = None
        if slice_type == 2 and not self.use_md:
            if (decisions is not None and native.available() and not sao
                    and not seg_mode and crypto_res is None):
                data, sizes = native.encode_intra_grid(
                    decisions["modes"], decisions["levels_y"],
                    decisions["levels_cb"], decisions["levels_cr"], sh.qp,
                    wpp, sdh=sdh)
                self.native_slices += 1
                return split(data, sizes), None, None, None
            from .engine.frame_encoder import IntraFrameEncoder
            if decisions is not None:
                decisions = {k: (v.cpu().numpy() if k.startswith("rec_")
                                 else v) for k, v in decisions.items()}
            host_enc = IntraFrameEncoder(self.sps, self.pps, sh, meta["y"],
                                         meta["cb"], meta["cr"], self.cfg,
                                         decisions=decisions)
            writer = _HostCtus(host_enc)
        elif slice_type == 2:
            if native.available() and not python_only:
                data, sizes = native.encode_md_slice(
                    decisions["size_map8"], decisions["mode_map8"],
                    decisions["levels_y"], decisions["levels_cb"],
                    decisions["levels_cr"], sh.qp, wpp, sdh=sdh,
                    sao_packed=native.pack_sao(decisions) if sao else None,
                    bit_depth=self.sps.bit_depth_luma,
                    mode4=decisions.get("mode_map4"))
                self.native_slices += 1
                return split(data, sizes), None, None, None
            from .engine.md_writer import MdIntraWriter
            writer = MdIntraWriter(self.sps, self.pps, sh, decisions)
            if self.tile_grid is not None:
                writer.tile_ctb = self.tile_grid.tile_id_ctb
                writer.tile4 = self.tile_grid.tile4_map(self.sps.ctb_size)
        else:
            from .engine.inter_writer import PSliceWriter
            from .engine.md_inter_writer import MdPSliceWriter
            l0, l1 = meta["l0"], meta["l1"]
            re0 = [dict(self._motion_fields.get(p, {}), poc=p) for p in l0]
            re1 = [dict(self._motion_fields.get(p, {}), poc=p) for p in l1]
            sh.temporal_mvp_enabled = (
                1 if self.sps.temporal_mvp_enabled and re0
                and all("mv" in e for e in re0 + re1) else 0)
            writer = (MdPSliceWriter if self.inter_md else PSliceWriter)(
                self.sps, self.pps, sh, decisions, re0, meta["poc"],
                ref_entries_l1=re1, union_pocs=meta["union"])
            if (self.inter_md and native.available()
                    and "part8" not in decisions
                    and not python_only):
                data, sizes, mv4, refpoc4 = native.encode_md_slice_pb(
                    decisions, sh, writer.helper.ref_list, meta["poc"],
                    wpp, sdh=sdh, ref_entries_l1=writer.helper.ref_list1,
                    union_pocs=meta["union"],
                    sao_packed=native.pack_sao(decisions) if sao else None,
                    sao_cmax=(1 << (min(self.sps.bit_depth_luma, 10)
                                    - 5)) - 1,
                    max_merge=5 - sh.five_minus_max_num_merge_cand)
                self.native_slices += 1
                return split(data, sizes), (mv4, refpoc4), None, None
        if sao:
            from .engine.sao_writer import SaoWriter
            writer.sao_w = SaoWriter(decisions, bool(sh.sao_luma),
                                     bool(sh.sao_chroma),
                                     bit_depth=self.sps.bit_depth_luma)
        lcu_bits = (np.zeros((n_y, n_x), np.int64) if self.lcu_rc
                    else None)
        if self.tile_grid is not None:
            # tile-scan order: (ctu_x, ctu_y, substream start, substream
            # end) a CTB, a substream a tile
            g = self.tile_grid
            scan = [(x, y, (x, y) == g.rect(tid)[:2], end)
                    for x, y, tid, end in g.scan()]
        else:
            scan = [(x, y, x == 0 and (y == 0 or wpp),
                     x == n_x - 1 and (wpp or y == n_y - 1))
                    for y in range(n_y) for x in range(n_x)]
        substreams = []
        saved_ctx = None
        bw = cab = None
        for ctu_x, ctu_y, start, end in scan:
            if start:
                # a new substream: the slice's first, a tile's or a WPP
                # row's
                ctx = (saved_ctx.copy() if saved_ctx is not None
                       else ContextSet(2 - slice_type, sh.qp))
                bw = BitWriter()
                cab = CabacEncoder(bw, ctx)
                cab.crypto_res = crypto_res
                writer.cab = cab
                if hasattr(writer, "reset_qp_chain"):
                    writer.reset_qp_chain()
            b0 = cab.bit_count
            writer.write_ctu(ctu_y, ctu_x)
            if lcu_bits is not None:
                lcu_bits[ctu_y, ctu_x] = cab.bit_count - b0
            if wpp and ctu_x == 1 and n_x > 1:
                saved_ctx = ctx.copy()
            last = ctu_y == n_y - 1 and ctu_x == n_x - 1
            # end_of_slice_segment_flag, 1 at every substream's end with a
            # segment a substream; else end_of_subset_one_bit at the end
            # of a tile or WPP row
            cab.encode_bin_trm(1 if last or (seg_mode and end) else 0)
            if end and not last and not seg_mode:
                cab.encode_bin_trm(1)
            if end:
                cab.finish()
                bw.byte_align_one()
                substreams.append(bw.get_bytes())
        motion = (writer.fs.mv, writer.fs.ref_poc) \
            if hasattr(writer, "fs") else None
        return substreams, motion, lcu_bits, host_enc

    def _deblock_recon(self, rec, edges, qp: int) -> list:
        """The in-loop deblocking filter of a host-coded intra frame: BS 2
        on every TU edge the encoder recorded (ops/deblock.py)."""
        from .ops.deblock import deblock_frame
        from .tables import chroma_qp
        cfg = self.cfg
        w, h = self.sps.width, self.sps.height
        y, cb, cr = deblock_frame(
            rec[0].astype(np.int32), rec[1].astype(np.int32),
            rec[2].astype(np.int32), edges[0][:h // 4, :w // 8].copy(),
            edges[1][:h // 8, :w // 4].copy(), qp,
            chroma_qp(qp, self.pps.cb_qp_offset),
            chroma_qp(qp, self.pps.cr_qp_offset), cfg.deblock_beta,
            cfg.deblock_tc)
        return [y.astype(np.uint16), cb.astype(np.uint16),
                cr.astype(np.uint16)]

    def finalize_frame(self, meta: dict) -> tuple[bytes, dict]:
        cfg = self.cfg
        is_idr = meta["is_idr"]
        nal_type = (NAL_IDR_W_RADL if is_idr else
                    NAL_CRA_NUT if meta["nal"] == "CRA" else
                    (NAL_RASL_R if meta["is_ref"] else NAL_RASL_N)
                    if meta["nal"] == "RASL" else
                    NAL_TRAIL_R if meta["is_ref"] else NAL_TRAIL_N)
        sh = self._slice_header(meta)
        decisions = (None if meta["dev"] is None
                     else self._pipeline.materialize(meta["dev"]))
        self._last_decisions = decisions
        substreams, motion, lcu_bits, host_enc = self._slice_data(
            meta, sh, decisions)

        # snapshot a reference frame's motion field for future TMVP
        if (self.inter_enabled and meta["is_ref"]
                and self.sps.temporal_mvp_enabled):
            if is_idr:
                self._motion_fields.clear()
            if motion is not None:
                self._motion_fields[meta["poc"]] = {
                    "poc": meta["poc"], "mv": motion[0],
                    "ref_poc": motion[1]}
            else:
                mh = self.sps.height_in_ctbs * self.sps.ctb_size // 4
                mw = self.sps.width_in_ctbs * self.sps.ctb_size // 4
                self._motion_fields[meta["poc"]] = {
                    "poc": meta["poc"],
                    "mv": np.zeros((mh, mw, 2, 2), np.int32),
                    "ref_poc": np.full((mh, mw, 2), -(1 << 30), np.int64)}
            keep = set(meta["dpb_pocs"]) | {meta["poc"]}
            for p in list(self._motion_fields):
                if p not in keep:
                    del self._motion_fields[p]

        if cfg.slices != "none" and len(substreams) > 1:
            # --slices tiles|wpp: a slice segment NAL a substream (tile or
            # CTB row), addressed at its first CTB, the first independent,
            # the rest dependent (spec 7.4.7.1)
            import copy
            g = self.tile_grid
            addrs = [(g.rect(i)[1] * self.sps.width_in_ctbs + g.rect(i)[0]
                      if g is not None else i * self.sps.width_in_ctbs)
                     for i in range(len(substreams))]
            slice_nals = []
            for i, sdata in enumerate(substreams):
                shi = copy.copy(sh)
                shi.first_slice_in_pic = 1 if i == 0 else 0
                shi.dependent_slice_segment = 0 if i == 0 else 1
                shi.segment_address = addrs[i]
                shi.entry_point_offsets = []
                w = BitWriter()
                write_slice_header(shi, self.sps, self.pps, nal_type, w)
                slice_nals.append(w.get_bytes() + sdata)
        else:
            # entry points count emulation-prevented (EBSP) bytes; each
            # substream ends in a nonzero byte, so its emulation alone
            # equals the whole slice's
            sh.entry_point_offsets = [len(rbsp_to_ebsp(s))
                                      for s in substreams[:-1]]
            shw = BitWriter()
            write_slice_header(sh, self.sps, self.pps, nal_type, shw)
            slice_nals = [shw.get_bytes() + b"".join(substreams)]

        out = b""
        if cfg.aud_enable:
            from .bitstream import NAL_AUD
            aud = BitWriter()
            aud.u({0: 2, 1: 1}.get(meta["slice_type"], 0), 3)
            aud.byte_align_one()
            out += nal_unit(aud.get_bytes(), NAL_AUD)
        vp = cfg.vps_period * cfg.intra_period
        if meta["frame_num"] == 0 or (vp > 0
                                      and meta["frame_num"] % vp == 0):
            out += self.headers()
        if self.field_mode:
            # pic_timing SEI: a top or bottom field by the picture's
            # parity in the field sequence and the field order
            from .bitstream import NAL_PREFIX_SEI
            from .hevc.sei import write_pic_timing_sei
            is_top = (meta["frame_num"] % 2 == 0) == (
                cfg.source_scan_type == "tff")
            out += nal_unit(write_pic_timing_sei(1 if is_top else 2),
                            NAL_PREFIX_SEI)
        for s in slice_nals:
            out += nal_unit(s, nal_type)

        w, h = self.sps.width, self.sps.height
        if decisions is not None:
            rec = [decisions[k].cpu().numpy().astype(np.uint16)
                   for k in ("rec_y", "rec_cb", "rec_cr")]
        else:
            rec = [host_enc.rec_y[:h, :w].astype(np.uint16),
                   host_enc.rec_cb[:h // 2, :w // 2].astype(np.uint16),
                   host_enc.rec_cr[:h // 2, :w // 2].astype(np.uint16)]
        # device frames come out of the in-loop filters with their
        # checksum and SSE; the host route's frames are deblocked here
        device_final = decisions is not None
        if cfg.deblock_enable and not device_final:
            rec = self._deblock_recon(
                rec, (host_enc.edges_ver, host_enc.edges_hor), meta["qp"])
        if cfg.hash != "none":
            if cfg.hash == "checksum" and device_final:
                sei = write_hash_sei([], HASH_CHECKSUM,
                                     self.sps.bit_depth_luma,
                                     checksums=decisions["hash"])
            else:
                sei = write_hash_sei(
                    rec, HASH_CHECKSUM if cfg.hash == "checksum"
                    else HASH_MD5, self.sps.bit_depth_luma)
            out += nal_unit(sei, NAL_SUFFIX_SEI)
        crop = [rec[0][:cfg.height, :cfg.width],
                rec[1][:cfg.height // 2, :cfg.width // 2],
                rec[2][:cfg.height // 2, :cfg.width // 2]]
        mv = float((1 << self.sps.bit_depth_luma) - 1)
        if device_final:
            npix = [w * h, w * h // 4, w * h // 4]
            psnr = [99.0 if s_ == 0 else 10.0 * np.log10(mv ** 2 * n_ / s_)
                    for s_, n_ in zip(decisions["sse"], npix)]
        else:
            y, cb, cr = meta["y"], meta["cb"], meta["cr"]
            psnr = _psnr((y[:cfg.height, :cfg.width],
                          cb[:cfg.height // 2, :cfg.width // 2],
                          cr[:cfg.height // 2, :cfg.width // 2]), crop, mv)
        if self._rc is not None:
            self._rc.update(len(out) * 8, is_idr, layer=meta["layer"])
            if lcu_bits is not None:
                self._rc.update_lcu(lcu_bits)
                if hasattr(self._rc, "update_oba"):
                    self._rc.update_oba(lcu_bits,
                                        (meta["y"], meta["cb"], meta["cr"]),
                                        rec, layer=meta["layer"])
        dd = decisions or {}
        info = {"poc": meta["poc"], "bytes": len(out), "qp": meta["qp"],
                "recon": rec, "recon_out": crop, "psnr": psnr,
                "n_waves": dd.get("n_waves"),
                "tile_waves": dd.get("tile_waves"),
                "slice_type": meta["slice_type"],
                "substreams": len(substreams), "slices": len(slice_nals)}
        if cfg.stats_file_prefix:
            lam = 0.57 * 2.0 ** ((meta["qp"] - 12) / 3.0)
            with open(cfg.stats_file_prefix + "frames.txt", "a") as f:
                f.write(f"{meta['poc']} {meta['qp']} {lam:.4f} "
                        f"{len(out) * 8} {psnr[0]:.4f} {psnr[1]:.4f} "
                        f"{psnr[2]:.4f}\n")
        return out, info


class _HostCtus:
    """IntraFrameEncoder under the slice writers' interface (cab, sao_w,
    write_ctu(ctu_y, ctu_x))."""

    def __init__(self, enc) -> None:
        self.enc = enc

    @property
    def cab(self):
        return self.enc.cab

    @cab.setter
    def cab(self, cab) -> None:
        self.enc.cab = cab

    @property
    def sao_w(self):
        return getattr(self.enc, "sao_w", None)

    @sao_w.setter
    def sao_w(self, w) -> None:
        self.enc.sao_w = w

    def write_ctu(self, ctu_y: int, ctu_x: int) -> None:
        self.enc.encode_ctu(ctu_x, ctu_y)


def _psnr(src_planes, rec_planes, maxv: float) -> list[float]:
    out = []
    for s, r in zip(src_planes, rec_planes):
        mse = np.mean((s.astype(np.float64) - r.astype(np.float64)) ** 2)
        out.append(99.0 if mse == 0 else 10.0 * np.log10(maxv ** 2 / mse))
    return out


def field_config(cfg: Config) -> Config:
    """The configuration of encode_sequence's pictures: with field coding
    (--source-scan-type tff|bff) a copy at half the frame's height that is
    marked as split, else cfg itself. An encoder given to encode_sequence
    is built on it."""
    if cfg.source_scan_type not in ("tff", "bff") or \
            getattr(cfg, "_fields_split", False):
        return cfg
    import copy
    fcfg = copy.copy(cfg)
    fcfg.height = cfg.height // 2
    fcfg._fields_split = True
    return fcfg


def encode_sequence(cfg: Config, frames, encoder: "Encoder | None" = None,
                    device="cuda") -> tuple[bytes, list[dict]]:
    """Encode an iterable of display-order (y, cb, cr) frames to an
    Annex-B stream. A B pyramid goes through push_frame/flush; otherwise
    frame N+1's device work is queued before frame N's host entropy
    coding (the reference pictures stay on the device). With field coding
    (--source-scan-type tff|bff) each frame becomes two pictures of half
    its height, its top field (even lines) first with tff, its bottom
    field first with bff (kvazaar src/kvazaar.c:311-392); a given
    `encoder` must then be built on field_config(cfg)."""
    fcfg = field_config(cfg)
    if fcfg is not cfg:
        tff = cfg.source_scan_type == "tff"
        fields = []
        for (y, cb, cr) in frames:
            top = (y[0::2], cb[0::2], cr[0::2])
            bottom = (y[1::2], cb[1::2], cr[1::2])
            fields.extend((top, bottom) if tff else (bottom, top))
        return encode_sequence(fcfg, fields, encoder=encoder, device=device)
    enc = encoder if encoder is not None else Encoder(cfg, device=device)
    out = b""
    infos = []
    if enc.gop_enabled:
        for f in frames:
            for chunk, info in enc.push_frame(*f):
                out += chunk
                infos.append(info)
        for chunk, info in enc.flush():
            out += chunk
            infos.append(info)
        return out, infos
    if (enc.use_device and cfg.frame_batch > 1 and not enc.inter_enabled
            and enc._rc is None and not enc.dqp_enabled
            and hasattr(enc._pipeline, "submit_many")):
        # frame-batched all-intra (Config.frame_batch): groups of B
        # frames through one device pass each, the previous group
        # entropy coded after the next is submitted
        frames = list(frames)
        prev: list = []
        for i in range(0, len(frames), cfg.frame_batch):
            metas = enc.submit_frames(frames[i:i + cfg.frame_batch])
            for m in prev:
                chunk, info = enc.finalize_frame(m)
                out += chunk
                infos.append(info)
            prev = metas
        for m in prev:
            chunk, info = enc.finalize_frame(m)
            out += chunk
            infos.append(info)
        return out, infos
    pending = None
    for (y, cb, cr) in frames:
        if not enc.use_device:
            # the host route codes frame by frame
            chunk, info = enc.encode_frame(y, cb, cr)
            out += chunk
            infos.append(info)
            continue
        meta = enc.submit_frame(y, cb, cr)
        if pending is not None:
            chunk, info = enc.finalize_frame(pending)
            out += chunk
            infos.append(info)
        pending = meta
    if pending is not None:
        chunk, info = enc.finalize_frame(pending)
        out += chunk
        infos.append(info)
    return out, infos
