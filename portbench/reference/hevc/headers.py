"""VPS/SPS/PPS/slice-header writers and parsers (HEVC spec 7.3.2-7.3.6).

Reference parity: writers mirror what kvazaar emits
(src/encoder_state-bitstream.c:129 kvz_encoder_state_write_bitstream_VPS,
:361 ..._SPS, :481 ..._PPS, :713 kvz_encoder_state_write_bitstream_slice
_header); parsers cover the same subset so we can decode both our own and
the reference encoder's streams for validation.
"""
from __future__ import annotations

from ..bitstream import BitReader
from .params import PPS, SPS, ProfileTierLevel, ShortTermRPS, SliceHeader

# ---------------------------------------------------------------------------
# profile_tier_level
# ---------------------------------------------------------------------------


def parse_ptl(br: BitReader, max_sub_layers_minus1: int = 0) \
        -> ProfileTierLevel:
    ptl = ProfileTierLevel()
    br.u(2)
    ptl.general_tier_flag = br.u(1)
    ptl.general_profile_idc = br.u(5)
    br.u(32)  # compatibility flags
    ptl.general_progressive_source_flag = br.u(1)
    ptl.general_interlaced_source_flag = br.u(1)
    ptl.general_non_packed_constraint_flag = br.u(1)
    ptl.general_frame_only_constraint_flag = br.u(1)
    br.u(32)
    br.u(12)
    ptl.general_level_idc = br.u(8)
    if max_sub_layers_minus1:
        present = [(br.u(1), br.u(1)) for _ in range(max_sub_layers_minus1)]
        if max_sub_layers_minus1 < 8:
            br.u(2 * (8 - max_sub_layers_minus1))
        for prof, lvl in present:
            if prof:
                br.u(32)
                br.u(32)
                br.u(24)
            if lvl:
                br.u(8)
    return ptl


# ---------------------------------------------------------------------------
# VPS
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# short-term reference picture sets
# ---------------------------------------------------------------------------


def parse_st_rps(br: BitReader, idx: int, rps_list: list[ShortTermRPS],
                 num_total: int) -> ShortTermRPS:
    rps = ShortTermRPS()
    pred = br.u(1) if idx != 0 else 0
    if pred:
        delta_idx_minus1 = br.ue() if idx == num_total else 0
        ref = rps_list[idx - 1 - delta_idx_minus1]
        sign = br.u(1)
        abs_delta = br.ue() + 1
        delta_rps = (1 - 2 * sign) * abs_delta
        ref_all = (list(ref.delta_pocs_s0)[::-1] + [0]
                   + list(ref.delta_pocs_s1))
        use_flags = []
        for _ in range(len(ref_all)):
            used = br.u(1)
            if not used:
                in_rps = br.u(1)
            else:
                in_rps = 1
            use_flags.append((in_rps, used))
        neg, pos = [], []
        for dp, (in_rps, used) in zip(ref_all, use_flags):
            if not in_rps:
                continue
            d = dp + delta_rps
            if d < 0:
                neg.append((d, used))
            elif d > 0:
                pos.append((d, used))
        neg.sort(key=lambda t: -t[0])
        pos.sort(key=lambda t: t[0])
        rps.delta_pocs_s0 = [d for d, _ in neg]
        rps.used_s0 = [u for _, u in neg]
        rps.delta_pocs_s1 = [d for d, _ in pos]
        rps.used_s1 = [u for _, u in pos]
        return rps
    n_neg = br.ue()
    n_pos = br.ue()
    prev = 0
    for _ in range(n_neg):
        prev = prev - (br.ue() + 1)
        rps.delta_pocs_s0.append(prev)
        rps.used_s0.append(br.u(1))
    prev = 0
    for _ in range(n_pos):
        prev = prev + br.ue() + 1
        rps.delta_pocs_s1.append(prev)
        rps.used_s1.append(br.u(1))
    return rps


# ---------------------------------------------------------------------------
# SPS
# ---------------------------------------------------------------------------


def parse_sps(data: bytes) -> SPS:
    br = BitReader(data)
    sps = SPS()
    sps.vps_id = br.u(4)
    sps.max_sub_layers_minus1 = br.u(3)
    sps.temporal_id_nesting_flag = br.u(1)
    sps.ptl = parse_ptl(br, sps.max_sub_layers_minus1)
    sps.sps_id = br.ue()
    sps.chroma_format_idc = br.ue()
    if sps.chroma_format_idc == 3:
        br.u(1)
    sps.width = br.ue()
    sps.height = br.ue()
    if br.u(1):
        sps.conf_win = (br.ue(), br.ue(), br.ue(), br.ue())
    sps.bit_depth_luma = br.ue() + 8
    sps.bit_depth_chroma = br.ue() + 8
    sps.log2_max_poc_lsb = br.ue() + 4
    sub_layer_ordering = br.u(1)
    n = sps.max_sub_layers_minus1 + 1 if sub_layer_ordering else 1
    for _ in range(n):
        sps.max_dec_pic_buffering_minus1 = br.ue()
        sps.max_num_reorder_pics = br.ue()
        sps.max_latency_increase_plus1 = br.ue()
    sps.log2_min_cb_size = br.ue() + 3
    sps.log2_diff_max_min_cb_size = br.ue()
    sps.log2_min_tb_size = br.ue() + 2
    sps.log2_diff_max_min_tb_size = br.ue()
    sps.max_transform_hierarchy_depth_inter = br.ue()
    sps.max_transform_hierarchy_depth_intra = br.ue()
    sps.scaling_list_enabled = br.u(1)
    sps.scaling_lists = None
    if sps.scaling_list_enabled:
        if br.u(1):
            from .scaling import parse_scaling_list_data
            sps.scaling_lists = parse_scaling_list_data(br)
    sps.amp_enabled = br.u(1)
    sps.sao_enabled = br.u(1)
    sps.pcm_enabled = br.u(1)
    if sps.pcm_enabled:
        raise NotImplementedError("PCM")
    num_rps = br.ue()
    for i in range(num_rps):
        sps.short_term_rps.append(
            parse_st_rps(br, i, sps.short_term_rps, num_rps))
    sps.long_term_ref_pics_present = br.u(1)
    if sps.long_term_ref_pics_present:
        raise NotImplementedError("long-term refs")
    sps.temporal_mvp_enabled = br.u(1)
    sps.strong_intra_smoothing = br.u(1)
    sps.vui_present = br.u(1)
    if sps.vui_present:
        _parse_vui(br, sps)
    return sps


def _parse_vui(br: BitReader, sps: SPS) -> None:
    if br.u(1):  # aspect_ratio_info_present
        idc = br.u(8)
        if idc == 255:
            br.u(16)
            br.u(16)
    if br.u(1):  # overscan
        br.u(1)
    if br.u(1):  # video_signal_type
        br.u(3)
        br.u(1)
        if br.u(1):
            br.u(8)
            br.u(8)
            br.u(8)
    if br.u(1):  # chroma_loc
        br.ue()
        br.ue()
    br.u(1)  # neutral_chroma
    br.u(1)  # field_seq
    br.u(1)  # frame_field_info
    if br.u(1):  # default_display_window
        br.ue()
        br.ue()
        br.ue()
        br.ue()
    if br.u(1):  # vui_timing_info_present
        num = br.u(32)
        scale = br.u(32)
        sps.vui_timing = (num, scale)
        if br.u(1):  # poc_proportional_to_timing
            br.ue()
        if br.u(1):  # hrd_parameters_present
            raise NotImplementedError("HRD parameters")
    if br.u(1):  # bitstream_restriction
        br.u(3)
        br.ue()
        br.ue()
        br.ue()
        br.ue()
        br.ue()


# ---------------------------------------------------------------------------
# PPS
# ---------------------------------------------------------------------------


def parse_pps(data: bytes) -> PPS:
    br = BitReader(data)
    pps = PPS()
    pps.pps_id = br.ue()
    pps.sps_id = br.ue()
    pps.dependent_slice_segments_enabled = br.u(1)
    pps.output_flag_present = br.u(1)
    pps.num_extra_slice_header_bits = br.u(3)
    pps.sign_data_hiding_enabled = br.u(1)
    pps.cabac_init_present = br.u(1)
    pps.num_ref_idx_l0_default_minus1 = br.ue()
    pps.num_ref_idx_l1_default_minus1 = br.ue()
    pps.init_qp = 26 + br.se()
    pps.constrained_intra_pred = br.u(1)
    pps.transform_skip_enabled = br.u(1)
    pps.cu_qp_delta_enabled = br.u(1)
    if pps.cu_qp_delta_enabled:
        pps.diff_cu_qp_delta_depth = br.ue()
    pps.cb_qp_offset = br.se()
    pps.cr_qp_offset = br.se()
    pps.slice_chroma_qp_offsets_present = br.u(1)
    pps.weighted_pred = br.u(1)
    pps.weighted_bipred = br.u(1)
    pps.transquant_bypass_enabled = br.u(1)
    pps.tiles_enabled = br.u(1)
    pps.entropy_coding_sync_enabled = br.u(1)
    if pps.tiles_enabled:
        pps.num_tile_columns = br.ue() + 1
        pps.num_tile_rows = br.ue() + 1
        pps.uniform_spacing = br.u(1)
        if not pps.uniform_spacing:
            pps.column_widths = [br.ue() + 1
                                 for _ in range(pps.num_tile_columns - 1)]
            pps.row_heights = [br.ue() + 1
                               for _ in range(pps.num_tile_rows - 1)]
        pps.loop_filter_across_tiles = br.u(1)
    pps.loop_filter_across_slices = br.u(1)
    pps.deblocking_filter_control_present = br.u(1)
    if pps.deblocking_filter_control_present:
        pps.deblocking_filter_override_enabled = br.u(1)
        pps.deblocking_filter_disabled = br.u(1)
        if not pps.deblocking_filter_disabled:
            pps.beta_offset_div2 = br.se()
            pps.tc_offset_div2 = br.se()
    pps.scaling_lists = None
    if br.u(1):
        from .scaling import parse_scaling_list_data
        pps.scaling_lists = parse_scaling_list_data(br)
    pps.lists_modification_present = br.u(1)
    pps.log2_parallel_merge_level = br.ue() + 2
    pps.slice_segment_header_extension_present = br.u(1)
    return pps


# ---------------------------------------------------------------------------
# Slice segment header
# ---------------------------------------------------------------------------


def parse_slice_header(br: BitReader, sps: SPS, pps_map: dict[int, PPS],
                       nal_type: int) -> tuple[SliceHeader, PPS]:
    from ..bitstream import NAL_BLA_W_LP, NAL_CRA_NUT, NAL_IDR_W_RADL
    is_irap = NAL_BLA_W_LP <= nal_type <= NAL_CRA_NUT
    is_idr = nal_type in (NAL_IDR_W_RADL, 20)
    sh = SliceHeader()
    sh.first_slice_in_pic = br.u(1)
    if is_irap:
        sh.no_output_of_prior_pics = br.u(1)
    sh.pps_id = br.ue()
    pps = pps_map[sh.pps_id]
    if not sh.first_slice_in_pic:
        if pps.dependent_slice_segments_enabled:
            sh.dependent_slice_segment = br.u(1)
        n_ctbs = sps.width_in_ctbs * sps.height_in_ctbs
        sh.segment_address = br.u((n_ctbs - 1).bit_length())
    if not sh.dependent_slice_segment:
        for _ in range(pps.num_extra_slice_header_bits):
            br.u(1)
        sh.slice_type = br.ue()
        if pps.output_flag_present:
            br.u(1)
        if not is_idr:
            sh.pic_order_cnt_lsb = br.u(sps.log2_max_poc_lsb)
            sh.short_term_rps_sps_flag = br.u(1)
            if not sh.short_term_rps_sps_flag:
                sh.short_term_rps = parse_st_rps(
                    br, len(sps.short_term_rps), sps.short_term_rps,
                    len(sps.short_term_rps))
            elif len(sps.short_term_rps) > 1:
                sh.short_term_rps_idx = br.u(
                    (len(sps.short_term_rps) - 1).bit_length())
            if sps.temporal_mvp_enabled:
                sh.temporal_mvp_enabled = br.u(1)
        if sps.sao_enabled:
            sh.sao_luma = br.u(1)
            sh.sao_chroma = br.u(1)
        if sh.slice_type != 2:
            rps = (sh.short_term_rps if not sh.short_term_rps_sps_flag
                   else sps.short_term_rps[sh.short_term_rps_idx])
            n_pics = sum(rps.used_s0) + sum(rps.used_s1)
            sh.num_ref_idx_l0_active_minus1 = pps.num_ref_idx_l0_default_minus1
            sh.num_ref_idx_l1_active_minus1 = pps.num_ref_idx_l1_default_minus1
            sh.num_ref_idx_active_override = br.u(1)
            if sh.num_ref_idx_active_override:
                sh.num_ref_idx_l0_active_minus1 = br.ue()
                if sh.slice_type == 0:
                    sh.num_ref_idx_l1_active_minus1 = br.ue()
            if pps.lists_modification_present and n_pics > 1:
                if br.u(1):
                    raise NotImplementedError("ref list modification")
                if sh.slice_type == 0 and br.u(1):
                    raise NotImplementedError("ref list modification l1")
            if sh.slice_type == 0:
                sh.mvd_l1_zero = br.u(1)
            if pps.cabac_init_present:
                sh.cabac_init_flag = br.u(1)
            if sh.temporal_mvp_enabled:
                if sh.slice_type == 0:
                    sh.collocated_from_l0 = br.u(1)
                nref = (sh.num_ref_idx_l0_active_minus1 + 1
                        if sh.collocated_from_l0
                        else sh.num_ref_idx_l1_active_minus1 + 1)
                if nref > 1:
                    sh.collocated_ref_idx = br.ue()
            if pps.weighted_pred or pps.weighted_bipred:
                raise NotImplementedError("weighted prediction")
            sh.five_minus_max_num_merge_cand = br.ue()
        sh.qp = pps.init_qp + br.se()
        if pps.slice_chroma_qp_offsets_present:
            br.se()
            br.se()
        deblock_override = 0
        if pps.deblocking_filter_control_present:
            if pps.deblocking_filter_override_enabled:
                deblock_override = br.u(1)
            if deblock_override:
                sh.deblocking_filter_disabled = br.u(1)
                if not sh.deblocking_filter_disabled:
                    sh.beta_offset_div2 = br.se()
                    sh.tc_offset_div2 = br.se()
            else:
                sh.deblocking_filter_disabled = pps.deblocking_filter_disabled
                sh.beta_offset_div2 = pps.beta_offset_div2
                sh.tc_offset_div2 = pps.tc_offset_div2
        if pps.loop_filter_across_slices and \
                (sh.sao_luma or sh.sao_chroma
                 or not sh.deblocking_filter_disabled):
            sh.loop_filter_across_slices = br.u(1)
    if pps.tiles_enabled or pps.entropy_coding_sync_enabled:
        n = br.ue()
        if n:
            nbits = br.ue() + 1
            sh.entry_point_offsets = [br.u(nbits) + 1 for _ in range(n)]
    if pps.slice_segment_header_extension_present:
        ext_len = br.ue()
        for _ in range(ext_len):
            br.u(8)
    # byte_alignment(): alignment_bit_equal_to_one + zero bits
    one = br.u(1)
    assert one == 1, "slice header alignment bit"
    br.byte_align()
    return sh, pps
