"""Parameter set dataclasses (SPS/PPS/VPS) shared by encoder and decoder.

Reference parity: kvazaar src/encoder_state-bitstream.c:129-606 (writers);
field names follow the HEVC spec (7.3.2).
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class ProfileTierLevel:
    general_profile_idc: int = 1  # Main
    general_tier_flag: int = 0
    general_level_idc: int = 120  # level 4.0
    general_progressive_source_flag: int = 1
    general_interlaced_source_flag: int = 0
    general_non_packed_constraint_flag: int = 0
    general_frame_only_constraint_flag: int = 1


@dataclass
class ShortTermRPS:
    """One short-term reference picture set (spec 7.3.7)."""
    delta_pocs_s0: list[int] = field(default_factory=list)  # negative deltas
    used_s0: list[int] = field(default_factory=list)
    delta_pocs_s1: list[int] = field(default_factory=list)  # positive deltas
    used_s1: list[int] = field(default_factory=list)

    @property
    def num_negative(self) -> int:
        return len(self.delta_pocs_s0)

    @property
    def num_positive(self) -> int:
        return len(self.delta_pocs_s1)


@dataclass
class SPS:
    sps_id: int = 0
    vps_id: int = 0
    max_sub_layers_minus1: int = 0
    temporal_id_nesting_flag: int = 1
    ptl: ProfileTierLevel = field(default_factory=ProfileTierLevel)
    chroma_format_idc: int = 1
    width: int = 0   # pic_width_in_luma_samples (padded)
    height: int = 0
    conf_win: tuple[int, int, int, int] = (0, 0, 0, 0)  # l, r, t, b
    bit_depth_luma: int = 8
    bit_depth_chroma: int = 8
    log2_max_poc_lsb: int = 8
    max_dec_pic_buffering_minus1: int = 5
    max_num_reorder_pics: int = 0
    max_latency_increase_plus1: int = 0
    log2_min_cb_size: int = 3
    log2_diff_max_min_cb_size: int = 3
    log2_min_tb_size: int = 2
    log2_diff_max_min_tb_size: int = 3
    max_transform_hierarchy_depth_inter: int = 0
    max_transform_hierarchy_depth_intra: int = 0
    scaling_list_enabled: int = 0
    amp_enabled: int = 0
    sao_enabled: int = 0
    pcm_enabled: int = 0
    short_term_rps: list[ShortTermRPS] = field(default_factory=list)
    long_term_ref_pics_present: int = 0
    temporal_mvp_enabled: int = 0
    strong_intra_smoothing: int = 0
    vui_present: int = 0
    vui_timing: tuple[int, int] | None = None  # (num_units_in_tick, time_scale)

    @property
    def ctb_log2(self) -> int:
        return self.log2_min_cb_size + self.log2_diff_max_min_cb_size

    @property
    def ctb_size(self) -> int:
        return 1 << self.ctb_log2

    @property
    def width_in_ctbs(self) -> int:
        return -(-self.width // self.ctb_size)

    @property
    def height_in_ctbs(self) -> int:
        return -(-self.height // self.ctb_size)


@dataclass
class PPS:
    pps_id: int = 0
    sps_id: int = 0
    dependent_slice_segments_enabled: int = 0
    output_flag_present: int = 0
    num_extra_slice_header_bits: int = 0
    sign_data_hiding_enabled: int = 0
    cabac_init_present: int = 0
    num_ref_idx_l0_default_minus1: int = 0
    num_ref_idx_l1_default_minus1: int = 0
    init_qp: int = 26
    constrained_intra_pred: int = 0
    transform_skip_enabled: int = 0
    cu_qp_delta_enabled: int = 0
    diff_cu_qp_delta_depth: int = 0
    cb_qp_offset: int = 0
    cr_qp_offset: int = 0
    slice_chroma_qp_offsets_present: int = 0
    weighted_pred: int = 0
    weighted_bipred: int = 0
    transquant_bypass_enabled: int = 0
    tiles_enabled: int = 0
    entropy_coding_sync_enabled: int = 0
    num_tile_columns: int = 1
    num_tile_rows: int = 1
    uniform_spacing: int = 1
    column_widths: list[int] = field(default_factory=list)  # in CTBs
    row_heights: list[int] = field(default_factory=list)
    loop_filter_across_tiles: int = 1
    loop_filter_across_slices: int = 1
    deblocking_filter_control_present: int = 0
    deblocking_filter_override_enabled: int = 0
    deblocking_filter_disabled: int = 0
    beta_offset_div2: int = 0
    tc_offset_div2: int = 0
    lists_modification_present: int = 0
    log2_parallel_merge_level: int = 2
    slice_segment_header_extension_present: int = 0


@dataclass
class SliceHeader:
    first_slice_in_pic: int = 1
    no_output_of_prior_pics: int = 0
    pps_id: int = 0
    dependent_slice_segment: int = 0
    segment_address: int = 0
    slice_type: int = 2  # 0=B, 1=P, 2=I
    pic_order_cnt_lsb: int = 0
    short_term_rps_sps_flag: int = 0
    short_term_rps_idx: int = 0
    short_term_rps: ShortTermRPS | None = None
    num_ref_idx_active_override: int = 0
    num_ref_idx_l0_active_minus1: int = 0
    num_ref_idx_l1_active_minus1: int = 0
    mvd_l1_zero: int = 0
    cabac_init_flag: int = 0
    collocated_from_l0: int = 1
    collocated_ref_idx: int = 0
    five_minus_max_num_merge_cand: int = 0
    qp: int = 26
    sao_luma: int = 0
    sao_chroma: int = 0
    temporal_mvp_enabled: int = 0
    deblocking_filter_disabled: int = 0
    beta_offset_div2: int = 0
    tc_offset_div2: int = 0
    loop_filter_across_slices: int = 1
    entry_point_offsets: list[int] = field(default_factory=list)

    @property
    def is_intra(self) -> bool:
        return self.slice_type == 2
