"""Drive the bitstream front-end end-to-end against the reference ffmpeg.

Builds a minimal legal VVC Annex-B stream (SPS + PPS + IDR slice with
PH-in-SH) through the public ffvvc_jax.bitstream API, then:
  1. feeds it to the reference ffmpeg's trace_headers BSF (independent CBS
     parser) and checks the field values it logs;
  2. re-parses it with our readers and compares values.
"""
import os
import subprocess
import sys

from ffvvc_jax.bitstream import write_nal, split_annexb, BitReader, NalType
from ffvvc_jax.bitstream.h266 import (SyntaxObj, H266ParamSets, read_sps,
                                      read_pps, read_slice_header)
from ffvvc_jax.bitstream.h266_write import (write_sps, write_pps,
                                            write_slice_header)

FFMPEG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".refbuild", "ffmpeg")


def minimal_sps(width=64, height=64):
    sps = SyntaxObj()
    sps.sps_seq_parameter_set_id = 0
    sps.sps_video_parameter_set_id = 0
    sps.sps_max_sublayers_minus1 = 0
    sps.sps_chroma_format_idc = 1
    sps.sps_log2_ctu_size_minus5 = 0  # CTU 32
    sps.sps_ptl_dpb_hrd_params_present_flag = 1
    ptl = SyntaxObj()
    ptl.general_profile_idc = 1  # Main 10
    ptl.general_tier_flag = 0
    ptl.general_level_idc = 35
    ptl.ptl_frame_only_constraint_flag = 1
    ptl.ptl_multilayer_enabled_flag = 0
    ptl.general_constraints_info = None
    ptl.ptl_sublayer_level_present_flag = []
    ptl.ptl_num_sub_profiles = 0
    sps.profile_tier_level = ptl
    sps.sps_pic_width_max_in_luma_samples = width
    sps.sps_pic_height_max_in_luma_samples = height
    dpb = SyntaxObj()
    dpb.dpb_max_dec_pic_buffering_minus1 = [0]
    dpb.dpb_max_num_reorder_pics = [0]
    dpb.dpb_max_latency_increase_plus1 = [0]
    sps.sps_dpb_params = dpb
    sps.sps_log2_max_pic_order_cnt_lsb_minus4 = 4
    sps.sps_log2_min_luma_coding_block_size_minus2 = 0
    sps.sps_same_qp_table_for_chroma_flag = 1
    sps.sps_qp_table_start_minus26 = [0]
    sps.sps_num_points_in_qp_table_minus1 = [0]
    sps.sps_delta_qp_in_val_minus1 = [[0]]
    sps.sps_delta_qp_diff_val = [[0]]
    sps.sps_num_ref_pic_lists = [0, 0]
    sps.sps_ref_pic_list_struct = [[], []]
    sps.sps_rpl1_same_as_rpl0_flag = 1
    sps.sps_chroma_horizontal_collocated_flag = 1
    sps.sps_chroma_vertical_collocated_flag = 1
    return sps


def minimal_pps(sps):
    pps = SyntaxObj()
    pps.pps_pic_parameter_set_id = 0
    pps.pps_seq_parameter_set_id = 0
    pps.pps_pic_width_in_luma_samples = sps.sps_pic_width_max_in_luma_samples
    pps.pps_pic_height_in_luma_samples = sps.sps_pic_height_max_in_luma_samples
    pps.pps_no_pic_partition_flag = 1
    pps.pps_num_ref_idx_default_active_minus1 = [0, 0]
    pps.pps_init_qp_minus26 = 0
    return pps


def main():
    sps = minimal_sps()
    pps = minimal_pps(sps)
    sps_rbsp = write_sps(sps)
    pps_rbsp = write_pps(pps, sps)
    # round-trip through the readers to pick up derived fields (tile grid,
    # num_slices_in_subpic) needed when writing the slice header
    ps0 = H266ParamSets()
    sps = read_sps(BitReader(sps_rbsp))
    ps0.store_sps(sps)
    pps = read_pps(BitReader(pps_rbsp), ps0)

    ph = SyntaxObj()
    ph.ph_gdr_or_irap_pic_flag = 1
    ph.ph_inter_slice_allowed_flag = 0
    ph.ph_intra_slice_allowed_flag = 1
    ph.ph_pic_parameter_set_id = 0
    ph.ph_pic_order_cnt_lsb = 0
    ph.ph_pic_output_flag = 1
    sh = SyntaxObj()
    sh.nal_unit_type = int(NalType.IDR_N_LP)
    sh.sh_picture_header_in_slice_header_flag = 1
    sh.sh_slice_type = 2
    sh.sh_qp_delta = 5
    w = write_slice_header(sh, sps, pps, ph)
    slice_rbsp = w.bytes() + bytes([0x55, 0xAA, 0x12, 0x80])  # dummy slice_data

    stream = (write_nal(NalType.SPS, sps_rbsp) +
              write_nal(NalType.PPS, pps_rbsp) +
              write_nal(NalType.IDR_N_LP, slice_rbsp))
    open("/tmp/forge_min.bit", "wb").write(stream)
    print(f"stream: {len(stream)} bytes")

    # 1) independent parse by reference CBS
    res = subprocess.run(
        [FFMPEG, "-hide_banner", "-loglevel", "info", "-f", "vvc",
         "-i", "/tmp/forge_min.bit", "-c", "copy", "-bsf:v", "trace_headers",
         "-f", "framecrc", "-y", "/tmp/out.framecrc"],
        capture_output=True, text=True, timeout=60)
    trace = res.stderr
    checks = [
        ("sps_log2_ctu_size_minus5", 0),
        ("sps_pic_width_max_in_luma_samples", 64),
        ("sps_pic_height_max_in_luma_samples", 64),
        ("sps_chroma_format_idc", 1),
        ("general_profile_idc", 1),
        ("pps_no_pic_partition_flag", 1),
        ("sh_picture_header_in_slice_header_flag", 1),
        ("ph_gdr_or_irap_pic_flag", 1),
        ("sh_qp_delta", 5),
    ]
    import re
    failed = []
    for name, want in checks:
        m = re.search(rf"{name}\s+.*?=\s*(-?\d+)", trace)
        if not m:
            failed.append(f"{name}: NOT FOUND in trace")
        elif int(m.group(1)) != want:
            failed.append(f"{name}: trace={m.group(1)} want={want}")
    if failed:
        print("TRACE_HEADERS MISMATCH:")
        for f in failed:
            print("  " + f)
        print("--- trace excerpt ---")
        print(trace[-4000:])
        sys.exit(1)
    print("trace_headers parse: all checked fields match")

    # 2) our readers on the same bytes
    ps = H266ParamSets()
    nals = split_annexb(stream)
    assert [n.nal_unit_type for n in nals] == [NalType.SPS, NalType.PPS, NalType.IDR_N_LP]
    sps2 = read_sps(BitReader(nals[0].rbsp))
    ps.store_sps(sps2)
    pps2 = read_pps(BitReader(nals[1].rbsp), ps)
    ps.store_pps(pps2)
    sh2 = read_slice_header(BitReader(nals[2].rbsp), ps, nals[2].nal_unit_type)
    assert sps2.sps_pic_width_max_in_luma_samples == 64
    assert sps2.sps_chroma_format_idc == 1
    assert sps2.profile_tier_level.general_profile_idc == 1
    assert sps2.sps_log2_max_pic_order_cnt_lsb_minus4 == 4
    assert pps2.num_tiles_in_pic == 1 and pps2.num_tile_columns == 1
    assert sh2.sh_picture_header_in_slice_header_flag == 1
    assert sh2.sh_slice_type == 2
    assert sh2.sh_qp_delta == 5
    assert sh2.sh_picture_header.ph_gdr_or_irap_pic_flag == 1
    # slice_data starts right after byte alignment
    assert nals[2].rbsp[sh2_pos_bytes(sh2, nals[2].rbsp):] [:4] == bytes([0x55, 0xAA, 0x12, 0x80])
    print("ffvvc_jax readers: all checked fields match")
    print("VERIFY_HEADERS_OK")


def sh2_pos_bytes(sh, rbsp):
    # recompute: the reader consumed up to byte alignment; re-read to find pos
    ps = H266ParamSets()
    sps = read_sps(BitReader(write_sps(minimal_sps())))
    ps.store_sps(sps)
    pps = read_pps(BitReader(write_pps(minimal_pps(sps), sps)), ps)
    ps.store_pps(pps)
    r = BitReader(rbsp)
    read_slice_header(r, ps, int(NalType.IDR_N_LP))
    assert r.byte_aligned()
    return r.pos // 8


if __name__ == "__main__":
    main()
