"""Forged-stream conformance: our decoder must match the reference decoder
byte-for-byte on synthesized streams (the in-repo analogue of FATE/JVET)."""
import sys
import os

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

from conftest import oracle_decode, have_oracle
from ffvvc_jax.decoder import VVCDecoder

pytestmark = pytest.mark.skipif(not have_oracle(),
                                reason="oracle not built")


def _forge(level, seed=0, w=64, h=64, qp=32, deblock=False, **sps_kw):
    from forge import (build_sps, build_pps, forge_frame, FlatPolicy,
                       FuzzPolicy, write_nal, write_sps, write_pps, NalType)
    if level == 0:
        sps_r = build_sps(w, h, min_qt_log2=5, max_mtt_depth=0, **sps_kw)
        policy = FlatPolicy()
    else:
        sps_r = build_sps(w, h, min_qt_log2=2, max_mtt_depth=2, **sps_kw)
        policy = FuzzPolicy(seed)
    kw = {}
    if not deblock:
        kw = dict(pps_deblocking_filter_control_present_flag=1,
                  pps_deblocking_filter_disabled_flag=1)
    pps_r = build_pps(sps_r, **kw)
    stream = write_nal(NalType.SPS, write_sps(sps_r))
    stream += write_nal(NalType.PPS, write_pps(pps_r, sps_r))
    nal, _ = forge_frame(sps_r, pps_r, policy, qp=qp, poc=0)
    return stream + nal


def _check(stream, tmp_path):
    ref = oracle_decode(stream, tmp_path)
    frames = VVCDecoder().decode(stream)
    assert len(frames) == 1
    mine = frames[0].to_yuv_bytes()
    assert mine == ref, "decoded YUV differs from reference"


def test_l0_flat(tmp_path):
    _check(_forge(0), tmp_path)


@pytest.mark.parametrize("seed,w,h,qp", [
    (1, 64, 64, 32),
    (2, 96, 64, 27),
    (3, 64, 96, 37),
])
def test_l1_intra_fuzz(seed, w, h, qp, tmp_path):
    _check(_forge(1, seed, w, h, qp), tmp_path)


@pytest.mark.parametrize("seed,qp", [(1, 32), (4, 38)])
def test_l2_deblock(seed, qp, tmp_path):
    _check(_forge(1, seed, 64, 64, qp, deblock=True), tmp_path)


@pytest.mark.parametrize("seed,vert_coll", [(1, 1), (2, 0), (7, 1)])
def test_l1_cclm(seed, vert_coll, tmp_path):
    """CCLM chroma prediction (8.4.5.2.14), collocated & midpoint filters."""
    _check(_forge(1, seed, 64, 64, 30, sps_cclm_enabled_flag=1,
                  sps_chroma_vertical_collocated_flag=vert_coll), tmp_path)


def _check_stream(stream, tmp_path, n_frames):
    ref = oracle_decode(stream, tmp_path)
    frames = VVCDecoder().decode(stream)
    assert len(frames) == n_frames
    mine = b"".join(f.to_yuv_bytes() for f in frames)
    assert mine == ref, "decoded YUV differs from reference"


@pytest.mark.parametrize("seed,slice_type,n_refs", [
    (0, 1, (1, 0)),            # P, single ref
    (1, 0, (1, 1)),            # B
    (6, 0, (2, 2)),            # B, two refs per list (ref_idx coding)
])
def test_l3_inter(seed, slice_type, n_refs, tmp_path):
    from forge import forge_inter_stream
    _check_stream(forge_inter_stream(seed=seed, nframes=3,
                                     slice_type=slice_type, n_refs=n_refs,
                                     deblock=True), tmp_path, 3)


AFFINE = dict(sps_affine_enabled_flag=1,
              sps_five_minus_max_num_subblock_merge_cand=0,
              sps_6param_affine_enabled_flag=1,
              sps_affine_prof_enabled_flag=1)
ALL_TOOLS = dict(sps_temporal_mvp_enabled_flag=1, sps_sbtmvp_enabled_flag=1,
                 sps_mmvd_enabled_flag=1, sps_ciip_enabled_flag=1,
                 sps_bcw_enabled_flag=1, sps_amvr_enabled_flag=1,
                 sps_affine_amvr_enabled_flag=1, sps_smvd_enabled_flag=1,
                 **AFFINE)


@pytest.mark.parametrize("seed,tools", [
    (0, dict(sps_temporal_mvp_enabled_flag=1)),          # TMVP
    (4, dict(sps_gpm_enabled_flag=1,                     # GPM
             sps_max_num_merge_cand_minus_max_num_gpm_cand=0,
             sps_six_minus_max_num_merge_cand=1)),
    (2, AFFINE),                                         # affine + PROF
    (7, dict(sps_sbt_enabled_flag=1)),                   # SBT
    (5, ALL_TOOLS),                                      # everything at once
    (6, dict(sps_sbt_enabled_flag=1, **ALL_TOOLS)),      # + SBT
])
def test_l4_inter_tools(seed, tools, tmp_path):
    from forge import forge_inter_stream
    _check_stream(forge_inter_stream(seed=seed, nframes=3, slice_type=0,
                                     n_refs=(2, 2), deblock=True, **tools),
                  tmp_path, 3)


def test_l5_weighted_pred(tmp_path):
    from forge import forge_inter_stream
    _check_stream(forge_inter_stream(
        seed=1, nframes=3, slice_type=0, deblock=True,
        sps_weighted_bipred_flag=1,
        pps_kw=dict(pps_weighted_bipred_flag=1)), tmp_path, 3)


def test_l4_long_term_refs(tmp_path):
    """Long-term reference pictures, LSB-only and explicit-MSB-cycle
    entries (decoder.py LT branch; reference ff_vvc_slice_rpl LT/MSB
    handling, vvc_refs.c:415-466)."""
    from forge import (build_sps, build_pps, forge_frame, FuzzPolicy,
                       write_nal, write_sps, write_pps, NalType)
    SLICE_B, SLICE_P = 0, 1
    sps_r = build_sps(64, 64, bit_depth=10, min_qt_log2=2, max_mtt_depth=2,
                      sps_long_term_ref_pics_flag=1)
    pps_r = build_pps(sps_r)
    stream = write_nal(NalType.SPS, write_sps(sps_r))
    stream += write_nal(NalType.PPS, write_pps(pps_r, sps_r))
    policy = FuzzPolicy(11)
    nal, _ = forge_frame(sps_r, pps_r, policy, qp=32, poc=0, idr=True)
    stream += nal
    nal, _ = forge_frame(sps_r, pps_r, policy, qp=32, poc=2, idr=False,
                         slice_type=SLICE_P, ref_deltas=([-2], []))
    stream += nal
    # ST ref to POC 2 + LSB-only LT ref to POC 0 in one list
    nal, _ = forge_frame(sps_r, pps_r, policy, qp=32, poc=4, idr=False,
                         slice_type=SLICE_P,
                         ref_deltas=([-2, ("lt", 0)], []))
    stream += nal
    # B frame whose L1 is a future LT ref with an explicit MSB cycle
    nal, _ = forge_frame(sps_r, pps_r, policy, qp=32, poc=3, idr=False,
                         slice_type=SLICE_B,
                         ref_deltas=([-1], [("ltmsb", 4)]))
    stream += nal
    _check_stream(stream, tmp_path, 4)


def test_l6_hier_dmvr_bdof(tmp_path):
    """Hierarchical GOP with future refs: DMVR + BDOF + POC reorder."""
    from forge import forge_hier_stream
    _check_stream(forge_hier_stream(seed=3, ngops=2, deblock=True,
                                    sps_bdof_enabled_flag=1,
                                    sps_dmvr_enabled_flag=1), tmp_path, 5)


@pytest.mark.parametrize("name,kw", [
    ("tiles", dict(seed=0, nframes=2)),
    ("tiles-P", dict(seed=1, nframes=3, slice_type=1)),
    ("tiles-no-lf", dict(seed=2, nframes=2, lf_across_tiles=0)),
    ("slices", dict(seed=3, nframes=2, slices=[(0, 2), (2, 2)])),
    ("slices-no-lf", dict(seed=4, nframes=2, slices=[(0, 2), (2, 2)],
                          lf_across_slices=0)),
    ("wpp", dict(seed=5, nframes=2, cols=(3,), rows=(3,), wpp=True)),
    ("wpp-tiles", dict(seed=6, nframes=2, wpp=True)),
])
def test_l8_partitions(name, kw, tmp_path):
    from forge import forge_tiled_stream
    stream = forge_tiled_stream(**kw)
    _check_stream(stream, tmp_path, kw["nframes"])


@pytest.mark.parametrize("seed,tools", [
    (1, dict(sps_sao_enabled_flag=1)),                       # SAO
    (2, dict(sps_alf_enabled_flag=1)),                       # ALF
    (3, dict(sps_alf_enabled_flag=1, sps_ccalf_enabled_flag=1)),  # CC-ALF
    (2, dict(sps_lmcs_enabled_flag=1)),                      # LMCS
    (3, dict(sps_sao_enabled_flag=1, sps_alf_enabled_flag=1,
             sps_ccalf_enabled_flag=1, sps_lmcs_enabled_flag=1)),  # chain
    (4, dict(sps_ladf_enabled_flag=1, sps_num_ladf_intervals_minus2=1,
             sps_ladf_lowest_interval_qp_offset=3,
             sps_ladf_qp_offset=[-2, 4],
             sps_ladf_delta_threshold_minus1=[30, 100])),          # LADF
])
def test_l7_loop_filters(seed, tools, tmp_path):
    from forge import forge_inter_stream
    _check_stream(forge_inter_stream(seed=seed, nframes=3, deblock=True,
                                     **tools), tmp_path, 3)


@pytest.mark.parametrize("name,kw", [
    ("mono", dict(seed=0, nframes=2, chroma=0)),
    ("422", dict(seed=1, nframes=2, chroma=2)),
    ("444", dict(seed=2, nframes=2, chroma=3)),
    ("12bit", dict(seed=3, nframes=2, bit_depth=12)),
    ("10bit_b", dict(seed=4, nframes=3, bit_depth=10, slice_type=0)),
    ("10bit_422_p", dict(seed=5, nframes=3, bit_depth=10, chroma=2,
                         slice_type=1)),
])
def test_l9_formats(name, kw, tmp_path):
    from forge import forge_inter_stream
    _check_stream(forge_inter_stream(deblock=True, **kw), tmp_path,
                  kw["nframes"])


@pytest.mark.parametrize("name,kw", [
    ("rect_i", dict(seed=0, slice_type=2)),
    ("rect_p", dict(seed=1, slice_type=1, nframes=3)),
    ("subpic_i", dict(seed=2, slice_type=2, subpic=True)),
    ("subpic_p", dict(seed=3, slice_type=1, nframes=3, subpic=True)),
    ("subpic_noclf", dict(seed=4, slice_type=2, subpic=True,
                          lf_across_tiles=0, lf_across_slices=0)),
    # non-identity subpic IDs: SubpicIdVal from explicit SPS mapping /
    # PPS override (h266.py:624-629 read, ps derivation vvc_ps.c:1040)
    ("subpic_ids_sps", dict(seed=5, slice_type=2, subpic=True,
                            subpic_ids=(2, 1), id_mapping="sps")),
    ("subpic_ids_pps", dict(seed=6, slice_type=1, nframes=3, subpic=True,
                            subpic_ids=(3, 0), id_mapping="pps")),
])
def test_l11_rect_slices_subpics(name, kw, tmp_path):
    """Rectangular slices and subpictures (reference slice-idx mapping
    vvc_ps.c:1034-1041; subpic SH resolution cbs template :3050-3070)."""
    from forge import forge_rect_slice_stream, forge_subpic_stream
    kw = dict(kw)
    fn = forge_subpic_stream if kw.pop("subpic", False) \
        else forge_rect_slice_stream
    n = kw.setdefault("nframes", 2)
    _check_stream(fn(**kw), tmp_path, n)


@pytest.mark.parametrize("name,kw", [
    # RPL/WP/QP-delta/SAO/ALF/deblock signalling moved into a standalone
    # PH (pps_*_info_in_ph_flag; reference picture_header_structure,
    # cbs_h266_syntax_template.c; consumers vvc_ps.c:1140-1166)
    # (TMVP is deliberately absent here: TMVP + rpl-in-PH hits reference
    # bug #6, pinned by test_ph_collocated_ref_bug below)
    ("ph_info_p", dict(seed=0, nframes=3, slice_type=1, info_in_ph=True,
                       sps_sao_enabled_flag=1, sps_alf_enabled_flag=1,
                       sps_ccalf_enabled_flag=1, sps_lmcs_enabled_flag=1)),
    # B + TMVP + rpl-in-PH with L0[0] == L1[0]: the reference's wrong
    # collocated list lands on the same picture, so outputs still match
    ("ph_info_tmvp_b", dict(seed=7, nframes=3, slice_type=0,
                            info_in_ph=True,
                            sps_temporal_mvp_enabled_flag=1)),
    # PH-level pred-weight table (pps_wp_info_in_ph_flag)
    ("ph_info_wp_b", dict(seed=1, nframes=3, slice_type=0,
                          info_in_ph=True, sps_weighted_bipred_flag=1)),
    ("ph_info_wp_p", dict(seed=2, nframes=3, slice_type=1,
                          info_in_ph=True, sps_weighted_pred_flag=1)),
    # PH partition-constraints override with values differing from the SPS
    ("ph_part_override", dict(
        seed=3, nframes=2, slice_type=2,
        sps_partition_constraints_override_enabled_flag=1,
        ph_kw=dict(ph_partition_constraints_override_flag=1,
                   ph_log2_diff_min_qt_min_cb_intra_slice_luma=1,
                   ph_max_mtt_hierarchy_depth_intra_slice_luma=1,
                   ph_log2_diff_max_bt_min_qt_intra_slice_luma=1,
                   ph_log2_diff_max_tt_min_qt_intra_slice_luma=1,
                   ph_log2_diff_min_qt_min_cb_inter_slice=1,
                   ph_max_mtt_hierarchy_depth_inter_slice=1,
                   ph_log2_diff_max_bt_min_qt_inter_slice=1,
                   ph_log2_diff_max_tt_min_qt_inter_slice=1))),
    # virtual boundaries: parsed and ignored by the reference too (its CBS
    # reads them, libavcodec/vvc never consumes them) — behavior parity
    ("vb_sps", dict(seed=4, nframes=2, slice_type=1,
                    sps_virtual_boundaries_enabled_flag=1,
                    sps_virtual_boundaries_present_flag=1,
                    sps_num_ver_virtual_boundaries=1,
                    sps_virtual_boundary_pos_x_minus1=[3],
                    sps_num_hor_virtual_boundaries=1,
                    sps_virtual_boundary_pos_y_minus1=[3])),
    ("vb_ph", dict(seed=5, nframes=2, slice_type=1,
                   sps_virtual_boundaries_enabled_flag=1,
                   ph_kw=dict(ph_virtual_boundaries_present_flag=1,
                              ph_num_ver_virtual_boundaries=1,
                              ph_virtual_boundary_pos_x_minus1=[3],
                              ph_num_hor_virtual_boundaries=0,
                              ph_virtual_boundary_pos_y_minus1=[]))),
    # reserved extra PH/SH bits: emitted, skipped by readers
    ("extra_bits", dict(seed=6, nframes=2, slice_type=1,
                        sps_num_extra_ph_bytes=1,
                        sps_extra_ph_bit_present_flag=[1, 0, 1, 0,
                                                       0, 0, 0, 0],
                        sps_num_extra_sh_bytes=1,
                        sps_extra_sh_bit_present_flag=[0, 1, 0, 0,
                                                       0, 0, 0, 1])),
])
def test_ph_level_syntax(name, kw, tmp_path):
    """Decode-relevant syntax previously read but never forged
    (h266_write.py NotImplementedError closures, round 5)."""
    from forge import forge_inter_stream
    kw = dict(kw)
    n = kw.setdefault("nframes", 2)
    _check_stream(forge_inter_stream(deblock=True, **kw), tmp_path, n)


@pytest.mark.parametrize("name,kw", [
    ("intile_i", dict(seed=0, slice_type=2)),
    ("intile_p", dict(seed=1, slice_type=1, nframes=3)),
    ("delta_i", dict(seed=2, slice_type=2, delta=True)),
    ("delta_p", dict(seed=3, slice_type=1, nframes=3, delta=True)),
])
def test_l11_intile_and_delta_slices(name, kw, tmp_path):
    """Rect-slice layouts using pps_num_exp_slices_in_tile (a tile split
    into slices) and pps_tile_idx_delta (explicit slice->tile mapping) —
    reference pps_slice_map vvc_ps.c:414."""
    from forge import forge_intile_slice_stream, forge_tile_delta_stream
    kw = dict(kw)
    fn = forge_tile_delta_stream if kw.pop("delta", False) \
        else forge_intile_slice_stream
    n = kw.setdefault("nframes", 2)
    _check_stream(fn(**kw), tmp_path, n)


def test_ph_collocated_ref_bug(tmp_path):
    """Reference bug #6: with pps_rpl_info_in_ph_flag the reference's CBS
    never infers sh_collocated_from_l0_flag / sh_collocated_ref_idx from
    the PH (cbs_h266_syntax_template.c:3222-3236 has no infer in the
    rpl-in-PH branch), so its consumer (vvc_refs.c:461-463) reads the
    memset default 0 and resolves the collocated picture from L1 — for a
    P slice, from an EMPTY list (collocated = NULL, temporal candidates
    silently dropped).  H.266 7.4.3.7 infers both from ph_collocated_*.
    We implement the spec; pin the reference's mis-decode so a fixed
    reference flips this test."""
    from forge import forge_inter_stream
    from ffvvc_jax.config import DecoderConfig
    stream = forge_inter_stream(seed=0, nframes=3, slice_type=1,
                                info_in_ph=True, deblock=False,
                                sps_temporal_mvp_enabled_flag=1)
    a = VVCDecoder().decode(stream)
    b = VVCDecoder(DecoderConfig(native_parse=False)).decode(stream)
    assert len(a) == len(b) == 3
    ours = b"".join(f.to_yuv_bytes() for f in a)
    assert ours == b"".join(f.to_yuv_bytes() for f in b)
    ref = oracle_decode(stream, tmp_path)
    assert ours != ref, \
        "oracle now matches: reference bug #6 fixed — drop this pin"


def test_l10_gdr(tmp_path):
    """GDR: output suppressed until the recovery-point POC."""
    from forge import forge_gdr_stream
    _check_stream(forge_gdr_stream(seed=0, nframes=4, recovery=2),
                  tmp_path, 2)


@pytest.mark.parametrize("kw", [
    dict(seed=0), dict(seed=1, bit_depth=10), dict(seed=2, bdpcm=True),
    dict(seed=3, ts_res_disabled=True),
    dict(seed=4, bdpcm=True, ts_res_disabled=True),
    dict(seed=5, bit_depth=12), dict(seed=6, bit_depth=10, bdpcm=True)])
def test_transform_skip(kw, tmp_path):
    """Transform-skip / BDPCM tool rows (reference TSSC/BDPCM streams)."""
    from forge import forge_ts_stream
    _check_stream(forge_ts_stream(nframes=2, **kw), tmp_path, 2)


def test_l8_wpp_asymmetric_tiles_ref_bug(tmp_path):
    """Raster-scan tiles + WPP with tile cols != rows: the reference's CBS
    slice-header parser miscounts NumEntryPoints (cbs_h266_syntax_template.c
    :3406 divides the raster tile index by num_tile_rows instead of
    num_tile_columns, reading row_height_val out of bounds) and rejects
    spec-valid streams.  Our reader implements the spec formula
    (h266.py:1907); assert we decode such a stream consistently across the
    native and Python paths, and pin the oracle's rejection so a fixed
    reference flips this test."""
    import subprocess
    from forge import forge_tiled_stream
    from ffvvc_jax.config import DecoderConfig
    stream = forge_tiled_stream(seed=3, nframes=2, wpp=True, width=96,
                                height=96, rows=(1, 2), cols=(1,))
    a = VVCDecoder().decode(stream)
    b = VVCDecoder(DecoderConfig(native_parse=False)).decode(stream)
    assert len(a) == len(b) == 2
    assert b"".join(f.to_yuv_bytes() for f in a) == \
        b"".join(f.to_yuv_bytes() for f in b)
    if have_oracle():
        bit = tmp_path / "t.bit"
        bit.write_bytes(stream)
        from conftest import ORACLE
        r = subprocess.run(
            [ORACLE, "-hide_banner", "-loglevel", "error", "-threads", "1",
             "-f", "vvc", "-i", str(bit), "-f", "rawvideo", "-y",
             str(tmp_path / "t.yuv")], capture_output=True, timeout=120)
        assert b"byte_alignment" in r.stderr, \
            "reference now parses this stream — drop the bug pin and " \
            "compare outputs instead"


# --- intra coding-tools matrix: ISP / MIP / MRL / LFNST / MTS ---------------
# (the reference's CodingToolsSets streams, tests/fate/vvc.mak:1-2; also the
# BASELINE.md all-intra 10-bit config)

def _tools_policy(only=None):
    """ToolsPolicy restricted to a single intra tool (or all when None)."""
    from forge import ToolsPolicy

    class P(ToolsPolicy):
        def __call__(self, tag, **ctx):
            gate = {"mip_flag": "mip", "isp_mode_flag": "isp",
                    "mrl_idx": "mrl", "lfnst_idx": "lfnst",
                    "mts_idx": "mts"}.get(tag)
            if only is not None and gate is not None and gate != only:
                return 0
            return super().__call__(tag, **ctx)
    return P


@pytest.mark.parametrize("tool,kw", [
    ("mip", {}),
    ("isp", {}),
    ("mrl", {}),
    ("lfnst", {}),
    ("mts", {}),
])
def test_l12_intra_tool(tool, kw, tmp_path):
    """Each BASELINE-named intra tool in isolation, 10-bit, vs oracle."""
    from forge import forge_tools_stream
    p = _tools_policy(tool)(3)
    _check_stream(forge_tools_stream(seed=3, width=96, height=96, qp=30,
                                     bit_depth=10, nframes=1, policy=p, **kw),
                  tmp_path, 1)


@pytest.mark.parametrize("kw", [
    dict(seed=0, bit_depth=10),
    dict(seed=1, bit_depth=10, dual_tree=True),
    dict(seed=2, bit_depth=8),
    dict(seed=3, bit_depth=12),
])
def test_l12_tools_matrix(kw, tmp_path):
    """Combined ISP+MIP+MRL+LFNST+MTS stream (CodingToolsSets analogue)."""
    from forge import forge_tools_stream
    _check_stream(forge_tools_stream(width=128, height=128, qp=30, nframes=2,
                                     **kw), tmp_path, 2)


@pytest.mark.parametrize("kw", [
    dict(seed=4, bit_depth=10, scaling=True),
    dict(seed=5, bit_depth=10, scaling=True, dual_tree=True),
])
def test_l13_scaling_lists(kw, tmp_path):
    """Explicit scaling lists via APS (reference SCALING_A_1 analogue)."""
    from forge import forge_tools_stream
    _check_stream(forge_tools_stream(width=128, height=128, qp=30, nframes=2,
                                     **kw), tmp_path, 2)


# --- conformance cropping window (reference CROP_B_4 analogue) --------------

CONF_WIN = dict(sps_conformance_window_flag=1, sps_conf_win_left_offset=2,
                sps_conf_win_right_offset=1, sps_conf_win_top_offset=1,
                sps_conf_win_bottom_offset=3)


@pytest.mark.parametrize("chroma", [3, 0])
def test_l14_conf_window(chroma, tmp_path):
    """Output cropping, 4:4:4 / mono (SubWidthC=1: the reference's unscaled
    crop coincides with the spec there, so byte-compare vs oracle)."""
    from forge import forge_inter_stream
    _check_stream(forge_inter_stream(slice_type=2, nframes=2, width=64,
                                     height=64, seed=1, deblock=True,
                                     chroma=chroma, **CONF_WIN),
                  tmp_path, 2)


def test_l14_conf_window_ref_bug(tmp_path):
    """4:2:0 conformance window: spec 7.4.3.4 scales the offsets by
    SubWidthC/SubHeightC; the reference applies them UNSCALED
    (vvc_refs.c:188-191, vvcdec.c:675-676) and crops too little.  We follow
    the spec; pin both windows against the same full-plane decode so a
    fixed reference flips this test."""
    import subprocess
    import numpy as np
    from forge import forge_inter_stream
    from conftest import ORACLE
    stream = forge_inter_stream(slice_type=2, nframes=1, width=64, height=64,
                                seed=0, deblock=True, **CONF_WIN)
    frames = VVCDecoder().decode(stream)
    full = frames[0].buffer.planes[0]
    ours = np.frombuffer(frames[0].to_yuv_bytes(), np.uint8)
    assert ours.size == 58 * 56 + 2 * 29 * 28       # spec: 58x56
    assert np.array_equal(ours[:58 * 56].reshape(56, 58),
                          full[2:-6, 4:-2].astype(np.uint8))
    if have_oracle():
        bit = tmp_path / "t.bit"
        bit.write_bytes(stream)
        r = subprocess.run(
            [ORACLE, "-hide_banner", "-loglevel", "error", "-threads", "1",
             "-flags", "unaligned", "-f", "vvc", "-i", str(bit),
             "-f", "rawvideo", "-y", str(tmp_path / "t.yuv")],
            capture_output=True, timeout=120)
        assert r.returncode == 0
        ref = np.frombuffer((tmp_path / "t.yuv").read_bytes(), np.uint8)
        assert ref.size == 61 * 60 + 2 * 31 * 30, \
            "reference now scales the crop — compare outputs instead"
        assert np.array_equal(ref[:61 * 60].reshape(60, 61),
                              full[1:-3, 2:-1].astype(np.uint8))


# --- horizontal wraparound MC (reference WRAP_A_4 analogue) -----------------

@pytest.mark.parametrize("seed,slice_type,tools", [
    (0, 1, {}),                                           # P
    (1, 0, {}),                                           # B (DMVR/BDOF-able)
    (2, 0, dict(sps_affine_enabled_flag=1,                # affine + PROF
                sps_five_minus_max_num_subblock_merge_cand=0,
                sps_6param_affine_enabled_flag=1,
                sps_affine_prof_enabled_flag=1)),
])
def test_l15_wraparound_ref_bug(seed, slice_type, tools, tmp_path):
    """Horizontal wraparound MC (spec 8.5.6.3.2 ClipH): implemented in every
    fetch path (regular/affine/GPM MC, DMVR bilinear, BDOF/PROF rings).  The
    reference derives PpsRefWraparoundOffset (vvc_ps.c:428-433) but never
    applies it — its MC clamps.  Pin three facts: (a) golden == native with
    wrap on; (b) with the wrap derive neutered we match the oracle exactly
    (so the only divergence IS the wrap); (c) wrap on differs from the
    oracle — a fixed reference flips (c)."""
    from forge import forge_inter_stream
    import ffvvc_jax.ps as ps
    from ffvvc_jax.config import DecoderConfig
    stream = forge_inter_stream(
        seed=seed, slice_type=slice_type, nframes=3, width=64, height=64,
        deblock=True, sps_ref_wraparound_enabled_flag=1,
        pps_kw=dict(pps_ref_wraparound_enabled_flag=1,
                    pps_pic_width_minus_wraparound_offset=0), **tools)
    nat = b"".join(f.to_yuv_bytes()
                   for f in VVCDecoder().decode(stream))
    gold = b"".join(f.to_yuv_bytes() for f in VVCDecoder(DecoderConfig(
        backend="golden", native_cabac=False,
        native_parse=False)).decode(stream))
    assert nat == gold
    ref = oracle_decode(stream, tmp_path)
    orig = ps.PPS.__post_init__

    def patched(self):
        orig(self)
        self.ref_wraparound_offset = 0
    ps.PPS.__post_init__ = patched
    try:
        unwrapped = b"".join(f.to_yuv_bytes()
                             for f in VVCDecoder().decode(stream))
    finally:
        ps.PPS.__post_init__ = orig
    assert unwrapped == ref, "oracle no longer matches clamped MC"
    assert nat != ref, \
        "reference now applies wraparound — compare outputs instead"


# --- WPP without signalled entry-point offsets ------------------------------

@pytest.mark.parametrize("kw", [
    dict(seed=1, slice_type=2, nframes=2, width=96, height=96),
    dict(seed=3, slice_type=1, nframes=3, width=96, height=96),
])
def test_l16_wpp_no_offsets_ref_bug(kw, tmp_path):
    """sps_entry_point_offsets_present_flag == 0 with WPP: the subsets
    (end_of_subset_one_bit + byte_alignment at each row end) and the row
    context synchronization exist regardless of offset signalling (spec
    7.3.10.1, 9.3.1); only the offsets are unsignalled.  The reference
    only handles same-entry-point reinit for TILES (ff_vvc_cabac_init,
    vvc_cabac.c:842-857) and silently mis-decodes such streams.  Pin:
    our native and golden decodes agree; the oracle accepts the stream
    but differs — a fixed reference flips the last assert."""
    import subprocess
    from forge import forge_inter_stream
    from ffvvc_jax.config import DecoderConfig
    stream = forge_inter_stream(deblock=True,
                                sps_entropy_coding_sync_enabled_flag=1, **kw)
    nat = b"".join(f.to_yuv_bytes() for f in VVCDecoder().decode(stream))
    gold = b"".join(f.to_yuv_bytes() for f in VVCDecoder(DecoderConfig(
        backend="golden", native_cabac=False,
        native_parse=False)).decode(stream))
    assert nat == gold
    if have_oracle():
        from conftest import ORACLE
        bit = tmp_path / "t.bit"
        bit.write_bytes(stream)
        r = subprocess.run(
            [ORACLE, "-hide_banner", "-loglevel", "error", "-threads", "1",
             "-flags", "unaligned", "-f", "vvc", "-i", str(bit),
             "-f", "rawvideo", "-y", str(tmp_path / "t.yuv")],
            capture_output=True, timeout=120)
        assert r.returncode == 0
        ref = (tmp_path / "t.yuv").read_bytes()
        assert ref != nat, \
            "reference now syncs WPP rows without offsets — compare equal"


# --- more oracle-differential combinations ----------------------------------

@pytest.mark.parametrize("name,kw", [
    ("lmcs_intra_tools_dualtree",
     dict(seed=3, slice_type=2, nframes=2, width=96, height=96,
          bit_depth=10, sps_lmcs_enabled_flag=1, sps_mip_enabled_flag=1,
          sps_isp_enabled_flag=1, sps_lfnst_enabled_flag=1,
          sps_qtbtt_dual_tree_intra_flag=1)),
    ("wp_affine_10bit",
     dict(seed=6, slice_type=0, nframes=3, width=96, height=64,
          bit_depth=10, pps_kw=dict(pps_weighted_bipred_flag=1),
          sps_affine_enabled_flag=1,
          sps_five_minus_max_num_subblock_merge_cand=0,
          sps_6param_affine_enabled_flag=1)),
])
def test_l17_combinations(name, kw, tmp_path):
    from forge import forge_inter_stream
    n = kw["nframes"]
    _check_stream(forge_inter_stream(deblock=True, **kw), tmp_path, n)


def test_l17_tiles_inter_filters(tmp_path):
    from forge import forge_tiled_stream
    _check_stream(forge_tiled_stream(seed=4, nframes=3, width=128, height=96,
                                     slice_type=1, rows=(2,), cols=(2,),
                                     sps_sao_enabled_flag=1,
                                     sps_alf_enabled_flag=1), tmp_path, 3)


# --- large CTU sizes (sps_log2_ctu_size_minus5 = 1, 2) ----------------------

@pytest.mark.parametrize("ctu_log2", [6, 7])
def test_l18_large_ctu_tools(ctu_log2, tmp_path):
    """CTU-64 / CTU-128 all-intra with the full intra toolset and 64-pt
    transforms (sps_max_luma_transform_size_64_flag=1: 64-point DCT-2
    zero-out, deep QT/MTT trees)."""
    from forge import forge_tools_stream
    _check_stream(forge_tools_stream(seed=3, width=256, height=192, qp=30,
                                     bit_depth=10, nframes=1,
                                     ctu_log2=ctu_log2), tmp_path, 1)


@pytest.mark.parametrize("ctu_log2", [6, 7])
def test_l18_large_ctu_alf(ctu_log2, tmp_path):
    """ALF/CC-ALF virtual boundaries at 64/128 CTBs (the VB sits 4 rows
    above the CTB bottom — CTB-size-dependent geometry)."""
    from forge import forge_tools_stream
    _check_stream(forge_tools_stream(seed=4, width=256, height=192, qp=30,
                                     bit_depth=10, nframes=1,
                                     ctu_log2=ctu_log2,
                                     sps_sao_enabled_flag=1,
                                     sps_alf_enabled_flag=1,
                                     sps_ccalf_enabled_flag=1),
                  tmp_path, 1)


@pytest.mark.parametrize("ctu_log2", [6, 7])
def test_l18_large_ctu_ra(ctu_log2, tmp_path):
    """Random-access hierarchical GOP at CTU-64/128: inter TB splits of
    128-wide CUs, DMVR/BDOF, SAO+ALF, 64-pt transforms."""
    from forge import forge_hier_stream
    _check_stream(forge_hier_stream(
        seed=2, width=192, height=128, qp=32, bit_depth=10, ngops=2,
        deblock=True, ctu_log2=ctu_log2,
        sps_max_luma_transform_size_64_flag=1,
        sps_temporal_mvp_enabled_flag=1, sps_bdof_enabled_flag=1,
        sps_dmvr_enabled_flag=1, sps_alf_enabled_flag=1,
        sps_sao_enabled_flag=1), tmp_path, 5)


def test_l18_mip_multi_tb_ref_bug(tmp_path):
    """MIP CU wider than MaxTbSize (64x64 MIP, maxTB=32 -> four 32x32
    TBs).  The spec predicts every TB with the CU's signalled MIP
    mode/transpose (IntraPredModeY covers the whole CB).  The reference
    stores imm/imtf only in the FIRST min-CB column of each CU row
    (vvc_ctu.c:976-978 - single assignment, not memset) but samples them
    at each TB's origin (vvc_intra_template.c:630-631), so right-column
    TBs read stale (zero) cells and mis-predict.  Pin: our native and
    golden decodes agree; the oracle accepts the stream but differs — a
    fixed reference flips the last assert."""
    import subprocess
    import forge as F
    from ffvvc_jax.config import DecoderConfig

    class MipPolicy(F.FuzzPolicy):
        """Row-0 CTU: planar + random residual (noisy boundary).  Row-1
        CTU: one 64x64 MIP CU (mode 2, transposed), zero residual."""
        def __call__(self, tag, **ctx):
            y0 = ctx.get("y0", 0)
            if tag == "mip_flag":
                return int(y0 >= 64)
            if tag == "mip_transposed":
                return 1
            if tag == "mip_mode":
                return 2
            if tag in ("intra_luma_mode", "intra_chroma_mode"):
                return 0
            if tag in ("tu_y_coded", "tu_cb_coded", "tu_cr_coded"):
                return super().__call__(tag, **ctx) if y0 < 64 else 0
            return 0

    sps_r = F.build_sps(64, 128, bit_depth=10, ctu_log2=6, min_qt_log2=6,
                        max_mtt_depth=0, sps_mip_enabled_flag=1)
    pps_r = F.build_pps(sps_r)
    stream = F.write_nal(F.NalType.SPS, F.write_sps(sps_r))
    stream += F.write_nal(F.NalType.PPS, F.write_pps(pps_r, sps_r))
    nal, _ = F.forge_frame(sps_r, pps_r, MipPolicy(5), qp=30, poc=0,
                           idr=True)
    stream += nal
    nat = b"".join(f.to_yuv_bytes() for f in VVCDecoder().decode(stream))
    gold = b"".join(f.to_yuv_bytes() for f in VVCDecoder(DecoderConfig(
        backend="golden", native_cabac=False,
        native_parse=False)).decode(stream))
    assert nat == gold
    if have_oracle():
        from conftest import ORACLE
        bit = tmp_path / "t.bit"
        bit.write_bytes(stream)
        r = subprocess.run(
            [ORACLE, "-hide_banner", "-loglevel", "error", "-threads", "1",
             "-flags", "unaligned", "-f", "vvc", "-i", str(bit),
             "-f", "rawvideo", "-y", str(tmp_path / "t.yuv")],
            capture_output=True, timeout=120)
        assert r.returncode == 0
        ref = (tmp_path / "t.yuv").read_bytes()
        assert ref != nat, \
            "reference now predicts multi-TB MIP per spec — compare equal"


def test_l19_picture_hash_sei(tmp_path):
    """Decoded-picture-hash suffix SEI (type 132, MD5): with
    config.verify_picture_hash the decoder checks every decoded picture
    against the stream-carried hash and raises on mismatch.  (The
    reference parses but never verifies it - h266_metadata.c.)"""
    from forge import forge_tools_stream, insert_picture_hashes
    from ffvvc_jax.config import DecoderConfig
    stream = forge_tools_stream(seed=9, width=96, height=96, qp=30,
                                bit_depth=10, nframes=2)
    yuvs = [f.to_yuv_bytes() for f in VVCDecoder().decode(stream)]
    ref = oracle_decode(stream, tmp_path)
    assert b"".join(yuvs) == ref
    hashed = insert_picture_hashes(stream, yuvs, 10)
    # oracle still decodes the SEI-carrying stream identically
    assert oracle_decode(hashed, tmp_path) == ref
    cfg = DecoderConfig(verify_picture_hash=True)
    out = b"".join(f.to_yuv_bytes()
                   for f in VVCDecoder(cfg).decode(hashed))
    assert out == ref
    # corrupt one hash byte -> the decoder flags the mismatch
    bad = bytearray(hashed)
    idx = hashed.rindex(b"\x84\x32")       # payload type 132, size 50
    bad[idx + 4] ^= 0xFF
    with pytest.raises(ValueError, match="picture hash mismatch"):
        VVCDecoder(cfg).decode(bytes(bad))


@pytest.mark.parametrize("name,kw", [
    ("12bit", dict(bit_depth=12)),
    ("mono", dict(chroma=0)),
    ("444_alf", dict(chroma=3, sps_alf_enabled_flag=1,
                     sps_ccalf_enabled_flag=1, sps_sao_enabled_flag=1)),
])
def test_l20_hier_formats(name, kw, tmp_path):
    """Hierarchical RA GOPs across sample formats: 12-bit, monochrome and
    4:4:4 with the filter chain — the inter+DMVR/BDOF+reorder machinery
    at non-default formats."""
    from forge import forge_hier_stream
    _check_stream(forge_hier_stream(seed=2, width=96, height=96, qp=33,
                                    ngops=2, deblock=True,
                                    sps_temporal_mvp_enabled_flag=1,
                                    sps_bdof_enabled_flag=1,
                                    sps_dmvr_enabled_flag=1, **kw),
                  tmp_path, 5)


def test_l20_streaming_matches_whole(tmp_path):
    """AU-by-AU streaming decode (flush=False) must emit the same frames
    as the whole-stream call — DPB bumping order, the row-progress
    pipeline and the per-call pixel joins all interact here."""
    from forge import forge_hier_stream
    from ffvvc_jax.bitstream.au import split_access_unit_bytes
    from ffvvc_jax.config import DecoderConfig
    s = forge_hier_stream(seed=4, width=96, height=64, qp=32, ngops=3,
                          deblock=True, sps_sao_enabled_flag=1,
                          sps_temporal_mvp_enabled_flag=1)
    whole = [f.to_yuv_bytes() for f in VVCDecoder().decode(s)]
    dec = VVCDecoder(DecoderConfig())
    out = []
    for au in split_access_unit_bytes(s):
        out.extend(f.to_yuv_bytes() for f in dec.decode(au, flush=False))
    out.extend(f.to_yuv_bytes() for f in dec.flush())
    assert out == whole
