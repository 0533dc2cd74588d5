"""GOP-parallel decode must be byte-identical to sequential decode."""
import sys
import os

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

from ffvvc_jax.decoder import VVCDecoder
from ffvvc_jax.pipeline import decode_parallel, segment_stream


def _intra_stream(nframes):
    from forge import forge_stream
    return forge_stream(level=1, seed=3, width=96, height=64, qp=30,
                        nframes=nframes)


def test_segmenting_all_intra():
    stream = _intra_stream(4)
    segs = segment_stream(stream)
    assert len(segs) == 4
    # every byte of the stream lands in exactly one segment, in order
    assert b"".join(s for _p, s in segs) == stream


def test_parallel_matches_sequential():
    stream = _intra_stream(4)
    seq = [f.to_yuv_bytes() for f in VVCDecoder().decode(stream)]
    par = decode_parallel(stream, workers=2)
    assert len(par) == 4
    assert par == seq


def test_pipeline_depth_matches():
    """Depth-N frame pipeline (parse running ahead of queued pixel
    stages) must be byte-identical to the unpipelined decode, for both
    all-intra (runs ahead) and inter (drains at every MC barrier)."""
    from forge import forge_hier_stream
    from ffvvc_jax.config import DecoderConfig
    for stream in (_intra_stream(6),
                   forge_hier_stream(seed=1, width=96, height=64, qp=30,
                                     deblock=True)):
        ref = [f.to_yuv_bytes() for f in VVCDecoder(
            DecoderConfig(pipeline_frames=False)).decode(stream)]
        for depth in (1, 4):
            got = [f.to_yuv_bytes() for f in VVCDecoder(
                DecoderConfig(pipeline_depth=depth)).decode(stream)]
            assert got == ref, depth


def test_single_segment_fallback():
    from forge import forge_inter_stream
    stream = forge_inter_stream(seed=0, nframes=3, slice_type=1,
                                n_refs=(1, 0), deblock=True)
    assert len(segment_stream(stream)) == 1   # one IDR + trailing P frames
    seq = [f.to_yuv_bytes() for f in VVCDecoder().decode(stream)]
    par = decode_parallel(stream, workers=2)
    assert par == seq


def test_row_progress_overlap():
    """Row-granular cross-frame progress: frames publish filter-final rows
    incrementally, the consumer's MC performs per-row waits, and output
    stays byte-identical to the row-disabled decode."""
    import sys as _s, os as _o
    _s.path.insert(0, _o.path.join(_o.path.dirname(__file__), "..", "tools"))
    from forge import forge_hier_stream
    from ffvvc_jax.decoder import VVCDecoder, DecodedFrame
    from ffvvc_jax.config import DecoderConfig

    s = forge_hier_stream(seed=1, width=192, height=160, qp=32,
                          bit_depth=10, ngops=2, deblock=True,
                          sps_sao_enabled_flag=1, sps_alf_enabled_flag=1,
                          sps_temporal_mvp_enabled_flag=1)
    log = {"publishes": [], "waits": 0, "rows_runs": 0}
    orig_pub = DecodedFrame.publish_rows
    orig_wait = DecodedFrame.wait_rows
    orig_rows = VVCDecoder._pixel_stages_rows

    def spy_pub(self, y):
        log["publishes"].append(y)
        return orig_pub(self, y)

    def spy_wait(self, y):
        log["waits"] += 1
        return orig_wait(self, y)

    def spy_rows(self, *a, **k):
        r = orig_rows(self, *a, **k)
        log["rows_runs"] += int(bool(r))
        return r

    DecodedFrame.publish_rows = spy_pub
    DecodedFrame.wait_rows = spy_wait
    VVCDecoder._pixel_stages_rows = spy_rows
    try:
        a = b"".join(f.to_yuv_bytes()
                     for f in VVCDecoder(DecoderConfig()).decode(s))
    finally:
        DecodedFrame.publish_rows = orig_pub
        DecodedFrame.wait_rows = orig_wait
        VVCDecoder._pixel_stages_rows = orig_rows
    b = b"".join(f.to_yuv_bytes() for f in VVCDecoder(
        DecoderConfig(row_progress=False)).decode(s))
    assert a == b, "row-pipelined decode differs"
    assert log["rows_runs"] >= 3, log       # inter frames rolled by rows
    assert log["waits"] >= 1, log           # MC used per-row waits
    # incremental publishing: some frame published a partial row count
    # (not just the end-of-frame totals)
    h = 160
    assert any(0 < y < h for y in log["publishes"]), log["publishes"][:20]


def test_mc_row_needs_gpm():
    """Round-5 margin pin (decoder._mc_row_needs): on GPM-capable frames
    a stored MV's reach must be taken from its CTU ROW bottom — a GPM
    block blends BOTH parts' whole-block predictions while the 4x4 grid
    stores each part's MV only in its own region, so the 4x4's own
    bottom underestimates the read reach by up to (block_h - 4) rows."""
    import types
    import numpy as np
    H = W = 128
    ctb = 64
    h4 = H // 4
    tabs = types.SimpleNamespace(
        mvf_pf=np.zeros((h4, h4), np.uint8),
        mvf_mv=np.zeros((2, h4, h4, 2), np.int32))
    # one stored MV at the TOP 4x4 of CTU row 0 pointing 40 rows down —
    # the GPM-storage shape of a part whose prediction reaches the
    # block bottom
    tabs.mvf_pf[0, 0] = 1
    tabs.mvf_mv[0, 0, 0, 1] = 40 << 4
    for gpm, want0 in ((1, min(H, ctb + 40 + 12)),
                       (0, 4 + 40 + 12)):
        sps = types.SimpleNamespace(
            ctb_size_y=ctb,
            r=types.SimpleNamespace(sps_gpm_enabled_flag=gpm))
        pps = types.SimpleNamespace(height=H, ctb_height=H // ctb)
        needs = VVCDecoder._mc_row_needs(None, tabs, sps, pps)
        assert needs[0] == want0, (gpm, needs[0], want0)


@pytest.mark.parametrize("seed,kw", [
    # MVs up to ~100 luma rows in either direction with DMVR+BDOF active
    (0, dict(sps_dmvr_enabled_flag=1, sps_bdof_enabled_flag=1,
             sps_temporal_mvp_enabled_flag=1)),
    # + GPM (opposing part MVs) and affine/PROF subblock grids
    (1, dict(sps_dmvr_enabled_flag=1, sps_bdof_enabled_flag=1,
             sps_gpm_enabled_flag=1,
             sps_max_num_merge_cand_minus_max_num_gpm_cand=0,
             sps_temporal_mvp_enabled_flag=1)),
    (2, dict(sps_affine_enabled_flag=1,
             sps_five_minus_max_num_subblock_merge_cand=0,
             sps_6param_affine_enabled_flag=1,
             sps_affine_prof_enabled_flag=1, sps_gpm_enabled_flag=1,
             sps_max_num_merge_cand_minus_max_num_gpm_cand=0,
             sps_temporal_mvp_enabled_flag=1)),
    # 10-bit 4:2:0 chroma-reach case
    (3, dict(bit_depth=10, sps_dmvr_enabled_flag=1,
             sps_bdof_enabled_flag=1,
             sps_temporal_mvp_enabled_flag=1)),
])
def test_row_margin_adversarial(seed, kw):
    """Forged hier-GOP streams with near-maximum downward MVs
    (policy mvd_max=1600 ~ +-100 luma rows at 1/16 pel) + DMVR/BDOF/GPM:
    the rolling row pipeline must stay byte-identical to the
    row-disabled decode (VERDICT r4 item 4)."""
    from forge import forge_hier_stream
    from ffvvc_jax.config import DecoderConfig
    s = forge_hier_stream(seed=seed, width=192, height=192, qp=32,
                          ngops=3, deblock=True,
                          policy_kw=dict(mvd_max=1600), **kw)
    rowed = b"".join(f.to_yuv_bytes() for f in VVCDecoder(
        DecoderConfig()).decode(s))
    plain = b"".join(f.to_yuv_bytes() for f in VVCDecoder(
        DecoderConfig(row_progress=False, pipeline_frames=False)).decode(s))
    assert rowed == plain


def test_row_progress_with_device_mc():
    """Round-5 (VERDICT r4 item 8): row_progress and device_mc compose —
    the consumer's MC does per-row waits and each row-band runs as a
    batched device MC call; output byte-exact vs the plain decode."""
    from forge import forge_hier_stream
    from ffvvc_jax.decoder import VVCDecoder, DecodedFrame
    from ffvvc_jax.config import DecoderConfig
    from ffvvc_jax.ops import mc_device

    s = forge_hier_stream(seed=1, width=192, height=160, qp=32,
                          bit_depth=10, ngops=2, deblock=True,
                          sps_sao_enabled_flag=1, sps_alf_enabled_flag=1,
                          sps_temporal_mvp_enabled_flag=1,
                          sps_dmvr_enabled_flag=1, sps_bdof_enabled_flag=1)
    log = {"waits": 0, "mc_calls": 0}
    orig_wait = DecodedFrame.wait_rows
    orig_mc = mc_device.frame_device_mc

    def spy_wait(self, y):
        log["waits"] += 1
        return orig_wait(self, y)

    def spy_mc(jobs, sps, bd, mesh=None):
        log["mc_calls"] += 1
        return orig_mc(jobs, sps, bd, mesh=mesh)

    DecodedFrame.wait_rows = spy_wait
    mc_device.frame_device_mc = spy_mc
    try:
        a = b"".join(f.to_yuv_bytes() for f in VVCDecoder(
            DecoderConfig(device_mc=True)).decode(s))
    finally:
        DecodedFrame.wait_rows = orig_wait
        mc_device.frame_device_mc = orig_mc
    b = b"".join(f.to_yuv_bytes() for f in VVCDecoder(
        DecoderConfig(row_progress=False, pipeline_frames=False)).decode(s))
    assert a == b, "row+device_mc decode differs"
    # per-row device MC engaged: more MC calls than frames, waits observed
    assert log["mc_calls"] >= 4, log
    assert log["waits"] >= 1, log


def test_parallel_after_sequential_multi_ep():
    """Round-5 regression: sequential decode of a multi-entry-point
    stream populates the shared stage-thread pool; GOP workers forked
    AFTERWARDS must not inherit it (the executor's bookkeeping lists
    parent threads that don't exist post-fork -> submits queue forever).
    threads.executor is pid-keyed for this."""
    from forge import forge_scaling_stream
    s = forge_scaling_stream(seed=0, width=256, height=128, qp=34,
                             nframes=3)
    seq = b"".join(f.to_yuv_bytes() for f in VVCDecoder().decode(s))
    par = decode_parallel(s, workers=2)
    assert b"".join(par) == seq


def test_scaling_stream_conformance(tmp_path):
    """The BASELINE scaling config (multi-IDR, 2 subpictures over a 2x2
    tile grid, one rect slice per subpic) decodes bit-exactly vs the
    oracle and splits into one segment per IDR (BASELINE.md:26)."""
    import subprocess, os as _os
    from forge import forge_scaling_stream
    from ffvvc_jax.bitstream import split_annexb, BitReader
    from ffvvc_jax.bitstream.h266 import read_sps, read_pps, H266ParamSets
    from ffvvc_jax.bitstream.nal import NalType
    s = forge_scaling_stream(seed=1, width=256, height=128, qp=34,
                             nframes=3)
    # tiles + subpics genuinely active in the bitstream
    ps = H266ParamSets()
    for nal in split_annexb(s):
        if nal.nal_unit_type == NalType.SPS:
            sps = read_sps(BitReader(nal.rbsp))
            ps.store_sps(sps)
        elif nal.nal_unit_type == NalType.PPS:
            pps = read_pps(BitReader(nal.rbsp), ps)
    assert sps.sps_num_subpics_minus1 == 1
    assert pps.num_tiles_in_pic == 4
    assert len(segment_stream(s)) == 3
    ref = None
    oracle = _os.path.join(_os.path.dirname(__file__), "..", ".refbuild",
                           "ffmpeg")
    if _os.path.exists(oracle):
        bit = str(tmp_path / "sc.bit")
        yuv = str(tmp_path / "sc.yuv")
        open(bit, "wb").write(s)
        subprocess.run([oracle, "-hide_banner", "-loglevel", "error",
                        "-threads", "1", "-f", "vvc", "-i", bit,
                        "-f", "rawvideo", "-y", yuv], check=True)
        ref = open(yuv, "rb").read()
    mine = b"".join(f.to_yuv_bytes() for f in VVCDecoder().decode(s))
    if ref is not None:
        assert mine == ref
