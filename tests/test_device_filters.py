"""Device (XLA) filter passes must match the host golden bit-exactly.

Runs on the CPU backend mesh-free; the same code path runs on a real chip.
"""
import os
import sys
import types

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

from ffvvc_jax.sao import SaoFilter


def _fake_ctx(seed, W=96, H=64, ctb_log2=5, bit_depth=8, ntiles=1):
    rng = np.random.default_rng(seed)
    sps = types.SimpleNamespace(
        hshift=[0, 1, 1], vshift=[0, 1, 1], bit_depth=bit_depth,
        chroma_format_idc=1, ctb_size_y=1 << ctb_log2,
        ctb_log2_size_y=ctb_log2)
    cw, ch = -(-W // (1 << ctb_log2)), -(-H // (1 << ctb_log2))
    pps_r = types.SimpleNamespace(
        pps_loop_filter_across_slices_enabled_flag=int(seed % 2 == 0),
        pps_loop_filter_across_tiles_enabled_flag=int(seed % 3 == 0),
        num_tiles_in_pic=ntiles)
    pps = types.SimpleNamespace(
        r=pps_r, width=W, height=H, ctb_width=cw, ctb_height=ch,
        ctb_to_col_bd=list(range(cw + 1)) if ntiles > 1 else [0] * (cw + 1),
        ctb_to_row_bd=[0] * (ch + 1))
    nctb = cw * ch
    tabs = types.SimpleNamespace(
        sao_type=rng.integers(0, 3, (nctb, 3)).astype(np.int32),
        sao_band_pos=rng.integers(0, 32, (nctb, 3)).astype(np.int32),
        sao_eo_class=rng.integers(0, 4, (nctb, 3)).astype(np.int32),
        sao_offset=rng.integers(-31, 32, (nctb, 3, 5)).astype(np.int32),
        slice_idx=rng.integers(0, 2, (ch, cw)).astype(np.int32))
    tabs.sao_offset[:, :, 0] = 0
    planes = [rng.integers(0, (1 << bit_depth), (H, W)).astype(np.int32),
              rng.integers(0, (1 << bit_depth),
                           (H // 2, W // 2)).astype(np.int32),
              rng.integers(0, (1 << bit_depth),
                           (H // 2, W // 2)).astype(np.int32)]
    fb = types.SimpleNamespace(planes=planes)
    return sps, pps, tabs, fb


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_sao_device_matches_host(seed):
    from ffvvc_jax.ops.sao_device import sao_frame_device
    sps, pps, tabs, fb = _fake_ctx(seed, ntiles=1 + (seed % 2))
    ref_fb = types.SimpleNamespace(planes=[p.copy() for p in fb.planes])
    SaoFilter(sps, pps, tabs, ref_fb).sao_frame()
    sao_frame_device(sps, pps, tabs, fb)
    for c in range(3):
        assert np.array_equal(fb.planes[c], ref_fb.planes[c]), f"plane {c}"


@pytest.mark.parametrize("seed", [7])
def test_sao_device_10bit(seed):
    from ffvvc_jax.ops.sao_device import sao_frame_device
    sps, pps, tabs, fb = _fake_ctx(seed, bit_depth=10)
    ref_fb = types.SimpleNamespace(planes=[p.copy() for p in fb.planes])
    SaoFilter(sps, pps, tabs, ref_fb).sao_frame()
    sao_frame_device(sps, pps, tabs, fb)
    for c in range(3):
        assert np.array_equal(fb.planes[c], ref_fb.planes[c])


def test_device_sao_full_decode(oracle_path, tmp_path):
    """End-to-end decode with device SAO enabled must match the oracle."""
    import subprocess
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
    from forge import forge_stream
    from ffvvc_jax.decoder import VVCDecoder
    from ffvvc_jax.config import DecoderConfig

    stream = forge_stream(level=1, seed=3, width=128, height=96, qp=30,
                          nframes=2)
    bit = tmp_path / "s.bit"
    yuv = tmp_path / "s.yuv"
    bit.write_bytes(stream)
    subprocess.run([oracle_path, "-hide_banner", "-loglevel", "error",
                    "-threads", "1", "-f", "vvc", "-i", str(bit),
                    "-f", "rawvideo", "-y", str(yuv)], check=True)
    frames = VVCDecoder(DecoderConfig(device_sao=True)).decode(stream)
    ours = b"".join(f.to_yuv_bytes() for f in frames)
    assert ours == yuv.read_bytes()


def test_sao_sharded_matches_single_device():
    """Row-slab-sharded SAO with ppermute halo exchange == single-device
    whole-frame SAO (the P2/P6 spatial-shard story on a real filter)."""
    import jax
    import numpy as np
    from jax.sharding import Mesh
    from ffvvc_jax.parallel.mesh import build_sharded_sao
    from ffvvc_jax.ops.sao_device import _sao_xla, _rasterize_plane, SaoFilter

    sps, pps, tabs, fb = _fake_ctx(2, W=96, H=64)
    plane = fb.planes[0]
    maps = _rasterize_plane(SaoFilter(sps, pps, tabs, fb), 0, plane)
    assert maps is not None
    typ, m1, offs, keep = maps
    src_pad = np.pad(plane, 1, mode="edge").astype(np.int32)
    shift, pix_max = sps.bit_depth - 5, (1 << sps.bit_depth) - 1
    ref = np.asarray(_sao_xla(src_pad, typ, m1, offs, keep, shift, pix_max))

    devs = np.array(jax.devices()[:4]).reshape(1, 4)
    mesh = Mesh(devs, ("gop", "tile"))
    fn = build_sharded_sao(mesh, plane.shape[0], plane.shape[1], shift,
                           pix_max)
    got = np.asarray(fn(plane.astype(np.int32), typ, m1, offs, keep))
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("seed,tools", [
    (2, dict(sps_alf_enabled_flag=1)),
    (3, dict(sps_alf_enabled_flag=1, sps_ccalf_enabled_flag=1)),
    (3, dict(sps_sao_enabled_flag=1, sps_alf_enabled_flag=1,
             sps_ccalf_enabled_flag=1, sps_lmcs_enabled_flag=1)),
])
def test_alf_device_matches_host(seed, tools):
    """Device ALF/CC-ALF pass == host golden on real forged inter streams
    (the forged CTB flag/APS matrix exercises fixed + APS filters, alt
    chroma filters and CC-ALF idc)."""
    from forge import forge_inter_stream
    from ffvvc_jax.decoder import VVCDecoder
    from ffvvc_jax.config import DecoderConfig

    stream = forge_inter_stream(seed=seed, nframes=3, deblock=True, **tools)
    ref = b"".join(f.to_yuv_bytes() for f in VVCDecoder().decode(stream))
    frames = VVCDecoder(DecoderConfig(device_alf=True)).decode(stream)
    dev = b"".join(f.to_yuv_bytes() for f in frames)
    assert dev == ref


def test_device_alf_full_decode(oracle_path, tmp_path):
    """End-to-end decode with device ALF enabled must match the oracle."""
    import subprocess
    from forge import forge_inter_stream
    from ffvvc_jax.decoder import VVCDecoder
    from ffvvc_jax.config import DecoderConfig

    stream = forge_inter_stream(seed=3, nframes=3, deblock=True,
                                sps_sao_enabled_flag=1,
                                sps_alf_enabled_flag=1,
                                sps_ccalf_enabled_flag=1)
    bit = tmp_path / "a.bit"
    yuv = tmp_path / "a.yuv"
    bit.write_bytes(stream)
    subprocess.run([oracle_path, "-hide_banner", "-loglevel", "error",
                    "-threads", "1", "-f", "vvc", "-i", str(bit),
                    "-f", "rawvideo", "-y", str(yuv)], check=True)
    frames = VVCDecoder(DecoderConfig(device_alf=True,
                                      device_sao=True)).decode(stream)
    ours = b"".join(f.to_yuv_bytes() for f in frames)
    assert ours == yuv.read_bytes()


# --- device deblock (ops/deblock_device.py) ---------------------------------

@pytest.mark.parametrize("kw", [
    dict(slice_type=2, nframes=2, width=96, height=96, seed=3,
         sps_sao_enabled_flag=1, sps_lmcs_enabled_flag=1),
    dict(slice_type=0, nframes=3, width=96, height=64, seed=1),   # B, DMVR-able
    dict(slice_type=1, nframes=3, width=64, height=80, seed=2),   # P, odd h
    dict(slice_type=2, nframes=2, width=64, height=64, seed=4, bit_depth=10),
    dict(slice_type=0, nframes=3, width=128, height=128, seed=5, qp=38),
])
def test_device_deblock_matches_host(kw):
    """Whole-stream decode with the device deblock pass must equal the
    host decode byte-for-byte (host path is oracle-pinned elsewhere)."""
    import sys as _s, os as _o
    _s.path.insert(0, _o.path.join(_o.path.dirname(__file__), "..", "tools"))
    from forge import forge_inter_stream
    from ffvvc_jax.decoder import VVCDecoder
    from ffvvc_jax.config import DecoderConfig
    s = forge_inter_stream(deblock=True, **kw)
    host = b"".join(f.to_yuv_bytes() for f in VVCDecoder().decode(s))
    dev = b"".join(f.to_yuv_bytes() for f in VVCDecoder(
        DecoderConfig(device_deblock=True)).decode(s))
    assert host == dev


def test_device_deblock_tiles():
    """Tile boundaries gate edges via the BS maps; device must agree."""
    import sys as _s, os as _o
    _s.path.insert(0, _o.path.join(_o.path.dirname(__file__), "..", "tools"))
    from forge import forge_tiled_stream
    from ffvvc_jax.decoder import VVCDecoder
    from ffvvc_jax.config import DecoderConfig
    s = forge_tiled_stream(seed=2, nframes=2, width=96, height=96,
                           rows=(2,), cols=(2,))
    host = b"".join(f.to_yuv_bytes() for f in VVCDecoder().decode(s))
    dev = b"".join(f.to_yuv_bytes() for f in VVCDecoder(
        DecoderConfig(device_deblock=True)).decode(s))
    assert host == dev


def test_device_deblock_ladf_fallback():
    """LADF reads pixel averages mid-pass: the device path must decline
    and the host fallback keep the decode byte-identical."""
    import sys as _s, os as _o
    _s.path.insert(0, _o.path.join(_o.path.dirname(__file__), "..", "tools"))
    from forge import forge_inter_stream
    from ffvvc_jax.decoder import VVCDecoder
    from ffvvc_jax.config import DecoderConfig
    s = forge_inter_stream(seed=4, nframes=2, deblock=True,
                           sps_ladf_enabled_flag=1,
                           sps_num_ladf_intervals_minus2=1,
                           sps_ladf_lowest_interval_qp_offset=3,
                           sps_ladf_qp_offset=[-2, 4],
                           sps_ladf_delta_threshold_minus1=[30, 100])
    host = b"".join(f.to_yuv_bytes() for f in VVCDecoder().decode(s))
    dev = b"".join(f.to_yuv_bytes() for f in VVCDecoder(
        DecoderConfig(device_deblock=True)).decode(s))
    assert host == dev


@pytest.mark.parametrize("slice_type", [2, 0])
def test_all_device_paths_end_to_end(slice_type):
    """Everything the device can take at once — device SAO + ALF/CC-ALF +
    deblock + LMCS + batched MC + wavefront intra (on the I-frames) — must
    equal the host decode byte-for-byte on a full-tool stream."""
    import sys as _s, os as _o
    _s.path.insert(0, _o.path.join(_o.path.dirname(__file__), "..", "tools"))
    from forge import forge_inter_stream
    from ffvvc_jax.decoder import VVCDecoder
    from ffvvc_jax.config import DecoderConfig
    s = forge_inter_stream(
        slice_type=slice_type, nframes=3, width=96, height=96, seed=7,
        deblock=True, bit_depth=10, sps_sao_enabled_flag=1,
        sps_alf_enabled_flag=1, sps_ccalf_enabled_flag=1,
        sps_lmcs_enabled_flag=1)
    host = b"".join(f.to_yuv_bytes() for f in VVCDecoder().decode(s))
    dev = b"".join(f.to_yuv_bytes() for f in VVCDecoder(DecoderConfig(
        device_sao=True, device_alf=True, device_deblock=True,
        device_mc=True, device_lmcs=True, device_intra=True)).decode(s))
    assert host == dev


def test_device_pipeline_single_chip():
    """config.device_pipeline: the whole deferred filter chain
    (residual-add/LMCS/deblock/SAO/ALF/CC-ALF) runs as batched device
    passes on ONE device with frame batching at drains; output must be
    byte-identical to the host decode."""
    import sys as _s, os as _o
    _s.path.insert(0, _o.path.join(_o.path.dirname(__file__), "..", "tools"))
    from forge import forge_inter_stream, forge_hier_stream
    from ffvvc_jax.decoder import VVCDecoder
    from ffvvc_jax.config import DecoderConfig
    tools = dict(sps_sao_enabled_flag=1, sps_alf_enabled_flag=1,
                 sps_ccalf_enabled_flag=1, sps_lmcs_enabled_flag=1)
    for s in (forge_inter_stream(slice_type=2, nframes=3, width=96,
                                 height=96, seed=3, deblock=True, **tools),
              forge_hier_stream(seed=2, width=96, height=64, qp=32,
                                ngops=2, deblock=True, **tools)):
        host = b"".join(f.to_yuv_bytes() for f in VVCDecoder().decode(s))
        dev = b"".join(f.to_yuv_bytes() for f in VVCDecoder(
            DecoderConfig(device_pipeline=True)).decode(s))
        assert host == dev


@pytest.mark.parametrize("name,kw", [
    ("intra_all", dict(slice_type=2, nframes=3, width=96, height=96,
                       seed=3)),
    ("p_all", dict(slice_type=1, nframes=3, width=128, height=96,
                   seed=4)),
    ("b_10bit", dict(slice_type=0, nframes=3, width=96, height=96,
                     seed=5, bit_depth=10)),
    ("p_12bit", dict(slice_type=1, nframes=2, width=96, height=64,
                     seed=6, bit_depth=12)),
    ("p_422", dict(slice_type=1, nframes=3, width=96, height=96,
                   seed=7, chroma=2)),
    ("p_444", dict(slice_type=1, nframes=2, width=96, height=96,
                   seed=8, chroma=3)),
    ("mono_lmcs", dict(slice_type=1, nframes=3, width=96, height=96,
                       seed=9, chroma=0)),
    ("ctu64", dict(slice_type=1, nframes=2, width=128, height=128,
                   seed=10, ctu_log2=6)),
])
def test_fused_chain_formats(name, kw):
    """The fused device-resident chain (ops/fused_device.py) is bit-exact
    vs the host decode across slice types / bit depths / chroma formats,
    and actually runs (stats.frames counts)."""
    from forge import forge_inter_stream
    from ffvvc_jax.decoder import VVCDecoder
    from ffvvc_jax.config import DecoderConfig
    from ffvvc_jax.ops import fused_device as fd
    tools = dict(sps_sao_enabled_flag=1, sps_alf_enabled_flag=1,
                 sps_ccalf_enabled_flag=1, sps_lmcs_enabled_flag=1)
    s = forge_inter_stream(deblock=True, **tools, **kw)
    host = b"".join(f.to_yuv_bytes() for f in VVCDecoder().decode(s))
    fd.reset_stats()
    dev = b"".join(f.to_yuv_bytes() for f in VVCDecoder(
        DecoderConfig(device_pipeline=True)).decode(s))
    assert host == dev
    assert fd.stats["frames"] > 0, "fused chain never engaged"


def test_fused_chain_transfer_budget():
    """The fused chain's whole host<->device traffic is bounded: one
    int32 plane-set up (+ small params), one plane-set down per frame —
    the device-residency requirement (no per-stage round trips)."""
    from forge import forge_inter_stream
    from ffvvc_jax.decoder import VVCDecoder
    from ffvvc_jax.config import DecoderConfig
    from ffvvc_jax.ops import fused_device as fd
    W = H = 96
    s = forge_inter_stream(slice_type=2, nframes=3, width=W, height=H,
                           seed=3, deblock=True, sps_sao_enabled_flag=1,
                           sps_alf_enabled_flag=1, sps_ccalf_enabled_flag=1,
                           sps_lmcs_enabled_flag=1)
    fd.reset_stats()
    VVCDecoder(DecoderConfig(device_pipeline=True)).decode(s)
    n = fd.stats["frames"]
    assert n == 3
    plane_set = (W * H + 2 * (W // 2) * (H // 2)) * 2   # uint16 wire bytes
    # downloads: exactly the output planes (uint16 on the wire)
    assert fd.stats["down_bytes"] == n * plane_set
    # uploads: the input planes + per-CTB/segment params.  At this tiny
    # frame size the fixed-size params weigh ~1 plane-set; at real sizes
    # they amortize to ~1/3 (1080p measured: 4 MB params vs 6.2 MB
    # planes, printed by the bench device leg)
    assert fd.stats["up_bytes"] < n * plane_set * 2.5


def test_row_pipeline_lmcs_domain():
    """Round-5 regression: the rolling row pipeline must apply LMCS
    inverse one row BEHIND recon — row r+1's intra prediction reads row
    r's mapped-domain samples (spec 8.7.5.2).  Only chroma-scale-off
    LMCS streams reach the row path (mono here), which is why round 4's
    suite missed it."""
    from forge import forge_inter_stream
    from ffvvc_jax.decoder import VVCDecoder
    from ffvvc_jax.config import DecoderConfig
    s = forge_inter_stream(slice_type=1, nframes=3, width=96, height=96,
                           seed=7, chroma=0, deblock=True,
                           sps_lmcs_enabled_flag=1, sps_sao_enabled_flag=1,
                           sps_alf_enabled_flag=1)
    rowed = b"".join(f.to_yuv_bytes() for f in VVCDecoder(
        DecoderConfig()).decode(s))
    plain = b"".join(f.to_yuv_bytes() for f in VVCDecoder(
        DecoderConfig(pipeline_frames=False)).decode(s))
    assert rowed == plain


def test_fused_chain_fallback_paths():
    """Streams outside the fused chain's eligibility (loop-filter-across
    disabled at slice/tile boundaries — SAO/ALF restore regions) must
    fall back to the host stages and stay byte-exact; eligible streams
    in the same decode still run fused."""
    from forge import forge_tiled_stream, forge_subpic_stream
    from ffvvc_jax.decoder import VVCDecoder
    from ffvvc_jax.config import DecoderConfig
    from ffvvc_jax.ops import fused_device as fd
    # across-disabled tiles: ineligible -> host fallback
    s = forge_tiled_stream(seed=2, nframes=2, width=96, height=96,
                           lf_across_tiles=0, lf_across_slices=0,
                           sps_sao_enabled_flag=1, sps_alf_enabled_flag=1)
    host = b"".join(f.to_yuv_bytes() for f in VVCDecoder().decode(s))
    fd.reset_stats()
    dev = b"".join(f.to_yuv_bytes() for f in VVCDecoder(
        DecoderConfig(device_pipeline=True)).decode(s))
    assert host == dev
    assert fd.stats["frames"] == 0, "ineligible stream ran fused"
    # across-enabled subpic stream: eligible, runs fused
    s = forge_subpic_stream(seed=0, width=128, height=64, qp=30,
                            sps_sao_enabled_flag=1)
    host = b"".join(f.to_yuv_bytes() for f in VVCDecoder().decode(s))
    fd.reset_stats()
    dev = b"".join(f.to_yuv_bytes() for f in VVCDecoder(
        DecoderConfig(device_pipeline=True)).decode(s))
    assert host == dev
    assert fd.stats["frames"] > 0


def test_all_device_toggles_compose():
    """device_pipeline + device_mc + device_intra together: the full
    device configuration stays byte-exact on inter (DMVR/BDOF) and
    all-intra content."""
    from forge import forge_hier_stream, forge_inter_stream
    from ffvvc_jax.decoder import VVCDecoder
    from ffvvc_jax.config import DecoderConfig
    cfg = DecoderConfig(device_pipeline=True, device_mc=True,
                        device_intra=True)
    for s in (forge_hier_stream(seed=2, width=96, height=64, qp=32,
                                ngops=2, deblock=True,
                                sps_sao_enabled_flag=1,
                                sps_alf_enabled_flag=1,
                                sps_temporal_mvp_enabled_flag=1,
                                sps_dmvr_enabled_flag=1,
                                sps_bdof_enabled_flag=1),
              forge_inter_stream(slice_type=2, nframes=2, width=96,
                                 height=96, seed=3, deblock=True,
                                 sps_sao_enabled_flag=1,
                                 sps_alf_enabled_flag=1,
                                 sps_ccalf_enabled_flag=1)):
        host = b"".join(f.to_yuv_bytes() for f in VVCDecoder().decode(s))
        dev = b"".join(f.to_yuv_bytes() for f in VVCDecoder(cfg).decode(s))
        assert host == dev
