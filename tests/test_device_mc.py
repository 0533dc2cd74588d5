"""Device (XLA) batched MC must match the host golden _mc_put bit-exactly —
the checkasm vvc_mc analogue: randomized sizes x frac classes x bit depths
(reference tests/checkasm/vvc_mc.c:68-114 pattern).
"""
import os
import sys
import types

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))


def _golden_put(plane, x, y, fx, fy, w, h, is_luma, bd):
    from ffvvc_jax.inter import InterPredictor
    ip = InterPredictor.__new__(InterPredictor)
    ip.bd = bd
    ip._mc_lib = None  # force the NumPy golden path
    return np.asarray(
        InterPredictor._mc_put(ip, plane, x, y, fx, fy, w, h, is_luma))


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("is_luma", [True, False])
@pytest.mark.parametrize("size", [(4, 4), (8, 16), (32, 8), (64, 64)])
def test_mc_put_device_matches_golden(bd, is_luma, size):
    from ffvvc_jax.ops.mc_device import mc_put_batch
    rng = np.random.default_rng(hash((bd, is_luma, size)) & 0xFFFF)
    H, W = 96, 128
    plane = rng.integers(0, 1 << bd, (H, W)).astype(np.int32)
    w, h = size
    B = 9
    xs = rng.integers(-8, W + 4, B)
    ys = rng.integers(-8, H + 4, B)
    nfrac = 16
    for fclass in range(4):
        fx = rng.integers(1, nfrac, B) * bool(fclass & 1)
        fy = rng.integers(1, nfrac, B) * bool(fclass & 2)
        got = mc_put_batch(plane, xs, ys, fx, fy, w, h, is_luma, bd)
        for b in range(B):
            ref = _golden_put(plane, int(xs[b]), int(ys[b]), int(fx[b]),
                              int(fy[b]), w, h, is_luma, bd)
            assert np.array_equal(got[b], ref), (fclass, b)


def test_mc_avg_uni_device():
    from ffvvc_jax.ops.mc_device import mc_avg_batch, mc_uni_batch
    from ffvvc_jax.inter import InterPredictor
    rng = np.random.default_rng(7)
    for bd in (8, 10):
        ip = InterPredictor.__new__(InterPredictor)
        ip.bd = bd
        s0 = rng.integers(-(1 << 13), 1 << 13, (5, 8, 8)).astype(np.int32)
        s1 = rng.integers(-(1 << 13), 1 << 13, (5, 8, 8)).astype(np.int32)
        got = mc_avg_batch(s0, s1, bd)
        for b in range(5):
            ref = InterPredictor._avg(ip, s0[b].astype(np.int64),
                                      s1[b].astype(np.int64))
            assert np.array_equal(got[b], ref)
        gotu = mc_uni_batch(s0, bd)
        for b in range(5):
            ref = InterPredictor._uni_out(ip, s0[b].astype(np.int64), False)
            assert np.array_equal(gotu[b], ref)


# --- decoder-side batched device MC dispatch --------------------------------

@pytest.mark.parametrize("kw", [
    dict(slice_type=1, nframes=3, width=96, height=64, seed=2),      # P
    dict(slice_type=0, nframes=3, width=96, height=96, seed=1),      # B
    dict(slice_type=0, nframes=3, width=64, height=64, seed=3,
         bit_depth=10),
    dict(slice_type=0, nframes=3, width=96, height=96, seed=5,       # mixed
         sps_temporal_mvp_enabled_flag=1, sps_ciip_enabled_flag=1,
         sps_bcw_enabled_flag=1, sps_mmvd_enabled_flag=1,
         sps_affine_enabled_flag=1,
         sps_five_minus_max_num_subblock_merge_cand=0,
         sps_6param_affine_enabled_flag=1, sps_affine_prof_enabled_flag=1),
])
def test_decoder_device_mc(kw):
    """Decode with device_mc on (simple regular blocks batched on device,
    complex blocks host C) must equal the host decode byte-for-byte."""
    import sys as _s, os as _o
    _s.path.insert(0, _o.path.join(_o.path.dirname(__file__), "..", "tools"))
    from forge import forge_inter_stream
    from ffvvc_jax.decoder import VVCDecoder
    from ffvvc_jax.config import DecoderConfig
    s = forge_inter_stream(deblock=True, **kw)
    host = b"".join(f.to_yuv_bytes() for f in VVCDecoder().decode(s))
    dev = b"".join(f.to_yuv_bytes() for f in VVCDecoder(
        DecoderConfig(device_mc=True)).decode(s))
    assert host == dev


def test_decoder_device_mc_dmvr_bdof():
    """DMVR refinement (batched bilinear prefetch + SAD search) and BDOF
    run on device, with the refined MVs written back to the TMVP col
    grids — the multi-frame hier GOP catches any writeback divergence."""
    import sys as _s, os as _o
    _s.path.insert(0, _o.path.join(_o.path.dirname(__file__), "..", "tools"))
    from forge import forge_hier_stream
    from ffvvc_jax.decoder import VVCDecoder
    from ffvvc_jax.config import DecoderConfig
    s = forge_hier_stream(seed=0, width=96, height=96, ngops=2, deblock=True,
                          sps_temporal_mvp_enabled_flag=1,
                          sps_bdof_enabled_flag=1, sps_dmvr_enabled_flag=1)
    host = b"".join(f.to_yuv_bytes() for f in VVCDecoder().decode(s))
    dev = b"".join(f.to_yuv_bytes() for f in VVCDecoder(
        DecoderConfig(device_mc=True)).decode(s))
    assert host == dev


@pytest.mark.parametrize("name,kw", [
    ("weighted_p", dict(slice_type=1, nframes=3, width=96, height=64,
                        seed=2, sps_weighted_pred_flag=1,
                        pps_kw=dict(pps_weighted_pred_flag=1))),
    ("weighted_bi", dict(slice_type=0, nframes=3, width=96, height=96,
                         seed=1, bit_depth=10, sps_weighted_bipred_flag=1,
                         pps_kw=dict(pps_weighted_bipred_flag=1))),
    ("bcw", dict(slice_type=0, nframes=3, width=128, height=128, seed=4,
                 sps_bcw_enabled_flag=1)),          # bcw needs >=256 CUs
    ("lmcs", dict(slice_type=1, nframes=3, width=96, height=64, seed=3,
                  bit_depth=10, sps_lmcs_enabled_flag=1, chroma=0)),
    # (4:2:0 lmcs streams carry chroma residual scaling, which gates the
    #  whole slice off the native path — mono exercises the device path)
    ("wraparound", dict(slice_type=1, nframes=3, width=128, height=64,
                        seed=5, sps_ref_wraparound_enabled_flag=1,
                        pps_kw=dict(
                            pps_ref_wraparound_enabled_flag=1,
                            pps_pic_width_minus_wraparound_offset=0))),
])
def test_decoder_device_mc_extended(name, kw):
    """Weighted pred / BCW finals, LMCS forward mapping and horizontal
    wraparound now batch on device (descriptor layout, vvc_inter.c
    inter_ctus_dev); output must equal the host decode byte-for-byte."""
    import sys as _s, os as _o
    _s.path.insert(0, _o.path.join(_o.path.dirname(__file__), "..", "tools"))
    from forge import forge_inter_stream
    from ffvvc_jax.decoder import VVCDecoder
    from ffvvc_jax.config import DecoderConfig
    s = forge_inter_stream(deblock=True, **kw)
    host = b"".join(f.to_yuv_bytes() for f in VVCDecoder().decode(s))
    dev = b"".join(f.to_yuv_bytes() for f in VVCDecoder(
        DecoderConfig(device_mc=True)).decode(s))
    assert host == dev


@pytest.mark.parametrize("seed", [4, 5])
def test_decoder_device_mc_gpm(seed):
    """GPM blocks batch on device: two uni puts + weight-plane blend
    (flags2 bit1 descriptors; weights host-sliced from the partition
    tables, blend math on device)."""
    import sys as _s, os as _o
    _s.path.insert(0, _o.path.join(_o.path.dirname(__file__), "..", "tools"))
    from forge import forge_inter_stream
    from ffvvc_jax.decoder import VVCDecoder
    from ffvvc_jax.config import DecoderConfig
    s = forge_inter_stream(deblock=True, slice_type=0, nframes=3, width=96,
                           height=96, seed=seed, sps_gpm_enabled_flag=1,
                           sps_max_num_merge_cand_minus_max_num_gpm_cand=0,
                           sps_six_minus_max_num_merge_cand=1)
    host = b"".join(f.to_yuv_bytes() for f in VVCDecoder().decode(s))
    dev = b"".join(f.to_yuv_bytes() for f in VVCDecoder(
        DecoderConfig(device_mc=True)).decode(s))
    assert host == dev


AFFINE_SPS = dict(sps_affine_enabled_flag=1,
                  sps_five_minus_max_num_subblock_merge_cand=0,
                  sps_6param_affine_enabled_flag=1,
                  sps_affine_prof_enabled_flag=1)


@pytest.mark.parametrize("name,kw", [
    ("affine_prof", dict(slice_type=0, nframes=3, width=96, height=96,
                         seed=2, **AFFINE_SPS)),
    ("sbtmvp", dict(slice_type=0, nframes=3, width=96, height=96, seed=5,
                    sps_temporal_mvp_enabled_flag=1,
                    sps_sbtmvp_enabled_flag=1, **AFFINE_SPS)),
    ("affine_weighted", dict(slice_type=0, nframes=3, width=96, height=64,
                             seed=6, bit_depth=10,
                             sps_weighted_bipred_flag=1,
                             pps_kw=dict(pps_weighted_bipred_flag=1),
                             **AFFINE_SPS)),
])
def test_decoder_device_mc_affine(name, kw):
    """Affine (+PROF) and SbTMVP subblock grids batch on device: per-
    subblock puts from the mvf/cp_mv tab grids, PROF gradient refinement
    as a batched kernel, spec-averaged chroma MVs per 2x2 group."""
    import sys as _s, os as _o
    _s.path.insert(0, _o.path.join(_o.path.dirname(__file__), "..", "tools"))
    from forge import forge_inter_stream
    from ffvvc_jax.decoder import VVCDecoder
    from ffvvc_jax.config import DecoderConfig
    s = forge_inter_stream(deblock=True, **kw)
    host = b"".join(f.to_yuv_bytes() for f in VVCDecoder().decode(s))
    dev = b"".join(f.to_yuv_bytes() for f in VVCDecoder(
        DecoderConfig(device_mc=True)).decode(s))
    assert host == dev


def test_decoder_device_mc_dmvr_12bit():
    """DMVR bilinear prefetch rounding differs above 10-bit ((v+off) >>
    (bd-10) instead of << (10-bd)): pin the 12-bit device path."""
    import sys as _s, os as _o
    _s.path.insert(0, _o.path.join(_o.path.dirname(__file__), "..", "tools"))
    from forge import forge_hier_stream
    from ffvvc_jax.decoder import VVCDecoder
    from ffvvc_jax.config import DecoderConfig
    s = forge_hier_stream(seed=2, width=96, height=64, ngops=2,
                          deblock=True, bit_depth=12,
                          sps_temporal_mvp_enabled_flag=1,
                          sps_bdof_enabled_flag=1, sps_dmvr_enabled_flag=1)
    host = b"".join(f.to_yuv_bytes() for f in VVCDecoder().decode(s))
    dev = b"".join(f.to_yuv_bytes() for f in VVCDecoder(
        DecoderConfig(device_mc=True)).decode(s))
    assert host == dev
