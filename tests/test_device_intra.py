"""Device intra prediction (ops/intra_device.py) must match the host path
bit-exactly — whole-decode differential over the intra toolset, plus an
oracle cross-check.

The device path runs wavefront-batched planar/DC/angular/MIP/CCLM kernels
over the frame plane; the host path is the native C walk (itself
oracle-differential-tested).  Runs on the CPU backend; the same code path
runs on a real chip.
"""
import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

from conftest import have_oracle, oracle_decode
from ffvvc_jax.decoder import VVCDecoder
from ffvvc_jax.config import DecoderConfig


def _decode(stream, **cfg):
    frames = VVCDecoder(DecoderConfig(**cfg)).decode(stream)
    return b"".join(f.to_yuv_bytes() for f in frames)


def _forge(case):
    from forge import (forge_stream, forge_tools_stream, forge_ts_stream,
                       forge_tiled_stream, forge_subpic_stream)
    if case == "basic":
        return forge_stream(level=0, seed=0, width=128, height=96, qp=30)
    if case == "fuzz":
        return forge_stream(level=1, seed=3, width=128, height=96, qp=28,
                            bit_depth=10)
    if case == "tools10":
        # the BASELINE-named intra toolset: ISP+MIP+MRL+LFNST+MTS, 10-bit
        return forge_tools_stream(seed=0, width=128, height=128, qp=30)
    if case == "cclm":
        return forge_tools_stream(seed=2, width=128, height=96, qp=30,
                                  sps_cclm_enabled_flag=1)
    if case == "cclm_coll":
        return forge_tools_stream(
            seed=3, width=128, height=96, qp=30, sps_cclm_enabled_flag=1,
            sps_chroma_vertical_collocated_flag=1)
    if case == "dualtree":
        return forge_tools_stream(seed=4, width=128, height=128, qp=30,
                                  dual_tree=True, sps_cclm_enabled_flag=1)
    if case == "ts_bdpcm":
        return forge_ts_stream(seed=0, width=96, height=64, qp=30,
                               bdpcm=True)
    if case == "tiled":
        return forge_tiled_stream(seed=0, width=96, height=96, qp=32)
    if case == "subpic":
        return forge_subpic_stream(seed=0, width=128, height=64, qp=30)
    if case == "wpp":
        return forge_tools_stream(
            seed=5, width=256, height=192, qp=30,
            sps_entropy_coding_sync_enabled_flag=1)
    if case == "mono":
        return forge_tools_stream(seed=6, width=128, height=96, qp=30,
                                  chroma=0)
    if case == "12bit":
        return forge_tools_stream(seed=7, width=96, height=96, qp=30,
                                  bit_depth=12)
    if case == "422":
        return forge_tools_stream(seed=8, width=128, height=96, qp=30,
                                  chroma=2, sps_cclm_enabled_flag=1)
    if case == "444":
        return forge_tools_stream(seed=9, width=128, height=96, qp=30,
                                  chroma=3, sps_cclm_enabled_flag=1)
    raise KeyError(case)


CASES = ["basic", "fuzz", "tools10", "cclm", "cclm_coll", "dualtree",
         "ts_bdpcm", "tiled", "subpic", "wpp", "mono", "12bit",
         "422", "444"]


@pytest.mark.parametrize("case", CASES)
def test_device_intra_matches_host(case):
    stream = _forge(case)
    host = _decode(stream)
    dev = _decode(stream, device_intra=True)
    assert dev == host, f"device intra decode differs on {case}"


@pytest.mark.skipif(not have_oracle(), reason="oracle not built")
def test_device_intra_matches_oracle(tmp_path):
    stream = _forge("cclm")
    ref = oracle_decode(stream, tmp_path)
    dev = _decode(stream, device_intra=True)
    assert dev == ref


def test_device_intra_falls_back_on_inter(tmp_path):
    """P/B frames must take the native path untouched (gate check)."""
    from forge import forge_inter_stream
    stream = forge_inter_stream(seed=0, width=64, height=64, qp=32)
    host = _decode(stream)
    dev = _decode(stream, device_intra=True)
    assert dev == host


def test_c_planner_engages_and_matches_python():
    """Round-5: the C planner (plan_intra_ctus + vectorized bucket
    build) must actually engage (not silently fall back) and produce
    byte-identical output to the round-4 Python planner across
    CCLM/MIP/ISP/MRL-bearing content."""
    import os
    from ffvvc_jax.ops import intra_device as idv
    for case in ("tools10", "cclm_coll", "dualtree", "422"):
        s = _forge(case)
        os.environ["FFVVC_INTRA_PLANNER"] = "py"
        try:
            py = b"".join(f.to_yuv_bytes() for f in VVCDecoder(
                DecoderConfig(device_intra=True)).decode(s))
        finally:
            del os.environ["FFVVC_INTRA_PLANNER"]
        idv.last_plan_s = -1.0
        cp = b"".join(f.to_yuv_bytes() for f in VVCDecoder(
            DecoderConfig(device_intra=True)).decode(s))
        assert cp == py, case
        assert idv.last_plan_s >= 0, f"C planner fell back on {case}"
