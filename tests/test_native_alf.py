"""Native C whole-frame ALF (native/vvc_alf.c) vs the Python golden pass —
whole-decode differential (the golden itself is oracle-differential-tested
in test_conformance.py test_l7_loop_filters, which now runs the C path by
default)."""
import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

from ffvvc_jax.decoder import VVCDecoder
from ffvvc_jax.config import DecoderConfig


def _decode(stream, **cfg):
    frames = VVCDecoder(DecoderConfig(**cfg)).decode(stream)
    return b"".join(f.to_yuv_bytes() for f in frames)


@pytest.mark.parametrize("case", ["alf", "ccalf", "chain", "tiled",
                                  "slices", "mono", "12bit"])
def test_native_alf_matches_golden(case):
    from forge import forge_inter_stream, forge_tiled_stream
    if case == "alf":
        s = forge_inter_stream(seed=2, nframes=3, deblock=True,
                               sps_alf_enabled_flag=1)
    elif case == "ccalf":
        s = forge_inter_stream(seed=3, nframes=3, deblock=True,
                               sps_alf_enabled_flag=1,
                               sps_ccalf_enabled_flag=1)
    elif case == "chain":
        s = forge_inter_stream(seed=3, nframes=3, deblock=True,
                               sps_sao_enabled_flag=1,
                               sps_alf_enabled_flag=1,
                               sps_ccalf_enabled_flag=1,
                               sps_lmcs_enabled_flag=1)
    elif case == "tiled":
        s = forge_tiled_stream(seed=2, nframes=2, sps_alf_enabled_flag=1,
                               sps_ccalf_enabled_flag=1, lf_across_tiles=0)
    elif case == "slices":
        s = forge_tiled_stream(seed=3, nframes=2, sps_alf_enabled_flag=1,
                               slices=[(0, 2), (2, 2)], lf_across_slices=0)
    elif case == "mono":
        s = forge_inter_stream(seed=4, nframes=2, deblock=True, chroma=0,
                               sps_alf_enabled_flag=1)
    else:
        s = forge_inter_stream(seed=5, nframes=2, deblock=True,
                               bit_depth=12, sps_alf_enabled_flag=1,
                               sps_ccalf_enabled_flag=1)
    assert _decode(s, native_alf=True) == _decode(s, native_alf=False)
