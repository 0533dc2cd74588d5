"""Streaming front-end: AU assembly, mp4<->Annex-B, vvcC record.

Reference analogues: vvc_parser.c (AU split), bsf/vvc_mp4toannexb.c,
libavformat/vvc.c (vvcC).
"""
import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

from ffvvc_jax.bitstream.au import split_access_units, split_access_unit_bytes
from ffvvc_jax.bitstream.mp4 import (annexb_to_mp4_sample,
                                     mp4_sample_to_annexb, parse_vvcc,
                                     vvcc_extradata_to_annexb, write_vvcc)
from ffvvc_jax.bitstream.nal import NalType, split_annexb, is_vcl


def _stream(nframes=4, **kw):
    from forge import forge_stream
    return forge_stream(level=1, seed=3, width=96, height=64, qp=30,
                        nframes=nframes, **kw)


def test_au_split_counts():
    stream = _stream(nframes=4)
    aus = list(split_access_units(stream))
    assert len(aus) == 4
    # every AU holds at least one VCL NAL; parameter sets ride in the first
    assert all(any(is_vcl(n.type) for n in au) for au in aus)
    assert any(n.type == NalType.SPS for n in aus[0])


def test_au_feed_packetwise_matches_whole_stream():
    from ffvvc_jax.decoder import VVCDecoder
    from ffvvc_jax.config import DecoderConfig
    stream = _stream(nframes=3)
    whole = VVCDecoder(DecoderConfig()).decode(stream)
    dec = VVCDecoder(DecoderConfig())
    frames = []
    for pkt in split_access_unit_bytes(stream):
        frames += dec.decode(pkt, flush=False)
    frames += dec.flush()
    a = b"".join(f.to_yuv_bytes() for f in whole)
    b = b"".join(f.to_yuv_bytes() for f in frames)
    assert a == b


def test_mp4_roundtrip():
    stream = _stream(nframes=2)
    for ls in (2, 4):
        sample = annexb_to_mp4_sample(stream, ls)
        back = mp4_sample_to_annexb(sample, ls)
        orig = [n.raw for n in split_annexb(stream)]
        conv = [n.raw for n in split_annexb(back)]
        assert orig == conv


def test_mp4_decode_equivalence():
    from ffvvc_jax.decoder import VVCDecoder
    from ffvvc_jax.config import DecoderConfig
    stream = _stream(nframes=2)
    sample = annexb_to_mp4_sample(stream, 4)
    back = mp4_sample_to_annexb(sample, 4)
    a = VVCDecoder(DecoderConfig()).decode(stream)
    b = VVCDecoder(DecoderConfig()).decode(back)
    assert b"".join(f.to_yuv_bytes() for f in a) == \
        b"".join(f.to_yuv_bytes() for f in b)


def test_vvcc_roundtrip():
    stream = _stream(nframes=1)
    ps = [(n.type.value, n.raw) for n in split_annexb(stream)
          if n.type in (NalType.SPS, NalType.PPS)]
    rec_bytes = write_vvcc(ps, length_size=4)
    rec = parse_vvcc(rec_bytes)
    assert rec.length_size == 4
    assert sorted(t for t, _ in rec.nal_units) == sorted(t for t, _ in ps)
    assert [b for _, b in sorted(rec.nal_units)] == \
        [b for _, b in sorted(ps)]
    annexb = vvcc_extradata_to_annexb(rec_bytes)
    assert [n.raw for n in split_annexb(annexb)] == [b for _, b in sorted(ps)]


def test_malformed_mp4_sample():
    with pytest.raises(ValueError):
        mp4_sample_to_annexb(b"\x00\x00\x00\xff\x01", 4)


def test_au_split_poc_matches_structural():
    """POC-based AU detection (vvc_parser.c:199-331 semantics) agrees with
    the structural splitter on ordinary streams."""
    from ffvvc_jax.bitstream.au import split_access_units_poc
    for stream in (_stream(nframes=4),):
        a = [[n.raw for n in au] for au in split_access_units(stream)]
        b = [[n.raw for n in au] for au in split_access_units_poc(stream)]
        assert a == b


def test_au_split_poc_hier_gop():
    """Out-of-order POCs (hierarchical GOP, B-frames) and inter streams
    split one AU per coded picture."""
    import sys as _s, os as _o
    _s.path.insert(0, _o.path.join(_o.path.dirname(__file__), "..", "tools"))
    from forge import forge_hier_stream, forge_inter_stream
    from ffvvc_jax.bitstream.au import split_access_units_poc
    s = forge_hier_stream(seed=1, ngops=2)
    assert len(list(split_access_units_poc(s))) == 5
    s = forge_inter_stream(seed=2, nframes=3, slice_type=0)
    assert len(list(split_access_units_poc(s))) == 3


def test_au_poc_packetwise_decode():
    from ffvvc_jax.decoder import VVCDecoder
    from ffvvc_jax.config import DecoderConfig
    from ffvvc_jax.bitstream.au import split_access_unit_bytes_poc
    stream = _stream(nframes=3)
    whole = VVCDecoder(DecoderConfig()).decode(stream)
    dec = VVCDecoder(DecoderConfig())
    frames = []
    for pkt in split_access_unit_bytes_poc(stream):
        frames += dec.decode(pkt, flush=False)
    frames += dec.flush()
    assert b"".join(f.to_yuv_bytes() for f in whole) == \
        b"".join(f.to_yuv_bytes() for f in frames)


def test_au_poc_multislice_no_ph_markers():
    """Multi-slice pictures whose slices share one PH NAL: the POC detector
    must keep the slices in one AU (same POC) and split between pictures."""
    import sys as _s, os as _o
    _s.path.insert(0, _o.path.join(_o.path.dirname(__file__), "..", "tools"))
    from forge import forge_rect_slice_stream
    from ffvvc_jax.bitstream.au import split_access_units_poc
    from ffvvc_jax.bitstream.nal import is_vcl
    s = forge_rect_slice_stream(seed=0, slice_type=2, nframes=2)
    aus = list(split_access_units_poc(s))
    assert len(aus) == 2
    assert all(sum(is_vcl(n.type) for n in au) >= 2 for au in aus)
