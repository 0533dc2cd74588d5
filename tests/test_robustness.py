"""Malformed-stream robustness: corrupted/truncated bitstreams must never
crash the process (reference CI negative tests, makefile.yml:90-91); in
error-resilient mode they must be swallowed by the per-frame error latch."""
import sys
import os

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

from ffvvc_jax.config import DecoderConfig
from ffvvc_jax.decoder import VVCDecoder


def _stream():
    from forge import forge_stream
    return forge_stream(level=1, seed=5, width=64, height=64, qp=30,
                        nframes=2)


def test_corrupted_bytes_never_crash():
    stream = bytearray(_stream())
    n = len(stream)
    rng_positions = [(7 * i * i + 13) % n for i in range(16)]
    for i, pos in enumerate(rng_positions):
        bad = bytearray(stream)
        bad[pos] ^= 0xFF >> (i % 7)
        dec = VVCDecoder(DecoderConfig(error_resilient=True))
        frames = dec.decode(bytes(bad))      # must not raise nor crash
        for f in frames:
            f.to_yuv_bytes()


def test_truncations_never_crash():
    stream = _stream()
    for frac in (1, 3, 7, 9, 13, 17):
        bad = stream[:len(stream) * frac // 20]
        dec = VVCDecoder(DecoderConfig(error_resilient=True))
        dec.decode(bad)


def test_garbage_input():
    dec = VVCDecoder(DecoderConfig(error_resilient=True))
    assert dec.decode(b"\x00\x00\x01" + bytes(range(256))) == []
    assert dec.decode(b"") == []
