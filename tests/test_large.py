"""Large-frame (1080p) oracle-differential correctness.

Nothing else in the suite checks frames above 128px (CTU-boundary,
line-buffer and tile math all scale with frame size).  The 1080p forge
costs ~13 s/frame, so the stream caches in /tmp (same scheme as
bench.py) and is forged on first run on a fresh machine."""
import hashlib
import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

from conftest import oracle_decode, have_oracle
from ffvvc_jax.decoder import VVCDecoder

W, H, QP, NFRAMES = 1920, 1080, 30, 2
_KEY = hashlib.sha256(f"large:{W}x{H}:{NFRAMES}:{QP}".encode()).hexdigest()
CACHE = f"/tmp/ffvvc_large_{_KEY[:16]}.bit"


def _stream():
    if os.path.exists(CACHE):
        with open(CACHE, "rb") as f:
            return f.read()
    from forge import forge_tools_stream
    s = forge_tools_stream(seed=7, width=W, height=H, qp=QP, bit_depth=10,
                           nframes=NFRAMES)
    with open(CACHE + ".tmp", "wb") as f:
        f.write(s)
    os.replace(CACHE + ".tmp", CACHE)
    return s


@pytest.mark.skipif(not have_oracle(), reason="oracle not built")
def test_1080p_allintra_tools(tmp_path):
    """1080p all-intra 10-bit ISP+MIP+MRL+LFNST+MTS vs oracle, byte-exact
    (the BASELINE.md all-intra config at full frame size)."""
    stream = _stream()
    ref = oracle_decode(stream, tmp_path)
    frames = VVCDecoder().decode(stream)
    assert len(frames) == NFRAMES
    assert b"".join(f.to_yuv_bytes() for f in frames) == ref
