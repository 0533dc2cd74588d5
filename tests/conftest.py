import os
import sys

# Tests run on the CPU backend with a virtual 8-device mesh; code that
# needs the GPU runs through chip_smoke.py on a machine with the card.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pytest  # noqa: E402

ORACLE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      ".refbuild", "ffmpeg")


def have_oracle():
    return os.path.exists(ORACLE)


@pytest.fixture
def oracle_path():
    if not have_oracle():
        pytest.skip("reference oracle not built (.refbuild/ffmpeg)")
    return ORACLE


def oracle_decode(stream: bytes, tmp_path) -> bytes:
    """Decode Annex-B bytes with the reference decoder; returns raw YUV.
    -flags unaligned makes conformance-window cropping exact (FATE does the
    same, reference tests/fate/vvc.mak:41)."""
    import subprocess
    bit = tmp_path / "t.bit"
    yuv = tmp_path / "t.yuv"
    bit.write_bytes(stream)
    r = subprocess.run(
        [ORACLE, "-hide_banner", "-loglevel", "error", "-threads", "1",
         "-flags", "unaligned",
         "-f", "vvc", "-i", str(bit), "-f", "rawvideo", "-y", str(yuv)],
        capture_output=True, timeout=120)
    assert r.returncode == 0 and not r.stderr, r.stderr.decode()
    return yuv.read_bytes()


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Bound in-process XLA/LLVM compiler state: after ~200 tests of
    accumulated compilations the CPU backend_compile segfaults
    deterministically on one more BDOF-solve HLO (history-dependent
    compiler crash — every file pair passes, only the full sequence
    trips it).  Clearing jit caches at module boundaries keeps the
    compiler state bounded; the cost is per-file recompiles."""
    yield
    try:
        import jax
        jax.clear_caches()
    except Exception:
        pass
