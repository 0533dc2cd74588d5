"""Who owns the device, where compiled kernels are cached, and the chip
smoke test's own logic, all checked on the CPU backend."""
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))


@pytest.mark.parametrize("case", ["env", "checkout", "forced_cpu"])
def test_compile_cache_dir(case, tmp_path):
    """JAX_COMPILATION_CACHE_DIR is the cache when set (compiled entries
    land there); otherwise the package sets the fixed checkout path; the
    forced-CPU backend gets no persistent cache."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "JAX_COMPILATION_CACHE_DIR")}
    if case == "env":
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path)
    if case == "forced_cpu":
        env["JAX_PLATFORMS"] = "cpu"
    prog = ("import sys, jax, jax.numpy as jnp\n"
            f"sys.path.insert(0, {REPO!r})\n"
            "import ffvvc_jax.ops\n"
            "if len(sys.argv) > 1:\n"
            "    jax.jit(lambda x: x * 3 + 1)(jnp.arange(7)).block_until_ready()\n"
            "print(jax.config.jax_compilation_cache_dir)\n")
    args = [sys.executable, "-c", prog] + (["compile"] if case == "env"
                                           else [])
    r = subprocess.run(args, env=env, capture_output=True, text=True,
                       timeout=120, cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr
    got = r.stdout.strip().splitlines()[-1]
    if case == "env":
        assert got == str(tmp_path)
        assert any(os.scandir(tmp_path)), "no compiled entry in the cache"
    elif case == "checkout":
        assert got == os.path.join(REPO, ".jax_cache")
    else:
        assert got == "None"


def test_device_decode_stays_in_process(monkeypatch):
    """decode_parallel with a device stage on decodes in the calling
    process (it owns the card): no worker pool is started, and no worker
    silently decodes without the device stages."""
    from forge import forge_tools_stream
    from ffvvc_jax import pipeline
    from ffvvc_jax.config import DecoderConfig
    from ffvvc_jax.decoder import VVCDecoder

    def no_pool(workers):
        raise AssertionError("worker pool started for a device config")
    monkeypatch.setattr(pipeline, "_get_pool", no_pool)
    one = forge_tools_stream(seed=1, width=64, height=64, nframes=1)
    stream = one + one                     # two IDR segments
    assert len(pipeline.segment_stream(stream)) == 2
    cfg = DecoderConfig(device_pipeline=True)
    assert cfg.uses_device()
    assert not DecoderConfig().uses_device()
    assert not DecoderConfig(backend="golden", device_mc=True).uses_device()
    assert DecoderConfig(mesh_shape=(1, 2)).uses_device()
    got = pipeline.decode_parallel(stream, workers=2, config=cfg)
    want = [f.to_yuv_bytes() for f in VVCDecoder().decode(stream)]
    assert got == want


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_refuses_without_gpu(where, tmp_path):
    """Without a GPU (here: the CPU backend), and in a directory holding
    nothing else of the repository, chip_smoke.py exits non-zero and
    prints no result line."""
    script = os.path.join(REPO, "chip_smoke.py")
    if where == "alone":
        alone = tmp_path / "chip_smoke.py"
        alone.write_bytes(open(script, "rb").read())
        script = str(alone)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, script], env=env,
                       capture_output=True, text=True, timeout=120,
                       cwd=str(tmp_path))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


@pytest.fixture(scope="module")
def smoke_streams(tmp_path_factory):
    import chip_smoke
    return chip_smoke.forge_streams(64, 64, str(tmp_path_factory.mktemp("s")))


@pytest.mark.parametrize("name,n_intra", [("intra", 4), ("ra", 1)])
def test_chip_smoke_stream_checks(smoke_streams, name, n_intra):
    """The smoke test's per-stream check at 64x64 on the CPU backend:
    device decode byte-equal to the host with picture hashes verified, and
    every frame counted on its device stages (fused chain on all frames,
    device intra on the intra frames, device MC on the inter frames)."""
    import chip_smoke
    counts = chip_smoke.check_stream(name, smoke_streams[name], n_intra)
    n = 4 if name == "intra" else 5
    assert counts == {"fused": n, "intra": n_intra, "mc": n - n_intra}


def test_chip_smoke_mesh_checks(smoke_streams):
    """The --multi comparison on a (2, 2) mesh of virtual CPU devices:
    sharded filter chain and sharded MC byte-equal to the host decode."""
    import chip_smoke
    chip_smoke.check_mesh(smoke_streams, (2, 2))
