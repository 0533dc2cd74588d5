"""Smoke test of the device decode path on NVIDIA GPUs.

Forges two 1920x1080 10-bit 4:2:0 streams (a filter-heavy all-intra stream
and a hierarchical-GOP random-access stream), decodes each on the host path
as the reference, then through `VVCDecoder` with every device stage on
(fused post-recon chain, device intra, device MC) and checks that:

  * the device decode equals the host decode byte for byte (all device math
    is integer, so the tolerance is zero), and the decoder verifies every
    picture against the host's MD5 carried in decoded-picture-hash SEI;
  * every frame ran on the device stages it is eligible for — a frame that
    fell back to the host fails the run.

    python chip_smoke.py           # one GPU
    python chip_smoke.py --multi   # four GPUs: the (2, 2) mesh path only

Each phase prints one line with its wall time.  The last line of standard
output is one JSON object, printed only when every phase passed:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a GPU (or outside a checkout of the repository) it exits non-zero
and prints no such line.  Forged streams are cached in `.smoke_streams/`.
"""
import argparse
import contextlib
import hashlib
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [REPO, os.path.join(REPO, "tools")]
STREAM_DIR = os.path.join(REPO, ".smoke_streams")
WIDTH, HEIGHT, QP = 1920, 1080, 30
COMPILE_SECS = []     # one entry per XLA backend compile in this process


@contextlib.contextmanager
def phase(name):
    t0 = time.monotonic()
    yield
    print(f"[{name}] done in {time.monotonic() - t0:.1f} s", flush=True)


def require_gpus(count):
    """The accelerator JAX found: GPU platform and at least `count` cards,
    else SystemExit (no CPU fallback)."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: JAX found no GPU (platform "
                         f"{devs[0].platform!r}); nothing was run")
    if len(devs) < count:
        raise SystemExit(f"chip_smoke: {count} GPUs needed, JAX found "
                         f"{len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"device: {devs[0].device_kind}, {len(devs)} visible to JAX")
    for line in smi.splitlines():
        print(f"nvidia-smi: {line}")
    return devs


def forge_streams(width, height, cache_dir):
    """{name: Annex-B bytes} for the two smoke streams, forged from fixed
    seeds and cached under cache_dir keyed by the forge parameters."""
    import forge
    specs = {
        # filter-heavy all-intra (the BASELINE all-intra toolset plus SAO,
        # ALF, CC-ALF and LMCS): fused chain + device intra on every frame
        "intra": ("forge_tools_stream", dict(
            seed=0, width=width, height=height, qp=QP, bit_depth=10,
            nframes=4, sps_sao_enabled_flag=1, sps_alf_enabled_flag=1,
            sps_ccalf_enabled_flag=1, sps_lmcs_enabled_flag=1)),
        # random access: IDR + two (P, B) GOPs with DMVR, BDOF, affine with
        # PROF and TMVP.  No LMCS: chroma LMCS keeps device MC off.
        "ra": ("forge_hier_stream", dict(
            seed=0, width=width, height=height, qp=QP, bit_depth=10,
            ngops=2, deblock=True, sps_affine_enabled_flag=1,
            sps_five_minus_max_num_subblock_merge_cand=0,
            sps_6param_affine_enabled_flag=1,
            sps_affine_prof_enabled_flag=1,
            sps_temporal_mvp_enabled_flag=1, sps_bdof_enabled_flag=1,
            sps_dmvr_enabled_flag=1)),
    }
    os.makedirs(cache_dir, exist_ok=True)
    out = {}
    for name, (fn, kw) in specs.items():
        key = hashlib.sha256(json.dumps([fn, kw], sort_keys=True)
                             .encode()).hexdigest()[:16]
        path = os.path.join(cache_dir, f"{name}_{key}.bit")
        if not os.path.exists(path):
            data = getattr(forge, fn)(**kw)
            with open(path + ".tmp", "wb") as f:
                f.write(data)
            os.replace(path + ".tmp", path)
        with open(path, "rb") as f:
            out[name] = f.read()
    return out


def _decode(stream, config):
    """(output-order YUV bytes, frame count, decoder, seconds)."""
    from ffvvc_jax.decoder import VVCDecoder
    dec = VVCDecoder(config)
    t0 = time.monotonic()
    frames = dec.decode(stream)
    yuv = b"".join(f.to_yuv_bytes() for f in frames)
    return yuv, len(frames), dec, time.monotonic() - t0


def with_picture_hashes(stream):
    """The stream with the host decode's per-picture MD5 inserted as
    decoded-picture-hash SEI.  The SEI follows each access unit, so the
    hashes go in decode order: a streaming decode names the picture each
    access unit coded."""
    from ffvvc_jax.bitstream.au import split_access_unit_bytes
    from ffvvc_jax.config import DecoderConfig
    from ffvvc_jax.decoder import VVCDecoder
    from forge import insert_picture_hashes
    dec = VVCDecoder(DecoderConfig(backend="golden"))
    order, yuv = [], {}
    for au in split_access_unit_bytes(stream):
        frames = dec.decode(au, flush=False)
        order.append(dec.dpb[-1].poc)
        yuv.update((f.poc, f.to_yuv_bytes()) for f in frames)
    yuv.update((f.poc, f.to_yuv_bytes()) for f in dec.flush())
    return insert_picture_hashes(stream, [yuv[p] for p in order],
                                 dec.sps.bit_depth)


def check_stream(name, stream, n_intra):
    """Host reference vs device decode of one stream; raises on any
    difference or on a frame that did not run on its device stages.
    n_intra: leading intra-only frames (device intra); the rest are inter
    frames (device MC).  Returns the device decoder's frame counters."""
    from ffvvc_jax.config import DecoderConfig
    from ffvvc_jax.ops import fused_device as fd

    with phase(f"{name}: reference"):
        hashed = with_picture_hashes(stream)
        host_cfg = DecoderConfig(backend="golden", verify_picture_hash=True)
        ref, n, _, _ = _decode(hashed, host_cfg)       # builds native libs
        ref2, _, _, t_host = _decode(hashed, host_cfg)
        assert ref2 == ref, f"{name}: host decode not deterministic"
        print(f"{name}: {n} frames, host {n / t_host:.3f} frames/s")

    dev_cfg = DecoderConfig(backend="device", device_pipeline=True,
                            device_mc=True, device_intra=True,
                            verify_picture_hash=True)
    for run in ("cold", "warm"):
        with phase(f"{name}: device {run}"):
            fd.reset_stats()
            n_comp = len(COMPILE_SECS)
            yuv, n_dev, dec, t_dev = _decode(hashed, dev_cfg)
            assert n_dev == n, f"{name}: {n_dev} frames, host {n}"
            assert yuv == ref, f"{name}: device decode differs from host"
            want = {"fused": n, "intra": n_intra, "mc": n - n_intra}
            assert dec.device_frames == want, \
                f"{name}: device frames {dec.device_frames}, want {want}"
            per = max(fd.stats["frames"], 1)
            print(f"{name}: device {run} {t_dev:.2f} s "
                  f"({n / t_dev:.3f} frames/s; host {n / t_host:.3f} "
                  f"frames/s), byte-equal to host, picture hashes verified, "
                  f"device frames {dec.device_frames}, "
                  f"{len(COMPILE_SECS) - n_comp} compiles "
                  f"({sum(COMPILE_SECS[n_comp:]):.1f} s), "
                  f"{fd.stats['up_bytes'] / per / 1e6:.3f} MB up / "
                  f"{fd.stats['down_bytes'] / per / 1e6:.3f} MB down and "
                  f"{fd.stats['seconds'] / per * 1e3:.1f} ms in the fused "
                  f"chain per frame", flush=True)
    return dec.device_frames


def check_mesh(streams, mesh_shape):
    """Mesh decodes equal the single-device host decode: the all-intra
    stream with the sharded filter chain, the RA stream with it and device
    MC sharded over the "tile" axis as well."""
    from ffvvc_jax.config import DecoderConfig
    from ffvvc_jax.ops import mc_device
    host_cfg = DecoderConfig(backend="golden")
    runs = (("intra", {}), ("ra", {"device_mc": True}))
    for name, extra in runs:
        label = f"{name}: mesh {mesh_shape}" + \
            (" + device MC" if extra else "")
        with phase(label):
            ref, n, _, _ = _decode(streams[name], host_cfg)
            puts = mc_device.sharded_puts
            yuv, n_dev, _, t = _decode(streams[name], DecoderConfig(
                backend="device", mesh_shape=mesh_shape, **extra))
            assert n_dev == n and yuv == ref, \
                f"{label}: differs from the single-device host decode"
            if extra:
                assert mc_device.sharded_puts > puts, \
                    f"{label}: sharded MC did not engage"
            print(f"{label}: {n} frames byte-equal to host in {t:.2f} s "
                  f"(cold), sharded puts "
                  f"{mc_device.sharded_puts - puts}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="four GPUs: decode on a (2, 2) mesh only")
    args = ap.parse_args(argv)
    count = 4 if args.multi else 1
    with phase("device"):
        devs = require_gpus(count)
    import jax
    jax.monitoring.register_event_duration_secs_listener(
        lambda event, secs, **kw: COMPILE_SECS.append(secs)
        if event == "/jax/core/compile/backend_compile_duration" else None)
    with phase("streams"):
        streams = forge_streams(WIDTH, HEIGHT, STREAM_DIR)
    if args.multi:
        check_mesh(streams, (2, 2))
    else:
        check_stream("intra", streams["intra"], n_intra=4)
        check_stream("ra", streams["ra"], n_intra=1)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))


if __name__ == "__main__":
    main()
