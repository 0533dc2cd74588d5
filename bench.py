"""Decode benchmark: our decoder vs the reference CPU decoder (oracle).

Prints ONE JSON line {"metric", "value", "unit", "vs_baseline", "extra"}.
vs_baseline = our fps / reference-C-decoder fps on the same stream + host
(the reference publishes no numbers of its own — BASELINE.md).

Measured configs (BASELINE.md targets):
  * primary metric: 1080p all-intra **10-bit with ISP+MIP+MRL+LFNST+MTS**
    (the BASELINE-named all-intra config), GOP-parallel host decode.
  * extra.ra_fps / ra_vs_baseline: 1080p random-access 10-bit hierarchical
    GOP with DMVR/BDOF + affine (the BASELINE-named RA config).
  * extra.scaling_efficiency: 1-worker vs N-worker GOP-parallel decode of
    the multi-IDR primary stream (BASELINE target >= 0.8).
  * extra.uhd_ra_fps: 4K random access with the full loop-filter chain
    (deblock+SAO+ALF/CC-ALF+LMCS), the BASELINE-named 4K config.
  * extra.device_fps: decode of a filter-heavy 1080p stream with the
    fused device chain (LMCS/deblock/SAO/ALF/CC-ALF as one jit per frame,
    ops/fused_device.py) in a child process that owns the card (the
    parent never opens it), bit-exact vs oracle, with the bytes moved up
    and down per frame.  A failed device leg makes the bench exit non-zero.

Env knobs: FFVVC_BENCH_SIZE ("1920x1080"), FFVVC_BENCH_FRAMES (4),
FFVVC_BENCH_QP (30), FFVVC_BENCH_WORKERS (cpu count),
FFVVC_BENCH_QUICK=1 (primary metric only).
"""
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

ORACLE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      ".refbuild", "ffmpeg")


def _cached_stream(tag, builder):
    key = hashlib.sha256(tag.encode()).hexdigest()
    cache = f"/tmp/ffvvc_bench_{key[:16]}.bit"
    if os.path.exists(cache):
        with open(cache, "rb") as f:
            return f.read()
    stream = builder()
    with open(cache + ".tmp", "wb") as f:
        f.write(stream)
    os.replace(cache + ".tmp", cache)
    return stream


def _time_best(fn, n=3):
    best = None
    out = None
    for _ in range(n):
        t0 = time.monotonic()
        out = fn()
        dt = time.monotonic() - t0
        best = dt if best is None or dt < best else best
    return best, out


def _oracle_fps(stream, n_frames, tmp="/tmp/bench", n=3):
    if not os.path.exists(ORACLE):
        return 0.0, None
    bit, yuv = tmp + ".bit", tmp + "_ref.yuv"
    with open(bit, "wb") as f:
        f.write(stream)
    best, _ = _time_best(lambda: subprocess.run(
        [ORACLE, "-hide_banner", "-loglevel", "error", "-flags", "unaligned",
         "-f", "vvc", "-i", bit, "-f", "rawvideo", "-y", yuv], check=True),
        n=n)
    with open(yuv, "rb") as f:
        ref_yuv = f.read()
    return n_frames / best, ref_yuv


def _paired_vs_oracle(fn, stream, n_frames, tmp, reps=3):
    """Interleave (ours, oracle) timing pairs and report the MEDIAN
    per-pair ratio — matched measurement windows cancel the shared
    host's common-mode load (same rationale as the scaling leg).
    Returns (ours_fps_best, ratio_median, ref_yuv, ours_output)."""
    import statistics
    ratios = []
    ours_best = None
    out = None
    ref_yuv = None
    for _ in range(reps):
        d_ours, out = _time_best(fn, n=1)
        if os.path.exists(ORACLE):
            ref_fps, ref_yuv = _oracle_fps(stream, n_frames, tmp=tmp, n=1)
            if ref_fps:
                ratios.append((n_frames / d_ours) / ref_fps)
        ours_best = d_ours if ours_best is None or d_ours < ours_best \
            else ours_best
    ratio = statistics.median(ratios) if ratios else 0.0
    return n_frames / ours_best, ratio, ref_yuv, out


def main():
    from tools.forge import (forge_tools_stream, forge_hier_stream,
                             forge_scaling_stream)
    from ffvvc_jax.decoder import VVCDecoder
    from ffvvc_jax.config import DecoderConfig
    from ffvvc_jax.pipeline import decode_parallel

    w, h = (int(v) for v in os.environ.get(
        "FFVVC_BENCH_SIZE", "1920x1080").split("x"))
    n_frames = int(os.environ.get("FFVVC_BENCH_FRAMES", "4"))
    qp = int(os.environ.get("FFVVC_BENCH_QP", "30"))
    workers = int(os.environ.get("FFVVC_BENCH_WORKERS", os.cpu_count() or 1))
    quick = os.environ.get("FFVVC_BENCH_QUICK") == "1"

    # --- primary: all-intra 10-bit ISP+MIP+MRL+LFNST+MTS (BASELINE.md) ----
    stream = _cached_stream(
        f"tools10:{w}x{h}:{n_frames}:{qp}",
        lambda: forge_tools_stream(seed=0, width=w, height=h, qp=qp,
                                   bit_depth=10, nframes=n_frames))
    yuvs = decode_parallel(stream, workers=workers)      # warm libs/pool
    ours_fps, vs_baseline, ref_yuv, yuvs = _paired_vs_oracle(
        lambda: decode_parallel(stream, workers=workers),
        stream, len(yuvs), "/tmp/bench", reps=5)
    ours_yuv = b"".join(yuvs)
    if ref_yuv is not None:
        assert ref_yuv == ours_yuv, "bench decode NOT bit-exact vs oracle"

    extra = {}
    if not quick:
        # --- scaling efficiency: 1 vs N workers (multi-IDR stream).
        # Both runs disable the in-worker frame pipeline so the metric
        # isolates the GOP axis (the axis that scales across hosts, where
        # each worker owns its cores); with pipelining on, a 1-worker run
        # already uses 2 threads and the N-worker run can't show the
        # cross-host headroom on this single oversubscribed box.
        # stage_threads=1 on BOTH legs: GOP workers pin it (pipeline.py)
        # and the 1-worker run decodes in-process, where auto stage threads
        # would otherwise use every core — the metric is per-core GOP-axis
        # scaling, not intra-frame threading
        # The bench host load swings +/-40%: measure the legs as
        # INTERLEAVED (t1, tn) pairs and report the median per-pair ratio
        # — matched measurement windows cancel common-mode load, and the
        # median resists outlier draws in either direction.
        if workers > 1:
            import statistics
            # the BASELINE-named scaling stream (BASELINE.md:26): multi-
            # IDR RA segments at UHD with 2 subpictures over a 2x2 tile
            # grid, one rect slice per subpic — GOP decode shards the
            # segments across workers/hosts.  8K via
            # FFVVC_BENCH_SCALING_SIZE=7680x4320.
            sw, sh_ = (int(v) for v in os.environ.get(
                "FFVVC_BENCH_SCALING_SIZE", "3840x2160").split("x"))
            scal = _cached_stream(
                f"scaling10:{sw}x{sh_}:4",
                lambda: forge_scaling_stream(seed=0, width=sw, height=sh_,
                                             qp=37, bit_depth=10,
                                             nframes=4))
            # parse_workers=1 on BOTH legs (auto would hand the 1-worker
            # leg every core for threaded entry-point parse); the 1-worker
            # leg runs through the same pool + shm transport (force_pool)
            # so the ratio isolates the GOP axis, not the IPC machinery
            nopipe = DecoderConfig(pipeline_frames=False, stage_threads=1,
                                   parse_workers=1)
            decode_parallel(scal, workers=workers, config=nopipe)
            decode_parallel(scal, workers=1, config=nopipe, force_pool=True)
            ratios = []
            for _ in range(5):
                d1, _o = _time_best(lambda: decode_parallel(
                    scal, workers=1, config=nopipe, force_pool=True), n=1)
                dn, _o = _time_best(lambda: decode_parallel(
                    scal, workers=workers, config=nopipe), n=1)
                ratios.append(d1 / (workers * dn))
            extra["scaling_efficiency"] = round(statistics.median(ratios), 4)
            extra["scaling_workers"] = workers
            extra["scaling_stream"] = f"{sw}x{sh_}_subpic_tiles"

        # --- random access: hier-GOP 10-bit DMVR/BDOF + affine.  Two
        # IDR-led random-access segments (RA = periodic RAPs), so both the
        # GOP workers and the in-worker frame pipeline engage — the same
        # axes the reference's frame threading exploits
        def _forge_ra():
            kw = dict(width=w, height=h, qp=qp, bit_depth=10, ngops=2,
                      deblock=True, sps_affine_enabled_flag=1,
                      sps_five_minus_max_num_subblock_merge_cand=0,
                      sps_6param_affine_enabled_flag=1,
                      sps_affine_prof_enabled_flag=1,
                      sps_temporal_mvp_enabled_flag=1,
                      sps_bdof_enabled_flag=1, sps_dmvr_enabled_flag=1)
            return forge_hier_stream(seed=0, **kw) + \
                forge_hier_stream(seed=1, **kw)
        ra = _cached_stream(f"ra10v2:{w}x{h}:{qp}", _forge_ra)
        dec_cfg = DecoderConfig()
        yuvs_ra = decode_parallel(ra, workers=workers, config=dec_cfg)
        ra_fps, ra_ratio, ref_ra_yuv, yuvs_ra = _paired_vs_oracle(
            lambda: decode_parallel(ra, workers=workers, config=dec_cfg),
            ra, len(yuvs_ra), "/tmp/bench_ra", reps=5)
        if ref_ra_yuv is not None:
            assert ref_ra_yuv == b"".join(yuvs_ra), \
                "RA bench decode NOT bit-exact vs oracle"
        extra["ra_fps"] = round(ra_fps, 4)
        extra["ra_vs_baseline"] = round(ra_ratio, 4)

        # --- 4K random access, full loop-filter chain (BASELINE.md row):
        # measure-and-report config; reps=3 interleaved pairs so the
        # median ratio resists the shared host's +/-40% load swings
        if os.environ.get("FFVVC_BENCH_4K", "1") == "1":
            uhd = _cached_stream(
                "uhd_ra10", lambda: forge_hier_stream(
                    seed=0, width=3840, height=2160, qp=32, bit_depth=10,
                    ngops=1, deblock=True, sps_sao_enabled_flag=1,
                    sps_alf_enabled_flag=1, sps_ccalf_enabled_flag=1,
                    sps_lmcs_enabled_flag=1,
                    sps_temporal_mvp_enabled_flag=1,
                    sps_bdof_enabled_flag=1, sps_dmvr_enabled_flag=1))
            yuvs_4k = decode_parallel(uhd, workers=workers)
            fps_4k, r_4k, ref_4k, yuvs_4k = _paired_vs_oracle(
                lambda: decode_parallel(uhd, workers=workers),
                uhd, len(yuvs_4k), "/tmp/bench_4k", reps=3)
            if ref_4k is not None:
                assert ref_4k == b"".join(yuvs_4k), \
                    "4K bench decode NOT bit-exact vs oracle"
            extra["uhd_ra_fps"] = round(fps_4k, 4)
            extra["uhd_ra_vs_baseline"] = round(r_4k, 4)

        # --- device pixel path: the fused device chain on a filter-heavy
        # 1080p all-intra stream, bit-exact vs the oracle.  The child
        # process owns the card; this process never opens it.
        dev_timeout = int(os.environ.get("FFVVC_BENCH_DEVICE_TIMEOUT",
                                         "900"))
        devstream = _cached_stream(
            f"toolsf10:{w}x{h}:4:{qp}",
            lambda: forge_tools_stream(seed=0, width=w, height=h, qp=qp,
                                       bit_depth=10, nframes=4,
                                       sps_sao_enabled_flag=1,
                                       sps_alf_enabled_flag=1,
                                       sps_ccalf_enabled_flag=1,
                                       sps_lmcs_enabled_flag=1))
        ref_dev_fps, ref_dev_yuv = _oracle_fps(devstream, 4,
                                               tmp="/tmp/bench_dev")
        prog = (
            "import sys, time, os, json\n"
            "sys.path.insert(0, %r)\n"
            "from ffvvc_jax.decoder import VVCDecoder\n"
            "from ffvvc_jax.config import DecoderConfig\n"
            "s = open(sys.argv[1], 'rb').read()\n"
            # the fused device-resident chain (ops/fused_device.py): one
            # jitted LMCS/deblock/SAO/ALF/CC-ALF launch per frame, planes
            # up once / down once — transfer bytes measured and printed
            "cfg = DecoderConfig(device_pipeline=True)\n"
            "VVCDecoder(cfg).decode(s)\n"          # warm compiles
            "from ffvvc_jax.ops import fused_device as fd\n"
            "fd.reset_stats()\n"
            "t0 = time.monotonic()\n"
            "frames = VVCDecoder(cfg).decode(s)\n"
            "best = time.monotonic() - t0\n"
            "import hashlib\n"
            "yuv = b''.join(f.to_yuv_bytes() for f in frames)\n"
            # device-intra PLANNER time at 1080p (C plan walk + vectorized
            # bucket build; plan-only mode consumes no state, decode
            # falls through to the host recon)
            "from ffvvc_jax.ops import intra_device as idv\n"
            "os.environ['FFVVC_INTRA_PLAN_ONLY'] = '1'\n"
            "idv.last_plan_s = -1.0\n"
            "VVCDecoder(DecoderConfig(device_intra=True)).decode(s)\n"
            "del os.environ['FFVVC_INTRA_PLAN_ONLY']\n"
            "n = max(1, fd.stats['frames'])\n"
            "print(json.dumps({'fps': len(frames) / best,\n"
            "                  'md5': hashlib.md5(yuv).hexdigest(),\n"
            "                  'fused_frames': fd.stats['frames'],\n"
            "                  'up_MB_per_frame':\n"
            "                      round(fd.stats['up_bytes'] / n / 1e6, 3),\n"
            "                  'down_MB_per_frame':\n"
            "                      round(fd.stats['down_bytes'] / n / 1e6,\n"
            "                            3),\n"
            "                  'intra_plan_ms':\n"
            "                      round(idv.last_plan_s * 1e3, 2)}))\n"
        ) % os.path.dirname(os.path.abspath(__file__))
        with tempfile.NamedTemporaryFile(suffix=".bit") as f:
            f.write(devstream)
            f.flush()
            r = subprocess.run([sys.executable, "-c", prog, f.name],
                               capture_output=True, text=True,
                               timeout=dev_timeout)
        if r.returncode != 0:
            sys.stderr.write(r.stderr)
            raise SystemExit(f"device leg failed (exit {r.returncode})")
        dev = json.loads(r.stdout.strip().splitlines()[-1])
        if ref_dev_yuv is not None:
            assert dev["md5"] == hashlib.md5(ref_dev_yuv).hexdigest(), \
                "device-path decode NOT bit-exact vs oracle"
        extra["device_fps"] = round(dev["fps"], 4)
        for k in ("fused_frames", "up_MB_per_frame", "down_MB_per_frame",
                  "intra_plan_ms"):
            extra[f"device_{k}"] = dev[k]

    print(json.dumps({"metric": "decode_fps", "value": round(ours_fps, 4),
                      "unit": "frames/sec/chip",
                      "vs_baseline": round(vs_baseline, 4),
                      "extra": extra}))


if __name__ == "__main__":
    main()
