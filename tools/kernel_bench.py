"""Per-kernel device timings at real frame sizes.

The checkasm `bench_new` analogue (reference tests/checkasm/*.c): random
inputs, best-of-N timing.  Device times wait for the result
(block_until_ready) with the inputs already on the device, so they are
kernel + dispatch time, without transfers.

  * the whole-frame SAO / ALF / CC-ALF passes (`_sao_xla`, `_alf_xla`,
    `_cc_xla`, plain XLA) at 1920x1080 and 3840x2160;
  * the fused post-recon chain (`fused_device._chain`) on the frames of
    chip_smoke.py's 1080p 10-bit all-intra stream (SAO/ALF/CC-ALF/LMCS);
  * the batched MC put against the native C and golden host paths.

Run from the repo root on the machine with the accelerator:

    python tools/kernel_bench.py
"""
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "tools")]


def best_of(fn, reps=5, inner=20):
    best = None
    for _ in range(reps):
        t0 = time.monotonic()
        for _ in range(inner):
            fn()
        dt = (time.monotonic() - t0) / inner
        best = dt if best is None or dt < best else best
    return best


def device_time(fn, *args, **kw):
    """Best-of seconds per call of a jitted fn on device-resident args
    (compiled first)."""
    import jax
    args = [jax.device_put(a) for a in args]
    jax.block_until_ready(fn(*args, **kw))
    return best_of(lambda: jax.block_until_ready(fn(*args, **kw)),
                   reps=5, inner=10)


def bench_filter_twins(sizes=((1920, 1080), (3840, 2160))):
    from ffvvc_jax.ops.sao_device import _sao_xla
    from ffvvc_jax.ops.alf_device import _alf_xla, _cc_xla
    rng = np.random.default_rng(0)
    bd = 10
    mx = (1 << bd) - 1

    def r(lo, hi, *shape):
        return rng.integers(lo, hi, shape).astype(np.int32)

    for W, H in sizes:
        sao = (r(0, mx + 1, H + 2, W + 2), r(0, 3, H, W), r(0, 32, H, W),
               r(-31, 32, 5, H, W), r(0, 2, H, W))
        t = device_time(_sao_xla, *sao, shift=bd - 5, pix_max=mx)
        nbytes = sum(a.nbytes for a in sao) + H * W * 4
        print(f"sao_xla {W}x{H} luma: {t * 1e3:.3f} ms "
              f"({nbytes / t / 1e9:.1f} GB/s of int32 operands)")
        alf = (r(0, mx + 1, H, W), r(0, mx + 1, 12, H, W),
               r(0, mx + 1, 12, H, W), r(-64, 64, 12, H, W),
               r(1, 1 << bd, 12, H, W), r(0, 2, H, W))
        t = device_time(_alf_xla, *alf, pix_max=mx)
        nbytes = sum(a.nbytes for a in alf) + H * W * 4
        print(f"alf_xla {W}x{H} luma: {t * 1e3:.3f} ms "
              f"({nbytes / t / 1e9:.1f} GB/s of int32 operands)")
        Hc, Wc = H // 2, W // 2
        cc = (r(0, mx + 1, Hc, Wc), r(0, mx + 1, Hc, Wc),
              r(0, mx + 1, 7, Hc, Wc), r(-64, 64, 7, Hc, Wc))
        t = device_time(_cc_xla, *cc, half=1 << (bd - 1), pix_max=mx)
        nbytes = sum(a.nbytes for a in cc) + Hc * Wc * 4
        print(f"cc_xla {Wc}x{Hc} chroma: {t * 1e3:.3f} ms "
              f"({nbytes / t / 1e9:.1f} GB/s of int32 operands)")


def bench_fused_chain(stream):
    import jax
    from ffvvc_jax.config import DecoderConfig
    from ffvvc_jax.decoder import VVCDecoder
    from ffvvc_jax.ops import fused_device as fd
    calls = []
    chain = fd._chain

    def capture(meta, arrs):
        calls.append((meta, arrs))
        return chain(meta, arrs)
    fd._chain = capture
    try:
        VVCDecoder(DecoderConfig(device_pipeline=True)).decode(stream)
    finally:
        fd._chain = chain
    for i, (meta, arrs) in enumerate(calls):
        jax.block_until_ready(chain(meta, arrs))
        t = best_of(lambda: jax.block_until_ready(chain(meta, arrs)),
                    reps=5, inner=10)
        print(f"fused chain frame {i}: {t * 1e3:.3f} ms "
              f"on device ({len(arrs)} operands resident)")


def bench_mc(bd=8):
    from ffvvc_jax.inter import InterPredictor
    rng = np.random.default_rng(0)
    plane = rng.integers(0, 1 << bd, (272, 480)).astype(np.int32)
    ip = InterPredictor.__new__(InterPredictor)
    ip.bd = bd
    w = h = 16
    n_blocks = 64
    xs = rng.integers(0, 464 - w, n_blocks)
    ys = rng.integers(0, 256 - h, n_blocks)

    def run_c():
        for b in range(n_blocks):
            ip._mc_put(plane, int(xs[b]), int(ys[b]), 7, 9, w, h, True)

    from ffvvc_jax.native import mc as mcn
    ip._mc_lib = mcn.load_lib()
    t_c = best_of(run_c)
    ip._mc_lib = None
    t_py = best_of(run_c, reps=3, inner=3)
    mp = n_blocks * w * h / 1e6
    print(f"mc_put 8-tap hv {w}x{h}: C {mp/t_c:8.1f} MP/s   "
          f"golden {mp/t_py:8.1f} MP/s   ({t_py/t_c:.0f}x)")

    from ffvvc_jax.ops.mc_device import mc_put_batch
    fx = np.full(n_blocks, 7)
    fy = np.full(n_blocks, 9)
    mc_put_batch(plane, xs, ys, fx, fy, w, h, True, bd)  # compile
    t_dev = best_of(lambda: mc_put_batch(plane, xs, ys, fx, fy, w, h,
                                         True, bd))
    print(f"mc_put 8-tap hv {w}x{h}: device {mp/t_dev:6.1f} MP/s "
          f"(batched, host arrays in and out)")


if __name__ == "__main__":
    import jax
    d = jax.devices()[0]
    print(f"device: {d.platform} {d.device_kind}")
    if d.platform == "gpu":
        print("nvidia-smi: " + subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip())
    import chip_smoke
    bench_filter_twins()
    bench_fused_chain(chip_smoke.forge_streams(
        chip_smoke.WIDTH, chip_smoke.HEIGHT, chip_smoke.STREAM_DIR)["intra"])
    bench_mc()
