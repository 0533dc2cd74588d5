"""CLI decoder: Annex-B .bit in, raw YUV out.

The user-facing equivalent of `ffmpeg -i in.bit -f rawvideo out.yuv`
(reference fftools/ffmpeg_dec.c surface).

    python -m ffvvc_jax.tools.decode in.bit out.yuv [--backend device|golden]
                                     [--no-native-cabac] [--md5]
"""
import argparse
import hashlib
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description="ffvvc_jax VVC decoder")
    ap.add_argument("input", help="Annex-B VVC bitstream (.bit)")
    ap.add_argument("output", nargs="?", help="raw YUV output path")
    ap.add_argument("--backend", choices=("device", "golden"), default="device")
    ap.add_argument("--no-native-cabac", action="store_true")
    ap.add_argument("--md5", action="store_true",
                    help="print per-frame and stream MD5 (framemd5-style)")
    args = ap.parse_args(argv)

    from ffvvc_jax.decoder import VVCDecoder
    from ffvvc_jax.config import DecoderConfig

    with open(args.input, "rb") as f:
        data = f.read()
    cfg = DecoderConfig(backend=args.backend,
                        native_cabac=not args.no_native_cabac)
    t0 = time.monotonic()
    frames = VVCDecoder(cfg).decode(data)
    dt = time.monotonic() - t0

    out = open(args.output, "wb") if args.output else None
    stream_md5 = hashlib.md5()
    for i, fr in enumerate(frames):
        yuv = fr.to_yuv_bytes()
        stream_md5.update(yuv)
        if out:
            out.write(yuv)
        if args.md5:
            print(f"frame {i} poc {fr.poc} md5 "
                  f"{hashlib.md5(yuv).hexdigest()}")
    if out:
        out.close()
    if args.md5:
        print(f"stream md5 {stream_md5.hexdigest()}")
    print(f"{len(frames)} frames in {dt:.2f}s "
          f"({len(frames)/dt:.2f} fps)" if dt > 0 else f"{len(frames)} frames",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
