"""Command-line interface mirroring the reference encoder/decoder, on the card.

Counterpart of the JAX package's cli.py: the same sub-commands, flags,
defaults, output naming and printed lines.  Both precisions run on the CUDA
card (its float64 is IEEE, so exact mode needs no CPU pin); with no GPU the
command fails rather than run on the CPU.

Encoder (reference: parsing_command, enc src:94-165):
  python -m icspcodec_torch.cli encode -i seq_cif.yuv -n 32 -q 16 \\
      [--qpdc 16 --qpac 16 --intraPeriod 10 --precision exact -o out.bin]

Decoder (reference decoder CLI: ./decoder N file.bin QPDC QPAC period orig.yuv):
  python -m icspcodec_torch.cli decode -i file.bin -n 32 [-o out.yuv] \\
      [--orig seq_cif.yuv]   # prints mean Y-PSNR like the reference harness

--gopShards N / --tileShards N split the GOPs / each frame's MB columns over
the first N CUDA devices (codec.encode and codec.decode); from Python,
main(argv, device=[...]) gives the device list, which may name one device
more than once.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np

from .codec import decode, encode, resolve_device
from .config import CodecConfig
from .io import load_yuv420, save_yuv420


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="icspcodec_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    enc = sub.add_parser("encode")
    enc.add_argument("-i", required=True, help="input planar YUV420 file")
    enc.add_argument("-n", type=int, required=True, help="number of frames")
    enc.add_argument("-q", type=int, default=None, help="QP for both DC and AC")
    enc.add_argument("--qpdc", type=int, default=16)
    enc.add_argument("--qpac", type=int, default=16)
    enc.add_argument("--intraPeriod", type=int, default=0)
    enc.add_argument("--width", type=int, default=352)
    enc.add_argument("--height", type=int, default=288)
    enc.add_argument("--precision", choices=["exact", "fast"], default="exact")
    enc.add_argument(
        "--gopShards", type=int, default=1,
        help="split the closed GOPs over this many devices (the --EnMultiThread "
             "analog, enc src:150-157); bytes identical at any count",
    )
    enc.add_argument(
        "--tileShards", type=int, default=1,
        help="split each frame's MB columns over this many devices, with halo "
             "exchange at the seams; must divide width/16; bytes identical",
    )
    enc.add_argument(
        "--entropy", choices=["auto", "device", "host"], default="auto",
        help="where entropy coding + bit packing run: on the card (only "
             "packed frames cross to the host; with shards, on the first "
             "device of the list) or on the host; bytes identical either way",
    )
    enc.add_argument("-o", default=None, help="output bitstream path")
    enc.add_argument("--recon", default=None, help="write recon YUV here")

    dec = sub.add_parser("decode")
    dec.add_argument("-i", required=True, help="input bitstream")
    dec.add_argument("-n", type=int, required=True)
    dec.add_argument("-o", default=None, help="output YUV path")
    dec.add_argument("--orig", default=None, help="original YUV for PSNR")
    dec.add_argument("--precision", choices=["exact", "fast"], default="exact")
    dec.add_argument("--gopShards", type=int, default=1,
                     help="split the GOPs over this many devices; planes identical")
    dec.add_argument("--tileShards", type=int, default=1,
                     help="split each frame's MB columns over this many devices; planes "
                          "identical")
    return ap


def main(argv=None, device=None):
    """Run one sub-command.  device: where to run, as codec.encode takes it;
    None means the CUDA card (every CUDA device with --gopShards or
    --tileShards above 1), and raises when there is none; a list of devices
    is the shard list."""
    args = _parser().parse_args(argv)
    sharded = args.gopShards > 1 or args.tileShards > 1
    dev = device if sharded else resolve_device(device)
    if args.cmd == "encode":
        qdc = args.q if args.q is not None else args.qpdc
        qac = args.q if args.q is not None else args.qpac
        cfg = CodecConfig(
            width=args.width, height=args.height, qp_dc=qdc, qp_ac=qac,
            intra_period=args.intraPeriod, precision=args.precision,
            gop_shards=args.gopShards, tile_shards=args.tileShards,
            entropy=args.entropy,
        )
        y, cb, cr = load_yuv420(args.i, cfg.width, cfg.height, args.n)
        t0 = time.time()
        bits, rec = encode(y, cb, cr, cfg, return_recon=args.recon is not None, device=dev)
        dt = time.time() - t0
        prefix = os.path.basename(args.i).split("_")[0]
        out = args.o or f"{prefix}_compCIF_{qdc}_{qac}_{args.intraPeriod}.bin"
        with open(out, "wb") as f:
            f.write(bits)
        if args.recon:
            save_yuv420(args.recon, rec["y"], rec["cb"], rec["cr"])
        print(
            f"encoded {args.n} frames -> {out} ({len(bits)} bytes) "
            f"in {dt:.2f}s ({args.n / dt:.1f} frames/s)"
        )
    else:
        with open(args.i, "rb") as f:
            data = f.read()
        t0 = time.time()
        out = decode(data, args.n, precision=args.precision, device=dev,
                     gop_shards=args.gopShards, tile_shards=args.tileShards)
        dt = time.time() - t0
        print(f"decoded {args.n} frames in {dt:.2f}s ({args.n / dt:.1f} frames/s)")
        if args.o:
            save_yuv420(args.o, out["y"], out["cb"], out["cr"])
        if args.orig:
            h, w = out["y"].shape[1:]
            oy, _, _ = load_yuv420(args.orig, w, h, args.n)
            mse = ((out["y"].astype(np.float64) - oy) ** 2).mean(axis=(1, 2))
            psnr = (20 * np.log10(255.0 / np.sqrt(mse))).mean()
            print(f"mean Y-PSNR: {psnr:.4f} dB")


if __name__ == "__main__":
    main()
