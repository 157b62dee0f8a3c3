#!/usr/bin/env python3
"""How often the port's parser reads a noisy stream's tail right, on the CPU.

    python3 tools/torch_stream_tail_rates.py [--checkout DIR]

Encodes three seeded sets of 5 frames of 64x96 with icspcodec_torch on the
CPU (codec.encode_symbols, then the writer: chip_smoke.tail_stream) and
parses each stream with runtime.parse_body (chip_smoke.tail_verdict).  Each
stream is "right" (the writer's symbols), "ambiguous" (refused: two readings
of the final byte fit with different symbols), "raised" (another
ValueError) or "wrong" (other symbols, no error).  The sets:

  A  240 fast streams: seeds 0-39, uniform noise (even seeds) or a gradient
     plus noise of sigma 20 (odd), QP 8/16, 16/16 and 1/1, period 0 and 3
  B  180 fast streams: a gradient plus noise of sigma 3, seeds 0-29, QP
     1/1, 8/8 and 16/16, period 0 and 3
  C  96 streams of uniform noise: seeds 0-23, exact and fast, QP 8/16 (even
     seeds) or 16/16 (odd), period 0 and 3

--checkout imports icspcodec_torch from another checkout (an older parser,
for example); the content and the classification are this checkout's.
Prints one JSON line of the counts and the streams that were not right.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parents[1]


def sets():
    for seed in range(40):
        kind = "noise" if seed % 2 == 0 else "gradient"
        for q in ((8, 16), (16, 16), (1, 1)):
            for period in (0, 3):
                yield "A", kind, 20.0, seed, "fast", q, period
    for seed in range(30):
        for q in ((1, 1), (8, 8), (16, 16)):
            for period in (0, 3):
                yield "B", "gradient", 3.0, seed, "fast", q, period
    for seed in range(24):
        for precision in ("exact", "fast"):
            for period in (0, 3):
                yield "C", "noise", 0.0, seed, precision, ((8, 16), (16, 16))[seed % 2], period


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkout", type=pathlib.Path, default=HERE)
    args = ap.parse_args()
    sys.path.insert(0, str(args.checkout.resolve()))
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import icspcodec_torch
    from icspcodec_torch.config import CodecConfig

    f, h, w = (cs.TAIL_SHAPE[k] for k in ("nframes", "height", "width"))
    counts, odd = {}, []
    for name, kind, sigma, seed, precision, (qdc, qac), period in sets():
        cfg = CodecConfig(width=w, height=h, qp_dc=qdc, qp_ac=qac, intra_period=period,
                          precision=precision)
        planes = cs.tail_content(kind, seed, sigma=sigma)
        bits, want, nbits, _ = cs.tail_stream(*planes, cfg, "cpu")
        verdict = cs.tail_verdict(bits, want, nbits, f, period)
        counts.setdefault(name, {}).setdefault(verdict, 0)
        counts[name][verdict] += 1
        if verdict != "right":
            odd.append([name, kind, seed, precision, qdc, qac, period, verdict, bits[-1],
                        nbits % 8])
    print(json.dumps({"package": str(pathlib.Path(icspcodec_torch.__file__).parent),
                      "counts": counts, "not_right": odd}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
