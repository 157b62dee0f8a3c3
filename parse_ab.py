#!/usr/bin/env python3
"""Parse times of the CIF300 decodes' streams for two checkouts of the port, in one call.

    python3 parse_ab.py OTHER_CHECKOUT [--out FILE]

Encodes 300 CIF frames of benchA (tools/make_content.py) on the card with
this checkout, fast, QP 16/16, all-intra and at intra period 10 (the
streams that chip_smoke.py's phases 7 and 12 decode).  Then times
runtime.parse_body of this checkout and of the other one (imported under
another package name, so that it builds its own parser into its own
build/) on each stream, in pairs of calls in one process, the order
alternating from pair to pair, so that the host's drift over the call
falls on both alike: one warm-up call each, then PAIRS pairs on the wall
clock (the parser is host C and runs nothing on the card).  Reports each
parser's median, quartiles and minimum, the share of pairs this checkout's
call was the faster, and the sha256 of the symbols each returned.  Prints
the card's name and power limit, then one JSON line; --out also writes
that line to FILE.  Needs one CUDA card, for the encode.
"""
from __future__ import annotations

import argparse
import hashlib
import importlib
import importlib.util
import json
import pathlib
import statistics
import subprocess
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
PAIRS = 40
STREAMS = {"all_intra": 0, "period10": 10}   # name: intra period


def _load(name: str, path: pathlib.Path):
    """Import the file at path as module name (a package for an __init__.py)."""
    spec = importlib.util.spec_from_file_location(
        name, path, submodule_search_locations=[str(path.parent)] if path.stem == "__init__"
        else None)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _digest(syms: dict) -> str:
    h = hashlib.sha256()
    for k in sorted(syms):
        h.update(syms[k].tobytes())
    return h.hexdigest()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=pathlib.Path)
    ap.add_argument("--out", type=pathlib.Path)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("parse_ab: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    from icspcodec_torch import codec
    from icspcodec_torch.config import CodecConfig
    from icspcodec_torch.runtime import parse_body

    other = args.other.resolve()
    _load("icspcodec_torch_other", other / "icspcodec_torch" / "__init__.py")
    parsers = {"this": parse_body,
               "other": importlib.import_module("icspcodec_torch_other.runtime").parse_body}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    cs = _load("chip_smoke_helpers", HERE / "chip_smoke.py")
    y, cb, cr = cs.cif_content(cs.NF)
    res = {"card": smi, "this": str(HERE), "other": str(other), "pairs": PAIRS}
    for name, period in STREAMS.items():
        cfg = CodecConfig(width=cs.W, height=cs.H, qp_dc=16, qp_ac=16, intra_period=period,
                          precision="fast")
        body = codec.encode(y, cb, cr, cfg, return_recon=False)[0][14:]
        ms = {k: [] for k in parsers}
        out = {k: _digest(fn(body, cs.NF, cs.H, cs.W, period)) for k, fn in parsers.items()}
        for i in range(PAIRS):
            for k in ("this", "other") if i % 2 else ("other", "this"):
                t0 = time.perf_counter()
                parsers[k](body, cs.NF, cs.H, cs.W, period)
                ms[k].append((time.perf_counter() - t0) * 1e3)
        stream = dict(bytes=len(body) + 14, final_byte=body[-1],
                      this_faster_share=sum(a < b for a, b in zip(ms["this"], ms["other"]))
                      / PAIRS)
        for k, v in ms.items():
            q = statistics.quantiles(v, n=4)
            stream[k] = dict(parse_ms_median=statistics.median(v), parse_ms_q1=q[0],
                             parse_ms_q3=q[2], parse_ms_min=min(v), symbols_sha256=out[k])
        res[name] = stream
    line = json.dumps(res)
    print(smi)
    print(line)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
