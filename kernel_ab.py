#!/usr/bin/env python3
"""Device times of kernels A, B, B' and C for two checkouts of the port, in one call.

    python3 kernel_ab.py OTHER_CHECKOUT [--out FILE]

Runs one process for each of: the other checkout, this one, this one, the
other, so that drift of the card over the call shows in both.  Each process
imports icspcodec_torch from its checkout (which builds its own kernels
into its own build/), makes 300 CIF frames of benchA (tools/make_content.py),
and reads with torch.profiler the device ms per call of kernel A
(intra_luma_scan_fused at QP 16/16, float32 and float64) and of kernel C
(intra_luma_decode_fused of A's float32 symbols, float32 and float64), as
chip_smoke.py's device_profile reads them; and of kernel B' (idc_dpcm_fused)
on three shapes of the decode: the CIF300 chroma batch (600 planes of
18x22, the all-intra decode's one launch) and one P-step's luma (30 planes
of 36x44) and chroma (60 planes of 18x22), the residuals A's float32 DC
symbols times 16; and of kernel B (dc_dpcm_fused at qstep 16, chroma kinds)
on the DCs of the CIF300 chroma planes in float32 and float64 (600 planes of
18x22, the batch of an all-intra chroma chain) and on one P-step's chroma
(the first 60 of those planes, float32).  Prints the card's name and power
limit, then one JSON line of the four runs; --out also writes that line to
FILE.  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent


def _smoke():
    """chip_smoke.py beside this script, for its content and profiler helpers."""
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def child(root: pathlib.Path) -> dict:
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    import icspcodec_torch
    from icspcodec_torch.engine.intra import to_blocks
    from icspcodec_torch.ops import _build, dc_fused, intra_decode_fused, intra_fused
    from icspcodec_torch.ops.transforms import fdct

    pkg = pathlib.Path(icspcodec_torch.__file__).resolve()
    if root not in pkg.parents:
        raise RuntimeError(f"icspcodec_torch came from {pkg}, not from {root}")
    cs = _smoke()
    _build.build(["intra_luma", "intra_decode", "dc_dpcm"])
    dev = torch.device("cuda")
    y, cb, cr = cs.cif_content(cs.NF)
    yt = torch.from_numpy(y).to(dev)
    oy = yt.reshape(cs.NF, cs.H // 8, 8, cs.W // 8, 8).movedim(-3, -2)
    out = {"checkout": str(root)}
    for name, dtype in (("float32", torch.float32), ("float64", torch.float64)):
        out[f"A_{name}_device_ms"] = cs.device_profile(lambda: intra_fused.intra_luma_scan_fused(
            oy, 16, 16, dtype=dtype, recon_plane=True), 5)["device_ms"]
    k = intra_fused.intra_luma_scan_fused(oy, 16, 16, dtype=torch.float32, recon_plane=True)
    for name, dtype in (("float32", torch.float32), ("float64", torch.float64)):
        out[f"C_{name}_device_ms"] = cs.device_profile(
            lambda: intra_decode_fused.intra_luma_decode_fused(
                k["scan"], k["mpm"], k["mode_bit"], 16, 16, dtype=dtype), 5)["device_ms"]
    # B' residuals: DC symbols of A's luma, and of the chroma-sized corners of
    # its planes, times the DC quantizer
    iq_l = k["scan"][..., 0].to(torch.int32) * 16
    iq_c = iq_l[:, :18, :22].repeat(2, 1, 1).contiguous()
    for name, iq, chroma in (("cif300_chroma", iq_c, True), ("p_step_luma", iq_l[:30].contiguous(),
                                                              False),
                             ("p_step_chroma", iq_c[:60].contiguous(), True)):
        out[f"Bi_{name}_device_ms"] = cs.device_profile(
            lambda: dc_fused.idc_dpcm_fused(iq, chroma), 20)["device_ms"]
    # B: the DCs of the CIF300 chroma planes
    ct = to_blocks(torch.from_numpy(np.concatenate([cb, cr])).to(dev)).to(torch.int32)
    for name, dtype, n in (("cif300_chroma_float32", torch.float32, 600),
                           ("cif300_chroma_float64", torch.float64, 600),
                           ("p_step_chroma_float32", torch.float32, 60)):
        dc = fdct(ct[:n], dtype=dtype)[..., 0, 0].contiguous()
        out[f"B_{name}_device_ms"] = cs.device_profile(
            lambda: dc_fused.dc_dpcm_fused(dc, 16, chroma=True), 20)["device_ms"]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=pathlib.Path, nargs="?")
    ap.add_argument("--out", type=pathlib.Path)
    ap.add_argument("--child", type=pathlib.Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        print(json.dumps(child(args.child.resolve())))
        return 0
    if args.other is None:
        ap.error("give the other checkout")
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    runs = []
    for root in (args.other.resolve(), HERE, HERE, args.other.resolve()):
        r = subprocess.run([sys.executable, str(HERE / "kernel_ab.py"), "--child", str(root)],
                           capture_output=True, text=True, timeout=900, cwd=root)
        if r.returncode != 0:
            print(r.stdout[-3000:] + r.stderr[-6000:], file=sys.stderr)
            return 1
        runs.append(json.loads(r.stdout.strip().splitlines()[-1]))
    line = json.dumps({"card": smi, "runs": runs})
    print(smi)
    print(line)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
