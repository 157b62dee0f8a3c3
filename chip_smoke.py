#!/usr/bin/env python3
"""Smoke run of the PyTorch port (icspcodec_torch) on one CUDA card.

    python3 chip_smoke.py

Builds the CUDA kernels from csrc/, holds each against its plain PyTorch
version on the card, drives the all-intra CIF300 encode (the codec's main
path) through codec.encode, and checks an exact-mode bitstream against a
sha256 that tests/test_torch_codec.py pins to the JAX package's output.
Phases, each of which fails the run:

  1. build    nvcc builds every kernel, all sources at once
  2. kernel B forward DC chain vs plain: CIF chroma grid, F=600, qstep 16
              and 1, float32 and float64, bit-identical
  3. kernel A intra luma wavefront vs plain: float64 at CIF, 8 frames,
              QP 16/16 and 1/1, bit-identical; float32 at CIF300, QP 16/16,
              at most 0.1% of symbols differing, |dPSNR-Y| <= 0.05 dB in
              every frame and bitstream size within 0.5%.  TF32 is on, as
              a caller may have it: the fast transforms on the card must
              still agree with the CPU's within 2e-5 of their largest
              value (float32 reordering; TF32 would err by ~5e-4)
  4. encode   codec.encode of CIF300, fast mode, through both kernels
              (launch counters), timed with CUDA events after a warm-up
  5. xcheck   exact-mode encode of a seeded 2x64x96 input: sha256 of the
              stream equals XCHECK_SHA256; exact CIF encode of 4 frames
              gives the same bytes and recon on the card and the CPU

Prints a JSON `kernels` line, the card's name and power limit, and as its
last line {"ok": true, "device": {...}}.  Exits non-zero, printing no
result, without a CUDA device.
"""
from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import time

import numpy as np

W, H, NF = 352, 288, 300
PEAK_BYTES_S = 3.35e12        # H100 SXM HBM3
PEAK_F32_FLOP_S = 67e12       # H100 SXM float32, outside the tensor cores
XCHECK_CFG = dict(width=96, height=64, qp_dc=8, qp_ac=16, precision="exact")
XCHECK_SHA256 = "08ece079fe3b9aa18c9654c2066c7f422a57f3fdec12f4f1559c49e8e50b3413"


def xcheck_input():
    """The seeded input of the cross-implementation byte check."""
    rng = np.random.default_rng(0)
    y = rng.integers(0, 256, (2, 64, 96), dtype=np.uint8)
    cb = rng.integers(0, 256, (2, 32, 48), dtype=np.uint8)
    cr = rng.integers(0, 256, (2, 32, 48), dtype=np.uint8)
    return y, cb, cr


def cif_content(nframes: int):
    """The bench's benchA CIF sequence as (y, cb, cr) uint8 arrays."""
    from tools.make_content import synth_sequence

    raw = synth_sequence("benchA", nframes).reshape(nframes, -1).copy()
    y = raw[:, : W * H].reshape(nframes, H, W)
    cb = raw[:, W * H: W * H * 5 // 4].reshape(nframes, H // 2, W // 2)
    cr = raw[:, W * H * 5 // 4:].reshape(nframes, H // 2, W // 2)
    return y, cb, cr


def psnr_frames(a, b) -> np.ndarray:
    mse = ((a.astype(np.float64) - b.astype(np.float64)) ** 2).mean(axis=(-2, -1))
    return 20 * np.log10(255.0 / np.sqrt(np.maximum(mse, 1e-12)))


def psnr(a, b) -> float:
    return float(psnr_frames(a, b).mean())


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def event_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean ms per call of fn() over `reps` calls, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def max_abs(a, b) -> int:
    """Largest absolute difference of two integer tensors."""
    import torch

    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) if a.numel() else 0


def profile_encode(fn, wall_ms: float) -> dict:
    """torch.profiler over one call: the time of the device-side events
    (kernels and copies; CUPTI's own buffer requests left out), its share of
    the unprofiled wall time wall_ms, and the top device events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(((e.self_device_time_total / 1e3, e.key, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
                   and not e.key.startswith("Activity Buffer")), reverse=True)
    busy = sum(r[0] for r in rows)
    return dict(device_ms=busy, busy_share=busy / wall_ms if rows else None,
                top=[dict(ms=t, name=n[:70], calls=c) for t, n, c in rows[:10]])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 1
    # a caller may have TF32 on; the fast path must not depend on it
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True

    from icspcodec_torch import codec
    from icspcodec_torch.bitstream_device import frame_items_dev
    from icspcodec_torch.config import CodecConfig
    from icspcodec_torch.constants import COS_DEC
    from icspcodec_torch.engine.intra import encode_chroma_batch, to_blocks
    from icspcodec_torch.ops import _build, dc_fused, intra_fused
    from icspcodec_torch.ops.transforms import fdct, idct

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([_build.nvcc(), "--version"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, torch's cuda "
          f"{torch.version.cuda}, nvcc: {nvcc}; on {smi}", flush=True)

    # ---- 1. build ---------------------------------------------------------
    t0 = time.time()
    logs = _build.build(["intra_luma", "dc_dpcm"])
    for name, log in logs.items():
        print(f"[build {name}]\n{log.strip()}")
    print(f"build: {time.time() - t0:.1f} s", flush=True)

    y, cb, cr = cif_content(NF)
    yt = torch.from_numpy(y).to(dev)
    ct = torch.from_numpy(np.concatenate([cb, cr])).to(dev)
    err_a = err_b = 0  # largest |kernel - plain| over every comparison

    # ---- 2. kernel B vs plain ---------------------------------------------
    for dtype in (torch.float32, torch.float64):
        dc = fdct(to_blocks(ct).to(torch.int32), dtype=dtype)[..., 0, 0].contiguous()
        for qstep in (16, 1):
            qk, dqk = dc_fused.dc_dpcm_fused(dc, qstep, chroma=True)
            qp, dqp = dc_fused.dc_dpcm_plain(dc, qstep, chroma=True)
            err = max(max_abs(qk, qp), max_abs(dqk, dqp))
            err_b = max(err_b, err)
            check(err == 0, f"kernel B {dtype} qstep {qstep}: differs from plain by {err}")
            print(f"kernel B {str(dtype)[6:]} qstep {qstep}: bit-identical "
                  f"({dc.shape[0]} planes)", flush=True)
    dc32 = fdct(to_blocks(ct).to(torch.int32), dtype=torch.float32)[..., 0, 0].contiguous()

    # ---- 3. kernel A vs plain ---------------------------------------------
    # its plain version's fast transforms, card against CPU, with TF32 on
    tb = to_blocks(ct[:8]).to(torch.int32) - 128
    terr = 0.0
    for fn in (lambda b: fdct(b, dtype=torch.float32),
               lambda b: idct(b * 16, COS_DEC, dtype=torch.float32)):
        ref = fn(tb.cpu())
        terr = max(terr, float((fn(tb).cpu() - ref).abs().max() / ref.abs().max()))
    check(terr <= 2e-5, f"fast transforms with TF32 on: card differs from CPU by {terr}")
    print(f"fast transforms with TF32 on: card within {terr} (relative) of the CPU",
          flush=True)

    keys =("scan", "mpm", "mode_bit", "acflag", "recon_plane")
    o8 = to_blocks(yt[:8])
    for qdc, qac in ((16, 16), (1, 1)):
        k = intra_fused.intra_luma_scan_fused(o8, qdc, qac, dtype=torch.float64,
                                              recon_plane=True)
        p = intra_fused.intra_luma_scan_plain(o8, qdc, qac, dtype=torch.float64,
                                              recon_plane=True)
        err = max(max_abs(k[n], p[n]) for n in keys)
        check(err == 0, f"kernel A float64 QP {qdc}/{qac}: differs from plain by {err}")
        print(f"kernel A float64 QP {qdc}/{qac}: bit-identical (8 CIF frames)", flush=True)

    oy = to_blocks(yt)
    k = intra_fused.intra_luma_scan_fused(oy, 16, 16, dtype=torch.float32, recon_plane=True)
    p = intra_fused.intra_luma_scan_plain(oy, 16, 16, dtype=torch.float32, recon_plane=True)
    err_a = max(max_abs(k[n], p[n]) for n in keys)
    ndiff = int((k["scan"] != p["scan"]).sum())
    frames = int((k["scan"] != p["scan"]).flatten(1).any(1).sum())
    dpf = (psnr_frames(k["recon_plane"].cpu().numpy(), y)
           - psnr_frames(p["recon_plane"].cpu().numpy(), y))
    dpsnr, dpsnr_max = float(dpf.mean()), float(np.abs(dpf).max())
    chroma = encode_chroma_batch(ct, 16, 16, dtype=torch.float32)

    def stream_bits(lum):
        syms = dict(y_scan=lum["scan"], y_acflag=lum["acflag"], mpm=lum["mpm"],
                    mode_bit=lum["mode_bit"])
        for i, name in enumerate(("cb", "cr")):
            syms[f"{name}_scan"] = chroma["scan"][i * NF:(i + 1) * NF]
            syms[f"{name}_acflag"] = chroma["acflag"][i * NF:(i + 1) * NF]
        return int(frame_items_dev(syms)[1].sum(dtype=torch.int64))

    bk, bp = stream_bits(k), stream_bits(p)
    dsize = abs(bk - bp) / bp
    a32 = dict(symbols_differing=ndiff, symbols=k["scan"].numel(), frames_affected=frames,
               dpsnr_y_db=dpsnr, dpsnr_y_db_worst_frame=dpsnr_max, bits_kernel=bk,
               bits_plain=bp, size_rel_diff=dsize)
    print("kernel A float32 CIF300 vs plain: " + json.dumps(a32), flush=True)
    check(ndiff <= 0.001 * a32["symbols"],
          f"kernel A float32: {ndiff} of {a32['symbols']} symbols differ (> 0.1%)")
    check(dpsnr_max <= 0.05, f"kernel A float32: a frame's |dPSNR-Y| {dpsnr_max} > 0.05 dB")
    check(dsize <= 0.005, f"kernel A float32: stream size differs by {dsize:.4%}")
    del k, p, chroma

    # other frame sizes (QCIF, 720p): float64 bit-identical, the kernels'
    # shared-memory sizing and diagonal bounds at other grids
    for w, h in ((176, 144), (1280, 720)):
        rng = np.random.default_rng(w)
        o = to_blocks(torch.from_numpy(rng.integers(0, 256, (2, h, w), dtype=np.uint8)).to(dev))
        k = intra_fused.intra_luma_scan_fused(o, 8, 16, dtype=torch.float64, recon_plane=True)
        p = intra_fused.intra_luma_scan_plain(o, 8, 16, dtype=torch.float64, recon_plane=True)
        err = max(max_abs(k[n], p[n]) for n in keys)
        check(err == 0, f"kernel A float64 at {w}x{h}: differs from plain by {err}")
        dc = torch.from_numpy(rng.normal(1024, 400, (3, h // 8, w // 8))).to(dev)
        errb = max(max_abs(a, b) for a, b in zip(dc_fused.dc_dpcm_fused(dc, 7, chroma=False),
                                                 dc_fused.dc_dpcm_plain(dc, 7, chroma=False)))
        check(errb == 0, f"kernel B (luma kinds) at {w}x{h}: differs from plain by {errb}")
        print(f"kernels A and B float64 at {w}x{h}: bit-identical", flush=True)

    # ---- 4. end to end: the main path -------------------------------------
    cfg = CodecConfig(width=W, height=H, qp_dc=16, qp_ac=16, precision="fast")
    intra_fused.launches = dc_fused.launches = 0
    bits, rec = codec.encode(y, cb, cr, cfg)
    torch.cuda.synchronize()
    launches = {"A": intra_fused.launches, "B": dc_fused.launches}
    check(launches["A"] >= 1 and launches["B"] >= 1,
          f"the encode did not launch both kernels: {launches}")
    check(rec["y"].shape == y.shape and len(bits) > 14, "encode output has the wrong shape")
    psnr_y = psnr(rec["y"], y)
    check(np.isfinite(psnr_y) and psnr_y > 30, f"encode PSNR-Y {psnr_y} dB is implausible")
    enc_ms = event_ms(lambda: codec.encode(y, cb, cr, cfg), reps=3, warmup=0)
    e2e = dict(frames=NF, bytes=len(bits), psnr_y_db=psnr_y, encode_ms=enc_ms,
               encode_fps=NF / (enc_ms / 1e3), launches=launches)
    print("encode CIF300 fast: " + json.dumps(e2e), flush=True)
    print("device time by kernel in one encode: " + json.dumps(profile_encode(
        lambda: codec.encode(y, cb, cr, cfg), enc_ms)), flush=True)

    # where the encode's time goes, stage by stage (events, after the warm-up)
    from icspcodec_torch.codec import _INTRA_KEYS, _pack_bucketed
    from icspcodec_torch.engine.intra import encode_intra_frames
    cbt, crt = torch.from_numpy(cb).to(dev), torch.from_numpy(cr).to(dev)
    st = {}
    st["upload_ms"] = event_ms(lambda: [torch.from_numpy(a).to(dev) for a in (y, cb, cr)], 3)
    st["engine_ms"] = event_ms(lambda: encode_intra_frames(yt, cbt, crt, 16, 16,
                                                           dtype=torch.float32), 3)
    out = encode_intra_frames(yt, cbt, crt, 16, 16, dtype=torch.float32)
    syms = {n: out[n] for n in _INTRA_KEYS}
    st["items_ms"] = event_ms(lambda: frame_items_dev(syms), 3)
    codes, lengths = frame_items_dev(syms)
    st["pack_and_pull_ms"] = event_ms(lambda: _pack_bucketed(codes, lengths), 3)
    st["recon_pull_ms"] = event_ms(lambda: [out[f"recon_{n}"].cpu() for n in ("y", "cb", "cr")], 3)
    st["luma_kernel_ms"] = event_ms(lambda: intra_fused.intra_luma_scan_fused(
        oy, 16, 16, dtype=torch.float32, recon_plane=True), 20)
    st["chroma_chain_ms"] = event_ms(lambda: encode_chroma_batch(ct, 16, 16,
                                                                 dtype=torch.float32), 5)
    print("encode stages (ms): " + json.dumps(st), flush=True)
    del out, syms, codes, lengths

    # kernel and plain-version times at the main path's shapes
    ka_ms = st["luma_kernel_ms"]
    ka64_ms = event_ms(lambda: intra_fused.intra_luma_scan_fused(
        oy, 16, 16, dtype=torch.float64, recon_plane=True), 5)
    pa_ms = event_ms(lambda: intra_fused.intra_luma_scan_plain(
        oy, 16, 16, dtype=torch.float32, recon_plane=True), 1)
    kb_ms = event_ms(lambda: dc_fused.dc_dpcm_fused(dc32, 16, chroma=True), 50)
    pb_ms = event_ms(lambda: dc_fused.dc_dpcm_plain(dc32, 16, chroma=True), 3)

    nblk = oy.shape[0] * oy.shape[1] * oy.shape[2]
    a_bytes = nblk * (64 + 128 + 3 + 64) + 2 * 64 * 64 * 4 + 64 * 4 + 36 * 44 * 4
    # the two transforms in their separable form: 2 passes x 64 outputs x 8
    # multiply-adds each (the kernel's float path spends 4x that, densely)
    a_flops = nblk * 2 * 2 * 64 * 8 * 2
    a_bound = max(a_bytes / PEAK_BYTES_S, a_flops / PEAK_F32_FLOP_S) * 1e3
    ncell = dc32.numel()
    b_bytes = ncell * (4 + 4 + 4) + 18 * 22 * 4
    b_bound = b_bytes / PEAK_BYTES_S * 1e3
    kernels = [
        dict(name="intra_luma_wavefront", route="cuda",
             source="icspcodec_torch/csrc/intra_luma.cu",
             replaces="icspcodec_tpu/ops/pallas_intra.py:160", launches=launches["A"],
             max_abs_err=err_a, ms=ka_ms, plain_ms=pa_ms,
             bound_ms=a_bound,
             bound_by="operations" if a_flops / PEAK_F32_FLOP_S > a_bytes / PEAK_BYTES_S
             else "bytes", library_ms=None,
             check="float64 bit-identical at QP 16/16 and 1/1; float32 "
                   f"{ndiff} of {a32['symbols']} symbols differ, dPSNR-Y {dpsnr:.5f} dB",
             ms_float64=ka64_ms),
        dict(name="dc_dpcm_forward", route="cuda", source="icspcodec_torch/csrc/dc_dpcm.cu",
             replaces="icspcodec_tpu/ops/pallas_dc.py:66", launches=launches["B"],
             max_abs_err=err_b, ms=kb_ms, plain_ms=pb_ms,
             bound_ms=b_bound, bound_by="bytes", library_ms=None,
             check="bit-identical in float32 and float64 at qstep 16 and 1"),
    ]

    # ---- 5. cross-implementation byte check --------------------------------
    xb, _ = codec.encode(*xcheck_input(), CodecConfig(**XCHECK_CFG), return_recon=False)
    digest = hashlib.sha256(xb).hexdigest()
    check(digest == XCHECK_SHA256, f"exact-mode stream sha256 {digest} != {XCHECK_SHA256}")
    print(f"xcheck: exact-mode stream of {len(xb)} bytes matches the pinned sha256", flush=True)
    # and at full width: the card's exact CIF stream equals the CPU's (the
    # plain versions), which the CPU tests hold equal to the JAX package's
    xcfg = CodecConfig(width=W, height=H, qp_dc=8, qp_ac=16, precision="exact")
    bg, rg = codec.encode(y[:4], cb[:4], cr[:4], xcfg)
    bc, rc = codec.encode(y[:4], cb[:4], cr[:4], xcfg, device="cpu")
    check(bg == bc and all(np.array_equal(rg[n], rc[n]) for n in rg),
          "exact-mode CIF stream or recon differs between the card and the CPU")
    print(f"xcheck: exact-mode CIF stream of 4 frames ({len(bg)} bytes) and recon "
          "identical on the card and the CPU", flush=True)

    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
