#!/usr/bin/env python3
"""Smoke run of the PyTorch port (icspcodec_torch) on one CUDA card.

    python3 chip_smoke.py

Builds the CUDA kernels from csrc/ and the bitstream parser from runtime/,
holds each kernel against its plain PyTorch version on the card, drives the
port's paths through its entry points at CIF300 (the all-intra encode with
codec.encode, the all-intra and the period-10 decode with codec.decode),
and checks exact-mode streams and decoded planes against sha256 digests
that tests/test_torch_codec.py and tests/test_torch_decode.py pin to the
JAX package's output.  Phases, each of which fails the run:

  1. build    nvcc builds every kernel and cc the parser, all at once
  2. kernels B and B' (DC chains) vs plain: forward at the CIF chroma grid,
              F=600, qstep 16 and 1, float32 and float64; inverse at the
              same grid; both at luma kinds at QCIF and 720p; bit-identical
  3. kernel A intra luma wavefront vs plain: float64 at CIF, 8 frames,
              QP 16/16 and 1/1, bit-identical; float32 at CIF300, QP 16/16,
              at most 0.1% of symbols differing, |dPSNR-Y| <= 0.05 dB in
              every frame and bitstream size within 0.5%.  TF32 is on, as
              a caller may have it: the fast transforms on the card must
              still agree with the CPU's within 2e-5 of their largest
              value (float32 reordering; TF32 would err by ~5e-4)
  4. encode   codec.encode of CIF300, fast mode, through kernels A and B
              (launch counters), timed with CUDA events after a warm-up
  5. kernel E motion compensation vs plain at CIF luma and chroma, MVs from
              the 129 union offsets and some leaving the padded frame:
              bit-identical
  6. kernel C intra luma decode vs plain: float64 at CIF (8 frames of the
              phase-4 stream, QP 16/16 and 1/1), QCIF and 720p,
              bit-identical; float32 on the CIF300 stream: at most 0.1% of
              pixels differing, |dPSNR-Y| <= 0.05 dB in every frame
  7. decode   codec.decode of the phase-4 stream (all-intra CIF300, fast)
              through kernels C and B': PSNR-Y within 0.05 dB of the
              encoder's recon; timed, stage by stage
  8. decode   codec.decode of a seeded period-10 CIF300 stream (intra
              frames from the port's encode of benchA, MVs from the union
              offsets, sparse residuals) through C, B' and E; its intra
              frames equal phase 7's; timed, stage by stage
  9. xcheck   exact mode: the encoded stream's sha256 and the decoded
              planes' digests of two small streams equal the pinned JAX
              ones; a CIF encode of 4 frames and a CIF decode of one GOP
              (10 frames) give the same bytes and planes on the card and
              the CPU

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
# sha256 of the exact-mode decoded planes (planes_digest) of the XCHECK
# stream and of inter_xcheck_stream(); tests/test_torch_decode.py pins both
# to the JAX package's decode
XCHECK_DECODE_SHA256 = "7b1d8295e362cc9c21563b908661197647add23507d8d349a8ea199ae0447dac"
INTER_XCHECK = dict(height=64, width=96, qdc=8, qac=16, period=3, nframes=5)
INTER_XCHECK_DECODE_SHA256 = (
    "5f34a468854c263b2230e3423e2bc51c21929f6825f25e6d5ec162ebe76930fb")


def xcheck_input():
    """The seeded input of the cross-implementation byte check."""
    rng = np.random.default_rng(0)
    y = rng.integers(0, 256, (2, 64, 96), dtype=np.uint8)
    cb = rng.integers(0, 256, (2, 32, 48), dtype=np.uint8)
    cr = rng.integers(0, 256, (2, 32, 48), dtype=np.uint8)
    return y, cb, cr


def planes_digest(planes: dict) -> str:
    """sha256 of the y, cb and cr planes' bytes, in that order."""
    h = hashlib.sha256()
    for k in ("y", "cb", "cr"):
        h.update(np.ascontiguousarray(planes[k]).tobytes())
    return h.hexdigest()


def _sparse_scan(rng, shape, share: float, amp: int, dc_amp: int):
    """Seeded coefficient symbols (int16): DC in [-dc_amp, dc_amp], a share
    of the AC in [-amp, amp], some blocks AC-empty; with their AC flags."""
    s = np.where(rng.random(shape + (64,)) < share, rng.integers(-amp, amp + 1, shape + (64,)), 0)
    s[..., 0] = rng.integers(-dc_amp, dc_amp + 1, shape)
    s[rng.random(shape) < 0.3, 1:] = 0
    return s.astype(np.int16), (np.count_nonzero(s[..., 1:], -1) == 0).astype(np.int8)


def seeded_symbols(rng, nframes: int, h: int, w: int, intra: bool, oob_share: float = 0.0):
    """Seeded symbols of nframes frames of h x w (numpy): sparse residuals;
    intra frames get MPM flags and mode bits, inter frames MVs drawn from
    the 129 union offsets (canonical and not), a share `oob_share` of them
    replaced by MVs up to 40 px that leave the padded frame.  Returns
    (symbols, mv or None)."""
    from icspcodec_torch.tables import NEG_UNION

    mbh, mbw = h // 16, w // 16
    syms = {}
    for k, shape in (("y", (nframes, 2 * mbh, 2 * mbw)), ("cb", (nframes, mbh, mbw)),
                     ("cr", (nframes, mbh, mbw))):
        syms[f"{k}_scan"], syms[f"{k}_acflag"] = _sparse_scan(rng, shape, 0.06, 3, 2)
    if intra:
        for k in ("mpm", "mode_bit"):
            syms[k] = rng.integers(0, 2, (nframes, 2 * mbh, 2 * mbw)).astype(np.int8)
        return syms, None
    mv = NEG_UNION[rng.integers(0, len(NEG_UNION), (nframes, mbh, mbw))]
    far = rng.random((nframes, mbh, mbw)) < oob_share
    mv = np.where(far[..., None], rng.integers(-40, 41, (nframes, mbh, mbw, 2)), mv)
    return syms, mv.astype(np.int32)


def write_gop_stream(intra_syms: dict, p_syms: dict, mv, nframes: int, h: int, w: int,
                     qdc: int, qac: int, period: int) -> bytes:
    """A closed-GOP stream of nframes frames from symbol tensors on one
    device, through the port's writer: intra_syms holds the GOPs' first
    frames, p_syms and mv (F, mbh, mbw, 2) the other frames in display
    order; the MVs are coded as their differential field."""
    import torch

    from icspcodec_torch.codec import write_stream
    from icspcodec_torch.ops.me import mv_diff_field

    idx = np.arange(nframes)
    p_syms = dict(p_syms, mv_diff=mv_diff_field(mv).to(torch.int16))
    return write_stream(intra_syms, idx[idx % period == 0], p_syms, idx[idx % period != 0],
                        nframes, h, w, qdc, qac, period)


def inter_xcheck_stream() -> bytes:
    """The seeded inter stream of the cross-implementation decode check:
    64x96, period 3, 5 frames (a shorter last GOP), MVs from the union
    offsets and some outside the padded frame, written on the CPU."""
    import torch

    c = INTER_XCHECK
    f, h, w, period = c["nframes"], c["height"], c["width"], c["period"]
    rng = np.random.default_rng(11)
    ni = len(range(0, f, period))
    si, _ = seeded_symbols(rng, ni, h, w, intra=True)
    sp, mv = seeded_symbols(rng, f - ni, h, w, intra=False, oob_share=0.2)
    to_t = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}  # noqa: E731
    return write_gop_stream(to_t(si), to_t(sp), torch.from_numpy(mv), f, h, w, c["qdc"],
                            c["qac"], period)


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


def profile_run(fn, wall_ms: float) -> dict:
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
    from icspcodec_torch.codec import _DEC_INTER_KEYS, _DEC_INTRA_KEYS, _INTRA_KEYS
    from icspcodec_torch.config import CodecConfig
    from icspcodec_torch.constants import COS_DEC
    from icspcodec_torch.engine.inter import decode_gop_mvs, decode_inter_frame
    from icspcodec_torch.engine.intra import (decode_chroma_idct, decode_intra_frames,
                                              encode_chroma_batch, encode_intra_frames,
                                              from_blocks, to_blocks)
    from icspcodec_torch.ops import _build, dc_fused, intra_decode_fused, intra_fused, mc_fused
    from icspcodec_torch.ops.me import window_start
    from icspcodec_torch.ops.pad import pad_image
    from icspcodec_torch.ops.quant import c_trunc
    from icspcodec_torch.ops.transforms import fdct, idct
    from icspcodec_torch.runtime import parse_body
    from icspcodec_torch.tables import NEG_SPIRAL, NEG_UNION

    dev = torch.device("cuda")
    f32 = torch.float32
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([_build.nvcc(), "--version"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, torch's cuda "
          f"{torch.version.cuda}, nvcc: {nvcc}; on {smi}", flush=True)

    def reset_counts():
        intra_fused.launches = dc_fused.launches = dc_fused.launches_inv = 0
        intra_decode_fused.launches = mc_fused.launches = 0

    def counts():
        return {"A": intra_fused.launches, "B": dc_fused.launches,
                "B'": dc_fused.launches_inv, "C": intra_decode_fused.launches,
                "E": mc_fused.launches}

    # ---- 1. build ---------------------------------------------------------
    t0 = time.time()
    logs = _build.build(["intra_luma", "dc_dpcm", "intra_decode", "mc_gather", "vlcparse"])
    for name, log in logs.items():
        print(f"[build {name}]\n{log.strip()}")
    print(f"build: {time.time() - t0:.1f} s", flush=True)

    y, cb, cr = cif_content(NF)
    yt = torch.from_numpy(y).to(dev)
    ct = torch.from_numpy(np.concatenate([cb, cr])).to(dev)
    err = {k: 0 for k in ("A", "B", "B'", "C", "E")}  # largest |kernel - plain|

    # ---- 2. kernels B and B' vs plain -------------------------------------
    for dtype in (torch.float32, torch.float64):
        dc = fdct(to_blocks(ct).to(torch.int32), dtype=dtype)[..., 0, 0].contiguous()
        for qstep in (16, 1):
            qk, dqk = dc_fused.dc_dpcm_fused(dc, qstep, chroma=True)
            qp, dqp = dc_fused.dc_dpcm_plain(dc, qstep, chroma=True)
            e = max(max_abs(qk, qp), max_abs(dqk, dqp))
            err["B"] = max(err["B"], e)
            check(e == 0, f"kernel B {dtype} qstep {qstep}: differs from plain by {e}")
            print(f"kernel B {str(dtype)[6:]} qstep {qstep}: bit-identical "
                  f"({dc.shape[0]} planes)", flush=True)
    dc32 = fdct(to_blocks(ct).to(torch.int32), dtype=f32)[..., 0, 0].contiguous()
    # B' on the dequantized DC residuals of the CIF300 chroma planes
    iq_c = dc_fused.dc_dpcm_fused(dc32, 16, chroma=True)[0] * 16
    e = max_abs(dc_fused.idc_dpcm_fused(iq_c, chroma=True), dc_fused.idc_dpcm_plain(iq_c, True))
    err["B'"] = max(err["B'"], e)
    check(e == 0, f"kernel B' at the CIF chroma grid: differs from plain by {e}")
    print(f"kernel B' at the CIF chroma grid: bit-identical ({iq_c.shape[0]} planes)", flush=True)

    # ---- 3. kernel A vs plain ---------------------------------------------
    # its plain version's fast transforms, card against CPU, with TF32 on
    tb = to_blocks(ct[:8]).to(torch.int32) - 128
    terr = 0.0
    for fn in (lambda b: fdct(b, dtype=f32), lambda b: idct(b * 16, COS_DEC, dtype=f32)):
        ref = fn(tb.cpu())
        terr = max(terr, float((fn(tb).cpu() - ref).abs().max() / ref.abs().max()))
    check(terr <= 2e-5, f"fast transforms with TF32 on: card differs from CPU by {terr}")
    print(f"fast transforms with TF32 on: card within {terr} (relative) of the CPU",
          flush=True)

    keys = ("scan", "mpm", "mode_bit", "acflag", "recon_plane")
    o8 = to_blocks(yt[:8])
    for qdc, qac in ((16, 16), (1, 1)):
        k = intra_fused.intra_luma_scan_fused(o8, qdc, qac, dtype=torch.float64,
                                              recon_plane=True)
        p = intra_fused.intra_luma_scan_plain(o8, qdc, qac, dtype=torch.float64,
                                              recon_plane=True)
        e = max(max_abs(k[n], p[n]) for n in keys)
        check(e == 0, f"kernel A float64 QP {qdc}/{qac}: differs from plain by {e}")
        print(f"kernel A float64 QP {qdc}/{qac}: bit-identical (8 CIF frames)", flush=True)

    oy = to_blocks(yt)
    k = intra_fused.intra_luma_scan_fused(oy, 16, 16, dtype=f32, recon_plane=True)
    p = intra_fused.intra_luma_scan_plain(oy, 16, 16, dtype=f32, recon_plane=True)
    err["A"] = max(max_abs(k[n], p[n]) for n in keys)
    ndiff = int((k["scan"] != p["scan"]).sum())
    frames = int((k["scan"] != p["scan"]).flatten(1).any(1).sum())
    dpf = (psnr_frames(k["recon_plane"].cpu().numpy(), y)
           - psnr_frames(p["recon_plane"].cpu().numpy(), y))
    dpsnr, dpsnr_max = float(dpf.mean()), float(np.abs(dpf).max())
    chroma = encode_chroma_batch(ct, 16, 16, dtype=f32)

    def stream_bits(lum):
        syms = dict(y_scan=lum["scan"], y_acflag=lum["acflag"], mpm=lum["mpm"],
                    mode_bit=lum["mode_bit"])
        for i, name in enumerate(("cb", "cr")):
            syms[f"{name}_scan"] = chroma["scan"][i * NF:(i + 1) * NF]
            syms[f"{name}_acflag"] = chroma["acflag"][i * NF:(i + 1) * NF]
        return int(frame_items_dev(syms, True)[1].sum(dtype=torch.int64))

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
        e = max(max_abs(k[n], p[n]) for n in keys)
        check(e == 0, f"kernel A float64 at {w}x{h}: differs from plain by {e}")
        dc = torch.from_numpy(rng.normal(1024, 400, (3, h // 8, w // 8))).to(dev)
        eb = max(max_abs(a, b) for a, b in zip(dc_fused.dc_dpcm_fused(dc, 7, chroma=False),
                                               dc_fused.dc_dpcm_plain(dc, 7, chroma=False)))
        check(eb == 0, f"kernel B (luma kinds) at {w}x{h}: differs from plain by {eb}")
        iq = torch.from_numpy(rng.integers(-3000, 3000, (3, h // 8, w // 8))).to(dev)
        ei = max_abs(dc_fused.idc_dpcm_fused(iq, False), dc_fused.idc_dpcm_plain(iq, False))
        check(ei == 0, f"kernel B' (luma kinds) at {w}x{h}: differs from plain by {ei}")
        print(f"kernels A, B and B' float64 / int at {w}x{h}: bit-identical", flush=True)

    # ---- 4. end to end: the all-intra encode ------------------------------
    cfg = CodecConfig(width=W, height=H, qp_dc=16, qp_ac=16, precision="fast")
    reset_counts()
    bits, rec = codec.encode(y, cb, cr, cfg)
    torch.cuda.synchronize()
    launches_enc = counts()
    check(launches_enc["A"] >= 1 and launches_enc["B"] >= 1,
          f"the encode did not launch kernels A and B: {launches_enc}")
    check(rec["y"].shape == y.shape and len(bits) > 14, "encode output has the wrong shape")
    psnr_y = psnr(rec["y"], y)
    check(np.isfinite(psnr_y) and psnr_y > 30, f"encode PSNR-Y {psnr_y} dB is implausible")
    enc_ms = event_ms(lambda: codec.encode(y, cb, cr, cfg), reps=3, warmup=0)
    e2e = dict(frames=NF, bytes=len(bits), psnr_y_db=psnr_y, encode_ms=enc_ms,
               encode_fps=NF / (enc_ms / 1e3), launches=launches_enc)
    print("encode CIF300 fast: " + json.dumps(e2e), flush=True)
    print("device time by kernel in one encode: " + json.dumps(profile_run(
        lambda: codec.encode(y, cb, cr, cfg), enc_ms)), flush=True)

    # where the encode's time goes, stage by stage (events, after the warm-up)
    from icspcodec_torch.codec import _pack_bucketed
    cbt, crt = torch.from_numpy(cb).to(dev), torch.from_numpy(cr).to(dev)
    st = {}
    st["upload_ms"] = event_ms(lambda: [torch.from_numpy(a).to(dev) for a in (y, cb, cr)], 3)
    st["engine_ms"] = event_ms(lambda: encode_intra_frames(yt, cbt, crt, 16, 16, dtype=f32), 3)
    out = encode_intra_frames(yt, cbt, crt, 16, 16, dtype=f32)
    syms = {n: out[n] for n in _INTRA_KEYS}
    st["items_ms"] = event_ms(lambda: frame_items_dev(syms, True), 3)
    codes, lengths = frame_items_dev(syms, True)
    st["pack_and_pull_ms"] = event_ms(lambda: _pack_bucketed(codes, lengths), 3)
    st["recon_pull_ms"] = event_ms(lambda: [out[f"recon_{n}"].cpu() for n in ("y", "cb", "cr")], 3)
    st["luma_kernel_ms"] = event_ms(lambda: intra_fused.intra_luma_scan_fused(
        oy, 16, 16, dtype=f32, recon_plane=True), 20)
    st["chroma_chain_ms"] = event_ms(lambda: encode_chroma_batch(ct, 16, 16, dtype=f32), 5)
    print("encode stages (ms): " + json.dumps(st), flush=True)
    del out, syms, codes, lengths

    # kernel and plain-version times at the main path's shapes
    ka_ms = st["luma_kernel_ms"]
    ka64_ms = event_ms(lambda: intra_fused.intra_luma_scan_fused(
        oy, 16, 16, dtype=torch.float64, recon_plane=True), 5)
    pa_ms = event_ms(lambda: intra_fused.intra_luma_scan_plain(
        oy, 16, 16, dtype=f32, recon_plane=True), 1)
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
    del oy

    # ---- 5. kernel E vs plain ---------------------------------------------
    rng = np.random.default_rng(5)
    for block, planes in ((16, yt[:30]), (8, ct[:60])):
        pad = pad_image(planes, block)
        shape = (planes.shape[0], planes.shape[1] // block, planes.shape[2] // block)
        mv = NEG_UNION[rng.integers(0, len(NEG_UNION), shape)]
        far = rng.random(shape) < 0.05
        mv = np.where(far[..., None], rng.integers(-400, 401, shape + (2,)), mv).astype(np.int32)
        mvt = torch.from_numpy(mv).to(dev)
        e = max_abs(mc_fused.mc_gather(pad, mvt, block), mc_fused.mc_gather_plain(pad, mvt, block))
        err["E"] = max(err["E"], e)
        check(e == 0, f"kernel E block {block}: differs from plain by {e}")
        print(f"kernel E block {block}: bit-identical ({shape[0]} planes, {int(far.sum())} "
              "MVs outside the padded frame)", flush=True)

    # ---- 6. kernel C vs plain ---------------------------------------------
    dsyms = parse_body(bits[14:], NF, H, W, 0)
    ys, mpm, mbit = (torch.from_numpy(dsyms[n]).to(dev) for n in ("y_scan", "mpm", "mode_bit"))
    for qdc, qac in ((16, 16), (1, 1)):
        args = (ys[:8], mpm[:8], mbit[:8], qdc, qac)
        e = max_abs(intra_decode_fused.intra_luma_decode_fused(*args, dtype=torch.float64),
                    intra_decode_fused.intra_luma_decode_plain(*args, dtype=torch.float64))
        check(e == 0, f"kernel C float64 QP {qdc}/{qac}: differs from plain by {e}")
        print(f"kernel C float64 QP {qdc}/{qac}: bit-identical (8 CIF frames)", flush=True)
    for w, h in ((176, 144), (1280, 720)):
        rng = np.random.default_rng(h)
        gh, gw = h // 8, w // 8
        sc = np.where(rng.random((2, gh, gw, 64)) < 0.15, rng.integers(-30, 31, (2, gh, gw, 64)), 0)
        sc[..., 0] = rng.integers(-6, 7, (2, gh, gw))
        fl = rng.integers(0, 2, (2, 2, gh, gw)).astype(np.int8)
        args = (torch.from_numpy(sc.astype(np.int16)).to(dev), torch.from_numpy(fl[0]).to(dev),
                torch.from_numpy(fl[1]).to(dev), 8, 16)
        e = max_abs(intra_decode_fused.intra_luma_decode_fused(*args, dtype=torch.float64),
                    intra_decode_fused.intra_luma_decode_plain(*args, dtype=torch.float64))
        check(e == 0, f"kernel C float64 at {w}x{h}: differs from plain by {e}")
        print(f"kernel C float64 at {w}x{h}: bit-identical", flush=True)
    kc = intra_decode_fused.intra_luma_decode_fused(ys, mpm, mbit, 16, 16, dtype=f32)
    pc = intra_decode_fused.intra_luma_decode_plain(ys, mpm, mbit, 16, 16, dtype=f32)
    err["C"] = max_abs(kc, pc)
    pdiff = int((kc != pc).sum())
    dpf = psnr_frames(kc.cpu().numpy(), y) - psnr_frames(pc.cpu().numpy(), y)
    c32 = dict(pixels_differing=pdiff, pixels=kc.numel(), max_abs_err=err["C"],
               frames_affected=int((kc != pc).flatten(1).any(1).sum()),
               dpsnr_y_db=float(dpf.mean()), dpsnr_y_db_worst_frame=float(np.abs(dpf).max()))
    print("kernel C float32 CIF300 vs plain: " + json.dumps(c32), flush=True)
    check(pdiff <= 0.001 * kc.numel(), f"kernel C float32: {pdiff} pixels differ (> 0.1%)")
    check(c32["dpsnr_y_db_worst_frame"] <= 0.05,
          f"kernel C float32: a frame's |dPSNR-Y| {c32['dpsnr_y_db_worst_frame']} > 0.05 dB")
    del kc, pc

    # ---- 7. end to end: the all-intra decode ------------------------------
    reset_counts()
    dec = codec.decode(bits, NF, precision="fast")
    torch.cuda.synchronize()
    launches_ai = counts()
    check(launches_ai["C"] >= 1 and launches_ai["B'"] >= 1,
          f"the all-intra decode did not launch kernels C and B': {launches_ai}")
    check(all(dec[n].shape == a.shape for n, a in (("y", y), ("cb", cb), ("cr", cr))),
          "all-intra decode output has the wrong shape")
    psnr_d = psnr(dec["y"], y)
    check(abs(psnr_d - psnr_y) <= 0.05,
          f"all-intra decode PSNR-Y {psnr_d} dB is not within 0.05 dB of the recon's {psnr_y}")
    dec_ms = event_ms(lambda: codec.decode(bits, NF, precision="fast"), reps=3, warmup=0)
    d_ai = dict(frames=NF, bytes=len(bits), psnr_y_db=psnr_d, recon_psnr_y_db=psnr_y,
                decode_ms=dec_ms, decode_fps=NF / (dec_ms / 1e3), launches=launches_ai)
    print("decode all-intra CIF300 fast: " + json.dumps(d_ai), flush=True)
    print("device time by kernel in one all-intra decode: " + json.dumps(profile_run(
        lambda: codec.decode(bits, NF, precision="fast"), dec_ms)), flush=True)
    sd = {}
    sd["parse_ms"] = event_ms(lambda: parse_body(bits[14:], NF, H, W, 0), 3)
    sd["upload_ms"] = event_ms(lambda: [torch.from_numpy(dsyms[n]).to(dev)
                                        for n in _DEC_INTRA_KEYS], 3)
    up = {n: torch.from_numpy(dsyms[n]).to(dev) for n in _DEC_INTRA_KEYS}
    up_args = [up[n] for n in _DEC_INTRA_KEYS]
    sd["engine_ms"] = event_ms(lambda: decode_intra_frames(*up_args, 16, 16, dtype=f32), 3)
    sd["luma_kernel_ms"] = event_ms(lambda: intra_decode_fused.intra_luma_decode_fused(
        ys, mpm, mbit, 16, 16, dtype=f32), 10)
    sd["chroma_chain_ms"] = event_ms(lambda: from_blocks(torch.clamp(c_trunc(decode_chroma_idct(
        up["cb_scan"], up["cr_scan"], 16, 16, dtype=f32)), 0, 255).to(torch.uint8)), 5)
    out = decode_intra_frames(*up_args, 16, 16, dtype=f32)
    sd["pull_ms"] = event_ms(lambda: [out[n].cpu().numpy() for n in ("y", "cb", "cr")], 3)
    print("all-intra decode stages (ms): " + json.dumps(sd), flush=True)

    kc_ms = sd["luma_kernel_ms"]
    kc64_ms = event_ms(lambda: intra_decode_fused.intra_luma_decode_fused(
        ys, mpm, mbit, 16, 16, dtype=torch.float64), 5)
    pc_ms = event_ms(lambda: intra_decode_fused.intra_luma_decode_plain(
        ys, mpm, mbit, 16, 16, dtype=f32), 1)
    kbi_ms = event_ms(lambda: dc_fused.idc_dpcm_fused(iq_c, chroma=True), 50)
    pbi_ms = event_ms(lambda: dc_fused.idc_dpcm_plain(iq_c, chroma=True), 3)
    c_bytes = nblk * (128 + 2 + 64) + 65 * 4 + 64 * 4 + 36 * 44 * 4
    c_flops = nblk * 2 * 64 * 8 * 2   # separable inverse DCT: 2 passes x 64 x 8 mul-adds
    c_bound = max(c_bytes / PEAK_BYTES_S, c_flops / PEAK_F32_FLOP_S) * 1e3
    bi_bytes = iq_c.numel() * (4 + 4) + 18 * 22 * 4
    bi_bound = bi_bytes / PEAK_BYTES_S * 1e3
    del up, up_args, out, ys, mpm, mbit

    # ---- 8. end to end: the period-10 decode ------------------------------
    period = 10
    isyms = encode_intra_frames(yt[::period], torch.from_numpy(cb[::period]).to(dev),
                                torch.from_numpy(cr[::period]).to(dev), 16, 16, dtype=f32,
                                return_recon=False)
    isyms = {n: isyms[n] for n in _INTRA_KEYS}
    psyms, mv = seeded_symbols(np.random.default_rng(2024), NF - NF // period, H, W,
                               intra=False)
    canon = {tuple(v) for v in NEG_SPIRAL.tolist()}
    nc = sum(1 for v in mv.reshape(-1, 2).tolist() if tuple(v) not in canon)
    check(nc > 0, "the period-10 stream carries no non-canonical MV")
    p10 = write_gop_stream(isyms, {n: torch.from_numpy(v).to(dev) for n, v in psyms.items()},
                           torch.from_numpy(mv).to(dev), NF, H, W, 16, 16, period)
    reset_counts()
    dec10 = codec.decode(p10, NF, precision="fast")
    torch.cuda.synchronize()
    launches_p10 = counts()
    check(all(launches_p10[n] >= 1 for n in ("C", "B'", "E")),
          f"the period-10 decode did not launch kernels C, B' and E: {launches_p10}")
    check(all(dec10[n].shape == dec[n].shape for n in dec),
          "period-10 decode output has the wrong shape")
    # the luma symbols of an intra frame do not depend on its batch (kernel A
    # works frame by frame), so neither do its decoded planes
    check(np.array_equal(dec10["y"][::period], dec["y"][::period]),
          "the period-10 decode's intra luma differs from the all-intra decode's")
    p10_ms = event_ms(lambda: codec.decode(p10, NF, precision="fast"), reps=3, warmup=0)
    d_p10 = dict(frames=NF, bytes=len(p10), mvs=mv.size // 2, noncanonical_mvs=nc,
                 decode_ms=p10_ms, decode_fps=NF / (p10_ms / 1e3), launches=launches_p10,
                 psnr_y_intra_frames_db=psnr(dec10["y"][::period], y[::period]),
                 intra_chroma_pixels_differing=int(sum(
                     (dec10[n][::period] != dec[n][::period]).sum() for n in ("cb", "cr"))))
    print("decode period-10 CIF300 fast: " + json.dumps(d_p10), flush=True)
    print("device time by kernel in one period-10 decode: " + json.dumps(profile_run(
        lambda: codec.decode(p10, NF, precision="fast"), p10_ms)), flush=True)
    psyms_np = parse_body(p10[14:], NF, H, W, period)
    keys10 = _DEC_INTRA_KEYS + ("mv_diff",)
    sp = {}
    sp["parse_ms"] = event_ms(lambda: parse_body(p10[14:], NF, H, W, period), 3)
    sp["upload_ms"] = event_ms(lambda: [torch.from_numpy(psyms_np[n]).to(dev)
                                        for n in keys10], 3)
    up = {n: torch.from_numpy(psyms_np[n]).to(dev) for n in keys10}
    starts = torch.arange(0, NF, period, device=dev)
    pidx = starts[:, None] + torch.arange(1, period, device=dev)[None, :]
    sym_i = [up[n][starts] for n in _DEC_INTRA_KEYS]
    sym_p = {n: up[n][pidx] for n in _DEC_INTER_KEYS}
    sp["intra_ms"] = event_ms(lambda: decode_intra_frames(*sym_i, 16, 16, dtype=f32), 3)
    sp["mv_scan_ms"] = event_ms(lambda: decode_gop_mvs(sym_p["mv_diff"]), 3)
    first = decode_intra_frames(*sym_i, 16, 16, dtype=f32)
    mvr = decode_gop_mvs(sym_p["mv_diff"])

    def p_steps():
        carry = first
        for j in range(period - 1):
            sym = dict(y_scan=sym_p["y_scan"][:, j], cb_scan=sym_p["cb_scan"][:, j],
                       cr_scan=sym_p["cr_scan"][:, j], mv=mvr[:, j])
            carry = decode_inter_frame(sym, carry["y"], carry["cb"], carry["cr"], 16, 16,
                                       dtype=f32)
        return carry

    sp["p_steps_ms"] = event_ms(p_steps, 3)
    sp["pull_ms"] = sd["pull_ms"]
    print("period-10 decode stages (ms; pull as in the all-intra decode): " + json.dumps(sp),
          flush=True)

    # kernel E at one P-step's shapes: luma and chroma, two launches
    pad_l = pad_image(first["y"], 16)
    mv_l = mvr[:, 0].contiguous()
    pad_c = pad_image(torch.cat([first["cb"], first["cr"]]), 8)
    mvc = torch.sign(mv_l) * torch.div(mv_l.abs(), 2, rounding_mode="floor")
    mv_c = torch.cat([mvc, mvc]).contiguous()

    def mc_kernel():
        return mc_fused.mc_gather(pad_l, mv_l, 16), mc_fused.mc_gather(pad_c, mv_c, 8)

    def mc_plain():
        return mc_fused.mc_gather_plain(pad_l, mv_l, 16), mc_fused.mc_gather_plain(pad_c, mv_c, 8)

    def gather_index(pad, mv, block):
        """(frame, row, column) index tensors of every predictor pixel."""
        b, nby, nbx = mv.shape[:3]
        ph, pw = pad.shape[1:]
        k = torch.arange(block, device=dev)
        oy = window_start(torch.arange(nby, device=dev)[:, None] * block - mv[..., 1] + block,
                          ph, block)
        ox = window_start(torch.arange(nbx, device=dev)[None, :] * block - mv[..., 0] + block,
                          pw, block)
        rows = (oy[..., None, None] + k[:, None]).expand(b, nby, nbx, block, block)
        cols = (ox[..., None, None] + k[None, :]).expand(b, nby, nbx, block, block)
        bi = torch.arange(b, device=dev)[:, None, None, None, None].expand_as(rows)
        return tuple(from_blocks(t).contiguous() for t in (bi, rows, cols))

    il, ic = gather_index(pad_l, mv_l, 16), gather_index(pad_c, mv_c, 8)

    def mc_library():
        return pad_l[il], pad_c[ic]

    check(all(torch.equal(a, b) for a, b in zip(mc_kernel(), mc_library())),
          "kernel E differs from the advanced-indexing gather")
    ke_ms = event_ms(mc_kernel, 50)
    pe_ms = event_ms(mc_plain, 5)
    le_ms = event_ms(mc_library, 20)
    e_bytes = (pad_l.numel() + pad_c.numel() + (mv_l.numel() + mv_c.numel()) * 4
               + first["y"].numel() + 2 * first["cb"].numel())
    e_bound = e_bytes / PEAK_BYTES_S * 1e3
    del up, sym_i, sym_p, first, mvr, pad_l, pad_c, il, ic

    # ---- 9. cross-implementation checks (exact mode) ----------------------
    xb, _ = codec.encode(*xcheck_input(), CodecConfig(**XCHECK_CFG), return_recon=False)
    digest = hashlib.sha256(xb).hexdigest()
    check(digest == XCHECK_SHA256, f"exact-mode stream sha256 {digest} != {XCHECK_SHA256}")
    print(f"xcheck: exact-mode stream of {len(xb)} bytes matches the pinned sha256", flush=True)
    nxi = INTER_XCHECK["nframes"]
    for name, data, n, pinned in (("XCHECK", xb, 2, XCHECK_DECODE_SHA256),
                                  ("inter", inter_xcheck_stream(), nxi,
                                   INTER_XCHECK_DECODE_SHA256)):
        digest = planes_digest(codec.decode(data, n, precision="exact"))
        check(digest == pinned, f"exact decode of the {name} stream: digest {digest} != {pinned}")
        print(f"xcheck: exact decode of the {name} stream matches the pinned digest", flush=True)
    # and at full width: the card's exact CIF stream and planes equal the
    # CPU's (the plain versions), which the CPU tests hold equal to the JAX
    # package's
    xcfg = CodecConfig(width=W, height=H, qp_dc=8, qp_ac=16, precision="exact")
    bg, rg = codec.encode(y[:4], cb[:4], cr[:4], xcfg)
    bc, rc = codec.encode(y[:4], cb[:4], cr[:4], xcfg, device="cpu")
    check(bg == bc and all(np.array_equal(rg[n], rc[n]) for n in rg),
          "exact-mode CIF stream or recon differs between the card and the CPU")
    print(f"xcheck: exact-mode CIF stream of 4 frames ({len(bg)} bytes) and recon "
          "identical on the card and the CPU", flush=True)
    dg = codec.decode(p10, period, precision="exact")
    dcpu = codec.decode(p10, period, precision="exact", device="cpu")
    check(all(np.array_equal(dg[n], dcpu[n]) for n in dg),
          "exact-mode CIF decode of one GOP differs between the card and the CPU")
    print(f"xcheck: exact-mode CIF decode of one GOP ({period} frames) identical on the card "
          "and the CPU", flush=True)

    kernels = [
        dict(name="intra_luma_wavefront", route="cuda",
             source="icspcodec_torch/csrc/intra_luma.cu",
             replaces="icspcodec_tpu/ops/pallas_intra.py:160", launches=launches_enc["A"],
             max_abs_err=err["A"], ms=ka_ms, plain_ms=pa_ms,
             bound_ms=a_bound,
             bound_by="operations" if a_flops / PEAK_F32_FLOP_S > a_bytes / PEAK_BYTES_S
             else "bytes", library_ms=None,
             check="float64 bit-identical at QP 16/16 and 1/1; float32 "
                   f"{ndiff} of {a32['symbols']} symbols differ, dPSNR-Y {dpsnr:.5f} dB",
             ms_float64=ka64_ms, path="encode"),
        dict(name="dc_dpcm_forward", route="cuda", source="icspcodec_torch/csrc/dc_dpcm.cu",
             replaces="icspcodec_tpu/ops/pallas_dc.py:66", launches=launches_enc["B"],
             max_abs_err=err["B"], ms=kb_ms, plain_ms=pb_ms,
             bound_ms=b_bound, bound_by="bytes", library_ms=None,
             check="bit-identical in float32 and float64 at qstep 16 and 1", path="encode"),
        dict(name="dc_dpcm_inverse", route="cuda", source="icspcodec_torch/csrc/dc_dpcm.cu",
             replaces="icspcodec_tpu/ops/pallas_dc.py:66", launches=launches_ai["B'"],
             max_abs_err=err["B'"], ms=kbi_ms, plain_ms=pbi_ms,
             bound_ms=bi_bound, bound_by="bytes", library_ms=None,
             check="bit-identical at the CIF chroma grid and luma kinds at QCIF and 720p",
             path="all-intra decode", launches_period10_decode=launches_p10["B'"]),
        dict(name="intra_luma_decode_wavefront", route="cuda",
             source="icspcodec_torch/csrc/intra_decode.cu",
             replaces="icspcodec_tpu/ops/pallas_intra.py:371", launches=launches_ai["C"],
             max_abs_err=err["C"], ms=kc_ms, plain_ms=pc_ms, bound_ms=c_bound,
             bound_by="operations" if c_flops / PEAK_F32_FLOP_S > c_bytes / PEAK_BYTES_S
             else "bytes", library_ms=None,
             check="float64 bit-identical at CIF QP 16/16 and 1/1, QCIF, 720p; float32 "
                   f"{pdiff} of {c32['pixels']} pixels differ",
             ms_float64=kc64_ms, path="all-intra decode",
             launches_period10_decode=launches_p10["C"]),
        dict(name="mc_gather", route="cuda", source="icspcodec_torch/csrc/mc_gather.cu",
             replaces="icspcodec_tpu/ops/pallas_me.py:387", launches=launches_p10["E"],
             max_abs_err=err["E"], ms=ke_ms, plain_ms=pe_ms, bound_ms=e_bound,
             bound_by="bytes", library_ms=le_ms,
             check="bit-identical at CIF luma and chroma, union and out-of-frame MVs; "
                   "times are one P-step's luma and chroma launches",
             path="period-10 decode"),
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
