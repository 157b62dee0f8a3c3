#!/usr/bin/env python3
"""Smoke run of the PyTorch port (icspcodec_torch) on one CUDA card.

    python3 chip_smoke.py

Builds the CUDA kernels from csrc/ and the bitstream parser from runtime/,
holds each kernel against its plain PyTorch version on the card, drives the
port's paths through its entry points at CIF300 (the all-intra and the
period-10 encode with codec.encode, the all-intra and the period-10 decode
with codec.decode), and checks exact-mode streams and decoded planes
against sha256 digests that tests/test_torch_codec.py,
tests/test_torch_inter_encode.py and tests/test_torch_decode.py pin to the
JAX package's output.  Phases, each of which fails the run:

  1. build    nvcc builds every kernel and cc the parser, all at once
  2. kernels B and B' (DC chains) vs plain: forward at the CIF chroma grid,
              F=600, qstep 16 and 1, float32 and float64; inverse at the
              same grid; both at luma kinds at QCIF and 720p, and at luma
              and chroma kinds on planes of 769 block rows (past the 768
              the first port took) and 8,190 (the header's largest),
              narrow; bit-identical (torch.equal).  B also, in float32
              and float64 and at luma and chroma kinds, on the planes just
              inside and just past the staged layout's limit for each type
              (the launcher's own answer), at gh = 1, gw = 1, odd gw and
              more than one band, at qstep 1 .. 255, on half-integer DCs
              and negative residuals, printing the layout each took; and
              its multiply-high division against C division for every
              qstep 1 .. 255 and every int32 dividend.
              No codec path runs B (the encoder's chroma chain is kernel
              F), so B's path is its entry point, ops/dc_fused.dc_dpcm_fused,
              called once at the CIF300 chroma grid (launch counter)
  3. kernel A intra luma wavefront vs plain: float64 at CIF, 8 frames,
              QP 16/16 and 1/1, float32 at CIF300, QP 16/16, and 8 frames
              at QP 1/1, bit-identical (torch.equal); both precisions on
              a plane of 2,560 block rows, whose ring of boundary state is
              too tall for shared memory and goes to global scratch.  TF32
              is on, as a caller may have it: the fast transforms on the
              card must still agree with the CPU's within 2e-5 of their
              largest value (float32 reordering; TF32 would err by ~5e-4).
              The intra chroma chain (encode_chroma_batch, through kernel
              F) equals F's plain version, the batched fdct, DC chain,
              quantization and idct (symbols, flags and idct; torch.equal)
              at CIF300 in both precisions
  4. encode   codec.encode of CIF300, all-intra, fast mode, through kernels
              A and F (launch counters), timed with CUDA events after a
              warm-up
  5. kernel E motion compensation vs plain at CIF luma and chroma, MVs from
              the 129 union offsets and some leaving the padded frame:
              bit-identical, both entry points (mc_gather, and mc_gather_yc,
              the decoder's luma and chroma in one launch)
  6. kernel C intra luma decode vs plain: float64 and float32 at CIF (8
              frames of the phase-4 stream, QP 16/16 and 1/1), QCIF and
              720p, on a plane of 2,560 block rows (the ring in global
              scratch) and on the CIF300 stream, bit-identical
              (torch.equal; the pixels differing and the dPSNR-Y printed)
  7. decode   codec.decode of the phase-4 stream (all-intra CIF300, fast)
              through kernels C and B': PSNR-Y within 0.05 dB of the
              encoder's recon; timed, stage by stage
  8. kernels D and G (motion search) vs plain: 30 benchA frames against
              the port's intra recon of the frames before them, 30
              synthStatic frames likewise, and 720p frames with static
              regions; bit-identical
  9. kernel F (forward residual chain) vs plain: float64 and float32 luma
              and chroma at CIF, 720p and 1080p, and a 4096-line plane, QP
              16/16 and 1/1, bit-identical; at QP 16/16 an 8K UHD luma plane
              (4,320 lines, walked in two bands of 512 block rows) and luma
              and chroma planes of the header's largest height (65,520 and
              32,760 lines, narrow), bit-identical; float32 at the CIF300 P-step
              shapes bit-identical, and at most 0.1% of symbols differing
              (the count printed) and |dPSNR-Y| <= 0.05 dB in every frame;
              a call split over planes bit-identical; two device launches
              a call
 10. encode   codec.encode of CIF300 at intra period 10, fast mode, through
              kernels A, D, E and F (launch counters); timed, stage by
              stage
 11. encode   codec.encode of 30 synthStatic CIF frames at period 10: the
              zero-SAD break fires, so kernel G runs (launch counter); its
              decode's PSNR-Y within 0.05 dB of its recon
 12. decode   codec.decode at period 10 of phase 10's stream through C, B'
              and E (one launch a P-step): PSNR-Y within 0.05 dB of the
              encoder's recon (which bounds the drift of the encoder's
              reference frames from the decoder's); timed, stage by stage;
              and of a seeded CIF300 stream (intra frames from the port's
              encode of benchA, MVs from the union offsets, sparse residuals)
              whose intra frames equal phase 7's; mc_gather_yc bit-identical
              to plain at every P-step of both streams; E timed as one
              launch, as two and as the library gather
 13. xcheck   exact mode: the encoded streams' sha256 (all-intra and period
              3 on static-trigger content) and the decoded planes' digests
              of two small streams equal the pinned JAX ones; a CIF encode
              of 4 frames, an exact CIF synthStatic GOP (10 frames) and a
              CIF decode of one GOP (10 frames: the first GOP of phase 12's
              seeded stream, written as a stream of its own) give the same
              bytes and planes on the card and the CPU; three
              configurations of the C++ reference's golden set (tests/golden/MANIFEST.sha256:
              synthA QP 16/16 all-intra, synthB 8/8 and synthStatic 1/1 at
              period 10; 32 CIF frames each) encoded and decoded on the
              card in exact mode: the stream, encoder-recon and decoder
              hashes equal the C++ reference's; a tall seeded sequence
              (3 frames of 32x16,384, period 2: luma planes of 2,048 block
              rows, chroma of 1,024) encoded and decoded in exact mode:
              the same bytes and planes on the card and the CPU
 14. search   sad_best and sad_union (the unfused search entry points) vs
              plain on phase 8's benchA, synthStatic and 720p inputs,
              bit-identical; sad_best's best equals D's wherever zc < 2, its
              MVs on benchA equal ops/me.spiral_search's, sad_union equals
              D's canonical rows followed by G's; the unfused search of the
              JAX package's ME-kernel tool (sad_best, then luma and chroma MC
              through kernel E) run once on a benchA P-step (launch
              counters) and timed
 15. stream   encode_streaming: exact at CIF, 30 frames, period 10, equal to
              codec.encode's bytes, and a resume after deleting one chunk
              re-encodes that GOP alone to the same bytes; fast at CIF300,
              period 10, timed, its bytes compared with phase 10's
              (identical, or size within 0.5% and decoded PSNR-Y within 0.05
              dB)
 16. host/cli codec.encode(entropy="host") at CIF300, period 10, fast: phase
              10's bytes; timed, with the host writer alone.  Then
              `python -m icspcodec_torch.cli encode` and `decode --orig` as
              subprocesses on a CIF300 .yuv file: phase 10's bytes, and the
              printed PSNR-Y within 0.05 dB of phase 10's recon; wall times
 17. shards   gop_shards=2 over the device list ["cuda:0"] * 2, CIF300 fast:
              codec.encode at period 10 gives phase 10's bytes and recon,
              all-intra phase 4's, codec.decode of phase 10's stream phase
              12's planes, encode_streaming phase 10's bytes; kernels A, D,
              E and F (encode) and C, B' and E (decode) launched in both
              shards (launch counters); device=None on a one-card machine
              raises ValueError; each call timed beside its unsharded phase,
              with the device busy share of the sharded period-10 encode
 18. tiles    tile_shards=2 (CIF's 22 MB columns) over ["cuda:0"] * 2: exact
              mode on 10 CIF frames at period 10 gives the untiled bytes,
              recon and planes, the encode launching kernel F as often as
              the untiled one; synthA QP 16/16 at period 1 (32 frames)
              through the tiled encode and decode gives the C++ reference's
              three hashes; fast mode on 30 frames gives the untiled bytes,
              recon and decoded planes, timed beside the untiled
 19. oracle   icspcodec_torch.oracle (host numpy) encodes the XCHECK input
              to the pinned stream and decodes it, its final byte realigned
              (the oracle reads that byte MSB-first, as the reference does),
              to the pinned planes
 20. api      the JAX package's last public functions: kernel A equals the
              grid-form wavefront engine/wavefront.intra_luma_scan (plain
              torch on the card; float64 on 8 CIF frames at QP 16/16;
              recon, scan, mpm, mode_bit) and kernel C the decode through
              intra_luma_decode_scan (float64, 8 frames of the phase-4
              stream): the same loops as phases 3 and 6 reach by the packed
              names, timed, with the grid encode's device busy share;
              ops/me.spiral_search_fixed
              equals -SPIRAL[best] of sad_best everywhere and of D where
              zc < 2, and spiral_search_union's index equals stateful_select
              over sad_union, on phase 8's benchA, synthStatic and 720p
              inputs; the four ops/mc_fused.mc_select_* wrappers launch
              kernel E once each and equal ops/me.gather_pred at the MVs
              -offsets[idx], indices drawn from each whole table; the
              searches and selects timed beside their kernels
 21. tail     the stream tail: the seeded set of
              tests/test_torch_stream_tail.py (TAIL_CASES: uniform noise and
              a gradient plus noise, 5 frames of 64x96, exact and fast, QP
              1/1 and 8/16, all-intra and period 3), 10 seeds a case,
              encoded and decoded on the card (codec.encode_symbols and the
              writer, then codec.decode, launches counted): every stream
              parses to its writer's symbols or is refused as ambiguous with
              the writer's reading among two or more, the decode refuses the
              same streams, and its planes equal the CPU's decode (exact) or
              lie within 0.05 dB of the recon's PSNR-Y (fast); the counts of
              right, ambiguous, raised and wrong streams printed; a raised
              or wrong one fails

Prints a JSON `kernels` line (each kernel's event time `ms` and the
profiler's device time `device_ms` per call of the same function; kernels
A and C also their device time per diagonal, C its resident CTAs an SM, B'
its device time on the three shapes a decode gives it; every kernel also
its launches in phase 17's sharded calls and phase 18's tiled ones, and E
its launches by phase 20's four mc_select_* calls), the
card's name and power limit, and as its last line {"ok": true, "device":
{...}}.  Exits non-zero, printing no result, without a CUDA device.
"""
from __future__ import annotations

import hashlib
import json
import pathlib
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent

W, H, NF = 352, 288, 300
PEAK_BYTES_S = 3.35e12        # H100 SXM HBM3
PEAK_F32_FLOP_S = 67e12       # H100 SXM float32, outside the tensor cores
PEAK_F64_FLOP_S = 33.5e12     # H100 SXM float64, outside the tensor cores
PEAK_F64_TC_FLOP_S = 67e12    # H100 SXM float64 on the tensor cores (DMMA)
# 32-bit lane operations per second outside the tensor cores: the float32
# rate with a multiply-add counted once.  The SAD kernels' work, byte
# absolute differences accumulated into sums, counts one operation per
# instruction that does it: four differences where the compiled body does
# them with VABSDIFF4 (sad_diffs_per_op), else one.
PEAK_LANE_OP_S = PEAK_F32_FLOP_S / 2
XCHECK_CFG = dict(width=96, height=64, qp_dc=8, qp_ac=16, precision="exact")
XCHECK_SHA256 = "08ece079fe3b9aa18c9654c2066c7f422a57f3fdec12f4f1559c49e8e50b3413"
# sha256 of the exact-mode decoded planes (planes_digest) of the XCHECK
# stream and of inter_xcheck_stream(); tests/test_torch_decode.py pins both
# to the JAX package's decode of the stream as written (its final byte's
# bits moved to the high end, which the JAX parser needs)
XCHECK_DECODE_SHA256 = "3f1147592f6ee7e1137d68f6f3ea79f1cd86c73a297212d705df9eeaa50ede76"
# the bits of the XCHECK stream's final byte (its writer's remainder; the
# only reading of that byte, tests/test_torch_decode.py)
XCHECK_TAIL_BITS = 6
INTER_XCHECK = dict(height=64, width=96, qdc=8, qac=16, period=3, nframes=5)
# the exact-mode period-3 encode of static_trigger_input(): its zero-SAD
# breaks run the stateful branch; tests/test_torch_inter_encode.py pins the
# sha256 to the JAX package's stream
INTER_ENC_CFG = dict(width=96, height=64, qp_dc=16, qp_ac=16, intra_period=3,
                     precision="exact")
INTER_ENC_SHA256 = "e77c6efa531f06087c6090dbce40eeec492f732c8443197100cb8fbbf2089101"
INTER_XCHECK_DECODE_SHA256 = (
    "5f34a468854c263b2230e3423e2bc51c21929f6825f25e6d5ec162ebe76930fb")


def xcheck_input():
    """The seeded input of the cross-implementation byte check."""
    rng = np.random.default_rng(0)
    y = rng.integers(0, 256, (2, 64, 96), dtype=np.uint8)
    cb = rng.integers(0, 256, (2, 32, 48), dtype=np.uint8)
    cr = rng.integers(0, 256, (2, 32, 48), dtype=np.uint8)
    return y, cb, cr


def static_trigger_input(f: int = 5, h: int = 64, w: int = 96):
    """Static-trigger content (tools/make_content.py's synthStatic idea at a
    small size): saturated black and white blocks repeated across frames
    beside a moving texture.  The black MB's zero SAD fires the encoder's
    early break, which mirrors the spiral for the MBs after it."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:h, 0:w]
    tex = 110 + 50 * np.sin(xx / 7.0) + 35 * np.cos(yy / 5.0) + rng.normal(0, 6, (h, w))
    ys = []
    for t in range(f):
        fr = np.roll(tex, (t, 3 * t), axis=(0, 1))
        fr[0:16, 0:32] = 0
        fr[48:64, 64:96] = 255
        ys.append(fr)
    y = np.clip(np.stack(ys), 0, 255).astype(np.uint8)
    c = np.full((f, h // 2, w // 2), 128, np.uint8)
    return y, c, c.copy()


def tall_input(h: int = 16384, w: int = 32, f: int = 3):
    """A seeded tall sequence: luma bands that move down frame by frame
    over noise, chroma noise; its luma planes have h / 8 block rows."""
    rng = np.random.default_rng(h)
    base = 128 + 60 * np.sin(np.arange(h)[:, None] / 37.0) + 40 * np.cos(np.arange(w) / 5.0)
    y = np.stack([np.roll(base, 3 * t, axis=0) + rng.normal(0, 8, (h, w)) for t in range(f)])
    y = np.clip(y, 0, 255).astype(np.uint8)
    cb = rng.integers(0, 256, (f, h // 2, w // 2), dtype=np.uint8)
    cr = rng.integers(0, 256, (f, h // 2, w // 2), dtype=np.uint8)
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


# the seeded set of the stream-tail check (phase 21 and
# tests/test_torch_stream_tail.py): 5 frames of 64x96 of each content, in
# both precisions, at QP 1/1 and 8/16, all-intra and at period 3
TAIL_CASES = [dict(kind=kind, precision=prec, qp_dc=qdc, qp_ac=qac, intra_period=period)
              for kind in ("noise", "gradient") for prec in ("exact", "fast")
              for qdc, qac in ((1, 1), (8, 16)) for period in (0, 3)]
TAIL_SHAPE = dict(nframes=5, height=64, width=96)
TAIL_SEEDS = 10               # seeds 0 .. 9 of each case on the card


def tail_content(kind: str, seed: int, f: int = 5, h: int = 64, w: int = 96,
                 sigma: float = 20.0):
    """Seeded planes whose streams end in noisy bits: "noise" is uniform in
    0..255 (y, then cb, then cr from default_rng(seed)); "gradient" a
    diagonal ramp on each plane plus gaussian noise of sigma levels."""
    rng = np.random.default_rng(seed)
    shapes = ((f, h, w), (f, h // 2, w // 2), (f, h // 2, w // 2))
    if kind == "noise":
        return tuple(rng.integers(0, 256, s, dtype=np.uint8) for s in shapes)
    out = []
    for s in shapes:
        yy, xx = np.mgrid[0:s[1], 0:s[2]]
        ramp = 40 + 85 * (xx / s[2] + yy / s[1])
        out.append(np.clip(ramp[None] + rng.normal(0, sigma, s), 0, 255).astype(np.uint8))
    return tuple(out)


def tail_stream(y, cb, cr, cfg, device):
    """codec.encode's two halves, kept apart: the engines
    (codec.encode_symbols) on device, then the writer (codec.packed_rows and
    assemble_frames, as codec.write_stream runs them, keeping the bit count).
    Returns (bytes, the writer's symbols as runtime.parse_body returns them
    (codec.host_symbols: numpy, display order), the writer's bit count, the
    recon planes as numpy)."""
    import torch

    from icspcodec_torch import codec
    from icspcodec_torch.bitstream_device import assemble_frames
    from icspcodec_torch.tables import pack_header

    nf = y.shape[0]
    (isyms, iidx), inter, rec = codec.encode_symbols(
        *(torch.from_numpy(a).to(device) for a in (y, cb, cr)), cfg)
    psyms, pidx = inter if inter is not None else (None, None)
    rows, nbits = codec.packed_rows(isyms, iidx, psyms, pidx, nf)
    bits = pack_header(cfg.height, cfg.width, cfg.qp_dc, cfg.qp_ac, cfg.intra_period) \
        + assemble_frames(rows, nbits)
    want = {}
    for syms, idx in ((codec.host_symbols(isyms), iidx), (codec.host_symbols(psyms), pidx)):
        for k, v in (syms or {}).items():
            want.setdefault(k, np.zeros((nf,) + v.shape[1:], v.dtype))[idx] = v
    return bits, want, sum(nbits), {k: v.cpu().numpy() for k, v in rec.items()}


def realign_tail(body: bytes, rem: int) -> bytes:
    """The stream body with its final byte's low rem bits moved to its high
    end: the bytes an MSB-first reader reads as the writer wrote them."""
    return body[:-1] + bytes([(body[-1] << (8 - rem)) & 0xFF if rem else body[-1]])


def tail_verdict(bits: bytes, want: dict, nbits: int, nframes: int, period: int) -> str:
    """How the port's parser reads a stream whose writer's symbols and bit
    count are known: "right" (the writer's symbols), "ambiguous" (refused,
    naming the writer's reading among two or more), "raised" (another
    ValueError) or "wrong" (other symbols, or an ambiguity that leaves the
    writer's reading out)."""
    from icspcodec_torch.runtime import parse_body
    from icspcodec_torch.tables import parse_header

    h, w = parse_header(bits[:14])[:2]
    try:
        got = parse_body(bits[14:], nframes, h, w, period)
    except ValueError as e:
        if not hasattr(e, "readings"):
            return "raised"
        return "ambiguous" if nbits % 8 in e.readings and len(e.readings) > 1 else "wrong"
    same = set(got) >= set(want) and all(np.array_equal(got[k], v) for k, v in want.items())
    return "right" if same else "wrong"


def cif_content(nframes: int, name: str = "benchA"):
    """A CIF sequence of tools/make_content.py (the bench's benchA by
    default) as (y, cb, cr) uint8 arrays."""
    from tools.make_content import synth_sequence

    raw = synth_sequence(name, nframes).reshape(nframes, -1).copy()
    y = raw[:, : W * H].reshape(nframes, H, W)
    cb = raw[:, W * H: W * H * 5 // 4].reshape(nframes, H // 2, W // 2)
    cr = raw[:, W * H * 5 // 4:].reshape(nframes, H // 2, W // 2)
    return y, cb, cr


def yuv_sha256(planes: dict) -> str:
    """sha256 of planes written frame by frame, Y then Cb then Cr: the
    reference's .yuv layout."""
    h = hashlib.sha256()
    for f in range(planes["y"].shape[0]):
        for k in ("y", "cb", "cr"):
            h.update(np.ascontiguousarray(planes[k][f], np.uint8).tobytes())
    return h.hexdigest()


def psnr_frames(a, b) -> np.ndarray:
    mse = ((a.astype(np.float64) - b.astype(np.float64)) ** 2).mean(axis=(-2, -1))
    return 20 * np.log10(255.0 / np.sqrt(np.maximum(mse, 1e-12)))


def psnr(a, b) -> float:
    return float(psnr_frames(a, b).mean())


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def sad_diffs_per_op(lib: pathlib.Path, cuobjdump: pathlib.Path) -> int:
    """Byte absolute differences one 32-bit lane instruction of the built
    SAD kernels does: 4 when their SASS accumulates them with VABSDIFF4,
    else 1."""
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    return 4 if "VABSDIFF4" in sass else 1


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


def nonzero_dequantized(scan, qdc: int, chroma: bool) -> int:
    """The nonzero values that go into the inverse products of blocks whose
    zig-zag symbols are scan (..., gh, gw, 64): the nonzero AC symbols, and
    the dequantized DCs, which the inverse DC chain's plain version rebuilds
    from the DC residuals, that are nonzero."""
    import torch

    from icspcodec_torch.ops.dc_fused import idc_dpcm_plain

    dq = idc_dpcm_plain(scan[..., 0].to(torch.int32) * qdc, chroma)
    return int(torch.count_nonzero(scan[..., 1:])) + int(torch.count_nonzero(dq))


def max_abs(a, b) -> int:
    """Largest absolute difference of two integer tensors."""
    import torch

    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) if a.numel() else 0


def profile_run(fn, wall_ms: float) -> dict:
    """torch.profiler over one call: the time of the device-side events
    (kernels and copies; CUPTI's own buffer requests left out), its share of
    the unprofiled wall time wall_ms, their count, and the top device
    events."""
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
                events=sum(r[2] for r in rows),
                top=[dict(ms=t, name=n[:70], calls=c) for t, n, c in rows[:10]])


def device_profile(fn, reps: int = 10, tries: int = 3) -> dict:
    """torch.profiler over `reps` calls of fn() after a warm-up: the self
    device time per call of all its device events (kernels and copies), the
    device events per call as recorded, and each event's ms per call by
    name: its mean time times its launches per call, rounded.  The profiler
    on the card sometimes drops records, or all of them: a session whose
    every event count is not a multiple of reps is run again, up to `tries`
    sessions, and the last one that recorded anything is kept."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    out = None
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        by_name, events, whole = {}, 0, True
        for e in prof.key_averages():
            if (e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
                    and not e.key.startswith("Activity Buffer")):
                name = e.key[:70]
                per_call = max(1, round(e.count / reps))
                by_name[name] = (by_name.get(name, 0.0)
                                 + e.self_device_time_total / 1e3 / e.count * per_call)
                events += e.count
                whole = whole and e.count % reps == 0
        if by_name:
            out = dict(device_ms=sum(by_name.values()), events=events / reps, by_name=by_name)
            if whole:
                break
    check(out is not None, "torch.profiler recorded no device time")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 1
    # a caller may have TF32 on; the fast path must not depend on it
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True

    from icspcodec_torch import codec
    from icspcodec_torch.bitstream import write_bitstream_grouped
    from icspcodec_torch.bitstream_device import frame_items_dev
    from icspcodec_torch.codec import _DEC_INTER_KEYS, _DEC_INTRA_KEYS, _INTRA_KEYS
    from icspcodec_torch.config import CodecConfig
    from icspcodec_torch.constants import COS_DEC, SPIRAL, SPIRAL_UNION
    from icspcodec_torch.bitstream_device import assemble_frames
    from icspcodec_torch.engine.inter import (decode_gop_mvs, decode_inter_frame,
                                              encode_inter_frame)
    from icspcodec_torch.engine.intra import (decode_chroma_idct, decode_intra_frames,
                                              encode_chroma_batch, encode_intra_frames,
                                              from_blocks, to_blocks)
    from icspcodec_torch.ops import (_build, dc_fused, intra_decode_fused, intra_fused, mc_fused,
                                     me_fused, xform_fused)
    from icspcodec_torch.io import save_yuv420
    from icspcodec_torch.metrics import MetricsLog
    from icspcodec_torch.engine.wavefront import intra_luma_scan
    from icspcodec_torch.ops.me import (gather_pred, mv_diff_field, spiral_search,
                                        spiral_search_fixed, spiral_search_union,
                                        stateful_select, window_start)
    from icspcodec_torch.ops.pad import pad_image
    from icspcodec_torch.ops.quant import c_trunc
    from icspcodec_torch.ops.transforms import fdct, idct
    from icspcodec_torch.runtime import AmbiguousTailError, parse_body
    from icspcodec_torch.streaming import _gop_fingerprint, encode_streaming
    from icspcodec_torch.tables import (CHROMA_OFFSETS, CHROMA_U_OFFSETS, NEG_SPIRAL, NEG_UNION,
                                        SPIRAL_TO_CHROMA, pack_header)

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
        me_fused.launches = me_fused.launches_extra = xform_fused.launches = 0
        me_fused.launches_best = me_fused.launches_union = 0

    def counts():
        return {"A": intra_fused.launches, "B": dc_fused.launches,
                "B'": dc_fused.launches_inv, "C": intra_decode_fused.launches,
                "E": mc_fused.launches, "D": me_fused.launches,
                "F": xform_fused.launches, "G": me_fused.launches_extra,
                "sad_best": me_fused.launches_best, "sad_union": me_fused.launches_union}

    # ---- 1. build ---------------------------------------------------------
    t0 = time.time()
    logs = _build.build(["intra_luma", "dc_dpcm", "intra_decode", "mc_gather", "sad_mc",
                         "xform_fwd", "vlcparse"])
    for name, log in logs.items():
        print(f"[build {name}]\n{log.strip()}")
    print(f"build: {time.time() - t0:.1f} s", flush=True)

    y, cb, cr = cif_content(NF)
    yt = torch.from_numpy(y).to(dev)
    ct = torch.from_numpy(np.concatenate([cb, cr])).to(dev)
    err = {k: 0 for k in ("A", "B", "B'", "C", "E", "D", "F", "G", "sad_best",
                          "sad_union")}  # largest |kernel - plain|

    # ---- 2. kernels B and B' vs plain -------------------------------------
    def b_layout(x):
        """The layout kernel B takes for the planes x: the launcher's answer."""
        ppc = dc_fused.forward_planes_per_cta(*x.shape, x.dtype == torch.float64, dev)
        return f"staged, {ppc} plane{'s' if ppc > 1 else ''} a CTA" if ppc else "ring"

    def check_b(x, qstep, chroma, what):
        ok = all(torch.equal(a, b) for a, b in zip(dc_fused.dc_dpcm_fused(x, qstep, chroma),
                                                    dc_fused.dc_dpcm_plain(x, qstep, chroma)))
        check(ok, f"kernel B {x.dtype} {what} {tuple(x.shape)} (chroma {chroma}, qstep {qstep}, "
                  f"{b_layout(x)}): differs from plain")

    dcs = {}
    for dtype in (torch.float32, torch.float64):
        dc = fdct(to_blocks(ct).to(torch.int32), dtype=dtype)[..., 0, 0].contiguous()
        dcs[dtype] = dc
        for qstep in (16, 1):
            qk, dqk = dc_fused.dc_dpcm_fused(dc, qstep, chroma=True)
            qp, dqp = dc_fused.dc_dpcm_plain(dc, qstep, chroma=True)
            e = max(max_abs(qk, qp), max_abs(dqk, dqp))
            err["B"] = max(err["B"], e)
            check(e == 0, f"kernel B {dtype} qstep {qstep}: differs from plain by {e}")
            print(f"kernel B {str(dtype)[6:]} qstep {qstep}: bit-identical "
                  f"({dc.shape[0]} planes; {b_layout(dc)})", flush=True)
    dc32, dc64 = dcs[f32], dcs[torch.float64]
    # B on both sides of the staged layout's limit, which the launcher
    # computes for each type from the card's opt-in shared memory (the
    # tallest plane of width 4 that it stages), on edge shapes (gh = 1,
    # gw = 1, odd gw), on planes of more than one band of the walk (128 block
    # rows) and at every qstep the header carries (1 .. 255), on DCs with
    # exact half-integers and residuals far below zero (floor against trunc,
    # C division of negatives)
    rng = np.random.default_rng(9)

    def edge_dcs(f, gh, gw):
        a = rng.normal(1024, 400, (f, gh, gw))
        a[..., ::3] = np.round(a[..., ::3]) + 0.5
        a[..., 1::4] = -rng.uniform(0, 3000, a[..., 1::4].shape)
        a[..., 2::5] = np.round(rng.uniform(-3000, 3000, a[..., 2::5].shape)) - 0.5
        return torch.from_numpy(a).to(dev)

    b_layouts = {}
    for dtype in (f32, torch.float64):
        name = str(dtype)[6:]
        lo, hi = 1, 8190
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if dc_fused.forward_planes_per_cta(2, mid, 4, dtype == torch.float64, dev):
                lo = mid
            else:
                hi = mid - 1
        check(lo < 8190, f"kernel B {name}: stages planes of every height (no ring walk left)")
        for shape in ((2, lo, 4), (2, lo + 1, 4), (3, 1, 9), (3, 7, 1), (3, 5, 7), (2, 200, 3),
                      (2, 300, 22)):
            x = edge_dcs(*shape).to(dtype)
            for chroma in (False, True):
                for qstep in (7,) if shape[1] > 1000 else (1, 7, 16, 255):
                    check_b(x, qstep, chroma, "edge DCs")
            b_layouts[f"{name} {shape}"] = b_layout(x)
            print(f"kernel B {name} {shape}: {b_layouts[f'{name} {shape}']}, bit-identical "
                  "(luma and chroma kinds)", flush=True)
        check(b_layouts[f"{name} {(2, lo, 4)}"] != "ring" and b_layouts[f"{name} {(2, lo + 1, 4)}"]
              == "ring", f"kernel B {name}: the planes beside the limit took {b_layouts}")
        x = edge_dcs(8, 18, 22).to(dtype)
        for qstep in range(1, 256):
            for chroma in (False, True):
                check_b(x, qstep, chroma, "qstep sweep")
        print(f"kernel B {name}: bit-identical at qstep 1 .. 255 (8 planes of 18x22, "
              f"{b_layout(x)}, luma and chroma kinds)", flush=True)
    div_bad = int(dc_fused.division_mismatches(255, dev).sum())
    check(div_bad == 0, f"kernel B's division differs from C division for {div_bad} dividends")
    print("kernel B's multiply-high division equals C division for qstep 1 .. 255 and every "
          "int32 dividend", flush=True)
    # B' on the dequantized DC residuals of the CIF300 chroma planes
    iq_c = dc_fused.dc_dpcm_fused(dc32, 16, chroma=True)[0] * 16
    e = max_abs(dc_fused.idc_dpcm_fused(iq_c, chroma=True), dc_fused.idc_dpcm_plain(iq_c, True))
    err["B'"] = max(err["B'"], e)
    check(e == 0, f"kernel B' at the CIF chroma grid: differs from plain by {e}")
    print(f"kernel B' at the CIF chroma grid: bit-identical ({iq_c.shape[0]} planes)", flush=True)
    # planes past the 768 block rows the first port took, and of the
    # header's largest height (8,190 block rows, 65,520 lines), narrow
    rng = np.random.default_rng(8190)
    tall_layouts = {}
    for gh in (769, 8190):
        for chroma in (False, True):
            dcb = torch.from_numpy(rng.normal(1024, 400, (2, gh, 4))).to(dev)
            for dtype in (f32, torch.float64):
                x = dcb.to(dtype)
                check_b(x, 7, chroma, "tall")
                tall_layouts[f"{str(dtype)[6:]} {tuple(x.shape)}"] = b_layout(x)
            iq = torch.from_numpy(rng.integers(-3000, 3000, (2, gh, 4))).to(dev)
            check(torch.equal(dc_fused.idc_dpcm_fused(iq, chroma),
                              dc_fused.idc_dpcm_plain(iq, chroma)),
                  f"kernel B' on {gh} block rows (chroma {chroma}): differs from plain")
    print("kernels B (float32, float64) and B' on planes of 769 and 8,190 block rows, luma and "
          "chroma kinds: bit-identical; B's layouts " + json.dumps(tall_layouts), flush=True)
    b_layouts.update(tall_layouts)
    del dcb, x, iq
    # B's path: its entry point, which no codec path calls since the
    # encoder's chroma chain went through kernel F
    reset_counts()
    dc_fused.dc_dpcm_fused(dc32, 16, chroma=True)
    torch.cuda.synchronize()
    launches_b = counts()
    check(launches_b["B"] == 1, f"the DC chain entry point did not launch kernel B: {launches_b}")

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
    # float32 too is bit-identical: its dense products' double sums are exact
    # (csrc/intra_luma.cu, "Precision")
    for dtype in (torch.float64, f32):
        for qdc, qac in ((16, 16), (1, 1)):
            k = intra_fused.intra_luma_scan_fused(o8, qdc, qac, dtype=dtype, recon_plane=True)
            p = intra_fused.intra_luma_scan_plain(o8, qdc, qac, dtype=dtype, recon_plane=True)
            e = max(max_abs(k[n], p[n]) for n in keys)
            check(all(torch.equal(k[n], p[n]) for n in keys),
                  f"kernel A {dtype} QP {qdc}/{qac}: differs from plain by {e}")
            print(f"kernel A {str(dtype)[6:]} QP {qdc}/{qac}: bit-identical (8 CIF frames)",
                  flush=True)

    oy = to_blocks(yt)
    k = intra_fused.intra_luma_scan_fused(oy, 16, 16, dtype=f32, recon_plane=True)
    p = intra_fused.intra_luma_scan_plain(oy, 16, 16, dtype=f32, recon_plane=True)
    err["A"] = max(max_abs(k[n], p[n]) for n in keys)
    ndiff = int((k["scan"] != p["scan"]).sum())
    a32 = dict(symbols_differing=ndiff, symbols=k["scan"].numel(), max_abs_err=err["A"])
    print("kernel A float32 CIF300 vs plain: " + json.dumps(a32), flush=True)
    check(all(torch.equal(k[n], p[n]) for n in keys),
          f"kernel A float32 CIF300: differs from plain ({a32})")
    a_nonzero = nonzero_dequantized(k["scan"], 16, chroma=False)   # for A's bound
    del k, p

    # the ring of boundary state in global scratch: a plane too tall for the
    # shared-memory ring (2,560 block rows x 96 bytes > 227 KB)
    rng = np.random.default_rng(2560)
    tall = to_blocks(torch.from_numpy(rng.integers(0, 256, (1, 2560 * 8, 32),
                                                    dtype=np.uint8)).to(dev))
    for dtype in (torch.float64, f32):
        k = intra_fused.intra_luma_scan_fused(tall, 8, 16, dtype=dtype, recon_plane=True)
        p = intra_fused.intra_luma_scan_plain(tall, 8, 16, dtype=dtype, recon_plane=True)
        check(all(torch.equal(k[n], p[n]) for n in keys),
              f"kernel A {dtype} on a 20,480x32 plane: differs from plain")
    print("kernel A float64 and float32 on a 20,480x32 plane (the ring in global scratch): "
          "bit-identical", flush=True)
    del k, p

    # the intra chroma chain through kernel F equals F's plain version: the
    # batched fdct, DC chain, quantization and idct
    for dtype in (torch.float64, f32):
        via_f = encode_chroma_batch(ct, 16, 16, dtype=dtype)
        plain = xform_fused.xform_fwd_plain(to_blocks(ct), 16, 16, True, dtype=dtype)
        check(all(torch.equal(via_f[n], plain[m])
                  for n, m in (("scan", "scan"), ("acflag", "acflag"), ("idct", "r"))),
              f"intra chroma {dtype}: kernel F's route differs from the plain chain")
    print(f"intra chroma chain of CIF300 ({ct.shape[0]} planes), float64 and float32: kernel F's "
          "route equals the plain chain", flush=True)
    del via_f, plain

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
        print(f"kernels A, B and B' float64 / int at {w}x{h}: bit-identical (B {b_layout(dc)})",
              flush=True)

    # ---- 4. end to end: the all-intra encode ------------------------------
    cfg = CodecConfig(width=W, height=H, qp_dc=16, qp_ac=16, precision="fast")
    reset_counts()
    bits, rec = codec.encode(y, cb, cr, cfg)
    torch.cuda.synchronize()
    launches_enc = counts()
    check(launches_enc["A"] >= 1 and launches_enc["F"] >= 1,
          f"the encode did not launch kernels A and F: {launches_enc}")
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
    a64_dev_ms = device_profile(lambda: intra_fused.intra_luma_scan_fused(
        oy, 16, 16, dtype=torch.float64, recon_plane=True), 5)["device_ms"]
    dev_ms = {"A": device_profile(lambda: intra_fused.intra_luma_scan_fused(
        oy, 16, 16, dtype=f32, recon_plane=True), 5)["device_ms"],
              "B": device_profile(lambda: dc_fused.dc_dpcm_fused(dc32, 16, chroma=True))[
                  "device_ms"]}   # the profiler's device ms per call of each timed function
    # B also in float64, and on one P-step's chroma planes (60 of 18x22)
    b64_dev_ms = device_profile(lambda: dc_fused.dc_dpcm_fused(dc64, 16, chroma=True))[
        "device_ms"]
    b60_dev_ms = device_profile(lambda: dc_fused.dc_dpcm_fused(dc32[:60], 16, chroma=True))[
        "device_ms"]

    nblk = oy.shape[0] * oy.shape[1] * oy.shape[2]
    a_bytes = nblk * (64 + 128 + 3 + 64) + 2 * 64 * 64 * 4 + 64 * 4 + 36 * 44 * 4
    # The float path's function is the two 64x64 products in double (what
    # keeps the encoder's rounding the decoder's), at the FP64 tensor-core
    # peak the kernel's mma can reach: the forward product dense, 4,096
    # multiply-adds a block, and the inverse 64 for each nonzero dequantized
    # value of this run (the kernel skips the k-steps whose blocks hold only
    # zeros).  The float64 path's is the separable transforms, 2 passes x 64
    # outputs x 8 multiply-adds each, on the FP64 pipes.
    a_flops = (nblk * 4096 + 64 * a_nonzero) * 2
    a_bound = max(a_bytes / PEAK_BYTES_S, a_flops / PEAK_F64_TC_FLOP_S) * 1e3
    a64_flops = nblk * 2 * 2 * 64 * 8 * 2
    a64_bound = max(a_bytes / PEAK_BYTES_S, a64_flops / PEAK_F64_FLOP_S) * 1e3
    a_diagonals = 2 * (oy.shape[1] - 1) + oy.shape[2]
    ncell = dc32.numel()
    # B reads its DCs and the kind grid once and writes q and dq
    b_bytes = ncell * (4 + 4 + 4) + 18 * 22 * 4
    b_bound = b_bytes / PEAK_BYTES_S * 1e3
    b64_bound = (ncell * (8 + 4 + 4) + 18 * 22 * 4) / PEAK_BYTES_S * 1e3
    b60_bound = (60 * 18 * 22 * (4 + 4 + 4) + 18 * 22 * 4) / PEAK_BYTES_S * 1e3
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

    def check_yc(pad_y, pad_c, mv, what):
        """mc_gather_yc against its plain version; returns the largest error."""
        e = max(max_abs(a, b) for a, b in zip(mc_fused.mc_gather_yc(pad_y, pad_c, mv),
                                              mc_fused.mc_gather_yc_plain(pad_y, pad_c, mv)))
        check(e == 0, f"kernel E mc_gather_yc on {what}: differs from plain by {e}")
        err["E"] = max(err["E"], e)

    shape = (30, H // 16, W // 16)
    mv = NEG_UNION[rng.integers(0, len(NEG_UNION), shape)]
    far = rng.random(shape) < 0.05
    mv = np.where(far[..., None], rng.integers(-400, 401, shape + (2,)), mv).astype(np.int32)
    check_yc(pad_image(yt[:30], 16), pad_image(torch.cat([ct[:30], ct[NF:NF + 30]]), 8),
             torch.from_numpy(mv).to(dev), "union and out-of-frame MVs")
    print(f"kernel E mc_gather_yc (luma, Cb and Cr in one launch): bit-identical (30 frames, "
          f"{int(far.sum())} MVs outside the padded frame)", flush=True)

    # ---- 6. kernel C vs plain ---------------------------------------------
    # float32 too is bit-identical: the kernel sums the plain version's double
    # product in another exact order (csrc/intra_decode.cu, "Precision")
    dsyms = parse_body(bits[14:], NF, H, W, 0)
    ys, mpm, mbit = (torch.from_numpy(dsyms[n]).to(dev) for n in ("y_scan", "mpm", "mode_bit"))
    c_cases = [("8 CIF frames", (ys[:8], mpm[:8], mbit[:8]), ((16, 16), (1, 1)))]
    # QCIF and 720p, and a plane of 2,560 block rows, whose ring is too tall
    # for shared memory and goes to global scratch
    for name, (h, w) in (("176x144", (144, 176)), ("1280x720", (720, 1280)),
                         ("20,480x32 plane", (20480, 32))):
        rng = np.random.default_rng(h)
        nf, gh, gw = (1 if h > 1000 else 2), h // 8, w // 8
        sc = np.where(rng.random((nf, gh, gw, 64)) < 0.15,
                      rng.integers(-30, 31, (nf, gh, gw, 64)), 0)
        sc[..., 0] = rng.integers(-6, 7, (nf, gh, gw))
        fl = rng.integers(0, 2, (2, nf, gh, gw)).astype(np.int8)
        c_cases.append((name, (torch.from_numpy(sc.astype(np.int16)).to(dev),
                               torch.from_numpy(fl[0]).to(dev), torch.from_numpy(fl[1]).to(dev)),
                        ((8, 16),)))
    for name, syms, qps in c_cases:
        for dtype in (torch.float64, f32):
            for qdc, qac in qps:
                k = intra_decode_fused.intra_luma_decode_fused(*syms, qdc, qac, dtype=dtype)
                p = intra_decode_fused.intra_luma_decode_plain(*syms, qdc, qac, dtype=dtype)
                check(torch.equal(k, p), f"kernel C {dtype} on {name} QP {qdc}/{qac}: "
                                         f"{int((k != p).sum())} pixels differ from plain")
        print(f"kernel C float64 and float32 on {name}, QP "
              f"{' and '.join(f'{a}/{b}' for a, b in qps)}: bit-identical", flush=True)
    del c_cases, k, p
    kc = intra_decode_fused.intra_luma_decode_fused(ys, mpm, mbit, 16, 16, dtype=torch.float64)
    check(torch.equal(kc, intra_decode_fused.intra_luma_decode_plain(ys, mpm, mbit, 16, 16,
                                                                      dtype=torch.float64)),
          "kernel C float64 CIF300: differs from plain")
    kc = intra_decode_fused.intra_luma_decode_fused(ys, mpm, mbit, 16, 16, dtype=f32)
    pc = intra_decode_fused.intra_luma_decode_plain(ys, mpm, mbit, 16, 16, dtype=f32)
    err["C"] = max_abs(kc, pc)
    pdiff = int((kc != pc).sum())
    dpf = psnr_frames(kc.cpu().numpy(), y) - psnr_frames(pc.cpu().numpy(), y)
    c32 = dict(pixels_differing=pdiff, pixels=kc.numel(), max_abs_err=err["C"],
               frames_affected=int((kc != pc).flatten(1).any(1).sum()),
               dpsnr_y_db=float(dpf.mean()), dpsnr_y_db_worst_frame=float(np.abs(dpf).max()))
    print("kernel C float32 CIF300 vs plain (float64 bit-identical too): " + json.dumps(c32),
          flush=True)
    check(torch.equal(kc, pc), f"kernel C float32 CIF300: differs from plain ({c32})")
    c_nonzero = nonzero_dequantized(ys, 16, chroma=False)   # for C's bound
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
    dev_ms["C"] = device_profile(lambda: intra_decode_fused.intra_luma_decode_fused(
        ys, mpm, mbit, 16, 16, dtype=f32), 5)["device_ms"]
    c64_dev_ms = device_profile(lambda: intra_decode_fused.intra_luma_decode_fused(
        ys, mpm, mbit, 16, 16, dtype=torch.float64), 5)["device_ms"]
    c_diagonals = 2 * (ys.shape[1] - 1) + ys.shape[2]
    c_ctas = {n: intra_decode_fused.resident_ctas(ys.shape[1], ys.shape[2], d)
              for n, d in (("float32", f32), ("float64", torch.float64))}
    # kernel B' at the three shapes a decode gives it: the all-intra decode's
    # chroma batch (600 planes of 18x22), and a period-10 decode P-step's luma
    # (30 planes of 36x44) and chroma (60 planes of 18x22); that decode
    # launches it once on 60 intra chroma planes and twice a P-step, 19 times
    iq_l = ys[:30, ..., 0].to(torch.int32) * 16
    dev_ms["B'"] = device_profile(lambda: dc_fused.idc_dpcm_fused(iq_c, chroma=True))["device_ms"]
    bi_luma_ms = device_profile(lambda: dc_fused.idc_dpcm_fused(iq_l, chroma=False))["device_ms"]
    bi_chroma60_ms = device_profile(lambda: dc_fused.idc_dpcm_fused(iq_c[:60],
                                                                    chroma=True))["device_ms"]
    bi_p10_ms = 10 * bi_chroma60_ms + 9 * bi_luma_ms
    print("kernel C CIF300 and B' at the decode's shapes (device ms): " + json.dumps(dict(
        C_float32_device_ms=dev_ms["C"], C_float64_device_ms=c64_dev_ms,
        C_device_us_per_diagonal=dev_ms["C"] / c_diagonals * 1e3, C_diagonals=c_diagonals,
        C_resident_ctas_per_sm=c_ctas, Bi_cif300_chroma_device_ms=dev_ms["B'"],
        Bi_p_step_luma_device_ms=bi_luma_ms, Bi_p_step_chroma_device_ms=bi_chroma60_ms,
        Bi_period10_decode_19_launches_device_ms=bi_p10_ms)), flush=True)
    # i16 symbols and i8 flags in, u8 recon out, the tables once.  The float
    # path's function is the inverse product in double (what keeps its
    # rounding the plain version's): 64 multiply-adds for each nonzero
    # dequantized value of this run, at the FP64 tensor-core peak, as for A
    c_bytes = nblk * (128 + 2 + 64) + 4096 * 4 + 64 * 4 + 36 * 44 * 4
    c_flops = 64 * c_nonzero * 2
    c_bound = max(c_bytes / PEAK_BYTES_S, c_flops / PEAK_F64_TC_FLOP_S) * 1e3
    bi_bytes = iq_c.numel() * (4 + 4) + 18 * 22 * 4
    bi_bound = bi_bytes / PEAK_BYTES_S * 1e3
    del up, up_args, out, ys, mpm, mbit, iq_l

    # ---- 8. kernels D and G vs plain --------------------------------------
    period = 10
    ng = NF // period                     # 30 GOPs: the batch of one P-step
    # benchA frames 1..30 against the port's intra recon of frames 0..29, the
    # same synthStatic frames, and 720p frames with static regions
    prev = encode_intra_frames(yt[:ng], cbt[:ng], crt[:ng], 16, 16, dtype=f32)
    sy, scb, scr = cif_content(ng + 1, "synthStatic")
    syt, scbt, scrt = (torch.from_numpy(a).to(dev) for a in (sy, scb, scr))
    sprev = encode_intra_frames(syt[:ng], scbt[:ng], scrt[:ng], 16, 16, dtype=f32)
    rng = np.random.default_rng(720)
    y7 = torch.from_numpy(rng.integers(0, 256, (3, 720, 1280), dtype=np.uint8)).to(dev)
    y7[1:, 96:304, 192:512] = y7[:2, 96:304, 192:512]
    me_cases = [(name, cur.contiguous(), pad_image(prv, 16))
                for name, cur, prv in (("benchA", yt[1:ng + 1], prev["recon_y"]),
                                       ("synthStatic", syt[1:], sprev["recon_y"]),
                                       ("720p", y7[1:], y7[:2]))]
    for name, cur, pad in me_cases:
        kd, pd = me_fused.sad_mc_best(cur, pad), me_fused.sad_mc_best_plain(cur, pad)
        kg, pg = me_fused.sad_union_extra(cur, pad), me_fused.sad_union_extra_plain(cur, pad)
        ed, eg = max(max_abs(a, b) for a, b in zip(kd, pd)), max_abs(kg, pg)
        err["D"], err["G"] = max(err["D"], ed), max(err["G"], eg)
        check(ed == 0, f"kernel D on {name}: differs from plain by {ed}")
        check(eg == 0, f"kernel G on {name}: differs from plain by {eg}")
        print(f"kernels D and G on {name} ({cur.shape[0]} frames of {cur.shape[2]}x{cur.shape[1]}, "
              f"{int((pd[1] >= 2).sum())} MBs with zc >= 2): bit-identical", flush=True)
    del kd, pd, kg, pg, y7, sprev
    cur_d, pad_d = me_cases[0][1:]
    kd_ms = event_ms(lambda: me_fused.sad_mc_best(cur_d, pad_d), 20)
    pd_ms = event_ms(lambda: me_fused.sad_mc_best_plain(cur_d, pad_d), 3)
    kg_ms = event_ms(lambda: me_fused.sad_union_extra(cur_d, pad_d), 20)
    pg_ms = event_ms(lambda: me_fused.sad_union_extra_plain(cur_d, pad_d), 3)
    dev_ms["D"] = device_profile(lambda: me_fused.sad_mc_best(cur_d, pad_d))["device_ms"]
    dev_ms["G"] = device_profile(lambda: me_fused.sad_union_extra(cur_d, pad_d))["device_ms"]
    nmb = ng * (H // 16) * (W // 16)
    # each input byte read once, each output written once; the byte absolute
    # differences accumulated (64 steps or 66 offsets x 256 px), diffs_op to
    # an operation
    diffs_op = sad_diffs_per_op(_build._target("sad_mc"),
                                pathlib.Path(_build.nvcc()).parent / "cuobjdump")
    d_bytes = 2 * cur_d.numel() + pad_d.numel() + nmb * (63 + 2) * 4 + 64 * 3 * 4
    d_ops = nmb * 64 * 256 // diffs_op
    d_bound = max(d_bytes / PEAK_BYTES_S, d_ops / PEAK_LANE_OP_S) * 1e3
    g_bytes = cur_d.numel() + pad_d.numel() + nmb * 66 * 4 + 66 * 2 * 4
    g_ops = nmb * 66 * 256 // diffs_op
    g_bound = max(g_bytes / PEAK_BYTES_S, g_ops / PEAK_LANE_OP_S) * 1e3

    # ---- 9. kernel F vs plain ---------------------------------------------
    # one P-step's residuals: luma against kernel D's predictor, Cb and Cr
    # against the chroma predictor at D's MVs (the fixed branch)
    best_d, _, _, pred_d = me_fused.sad_mc_best(cur_d, pad_d)
    res_l = to_blocks(cur_d.to(torch.int32) - pred_d.to(torch.int32))
    padc_d = pad_image(torch.cat([prev["recon_cb"], prev["recon_cr"]]), 8)
    cidx_d = torch.from_numpy(SPIRAL_TO_CHROMA).to(dev)[best_d.long()]
    predc_d = mc_fused.mc_select(padc_d, torch.cat([cidx_d, cidx_d]), CHROMA_OFFSETS, 8)
    curc_d = torch.cat([cbt[1:ng + 1], crt[1:ng + 1]])
    res_c = to_blocks(curc_d.to(torch.int32) - predc_d.to(torch.int32))
    rng = np.random.default_rng(7200)
    f_cases = [("CIF luma", res_l[:8], False), ("CIF chroma", res_c[:16], True)]
    # 720p and 1080p walk 3-5 sets of 32 block rows a lane (ROWS 4 and 8),
    # 1080p luma keeps its DC terms in global scratch (32,400 cells do not
    # fit in shared memory), and a 4096-line plane is the tallest the walk
    # takes (ROWS 16)
    for name, (h7, w7), chroma in (("720p luma", (720, 1280), False),
                                   ("720p chroma", (368, 640), True),
                                   ("1080p luma", (1080, 1920), False),
                                   ("1080p chroma", (544, 960), True),
                                   ("4096-line luma", (4096, 32), False)):
        r7 = np.clip(rng.normal(0, 30, (2, h7, w7)), -255, 255).astype(np.int32)
        f_cases.append((name, to_blocks(torch.from_numpy(r7).to(dev)), chroma))
    keys_f = ("scan", "acflag", "r")
    # planes taller than one band of the DC walk (512 block rows): an 8K UHD
    # luma plane, and luma and chroma planes of the header's largest height
    for name, (h7, w7), chroma in (("8K UHD luma", (4320, 7680), False),
                                   ("65,520-line luma", (65520, 32), False),
                                   ("32,760-line chroma", (32760, 16), True)):
        blk = to_blocks(torch.from_numpy(np.clip(rng.normal(0, 30, (1, h7, w7)), -255, 255)
                                         .astype(np.int32)).to(dev))
        for dtype in (torch.float64, f32):
            k = xform_fused.xform_fwd_fused(blk, 16, 16, chroma, dtype=dtype)
            p = xform_fused.xform_fwd_plain(blk, 16, 16, chroma, dtype=dtype)
            check(all(torch.equal(k[n], p[n]) for n in keys_f),
                  f"kernel F {dtype} {name} plane: differs from plain")
        print(f"kernel F float64 and float32 on a {name} plane ({w7}x{h7}), QP 16/16: "
              "bit-identical", flush=True)
        del blk, k, p
    # float32 too is bit-identical: its double sums are exact (csrc/xform_fwd.cu,
    # "Precision"); the 0.1% / 0.05 dB check below stays as the fast path's guard
    for name, blk, chroma in f_cases:
        for dtype in (torch.float64, f32):
            for qdc, qac in ((16, 16), (1, 1)):
                k = xform_fused.xform_fwd_fused(blk, qdc, qac, chroma, dtype=dtype)
                p = xform_fused.xform_fwd_plain(blk, qdc, qac, chroma, dtype=dtype)
                check(all(torch.equal(k[n], p[n]) for n in keys_f),
                      f"kernel F {dtype} {name} QP {qdc}/{qac}: differs from plain")
        print(f"kernel F float64 and float32 {name} ({blk.shape[0]} planes), QP 16/16 and 1/1: "
              "bit-identical", flush=True)
    kf = [xform_fused.xform_fwd_fused(res_l, 16, 16, False, dtype=f32),
          xform_fused.xform_fwd_fused(res_c, 16, 16, True, dtype=f32)]
    pf = [xform_fused.xform_fwd_plain(res_l, 16, 16, False, dtype=f32),
          xform_fused.xform_fwd_plain(res_c, 16, 16, True, dtype=f32)]
    err["F"] = max(float((a[n].double() - b[n].double()).abs().max())
                   for a, b in zip(kf, pf) for n in ("scan", "r"))
    fdiff = sum(int((a["scan"] != b["scan"]).sum()) for a, b in zip(kf, pf))
    fsyms = sum(a["scan"].numel() for a in kf)
    check(all(torch.equal(a[n], b[n]) for a, b in zip(kf, pf) for n in keys_f),
          "kernel F float32 at the CIF300 P-step: differs from plain")
    # a call of more blocks than one launch takes is split over its planes:
    # force it at CIF (3 planes a launch, 10 launches a call)
    cap, n0 = xform_fused.MAX_CELLS, xform_fused.launches
    xform_fused.MAX_CELLS = 3 * res_l.shape[1] * res_l.shape[2]
    try:
        for dtype, plain in ((f32, pf[0]),
                             (torch.float64, xform_fused.xform_fwd_plain(res_l, 16, 16, False))):
            k = xform_fused.xform_fwd_fused(res_l, 16, 16, False, dtype=dtype)
            check(all(torch.equal(k[n], plain[n]) for n in keys_f),
                  f"kernel F {dtype}, split over planes: differs from plain")
    finally:
        xform_fused.MAX_CELLS = cap
    check(xform_fused.launches - n0 == 20,
          f"kernel F split over planes: {xform_fused.launches - n0} launches (20 expected)")
    print("kernel F split over planes (10 launches a call): bit-identical", flush=True)

    def luma_recon(xf):
        return torch.clamp(pred_d.to(torch.int32) + from_blocks(xf["r"]), 0, 255).cpu().numpy()

    dpf = psnr_frames(luma_recon(kf[0]), cur_d.cpu().numpy()) - psnr_frames(
        luma_recon(pf[0]), cur_d.cpu().numpy())
    f_check = dict(symbols_differing=fdiff, symbols=fsyms, max_abs_err=err["F"],
                   dpsnr_y_db_worst_frame=float(np.abs(dpf).max()))
    print("kernel F float32 CIF300 P-step (luma and chroma) vs plain: " + json.dumps(f_check),
          flush=True)
    check(fdiff <= 0.001 * fsyms, f"kernel F float32: {fdiff} of {fsyms} symbols differ (> 0.1%)")
    check(f_check["dpsnr_y_db_worst_frame"] <= 0.05,
          f"kernel F float32: a frame's |dPSNR-Y| {f_check['dpsnr_y_db_worst_frame']} > 0.05 dB")
    f_nonzero = (nonzero_dequantized(kf[0]["scan"], 16, chroma=False)
                 + nonzero_dequantized(kf[1]["scan"], 16, chroma=True))   # for F's bound
    del kf, pf, f_cases

    def f_kernel():
        return (xform_fused.xform_fwd_fused(res_l, 16, 16, False, dtype=f32),
                xform_fused.xform_fwd_fused(res_c, 16, 16, True, dtype=f32))

    kf_ms = event_ms(f_kernel, 20)
    kf_prof = device_profile(f_kernel)
    dev_ms["F"] = kf_prof["device_ms"]
    # two kernels a call (the parent's F had three); the profiler may drop
    # a record, never add one
    check(kf_prof["events"] <= 4 and len(kf_prof["by_name"]) == 4,
          f"kernel F: {kf_prof['events']} device launches for two calls (two a call "
          f"expected): {kf_prof['by_name']}")
    print("kernel F float32 one P-step (luma and chroma calls), device ms by kernel: "
          + json.dumps(kf_prof), flush=True)
    kf64_ms = event_ms(lambda: (xform_fused.xform_fwd_fused(res_l, 16, 16, False),
                                xform_fused.xform_fwd_fused(res_c, 16, 16, True)), 10)
    pf_ms = event_ms(lambda: (xform_fused.xform_fwd_plain(res_l, 16, 16, False, dtype=f32),
                              xform_fused.xform_fwd_plain(res_c, 16, 16, True, dtype=f32)), 3)
    nb_l, nb_c = res_l[..., 0, 0].numel(), res_c[..., 0, 0].numel()
    # int32 blocks in; int16 symbols, int8 flags and r (int32 luma, float32
    # chroma) out.  The float path's function is the two 64x64 products in
    # double (what keeps the encoder's references equal to the decoder's),
    # at the FP64 tensor-core peak that the kernel's DMMA can reach: the
    # forward dense, 4,096 multiply-adds a block, and the inverse 64 for each
    # nonzero dequantized value of this run.  The float64 path's is the
    # separable transforms, 4,096 flops a block, on the FP64 pipes.
    f_bytes = (nb_l + nb_c) * (64 * 4 + 64 * 2 + 1 + 64 * 4) + 2 * (8192 * 4 + 64 * 4)
    f_flops = ((nb_l + nb_c) * 4096 + 64 * f_nonzero) * 2
    f_bound = max(f_bytes / PEAK_BYTES_S, f_flops / PEAK_F64_TC_FLOP_S) * 1e3
    f64_bytes = f_bytes + nb_c * 64 * 4 + 2 * (65 * 8 - 8192 * 4)
    f64_flops = (nb_l + nb_c) * 4096
    f64_bound = max(f64_bytes / PEAK_BYTES_S, f64_flops / PEAK_F64_FLOP_S) * 1e3

    # ---- 10. end to end: the period-10 encode -----------------------------
    cfg10 = CodecConfig(width=W, height=H, qp_dc=16, qp_ac=16, intra_period=period,
                        precision="fast")
    reset_counts()
    bits10, rec10 = codec.encode(y, cb, cr, cfg10)
    torch.cuda.synchronize()
    launches_enc10 = counts()
    check(all(launches_enc10[n] >= 1 for n in ("A", "D", "E", "F")),
          f"the period-10 encode did not launch kernels A, D, E and F: {launches_enc10}")
    check(rec10["y"].shape == y.shape and len(bits10) > 14,
          "period-10 encode output has the wrong shape")
    psnr10 = psnr(rec10["y"], y)
    check(np.isfinite(psnr10) and psnr10 > 30, f"period-10 encode PSNR-Y {psnr10} dB is implausible")
    enc10_ms = event_ms(lambda: codec.encode(y, cb, cr, cfg10), reps=3, warmup=0)
    e2e10 = dict(frames=NF, bytes=len(bits10), psnr_y_db=psnr10, encode_ms=enc10_ms,
                 encode_fps=NF / (enc10_ms / 1e3), launches=launches_enc10)
    print("encode period-10 CIF300 fast: " + json.dumps(e2e10), flush=True)
    print("device time by kernel in one period-10 encode: " + json.dumps(profile_run(
        lambda: codec.encode(y, cb, cr, cfg10), enc10_ms)), flush=True)

    # stage by stage: the engine, one P-step's parts (x 9 P-steps), the
    # entropy stages and the host splice
    from icspcodec_torch.engine.inter import encode_gop
    g3 = [a.reshape((ng, period) + a.shape[1:]) for a in (yt, cbt, crt)]
    st10 = {}
    st10["upload_ms"] = st["upload_ms"]
    st10["engine_ms"] = event_ms(lambda: encode_gop(*g3, 16, 16, dtype=f32), 3)
    st10["intra_batch_ms"] = event_ms(lambda: encode_intra_frames(
        g3[0][:, 0], g3[1][:, 0], g3[2][:, 0], 16, 16, dtype=f32), 3)
    it = encode_intra_frames(g3[0][:, 0], g3[1][:, 0], g3[2][:, 0], 16, 16, dtype=f32)
    cur1 = g3[0][:, 1]
    step = dict(p_step_ms=event_ms(lambda: encode_inter_frame(
        cur1, g3[1][:, 1], g3[2][:, 1], it["recon_y"], it["recon_cb"], it["recon_cr"], 16, 16,
        dtype=f32), 5))
    pad1 = pad_image(it["recon_y"], 16)
    step["D_ms"] = event_ms(lambda: me_fused.sad_mc_best(cur1, pad1), 20)
    best1, zc1, _, pred1 = me_fused.sad_mc_best(cur1, pad1)
    step["branch_sync_ms"] = event_ms(lambda: bool((zc1 >= 2).any()), 20)
    padc1 = pad_image(torch.cat([it["recon_cb"], it["recon_cr"]]), 8)
    cidx1 = torch.from_numpy(SPIRAL_TO_CHROMA).to(dev)[best1.long()]
    step["E_chroma_ms"] = event_ms(lambda: mc_fused.mc_select(
        padc1, torch.cat([cidx1, cidx1]), CHROMA_OFFSETS, 8), 20)
    predc1 = mc_fused.mc_select(padc1, torch.cat([cidx1, cidx1]), CHROMA_OFFSETS, 8)
    res1 = to_blocks(cur1.to(torch.int32) - pred1.to(torch.int32))
    resc1 = to_blocks(torch.cat([g3[1][:, 1], g3[2][:, 1]]).to(torch.int32)
                      - predc1.to(torch.int32))
    step["F_luma_ms"] = event_ms(lambda: xform_fused.xform_fwd_fused(
        res1, 16, 16, False, dtype=f32), 20)
    step["F_chroma_ms"] = event_ms(lambda: xform_fused.xform_fwd_fused(
        resc1, 16, 16, True, dtype=f32), 20)
    step["glue_ms"] = step["p_step_ms"] - sum(v for n, v in step.items() if n != "p_step_ms")
    st10["one_p_step_ms"] = step
    (isy, iix), (psy, pix), rect = codec.encode_symbols(yt, cbt, crt, cfg10)
    st10["items_ms"] = event_ms(lambda: (frame_items_dev(isy, True),
                                         frame_items_dev(psy, False)), 3)
    ci, li = frame_items_dev(isy, True)
    cp, lp = frame_items_dev(psy, False)
    st10["pack_and_pull_ms"] = event_ms(lambda: (_pack_bucketed(ci, li),
                                                 _pack_bucketed(cp, lp)), 3)
    rows10, nbits10 = [None] * NF, [None] * NF
    for idx, (r, b) in ((iix, _pack_bucketed(ci, li)), (pix, _pack_bucketed(cp, lp))):
        for n, row, nb in zip(idx, r, b):
            rows10[int(n)], nbits10[int(n)] = row, nb
    st10["host_splice_ms"] = event_ms(lambda: pack_header(H, W, 16, 16, period) + assemble_frames(
        rows10, nbits10), 3)
    check(pack_header(H, W, 16, 16, period) + assemble_frames(rows10, nbits10) == bits10,
          "the staged period-10 encode's bytes differ from codec.encode's")
    st10["recon_pull_ms"] = event_ms(lambda: [rect[n].cpu() for n in ("y", "cb", "cr")], 3)
    print("period-10 encode stages (ms; one P-step's parts, 9 P-steps per encode): "
          + json.dumps(st10), flush=True)
    del g3, it, isy, psy, rect, ci, li, cp, lp, rows10, res1, resc1

    # ---- 11. end to end: a synthStatic encode (kernel G) ------------------
    sy, scb, scr = sy[:ng], scb[:ng], scr[:ng]
    reset_counts()
    bits_s, rec_s = codec.encode(sy, scb, scr, cfg10)
    torch.cuda.synchronize()
    launches_static = counts()
    check(all(launches_static[n] >= 1 for n in ("A", "D", "E", "F", "G")),
          f"the synthStatic encode did not launch kernels A, D, E, F and G: {launches_static}")
    psnr_s = psnr(rec_s["y"], sy)
    dec_s = codec.decode(bits_s, ng, precision="fast")
    psnr_sd = psnr(dec_s["y"], sy)
    check(abs(psnr_sd - psnr_s) <= 0.05,
          f"synthStatic decode PSNR-Y {psnr_sd} dB is not within 0.05 dB of the recon's {psnr_s}")
    static_ms = event_ms(lambda: codec.encode(sy, scb, scr, cfg10), reps=3, warmup=0)
    print("encode period-10 synthStatic CIF, 30 frames, fast: " + json.dumps(dict(
        frames=ng, bytes=len(bits_s), psnr_y_db=psnr_s, decoded_psnr_y_db=psnr_sd,
        encode_ms=static_ms, encode_fps=ng / (static_ms / 1e3), launches=launches_static)),
        flush=True)

    # ---- 12. end to end: the period-10 decode -----------------------------
    reset_counts()
    dec10 = codec.decode(bits10, NF, precision="fast")
    torch.cuda.synchronize()
    launches_p10 = counts()
    check(all(launches_p10[n] >= 1 for n in ("C", "B'", "E")),
          f"the period-10 decode did not launch kernels C, B' and E: {launches_p10}")
    check(launches_p10["E"] == period - 1,
          f"the period-10 decode launched E {launches_p10['E']} times, not once a P-step")
    check(all(dec10[n].shape == dec[n].shape for n in dec),
          "period-10 decode output has the wrong shape")
    psnr_d10 = psnr(dec10["y"], y)
    check(abs(psnr_d10 - psnr10) <= 0.05,
          f"period-10 decode PSNR-Y {psnr_d10} dB is not within 0.05 dB of the recon's {psnr10}")
    p10_ms = event_ms(lambda: codec.decode(bits10, NF, precision="fast"), reps=3, warmup=0)
    d_p10 = dict(frames=NF, bytes=len(bits10), psnr_y_db=psnr_d10, recon_psnr_y_db=psnr10,
                 decode_ms=p10_ms, decode_fps=NF / (p10_ms / 1e3), launches=launches_p10)
    print("decode period-10 CIF300 fast (phase 10's stream): " + json.dumps(d_p10), flush=True)
    print("device time by kernel in one period-10 decode: " + json.dumps(profile_run(
        lambda: codec.decode(bits10, NF, precision="fast"), p10_ms)), flush=True)
    psyms_np = parse_body(bits10[14:], NF, H, W, period)
    keys10 = _DEC_INTRA_KEYS + ("mv_diff",)
    sp = {}
    sp["parse_ms"] = event_ms(lambda: parse_body(bits10[14:], NF, H, W, period), 3)
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

    # a seeded period-10 stream: intra frames from the all-intra path's
    # symbols, MVs drawn from the 129 union offsets, sparse residuals
    isyms = encode_intra_frames(yt[::period], cbt[::period], crt[::period], 16, 16, dtype=f32,
                                return_recon=False)
    isyms = {n: isyms[n] for n in _INTRA_KEYS}
    psyms, mv = seeded_symbols(np.random.default_rng(2024), NF - NF // period, H, W,
                               intra=False)
    canon = {tuple(v) for v in NEG_SPIRAL.tolist()}
    nc = sum(1 for v in mv.reshape(-1, 2).tolist() if tuple(v) not in canon)
    check(nc > 0, "the seeded period-10 stream carries no non-canonical MV")
    p10 = write_gop_stream(isyms, {n: torch.from_numpy(v).to(dev) for n, v in psyms.items()},
                           torch.from_numpy(mv).to(dev), NF, H, W, 16, 16, period)
    dec10s = codec.decode(p10, NF, precision="fast")
    # the luma symbols of an intra frame do not depend on its batch (kernel A
    # works frame by frame), so neither do its decoded planes
    check(np.array_equal(dec10s["y"][::period], dec["y"][::period]),
          "the seeded period-10 decode's intra luma differs from the all-intra decode's")
    check(np.array_equal(dec10["y"][::period], dec["y"][::period]),
          "the period-10 decode's intra luma differs from the all-intra decode's")
    p10s_ms = event_ms(lambda: codec.decode(p10, NF, precision="fast"), reps=3, warmup=0)
    print("decode period-10 CIF300 fast (seeded stream): " + json.dumps(dict(
        frames=NF, bytes=len(p10), mvs=mv.size // 2, noncanonical_mvs=nc, decode_ms=p10s_ms,
        decode_fps=NF / (p10s_ms / 1e3),
        psnr_y_intra_frames_db=psnr(dec10s["y"][::period], y[::period]))), flush=True)
    # its first GOP, a stream of its own: phase 13 decodes it on the card and
    # the CPU (a stream holds exactly the frames it is decoded for)
    p10_gop = write_gop_stream({n: v[:1] for n, v in isyms.items()},
                               {n: torch.from_numpy(v[:period - 1]).to(dev)
                                for n, v in psyms.items()},
                               torch.from_numpy(mv[:period - 1]).to(dev), period, H, W, 16, 16,
                               period)
    del isyms, psyms, dec10s

    # mc_gather_yc against plain at every P-step of both period-10 streams:
    # phase 10's (the planes decoded before each step, the step's MVs) and
    # the seeded one's MVs (all 129 union offsets) over the intra planes
    pad_l = pad_image(first["y"], 16)
    pad_c = pad_image(torch.cat([first["cb"], first["cr"]]), 8)
    for j in range(period - 1):
        prev = [torch.from_numpy(dec10[n][j::period]).to(dev) for n in ("y", "cb", "cr")]
        check_yc(pad_image(prev[0], 16), pad_image(torch.cat(prev[1:]), 8), mvr[:, j],
                 f"phase 12's stream, P-step {j + 1}")
        check_yc(pad_l, pad_c, torch.from_numpy(mv[j * ng:(j + 1) * ng]).to(dev),
                 f"the seeded stream's MVs, P-step {j + 1}")
    print("kernel E mc_gather_yc: bit-identical at the 9 P-steps of phase 10's stream and on the "
          "seeded stream's MVs", flush=True)

    # kernel E at one P-step's shapes: the decode's one launch, the
    # two-launch form (mc_gather for luma and for chroma) and the library
    mv_l = mvr[:, 0].contiguous()
    mvc = mc_fused.chroma_mv(mv_l)
    mv_c = torch.cat([mvc, mvc]).contiguous()

    def mc_kernel():
        return mc_fused.mc_gather_yc(pad_l, pad_c, mv_l)

    def mc_two():
        return mc_fused.mc_gather(pad_l, mv_l, 16), mc_fused.mc_gather(pad_c, mv_c, 8)

    def mc_plain():
        return mc_fused.mc_gather_yc_plain(pad_l, pad_c, mv_l)

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

    for fn in (mc_kernel, mc_two):
        check(all(torch.equal(a, b) for a, b in zip(fn(), mc_library())),
              f"kernel E ({fn.__name__}) differs from the advanced-indexing gather")
    ke_ms = event_ms(mc_kernel, 50)
    ke2_ms = event_ms(mc_two, 50)
    pe_ms = event_ms(mc_plain, 5)
    le_ms = event_ms(mc_library, 20)
    ke_prof = device_profile(mc_kernel)
    check(ke_prof["events"] <= 1 and len(ke_prof["by_name"]) == 1,
          f"mc_gather_yc made {ke_prof['events']} device launches: {ke_prof['by_name']}")
    dev_ms["E"] = ke_prof["device_ms"]
    e_times = dict(yc_ms=ke_ms, yc_device_ms=dev_ms["E"], two_launch_ms=ke2_ms,
                   two_launch_device_ms=device_profile(mc_two)["device_ms"], library_ms=le_ms,
                   library_device_ms=device_profile(mc_library)["device_ms"], plain_ms=pe_ms)
    print("kernel E at one decode P-step (30 CIF frames, luma, Cb and Cr): " + json.dumps(e_times),
          flush=True)
    # each predictor byte is read once from its block's window and written
    # once, beside the int32 MVs: the padding outside the windows need not
    # be read
    e_bytes = 2 * (first["y"].numel() + 2 * first["cb"].numel()) + mv_l.numel() * 4
    e_bound = e_bytes / PEAK_BYTES_S * 1e3
    del up, sym_i, sym_p, first, mvr, pad_l, pad_c, il, ic

    # ---- 13. cross-implementation checks (exact mode) ---------------------
    xb, _ = codec.encode(*xcheck_input(), CodecConfig(**XCHECK_CFG), return_recon=False)
    digest = hashlib.sha256(xb).hexdigest()
    check(digest == XCHECK_SHA256, f"exact-mode stream sha256 {digest} != {XCHECK_SHA256}")
    print(f"xcheck: exact-mode stream of {len(xb)} bytes matches the pinned sha256", flush=True)
    reset_counts()
    ib, _ = codec.encode(*static_trigger_input(), CodecConfig(**INTER_ENC_CFG),
                         return_recon=False)
    launches_x = counts()
    digest = hashlib.sha256(ib).hexdigest()
    check(digest == INTER_ENC_SHA256,
          f"exact-mode period-3 stream sha256 {digest} != {INTER_ENC_SHA256}")
    check(launches_x["G"] >= 1, f"the static-trigger encode did not launch kernel G: {launches_x}")
    print(f"xcheck: exact-mode period-3 static-trigger stream of {len(ib)} bytes matches the "
          "pinned sha256", flush=True)
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
    xcfg10 = CodecConfig(width=W, height=H, qp_dc=16, qp_ac=16, intra_period=period,
                         precision="exact")
    reset_counts()
    bg, rg = codec.encode(sy[:period], scb[:period], scr[:period], xcfg10)
    launches_x = counts()
    bc, rc = codec.encode(sy[:period], scb[:period], scr[:period], xcfg10, device="cpu")
    check(bg == bc and all(np.array_equal(rg[n], rc[n]) for n in rg),
          "exact-mode synthStatic GOP stream or recon differs between the card and the CPU")
    check(all(launches_x[n] >= 1 for n in ("D", "F", "G")),
          f"the exact synthStatic GOP did not launch kernels D, F and G: {launches_x}")
    print(f"xcheck: exact-mode CIF synthStatic GOP ({period} frames, {len(bg)} bytes) and recon "
          "identical on the card and the CPU", flush=True)
    dg = codec.decode(p10_gop, period, precision="exact")
    dcpu = codec.decode(p10_gop, period, precision="exact", device="cpu")
    check(all(np.array_equal(dg[n], dcpu[n]) for n in dg),
          "exact-mode CIF decode of one GOP differs between the card and the CPU")
    print(f"xcheck: exact-mode CIF decode of one GOP ({period} frames) identical on the card "
          "and the CPU", flush=True)
    # the tall path end to end: luma planes of 2,048 block rows and chroma of
    # 1,024, past the height kernel B' took before, through A, C, D, E, F
    # and B' on the card
    ty, tcb, tcr = tall_input()
    tcfg = CodecConfig(width=ty.shape[2], height=ty.shape[1], qp_dc=8, qp_ac=16, intra_period=2,
                       precision="exact")
    reset_counts()
    tb, trec = codec.encode(ty, tcb, tcr, tcfg)
    td = codec.decode(tb, ty.shape[0], precision="exact")
    torch.cuda.synchronize()
    launches_tall = counts()
    tb_cpu, trec_cpu = codec.encode(ty, tcb, tcr, tcfg, device="cpu")
    td_cpu = codec.decode(tb_cpu, ty.shape[0], precision="exact", device="cpu")
    check(tb == tb_cpu and all(np.array_equal(trec[n], trec_cpu[n]) for n in trec),
          "exact-mode tall sequence: the card's stream or recon differs from the CPU's")
    check(all(np.array_equal(td[n], td_cpu[n]) for n in td),
          "exact-mode tall sequence: the card's decode differs from the CPU's")
    check(all(launches_tall[n] >= 1 for n in ("A", "B'", "C", "D", "E", "F")),
          f"the tall sequence did not launch kernels A, B', C, D, E and F: {launches_tall}")
    print(f"xcheck: exact-mode tall sequence ({ty.shape[0]} frames of {ty.shape[2]}x{ty.shape[1]}, "
          f"period 2, {len(tb)} bytes): stream, recon and decode identical on the card and the "
          f"CPU; launches {json.dumps(launches_tall)}", flush=True)
    del ty, tcb, tcr, trec, td, trec_cpu, td_cpu

    # the C++ reference's own hashes (tests/golden/MANIFEST.sha256), on the
    # card in exact mode: a few of the configurations that
    # tests/test_torch_golden_hashes.py checks on the CPU
    manifest = dict(reversed(line.split()) for line in
                    (REPO / "tests" / "golden" / "MANIFEST.sha256").read_text().splitlines())
    for seq, qdc, qac, gp in (("synthA", 16, 16, 1), ("synthB", 8, 8, 10),
                              ("synthStatic", 1, 1, 10)):
        gy, gcb, gcr = cif_content(32, seq)
        reset_counts()
        gb, grec = codec.encode(gy, gcb, gcr, CodecConfig(width=W, height=H, qp_dc=qdc, qp_ac=qac,
                                                          intra_period=gp, precision="exact"))
        launches_g = counts()
        gdec = codec.decode(gb, 32, precision="exact")
        stem = f"{seq}_{qdc}_{qac}_{gp}"
        check(hashlib.sha256(gb).hexdigest() == manifest[f"{seq}_compCIF_{qdc}_{qac}_{gp}.bin"],
              f"golden {stem}: the card's stream differs from the C++ reference's")
        check(yuv_sha256(grec) == manifest[f"{stem}.encrecon.yuv"],
              f"golden {stem}: the card's encoder recon differs from the C++ reference's")
        check(yuv_sha256(gdec) == manifest[f"{stem}.decrecon.yuv"],
              f"golden {stem}: the card's decode differs from the C++ reference's")
        check(launches_g["A"] >= 1 and launches_g["F"] >= 1,
              f"golden {stem}: the encode did not launch kernels A and F: {launches_g}")
        print(f"xcheck: golden {stem} (32 CIF frames, exact, on the card): stream, encoder "
              "recon and decode equal the C++ reference's hashes", flush=True)

    # ---- 14. the unfused search entry points: sad_best and sad_union -------
    for name, cur, pad in me_cases:
        kb, pb = me_fused.sad_best(cur, pad), me_fused.sad_best_plain(cur, pad)
        ku, pu = me_fused.sad_union(cur, pad), me_fused.sad_union_plain(cur, pad)
        eb, eu = max(max_abs(a, b) for a, b in zip(kb, pb)), max_abs(ku, pu)
        err["sad_best"], err["sad_union"] = max(err["sad_best"], eb), max(err["sad_union"], eu)
        check(eb == 0, f"sad_best on {name}: differs from plain by {eb}")
        check(eu == 0, f"sad_union on {name}: differs from plain by {eu}")
        kd = me_fused.sad_mc_best(cur, pad)
        free = kb[1] < 2
        check(torch.equal(kb[0][free], kd[0][free]),
              f"sad_best's best differs from D's on {name} where zc < 2")
        check(torch.equal(ku, torch.cat([kd[2], me_fused.sad_union_extra(cur, pad)], dim=1)),
              f"sad_union on {name} is not D's canonical rows followed by G's")
        print(f"sad_best and sad_union on {name}: bit-identical; {int((~free).sum())} MBs with "
              "zc >= 2 take the second zero, the rest D's best; sad_union = D's rows + G's",
              flush=True)
    del kb, pb, ku, pu, kd
    zc_a = me_fused.sad_best(cur_d, pad_d)[1]
    check(not bool((zc_a >= 2).any()), "benchA has an MB with zc >= 2")
    s2c = torch.from_numpy(SPIRAL_TO_CHROMA).to(dev)

    def unfused_search():
        """The JAX package's ME-kernel tool's unfused search on the port: the
        picks of sad_best, then the luma and chroma (Cb and Cr) predictors
        at them through kernel E."""
        best = me_fused.sad_best(cur_d, pad_d)[0]
        cidx = s2c[best.long()]
        return (best, mc_fused.mc_select(pad_d, best, SPIRAL, 16),
                mc_fused.mc_select(padc_d, torch.cat([cidx, cidx]), CHROMA_OFFSETS, 8))

    reset_counts()
    best_s, pred_s, predc_s = unfused_search()
    union_s = me_fused.sad_union(cur_d, pad_d)
    torch.cuda.synchronize()
    launches_search = counts()
    check(launches_search["sad_best"] >= 1 and launches_search["sad_union"] >= 1
          and launches_search["E"] >= 2,
          f"the unfused search did not launch sad_best, sad_union and E: {launches_search}")
    check(torch.equal(pred_s, pred_d) and torch.equal(predc_s, predc_d),
          "the unfused search's predictors on benchA differ from the fused search's")
    check(torch.equal(spiral_search(cur_d, pad_d),
                      torch.from_numpy(NEG_SPIRAL).to(dev)[best_s.long()]),
          "sad_best's MVs on benchA differ from ops/me.spiral_search's")
    check(union_s.shape == (ng, len(NEG_UNION), H // 16, W // 16), "sad_union has the wrong shape")
    ksb_ms = event_ms(lambda: me_fused.sad_best(cur_d, pad_d), 20)
    psb_ms = event_ms(lambda: me_fused.sad_best_plain(cur_d, pad_d), 3)
    ksu_ms = event_ms(lambda: me_fused.sad_union(cur_d, pad_d), 20)
    psu_ms = event_ms(lambda: me_fused.sad_union_plain(cur_d, pad_d), 3)
    dev_ms["sad_best"] = device_profile(lambda: me_fused.sad_best(cur_d, pad_d))["device_ms"]
    dev_ms["sad_union"] = device_profile(lambda: me_fused.sad_union(cur_d, pad_d))["device_ms"]
    search_ms = event_ms(unfused_search, 20)
    print("unfused search on a benchA P-step (30 CIF frames; MVs = spiral_search's, predictors "
          "= D's fused ones): " + json.dumps(dict(
              sad_best_ms=ksb_ms, sad_union_ms=ksu_ms, unfused_search_ms=search_ms,
              fused_search_D_ms=kd_ms, launches=launches_search)), flush=True)
    # each input byte read once, each output written once; the byte absolute
    # differences accumulated (64 steps or 129 offsets x 256 px), diffs_op to
    # an operation
    sb_bytes = cur_d.numel() + pad_d.numel() + nmb * 2 * 4 + 64 * 2 * 4
    sb_ops = nmb * 64 * 256 // diffs_op
    sb_bound = max(sb_bytes / PEAK_BYTES_S, sb_ops / PEAK_LANE_OP_S) * 1e3
    su_bytes = cur_d.numel() + pad_d.numel() + nmb * len(NEG_UNION) * 4 + len(NEG_UNION) * 2 * 4
    su_ops = nmb * len(NEG_UNION) * 256 // diffs_op
    su_bound = max(su_bytes / PEAK_BYTES_S, su_ops / PEAK_LANE_OP_S) * 1e3
    del best_s, pred_s, predc_s, union_s

    # ---- 15. streaming: per-GOP durable chunks and resume ------------------
    n30 = 3 * period
    xs_cfg = CodecConfig(width=W, height=H, qp_dc=16, qp_ac=16, intra_period=period,
                         precision="exact")
    clip = (y[:n30], cb[:n30], cr[:n30])
    want_x, _ = codec.encode(*clip, xs_cfg, return_recon=False)
    with tempfile.TemporaryDirectory() as wd:
        log = MetricsLog()
        got = encode_streaming(*clip, xs_cfg, wd, metrics=log)
        check(got == want_x and len(log.records) == 3,
              f"exact streaming of 30 CIF frames: {len(log.records)} records, bytes "
              f"{'equal' if got == want_x else 'differ'} (codec.encode's)")
        pathlib.Path(wd, "gop_00001.npz").unlink()
        log = MetricsLog()
        got = encode_streaming(*clip, xs_cfg, wd, metrics=log)
        check(got == want_x and [r.gop_index for r in log.records] == [1],
              f"exact streaming resume: records {[r.gop_index for r in log.records]}, bytes "
              f"{'equal' if got == want_x else 'differ'}")
    print(f"stream exact CIF, {n30} frames, period 10: codec.encode's bytes ({len(want_x)}); a "
          "resume after deleting GOP 1's chunk re-encoded GOP 1 alone to the same bytes",
          flush=True)

    stream_log = MetricsLog()

    def stream_fast(log=stream_log):
        with tempfile.TemporaryDirectory() as wd:
            return encode_streaming(y, cb, cr, cfg10, wd, metrics=log)

    bits_st = stream_fast(MetricsLog())
    stream_ms = event_ms(stream_fast, reps=3, warmup=0)
    # where the time goes: the rounds (upload, engines, items, pack, pull and
    # MSE; the GOP records' walls) and the content fingerprints; the rest is
    # the chunk files and the final splice
    rounds_ms = sum(r.wall_s for r in stream_log.records) * 1e3 / 3
    fp_ms = event_ms(lambda: [_gop_fingerprint(y[i:i + period], cb[i:i + period],
                                               cr[i:i + period], cfg10)
                              for i in range(0, NF, period)], 3)
    st_res = dict(frames=NF, bytes=len(bits_st), identical_to_phase10=bits_st == bits10,
                  stream_ms=stream_ms, stream_fps=NF / (stream_ms / 1e3), rounds_ms=rounds_ms,
                  fingerprints_ms=fp_ms, chunks_and_splice_ms=stream_ms - rounds_ms - fp_ms,
                  codec_encode_ms_phase10=enc10_ms)
    if bits_st != bits10:
        dec_st = codec.decode(bits_st, NF, precision="fast")
        st_res.update(size_rel_diff=abs(len(bits_st) - len(bits10)) / len(bits10),
                      decoded_psnr_y_db=psnr(dec_st["y"], y), phase10_decoded_psnr_y_db=psnr_d10)
        check(st_res["size_rel_diff"] <= 0.005
              and abs(st_res["decoded_psnr_y_db"] - psnr_d10) <= 0.05,
              f"fast streaming differs from phase 10 beyond tolerance: {st_res}")
        del dec_st
    print("stream CIF300 period 10 fast (rounds of up to 16 GOPs): " + json.dumps(st_res),
          flush=True)

    # ---- 16. the host writer and the CLI ------------------------------------
    cfg10h = CodecConfig(width=W, height=H, qp_dc=16, qp_ac=16, intra_period=period,
                         precision="fast", entropy="host")
    t0 = time.perf_counter()
    bits_h, _ = codec.encode(y, cb, cr, cfg10h)
    host_ms = (time.perf_counter() - t0) * 1e3
    check(bits_h == bits10, "codec.encode(entropy='host') differs from phase 10's bytes")
    (isy, iix), (psy, pix), _ = codec.encode_symbols(yt, cbt, crt, cfg10, return_recon=False)
    t0 = time.perf_counter()
    hsyms = (codec.host_symbols(isy), codec.host_symbols(psy))
    pull_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    bits_w = write_bitstream_grouped(hsyms[0], iix, hsyms[1], pix, NF, H, W, 16, 16, period)
    writer_ms = (time.perf_counter() - t0) * 1e3
    check(bits_w == bits10, "the host writer's stream differs from phase 10's bytes")
    print("encode period-10 CIF300 fast, entropy='host' (phase 10's bytes): " + json.dumps(dict(
        encode_ms=host_ms, encode_fps=NF / (host_ms / 1e3), symbol_pull_ms=pull_ms,
        host_writer_ms=writer_ms, device_entropy_encode_ms_phase10=enc10_ms)), flush=True)
    del isy, psy, hsyms

    def run_cli(*args):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "icspcodec_torch.cli", *args], cwd=REPO,
                           capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        check(r.returncode == 0, f"the CLI's {args[0]} failed: {r.stderr[-3000:]}")
        return r.stdout.strip(), wall

    with tempfile.TemporaryDirectory() as td:
        yuv, out_bin = pathlib.Path(td, "benchA_cif.yuv"), pathlib.Path(td, "benchA.bin")
        save_yuv420(yuv, y, cb, cr)
        enc_out, enc_wall = run_cli("encode", "-i", str(yuv), "-n", str(NF), "-q", "16",
                                    "--intraPeriod", str(period), "--precision", "fast",
                                    "-o", str(out_bin))
        check(out_bin.read_bytes() == bits10, "the CLI's stream differs from phase 10's bytes")
        dec_out, dec_wall = run_cli("decode", "-i", str(out_bin), "-n", str(NF), "--precision",
                                    "fast", "--orig", str(yuv), "-o", str(pathlib.Path(td, "d")))
    m = re.search(r"mean Y-PSNR: ([0-9.]+) dB", dec_out)
    check(m is not None and abs(float(m.group(1)) - psnr10) <= 0.05,
          f"the CLI decode's PSNR line {dec_out!r} is not within 0.05 dB of the recon's {psnr10}")
    print("CLI CIF300 period 10 fast, as subprocesses (phase 10's bytes; PSNR-Y within 0.05 dB "
          "of the recon): " + json.dumps(dict(encode_wall_s=enc_wall, decode_wall_s=dec_wall,
                                              encode_line=enc_out, decode_lines=dec_out)),
          flush=True)

    # ---- 17. GOP shards on the card ---------------------------------------
    # two shards on the one card (a device list naming it twice): each shard
    # runs its engine, with its kernels, from a thread of its own; the host
    # writer packs (the sharded path's entropy gating, as the JAX package's)
    mesh2 = ["cuda:0"] * 2
    cfg10s = CodecConfig(width=W, height=H, qp_dc=16, qp_ac=16, intra_period=period,
                         precision="fast", gop_shards=2)
    cfg0s = CodecConfig(width=W, height=H, qp_dc=16, qp_ac=16, precision="fast", gop_shards=2)
    shard_runs = {}
    for name, fn, want, alone in (
            ("encode_period10", lambda: codec.encode(y, cb, cr, cfg10s, device=mesh2),
             (bits10, rec10), launches_enc10),
            ("encode_all_intra", lambda: codec.encode(y, cb, cr, cfg0s, device=mesh2),
             (bits, rec), launches_enc),
            ("decode_period10", lambda: codec.decode(bits10, NF, precision="fast", device=mesh2,
                                                     gop_shards=2), dec10, launches_p10)):
        reset_counts()
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        launched = counts()
        if name.startswith("encode"):
            check(got[0] == want[0], f"gop_shards=2 {name}: the bytes differ from the unsharded")
            check(all(np.array_equal(got[1][n], want[1][n]) for n in want[1]),
                  f"gop_shards=2 {name}: the recon differs from the unsharded")
            need = ("A", "D", "E", "F") if "period10" in name else ("A", "F")
        else:
            check(all(np.array_equal(got[n], want[n]) for n in want),
                  f"gop_shards=2 {name}: the planes differ from phase 12's")
            need = ("C", "B'", "E")
        # each shard launches what the unsharded call does (the counters
        # are bumped from the shards' threads under a lock)
        check(all(launched[n] == 2 * alone[n] >= 2 for n in need),
              f"gop_shards=2 {name}: kernels {need} not launched as the unsharded call "
              f"{alone} in each shard: {launched}")
        shard_runs[name] = dict(first_call_ms=wall, launches=launched,
                                ms=event_ms(fn, reps=1, warmup=0))
    shard_runs["encode_period10"]["unsharded_ms_phase10"] = enc10_ms
    shard_runs["encode_all_intra"]["unsharded_ms_phase4"] = enc_ms
    shard_runs["decode_period10"]["unsharded_ms_phase12"] = p10_ms
    prof_s = profile_run(lambda: codec.encode(y, cb, cr, cfg10s, device=mesh2),
                         shard_runs["encode_period10"]["ms"])
    shard_runs["encode_period10"]["device_busy_share"] = prof_s["busy_share"]
    shard_runs["encode_period10"]["device_ms"] = prof_s["device_ms"]
    with tempfile.TemporaryDirectory() as wd:
        t0 = time.perf_counter()
        got = encode_streaming(y, cb, cr, cfg10s, wd, metrics=MetricsLog(), device=mesh2)
        swall = (time.perf_counter() - t0) * 1e3
    check(got == bits10, "gop_shards=2 encode_streaming: the bytes differ from phase 10's")
    shard_runs["stream_period10"] = dict(ms=swall, unsharded_ms_phase15=stream_ms)
    if torch.cuda.device_count() == 1:
        try:
            codec.encode(y[:2], cb[:2], cr[:2], cfg10s)
            refused = False
        except ValueError as e:
            refused = "devices are available" in str(e)
        check(refused, "gop_shards=2 with device=None on a one-card machine did not raise "
                       "ValueError")
    print("gop_shards=2 on ['cuda:0'] * 2, CIF300 fast (phase 10's and 4's bytes, phase 12's "
          "planes, streaming phase 10's bytes; device=None refused on one card): "
          + json.dumps(shard_runs), flush=True)
    launches_shard = {n: shard_runs[n]["launches"] for n in
                      ("encode_period10", "encode_all_intra", "decode_period10")}

    # ---- 18. MB-column tiles on the card ------------------------------------
    # tile_shards=2 splits CIF's 22 MB columns over the device list; the
    # tiled wavefronts are plain torch (as the JAX package's are plain XLA),
    # the gathered forward residual chains run through kernel F as the
    # untiled encode's do, the gathered inverse DC chains through kernel B',
    # the tiles' union SADs through sad_union and their MC through kernel E
    tiled = {}
    n10 = period
    clip = (y[:n10], cb[:n10], cr[:n10])
    xt = dict(width=W, height=H, qp_dc=16, qp_ac=16, intra_period=period, precision="exact")
    reset_counts()
    want_b, want_r = codec.encode(*clip, CodecConfig(**xt))
    untiled_f = counts()["F"]
    want_d = codec.decode(want_b, n10, precision="exact")
    reset_counts()
    t0 = time.perf_counter()
    tb, tr = codec.encode(*clip, CodecConfig(**xt, tile_shards=2), device=mesh2)
    torch.cuda.synchronize()
    tiled["exact_encode_ms"] = (time.perf_counter() - t0) * 1e3
    tiled["exact_encode_launches"] = counts()
    check(tb == want_b and all(np.array_equal(tr[n], want_r[n]) for n in want_r),
          "tile_shards=2 exact encode (10 CIF frames, period 10): differs from the untiled")
    reset_counts()
    t0 = time.perf_counter()
    td = codec.decode(want_b, n10, precision="exact", device=mesh2, tile_shards=2)
    torch.cuda.synchronize()
    tiled["exact_decode_ms"] = (time.perf_counter() - t0) * 1e3
    tiled["exact_decode_launches"] = counts()
    check(all(np.array_equal(td[n], want_d[n]) for n in want_d),
          "tile_shards=2 exact decode (10 CIF frames, period 10): differs from the untiled")
    check(tiled["exact_encode_launches"]["F"] == untiled_f >= 1
          and tiled["exact_encode_launches"]["E"] >= 1
          and tiled["exact_decode_launches"]["B'"] >= 1
          and tiled["exact_decode_launches"]["E"] >= 1,
          f"the tiled paths did not launch F (as often as the untiled encode, {untiled_f}), "
          f"E and B': {tiled}")
    # the C++ reference's hashes through the tiled encode and decode
    gy, gcb, gcr = cif_content(32, "synthA")
    gb, grec = codec.encode(gy, gcb, gcr, CodecConfig(width=W, height=H, qp_dc=16, qp_ac=16,
                                                      intra_period=1, precision="exact",
                                                      tile_shards=2), device=mesh2)
    gdec = codec.decode(gb, 32, precision="exact", device=mesh2, tile_shards=2)
    check(hashlib.sha256(gb).hexdigest() == manifest["synthA_compCIF_16_16_1.bin"]
          and yuv_sha256(grec) == manifest["synthA_16_16_1.encrecon.yuv"]
          and yuv_sha256(gdec) == manifest["synthA_16_16_1.decrecon.yuv"],
          "golden synthA_16_16_1 through tile_shards=2: differs from the C++ reference's hashes")
    del gy, gcb, gcr, grec, gdec
    n30 = 3 * period
    fclip = (y[:n30], cb[:n30], cr[:n30])
    fcfg = dict(width=W, height=H, qp_dc=16, qp_ac=16, intra_period=period, precision="fast")
    fb, fr = codec.encode(*fclip, CodecConfig(**fcfg, entropy="host"))
    fbt, frt = codec.encode(*fclip, CodecConfig(**fcfg, tile_shards=2), device=mesh2)
    check(fbt == fb and all(np.array_equal(frt[n], fr[n]) for n in fr),
          "tile_shards=2 fast encode of 30 CIF frames: differs from the untiled")
    fd = codec.decode(fb, n30, precision="fast")
    fdt = codec.decode(fbt, n30, precision="fast", device=mesh2, tile_shards=2)
    check(all(np.array_equal(fdt[n], fd[n]) for n in fd),
          "tile_shards=2 fast decode of 30 CIF frames: differs from the untiled")
    tiled["fast_encode_ms"] = event_ms(lambda: codec.encode(
        *fclip, CodecConfig(**fcfg, tile_shards=2), device=mesh2), reps=1, warmup=0)
    tiled["fast_decode_ms"] = event_ms(lambda: codec.decode(
        fbt, n30, precision="fast", device=mesh2, tile_shards=2), reps=1, warmup=0)
    tiled["untiled_fast_encode_ms"] = event_ms(lambda: codec.encode(
        *fclip, CodecConfig(**fcfg)), reps=1)
    tiled["untiled_fast_decode_ms"] = event_ms(lambda: codec.decode(
        fb, n30, precision="fast"), reps=1)
    print("tile_shards=2 on ['cuda:0'] * 2 (exact, 10 CIF frames at period 10: the untiled bytes "
          "and planes; golden synthA_16_16_1 through the tiled encode and decode: the C++ "
          "hashes; fast, 30 frames: the untiled bytes, recon and decoded planes, timed): "
          + json.dumps(tiled), flush=True)
    del clip, fclip, fr, frt, fd, fdt, tr, td

    # ---- 19. the oracle (host numpy) ----------------------------------------
    from icspcodec_torch import oracle
    t0 = time.perf_counter()
    ob = oracle.encode(list(zip(*xcheck_input())), XCHECK_CFG["qp_dc"], XCHECK_CFG["qp_ac"],
                       0)[0]
    # the oracle, a copy of the reference, reads the final byte MSB-first:
    # it decodes the stream as written once that byte's bits are moved high
    od = oracle.decode(ob[:14] + realign_tail(ob[14:], XCHECK_TAIL_BITS), 2)
    check(hashlib.sha256(ob).hexdigest() == XCHECK_SHA256,
          "the port's oracle does not give the pinned XCHECK stream")
    check(planes_digest({k: np.stack([getattr(r, k) for r in od]) for k in ("y", "cb", "cr")})
          == XCHECK_DECODE_SHA256, "the port's oracle decode does not give the pinned digest")
    print(f"oracle: XCHECK stream and decoded planes equal the pinned digests "
          f"({(time.perf_counter() - t0) * 1e3:.1f} ms on the host)", flush=True)

    # ---- 20. the JAX package's last public functions ----------------------
    # kernels A and C against the grid-form wavefronts (plain torch on the
    # card: the loops that phases 3 and 6 reach through the packed names,
    # here through the JAX package's grid names); the fixed and union
    # searches against sad_best (H), D where zc < 2 and sad_union (H'); the
    # four mc_select_* wrappers (kernel E) against ops/me.gather_pred at the
    # MVs -offsets[idx]
    api_t0 = time.perf_counter()
    reset_counts()
    k = intra_fused.intra_luma_scan_fused(o8, 16, 16, dtype=torch.float64)
    g = intra_luma_scan(o8, 16, 16, dtype=torch.float64)
    same = {n: torch.equal(k[n].to(g[n].dtype), g[n])
            for n in ("recon", "scan", "mpm", "mode_bit")}
    check(all(same.values()),
          f"kernel A float64 differs from the grid form intra_luma_scan: {same}")
    grid_a = dict(grid_ms=event_ms(lambda: intra_luma_scan(o8, 16, 16, dtype=torch.float64), 2),
                  kernel_ms=event_ms(lambda: intra_fused.intra_luma_scan_fused(
                      o8, 16, 16, dtype=torch.float64), 20),
                  diagonals=2 * (o8.shape[1] - 1) + o8.shape[2])
    grid_prof = profile_run(lambda: intra_luma_scan(o8, 16, 16, dtype=torch.float64),
                            grid_a["grid_ms"])
    grid_a.update(device_ms=grid_prof["device_ms"], busy_share=grid_prof["busy_share"],
                  device_events=grid_prof["events"],
                  top=grid_prof["top"][:3])
    print("kernel A float64 QP 16/16 on 8 CIF frames: equal to the grid form intra_luma_scan "
          "(recon, scan, mpm, mode_bit)", flush=True)
    ys8, mpm8, mbit8 = (torch.from_numpy(dsyms[n][:8]).to(dev)
                        for n in ("y_scan", "mpm", "mode_bit"))
    kc = intra_decode_fused.intra_luma_decode_fused(ys8, mpm8, mbit8, 16, 16, dtype=torch.float64)
    # the plain decode: inverse zig-zag, dequantization, the inverse DC
    # chain, the inverse DCT, then the grid form intra_luma_decode_scan
    gc = intra_decode_fused.intra_luma_decode_plain(ys8, mpm8, mbit8, 16, 16, dtype=torch.float64)
    check(torch.equal(kc, gc), f"kernel C float64 on 8 frames of the phase-4 stream: "
                               f"{int((kc != gc).sum())} pixels differ from the grid form")
    grid_c = dict(grid_ms=event_ms(lambda: intra_decode_fused.intra_luma_decode_plain(
                      ys8, mpm8, mbit8, 16, 16, dtype=torch.float64), 2),
                  kernel_ms=event_ms(lambda: intra_decode_fused.intra_luma_decode_fused(
                      ys8, mpm8, mbit8, 16, 16, dtype=torch.float64), 20))
    print("kernel C float64 on 8 frames of the phase-4 stream: equal to the decode through "
          "the grid form intra_luma_decode_scan", flush=True)
    del k, g, kc, gc
    neg_s = torch.from_numpy(NEG_SPIRAL).to(dev)
    neg_u = torch.from_numpy(NEG_UNION).to(dev)
    for name, cur, pad in me_cases:
        fixed = spiral_search_fixed(cur, pad)
        kb = me_fused.sad_best(cur, pad)
        kd = me_fused.sad_mc_best(cur, pad)
        free = kd[1] < 2
        check(torch.equal(fixed, neg_s[kb[0].long()]),
              f"spiral_search_fixed on {name} differs from -SPIRAL[best] of sad_best")
        check(torch.equal(fixed[free], neg_s[kd[0].long()][free]),
              f"spiral_search_fixed on {name} differs from -SPIRAL[best] of D where zc < 2")
        mv_u, best_u = spiral_search_union(cur, pad)
        check(torch.equal(best_u, stateful_select(me_fused.sad_union(cur, pad)))
              and torch.equal(mv_u, neg_u[best_u.long()]),
              f"spiral_search_union on {name} differs from stateful_select over sad_union")
        print(f"spiral_search_fixed on {name}: = sad_best's picks, and D's where zc < 2 "
              f"({int((~free).sum())} MBs with zc >= 2); spiral_search_union = stateful_select "
              "over sad_union", flush=True)
    del fixed, kb, kd, mv_u, best_u
    search_ms = dict(
        spiral_search_fixed_ms=event_ms(lambda: spiral_search_fixed(cur_d, pad_d), 3),
        sad_best_ms=ksb_ms,
        spiral_search_union_ms=event_ms(lambda: spiral_search_union(cur_d, pad_d), 3),
        sad_union_ms=ksu_ms)
    # the MC selects: indices drawn from each whole table; kernel E once a call
    rng = np.random.default_rng(20)
    selects = [(mc_fused.mc_select_luma, pad_d, SPIRAL, 16),
               (mc_fused.mc_select_chroma, padc_d, CHROMA_OFFSETS, 8),
               (mc_fused.mc_select_luma_union, pad_d, SPIRAL_UNION, 16),
               (mc_fused.mc_select_chroma_union, padc_d, CHROMA_U_OFFSETS, 8)]
    sel_idx = [torch.from_numpy(rng.integers(0, len(offs), (pad.shape[0], pad.shape[1] // blk - 2,
                                                               pad.shape[2] // blk - 2))).to(dev)
               for _, pad, offs, blk in selects]
    launches_api = counts()   # the checks and timings above
    reset_counts()
    sel_out = [fn(pad, idx) for (fn, pad, _, _), idx in zip(selects, sel_idx)]
    torch.cuda.synchronize()
    launches_sel = counts()
    check(launches_sel["E"] == 4 and sum(launches_sel.values()) == 4,
          f"the four mc_select_* wrappers did not launch kernel E once each: {launches_sel}")
    for (fn, pad, offs, blk), idx, out in zip(selects, sel_idx, sel_out):
        mv = torch.from_numpy(-np.asarray(offs, np.int32)).to(dev)[idx.long()]
        check(torch.equal(out, from_blocks(gather_pred(pad, mv, blk))),
              f"{fn.__name__} differs from gather_pred at -offsets[idx]")
    sel_ms = {fn.__name__ + "_ms": event_ms(lambda: fn(pad, idx), 20)
              for (fn, pad, _, _), idx in zip(selects, sel_idx)}
    del sel_out, sel_idx, me_cases
    launches_api = {n: launches_api[n] + launches_sel[n] for n in launches_api}
    print("the four mc_select_* wrappers (benchA P-step: 30 luma planes, 60 chroma planes): "
          "equal to gather_pred at -offsets[idx], kernel E once each", flush=True)
    print("api phase on " + smi + ": " + json.dumps(dict(
        intra_luma_scan_float64_8_cif_frames=grid_a,
        intra_luma_decode_scan_float64_8_cif_frames=grid_c,
        searches_benchA_p_step=search_ms, mc_select=sel_ms, launches=launches_api,
        launches_mc_select=launches_sel, wall_s=time.perf_counter() - api_t0)), flush=True)

    # ---- 21. the stream tail ---------------------------------------------
    # the seeded set of tests/test_torch_stream_tail.py, TAIL_SEEDS seeds a
    # case, encoded and decoded on the card: each stream parses to its
    # writer's symbols or is refused as ambiguous (the writer's reading among
    # two or more); the card's decode refuses the same streams, and its
    # planes equal the CPU's decode (exact) or lie within 0.05 dB of the
    # recon's PSNR-Y (fast)
    tail_t0 = time.perf_counter()
    tf, th, tw = (TAIL_SHAPE[n] for n in ("nframes", "height", "width"))
    tally = {prec: {"right": 0, "ambiguous": 0, "raised": 0, "wrong": 0}
             for prec in ("exact", "fast")}
    faults, tails, launches_tail = [], [0] * 8, {n: 0 for n in counts()}
    for case in TAIL_CASES:
        prec, period_t = case["precision"], case["intra_period"]
        tcfg_t = CodecConfig(width=tw, height=th, qp_dc=case["qp_dc"], qp_ac=case["qp_ac"],
                             intra_period=period_t, precision=prec)
        for seed in range(TAIL_SEEDS):
            planes = tail_content(case["kind"], seed)
            bits_t, want_t, nbits_t, rec_t = tail_stream(*planes, tcfg_t, dev)
            verdict = tail_verdict(bits_t, want_t, nbits_t, tf, period_t)
            tails[nbits_t % 8] += 1
            reset_counts()
            try:
                dec_t = codec.decode(bits_t, tf, precision=prec)
            except AmbiguousTailError:
                dec_t = None
            torch.cuda.synchronize()
            launches_tail = {n: launches_tail[n] + v for n, v in counts().items()}
            if verdict == "right" and dec_t is not None:
                if prec == "exact":
                    ref_t = codec.decode(bits_t, tf, precision=prec, device="cpu")
                    same = all(np.array_equal(dec_t[n], ref_t[n]) for n in ref_t)
                else:
                    same = abs(psnr(dec_t["y"], planes[0]) - psnr(rec_t["y"], planes[0])) <= 0.05
                verdict = verdict if same else "wrong"
            elif verdict != "raised" and not (verdict == "ambiguous" and dec_t is None):
                verdict = "wrong"
            tally[prec][verdict] += 1
            if verdict in ("raised", "wrong"):
                faults.append(dict(case, seed=seed, verdict=verdict))
    n_tail = sum(sum(t.values()) for t in tally.values())
    check(not faults, f"stream tail: {len(faults)} of {n_tail} streams read wrong or raised: "
                      f"{faults[:5]}")
    check(all(launches_tail[n] >= 1 for n in ("C", "B'", "E")),
          f"the stream-tail decodes did not launch kernels C, B' and E: {launches_tail}")
    print(f"stream tail ({n_tail} seeded {th}x{tw} streams of {tf} frames, encoded and decoded "
          "on the card): " + json.dumps(dict(
              counts=tally, writer_remainders=tails, decode_launches=launches_tail,
              wall_s=time.perf_counter() - tail_t0)), flush=True)

    kernels = [
        dict(name="intra_luma_wavefront", route="cuda",
             source="icspcodec_torch/csrc/intra_luma.cu",
             replaces="icspcodec_tpu/ops/pallas_intra.py:160", launches=launches_enc["A"],
             max_abs_err=err["A"], ms=ka_ms, device_ms=dev_ms["A"], plain_ms=pa_ms,
             bound_ms=a_bound,
             bound_by="operations" if a_flops / PEAK_F64_TC_FLOP_S > a_bytes / PEAK_BYTES_S
             else "bytes", library_ms=None,
             bound_rate="PEAK_F64_TC_FLOP_S (FP64 tensor cores): the forward product dense, "
                        "the inverse over the nonzero dequantized values",
             nonzero_dequantized=a_nonzero, device_us_per_diagonal=dev_ms["A"] / a_diagonals * 1e3, diagonals=a_diagonals,
             check="float64 and float32 bit-identical at QP 16/16 and 1/1 (float32 at CIF300: "
                   f"{ndiff} of {a32['symbols']} symbols differ), and on a 20,480x32 plane "
                   "(the ring in global scratch)",
             ms_float64=ka64_ms, device_ms_float64=a64_dev_ms, bound_ms_float64=a64_bound,
             path="encode"),
        dict(name="dc_dpcm_forward", route="cuda", source="icspcodec_torch/csrc/dc_dpcm.cu",
             replaces="icspcodec_tpu/ops/pallas_dc.py:66", launches=launches_b["B"],
             max_abs_err=err["B"], ms=kb_ms, device_ms=dev_ms["B"], plain_ms=pb_ms,
             bound_ms=b_bound, bound_by="bytes", library_ms=None,
             share_of_bound=b_bound / dev_ms["B"], layout=b_layout(dc32),
             device_ms_float64=b64_dev_ms, bound_ms_float64=b64_bound,
             share_of_bound_float64=b64_bound / b64_dev_ms, layout_float64=b_layout(dc64),
             device_ms_p_step_chroma=b60_dev_ms, bound_ms_p_step_chroma=b60_bound,
             layout_p_step_chroma=b_layout(dc32[:60]), layouts_checked=b_layouts,
             division_mismatches=div_bad,
             check="bit-identical in float32 and float64 at qstep 16 and 1; luma and chroma "
                   "kinds on both sides of the staged layout's limit, at gh = 1, gw = 1, odd "
                   "gw, more than one band, 769 and 8,190 block rows, and at qstep 1 .. 255 on "
                   "half-integer and negative-residual DCs; its division equal to C division "
                   "for every qstep 1 .. 255 and int32 dividend",
             path="its entry point, ops/dc_fused.dc_dpcm_fused, at the CIF300 chroma grid; "
                  "no codec path calls it (the encoder's chroma chain is kernel F)",
             launches_encode=launches_enc["B"]),
        dict(name="dc_dpcm_inverse", route="cuda", source="icspcodec_torch/csrc/dc_dpcm.cu",
             replaces="icspcodec_tpu/ops/pallas_dc.py:66", launches=launches_ai["B'"],
             max_abs_err=err["B'"], ms=kbi_ms, device_ms=dev_ms["B'"], plain_ms=pbi_ms,
             bound_ms=bi_bound, bound_by="bytes", library_ms=None,
             check="bit-identical at the CIF chroma grid, luma kinds at QCIF and 720p, and luma "
                   "and chroma kinds on planes of 769 and 8,190 block rows",
             path="all-intra decode", launches_period10_decode=launches_p10["B'"],
             device_ms_p_step_luma=bi_luma_ms, device_ms_p_step_chroma=bi_chroma60_ms,
             device_ms_period10_decode_19_launches=bi_p10_ms),
        dict(name="intra_luma_decode_wavefront", route="cuda",
             source="icspcodec_torch/csrc/intra_decode.cu",
             replaces="icspcodec_tpu/ops/pallas_intra.py:371", launches=launches_ai["C"],
             max_abs_err=err["C"], ms=kc_ms, device_ms=dev_ms["C"], plain_ms=pc_ms,
             bound_ms=c_bound,
             bound_by="operations" if c_flops / PEAK_F64_TC_FLOP_S > c_bytes / PEAK_BYTES_S
             else "bytes", library_ms=None,
             bound_rate="PEAK_F64_TC_FLOP_S (FP64 tensor cores): the inverse product over the "
                        "nonzero dequantized values",
             nonzero_dequantized=c_nonzero,
             check="float64 and float32 bit-identical at CIF QP 16/16 and 1/1, QCIF, 720p, "
                   "a 20,480x32 plane and CIF300 (float32 at CIF300: "
                   f"{pdiff} of {c32['pixels']} pixels differ)",
             ms_float64=kc64_ms, device_ms_float64=c64_dev_ms,
             device_us_per_diagonal=dev_ms["C"] / c_diagonals * 1e3, diagonals=c_diagonals,
             resident_ctas_per_sm=c_ctas, path="all-intra decode",
             launches_period10_decode=launches_p10["C"]),
        dict(name="mc_gather", route="cuda", source="icspcodec_torch/csrc/mc_gather.cu",
             replaces="icspcodec_tpu/ops/pallas_me.py:387", launches=launches_p10["E"],
             max_abs_err=err["E"], ms=ke_ms, device_ms=dev_ms["E"], plain_ms=pe_ms,
             bound_ms=e_bound, bound_by="bytes", library_ms=le_ms,
             library_device_ms=e_times["library_device_ms"],
             check="bit-identical at CIF luma and chroma, union and out-of-frame MVs, both "
                   "entry points, every P-step of two period-10 streams; times are one "
                   "decode P-step's luma, Cb and Cr in one launch (mc_gather_yc)",
             ms_two_launches=ke2_ms, device_ms_two_launches=e_times["two_launch_device_ms"],
             path="period-10 decode", launches_period10_encode=launches_enc10["E"],
             launches_mc_select_wrappers=launches_sel["E"]),
        dict(name="sad_mc_best", route="cuda", source="icspcodec_torch/csrc/sad_mc.cu",
             replaces="icspcodec_tpu/ops/pallas_me.py:207", launches=launches_enc10["D"],
             max_abs_err=err["D"], ms=kd_ms, device_ms=dev_ms["D"], plain_ms=pd_ms,
             bound_ms=d_bound,
             bound_by="operations" if d_ops / PEAK_LANE_OP_S > d_bytes / PEAK_BYTES_S
             else "bytes", library_ms=None,
             check="bit-identical on benchA, synthStatic (CIF, 30 frames) and 720p; times "
                   "are one P-step (30 CIF frames)",
             byte_differences_per_operation=diffs_op, path="period-10 encode"),
        dict(name="xform_fwd", route="cuda", source="icspcodec_torch/csrc/xform_fwd.cu",
             replaces="icspcodec_tpu/ops/pallas_xform.py:63", launches=launches_enc10["F"],
             max_abs_err=err["F"], ms=kf_ms, device_ms=dev_ms["F"], plain_ms=pf_ms,
             bound_ms=f_bound,
             bound_by="operations" if f_flops / PEAK_F64_TC_FLOP_S > f_bytes / PEAK_BYTES_S
             else "bytes", library_ms=None,
             bound_rate="PEAK_F64_TC_FLOP_S (FP64 tensor cores, DMMA): the forward product "
                        "dense, the inverse over the nonzero dequantized values",
             nonzero_dequantized=f_nonzero,
             check="float64 and float32 bit-identical (luma and chroma at CIF, 720p and "
                   "1080p and a 4096-line plane, QP 16/16 and 1/1; the CIF300 P-step); "
                   f"float32 {fdiff} of {fsyms} symbols differ; times are one P-step's "
                   "luma and chroma calls, two launches each",
             ms_float64=kf64_ms, bound_ms_float64=f64_bound,
             bound_by_float64="operations" if f64_flops / PEAK_F64_FLOP_S
             > f64_bytes / PEAK_BYTES_S else "bytes", path="period-10 encode",
             launches_all_intra_encode=launches_enc["F"]),
        dict(name="sad_union_extra", route="cuda", source="icspcodec_torch/csrc/sad_mc.cu",
             replaces="icspcodec_tpu/ops/pallas_me.py:315", launches=launches_static["G"],
             max_abs_err=err["G"], ms=kg_ms, device_ms=dev_ms["G"], plain_ms=pg_ms,
             bound_ms=g_bound,
             bound_by="operations" if g_ops / PEAK_LANE_OP_S > g_bytes / PEAK_BYTES_S
             else "bytes", library_ms=None,
             check="bit-identical on benchA, synthStatic (CIF, 30 frames) and 720p; times "
                   "are one P-step (30 CIF frames)",
             path="period-10 encode of synthStatic",
             launches_period10_encode=launches_enc10["G"]),
        dict(name="sad_best", route="cuda", source="icspcodec_torch/csrc/sad_mc.cu",
             replaces="icspcodec_tpu/ops/pallas_me.py:113", launches=launches_search["sad_best"],
             max_abs_err=err["sad_best"], ms=ksb_ms, device_ms=dev_ms["sad_best"],
             plain_ms=psb_ms, bound_ms=sb_bound,
             bound_by="operations" if sb_ops / PEAK_LANE_OP_S > sb_bytes / PEAK_BYTES_S
             else "bytes", library_ms=None,
             check="bit-identical on benchA, synthStatic (CIF, 30 frames) and 720p; best = D's "
                   "where zc < 2; MVs = spiral_search's on benchA; times are one P-step "
                   "(30 CIF frames)",
             path="unfused search (sad_best, then luma and chroma MC through E)"),
        dict(name="sad_union", route="cuda", source="icspcodec_torch/csrc/sad_mc.cu",
             replaces="icspcodec_tpu/ops/pallas_me.py:366", launches=launches_search["sad_union"],
             max_abs_err=err["sad_union"], ms=ksu_ms, device_ms=dev_ms["sad_union"],
             plain_ms=psu_ms, bound_ms=su_bound,
             bound_by="operations" if su_ops / PEAK_LANE_OP_S > su_bytes / PEAK_BYTES_S
             else "bytes", library_ms=None,
             check="bit-identical on benchA, synthStatic (CIF, 30 frames) and 720p; = D's "
                   "canonical rows followed by G's; times are one P-step (30 CIF frames)",
             path="unfused search (G's entry point at all 129 union offsets)"),
    ]
    # which paths of this slice launch each kernel: the three GOP-sharded
    # calls of phase 17 and the tiled exact encode and decode of phase 18
    counter = {"intra_luma_wavefront": "A", "dc_dpcm_forward": "B", "dc_dpcm_inverse": "B'",
               "intra_luma_decode_wavefront": "C", "mc_gather": "E", "sad_mc_best": "D",
               "xform_fwd": "F", "sad_union_extra": "G", "sad_best": "sad_best",
               "sad_union": "sad_union"}
    for k in kernels:
        c = counter[k["name"]]
        k["launches_gop_shards"] = {n: v[c] for n, v in launches_shard.items()}
        k["launches_tiles"] = {"encode": tiled["exact_encode_launches"][c],
                               "decode": tiled["exact_decode_launches"][c]}
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
