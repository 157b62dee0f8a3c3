"""Top-level encode and decode API of the PyTorch port.

encode() runs the all-intra codec on one device: the intra engine
(engine/intra.py, with CUDA kernels A and B on the card), device-side
entropy items and bit packing (bitstream_device.py), and the host splice
plus the 14-byte header.  Only the packed frames (and, if asked, the recon
planes) come back to the host.

decode() reads any stream the codec writes, at every intra period: the
host parser (runtime/) produces fixed-shape symbol arrays, which go to the
device once; the intra frames of all GOPs decode as one batch (kernels C
and B'), the MVs of all P-frames in one batched walk, then each P-frame
position of the GOPs as one batched step (kernels B' and E).  The decode
side always uses the decoder-regime double table COS_DEC.

Two precision regimes (cfg.precision):
  exact -- float64 with the encoder's float-rounded cosine table: the
           bitstream is byte-identical to the JAX package's exact mode, and
           so to the C++ reference encoder.  The H100's float64 is IEEE, so
           exact mode runs on the card.
  fast  -- float32; identical structure, a quantizer rounding tie may flip.
"""
from __future__ import annotations

import numpy as np
import torch

from .bitstream_device import assemble_frames, frame_items_dev, pack_frames_dev
from .config import CodecConfig
from .constants import COS_DEC, COS_ENC
from .engine.inter import decode_gop_mvs, decode_inter_frame
from .engine.intra import decode_intra_frames, encode_intra_frames
from .runtime import parse_body
from .tables import pack_header, parse_header

_INTRA_KEYS = ("y_scan", "y_acflag", "mpm", "mode_bit",
               "cb_scan", "cb_acflag", "cr_scan", "cr_acflag")
_DEC_INTRA_KEYS = ("y_scan", "mpm", "mode_bit", "cb_scan", "cr_scan")
_DEC_INTER_KEYS = ("y_scan", "mv_diff", "cb_scan", "cr_scan")
_SHARDING = ("gop_shards / tile_shards > 1: GOP batching and sharding are not ported "
             "yet (ROADMAP.md queue 1 item 11)")


def resolve_device(device=None) -> torch.device:
    """The device to run on: the given one, else the current CUDA device.
    With no GPU and no device given this raises rather than falling back to
    the CPU, where the plain versions stand in for the kernels."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run "
                           "the plain PyTorch versions of the kernels on the CPU")
    return torch.device("cuda")


def _check_supported(cfg: CodecConfig) -> None:
    if cfg.intra_period not in (0, 1):
        raise NotImplementedError(
            f"intra_period={cfg.intra_period}: inter GOP encode is not ported yet "
            "(ROADMAP.md queue 1 items 7-8)")
    if cfg.gop_shards > 1 or cfg.tile_shards > 1:
        raise NotImplementedError(_SHARDING)
    if cfg.entropy == "host":
        raise NotImplementedError(
            "entropy='host': the host bitstream writer is not ported yet "
            "(ROADMAP.md queue 1 item 10); entropy='auto' or 'device' give the same bytes")
    if cfg.precision not in ("exact", "fast"):
        raise ValueError(f"precision must be exact|fast, got {cfg.precision!r}")


def _pack_bucketed(codes: torch.Tensor, lengths: torch.Tensor, slab: int = 32):
    """Pack (F, N) device items into per-frame byte rows on the host.

    Pulls the per-frame bit counts first to size one byte bucket (a multiple
    of 8 KB), then packs `slab` frames per call to bound the expand buffers;
    every slab is queued before the first row is pulled.  The bytes do not
    depend on the bucket or the slab."""
    nb = lengths.sum(dim=1, dtype=torch.int64).cpu().numpy()
    maxbytes = int(-(-int(nb.max()) // (8 * 8192)) * 8192)
    f = codes.shape[0]
    packed = [pack_frames_dev(codes[s:s + slab], lengths[s:s + slab], maxbytes)[0]
              for s in range(0, f, slab)]
    rows = [r for p in packed for r in p.cpu().numpy()]
    return rows, [int(b) for b in nb]


def write_stream(intra_syms, intra_idx, inter_syms, inter_idx, nframes: int, height: int,
                 width: int, qdc: int, qac: int, period: int) -> bytes:
    """Serialize batched symbol groups, intra and inter, into one stream in
    display order: the device-side counterpart of the JAX package's
    bitstream.write_bitstream_grouped.  *_syms: dicts of (F, ...) symbol
    tensors on one device (inter frames carry mv_diff), or None; *_idx: the
    display index of each of their frames."""
    rows, nbits = [None] * nframes, [None] * nframes
    for syms, idx, is_intra in ((intra_syms, intra_idx, True), (inter_syms, inter_idx, False)):
        if syms is None:
            continue
        codes, lengths = frame_items_dev(syms, is_intra)
        for n, row, nb in zip(idx, *_pack_bucketed(codes, lengths)):
            rows[int(n)], nbits[int(n)] = row, nb
    return pack_header(height, width, qdc, qac, period) + assemble_frames(rows, nbits)


def encode(y: np.ndarray, cb: np.ndarray, cr: np.ndarray, cfg: CodecConfig,
           return_recon: bool = True, device=None):
    """y: (F, H, W) uint8; cb/cr: (F, H/2, W/2) uint8.  Returns (bitstream
    bytes, recon dict of (F, ...) uint8 numpy planes, or None with
    return_recon=False).

    device: where to run; None means the CUDA card, and raises when there is
    none.  device="cpu" runs the plain versions of the kernels (the tests do).
    """
    _check_supported(cfg)
    dev = resolve_device(device)
    dtype = torch.float64 if cfg.precision == "exact" else torch.float32
    if y.shape[0] == 0:
        raise ValueError("need at least one frame")
    yt, cbt, crt = (torch.from_numpy(np.ascontiguousarray(a, np.uint8)).to(dev)
                    for a in (y, cb, cr))
    out = encode_intra_frames(yt, cbt, crt, cfg.qp_dc, cfg.qp_ac, table=COS_ENC,
                              dtype=dtype, return_recon=return_recon)
    f = y.shape[0]
    bits = write_stream({k: out[k] for k in _INTRA_KEYS}, range(f), None, None, f,
                        cfg.height, cfg.width, cfg.qp_dc, cfg.qp_ac, cfg.intra_period)
    rec = None
    if return_recon:
        rec = {k: out[f"recon_{k}"].cpu().numpy() for k in ("y", "cb", "cr")}
    return bits, rec


def decode_gop(sym_i: dict, sym_p: dict, qdc: int, qac: int, dtype=torch.float64,
               gop_frames=None):
    """Decode closed GOPs: frame 0 intra, the rest P-frames.

    sym_i: intra symbols (G, ...); sym_p: inter symbols (G, P-1, ...), all
    on one device.  gop_frames: each GOP's frame count, non-increasing (a
    shorter last GOP); None means P for all.  Symbols of frames past a
    GOP's count are ignored and their planes left zero.  Returns (first,
    rest): dicts of uint8 planes (G, ...) and (G, P-1, ...).

    The MV reconstruction depends only on the mv_diff symbols, so it runs
    once for all P-frames; then each P-frame position is one step batched
    over the GOPs that have it, carrying the previous planes."""
    first = decode_intra_frames(*(sym_i[k] for k in _DEC_INTRA_KEYS), qdc, qac,
                                table=COS_DEC, dtype=dtype)
    g, pm1 = sym_p["y_scan"].shape[:2]
    lens = [pm1 + 1] * g if gop_frames is None else [int(n) for n in gop_frames]
    if len(lens) != g or any(a < b for a, b in zip(lens, lens[1:])):
        raise ValueError(f"gop_frames must give {g} non-increasing counts, got {lens}")
    mv = decode_gop_mvs(sym_p["mv_diff"])
    rest = {k: v.new_zeros((g, pm1) + v.shape[1:]) for k, v in first.items()}
    carry = first
    for k in range(pm1):
        n = sum(1 for length in lens if length > k + 1)  # a prefix of the GOPs
        if n == 0:
            break
        sym = dict(y_scan=sym_p["y_scan"][:n, k], cb_scan=sym_p["cb_scan"][:n, k],
                   cr_scan=sym_p["cr_scan"][:n, k], mv=mv[:n, k])
        carry = decode_inter_frame(sym, carry["y"][:n], carry["cb"][:n], carry["cr"][:n],
                                   qdc, qac, table=COS_DEC, dtype=dtype)
        for c, v in carry.items():
            rest[c][:n, k] = v
    return first, rest


def decode(data: bytes, nframes: int, precision: str = "exact", device=None,
           gop_shards: int = 1, tile_shards: int = 1):
    """Decode a bitstream of `nframes` frames; returns dict(y, cb, cr) of
    (F, ...) uint8 numpy planes.

    precision: "exact" (float64: the JAX package's exact planes, byte for
    byte) or "fast" (float32).  device: where to run; None means the CUDA
    card, and raises when there is none; device="cpu" runs the plain
    versions of the kernels (the tests do)."""
    if gop_shards > 1 or tile_shards > 1:
        raise NotImplementedError(_SHARDING)
    if precision not in ("exact", "fast"):
        raise ValueError(f"precision must be exact|fast, got {precision!r}")
    if nframes < 1:
        raise ValueError("need at least one frame")
    dev = resolve_device(device)
    dtype = torch.float64 if precision == "exact" else torch.float32
    height, width, qdc, qac, period = parse_header(data[:14])
    syms = parse_body(data[14:], nframes, height, width, period)
    eff = 1 if period == 0 else period
    keys = _DEC_INTRA_KEYS if eff == 1 else _DEC_INTRA_KEYS + ("mv_diff",)
    up = {k: torch.from_numpy(syms[k]).to(dev) for k in keys}
    if eff == 1:
        out = decode_intra_frames(*(up[k] for k in _DEC_INTRA_KEYS), qdc, qac,
                                  table=COS_DEC, dtype=dtype)
    else:
        starts = np.arange(0, nframes, eff)
        pidx = starts[:, None] + np.arange(1, eff)[None, :]        # (G, P-1)
        valid = torch.from_numpy(pidx < nframes).to(dev)
        si = torch.from_numpy(starts).to(dev)
        pi = torch.from_numpy(np.minimum(pidx, nframes - 1)).to(dev)
        first, rest = decode_gop({k: up[k][si] for k in _DEC_INTRA_KEYS},
                                 {k: up[k][pi] for k in _DEC_INTER_KEYS}, qdc, qac,
                                 dtype=dtype, gop_frames=np.minimum(eff, nframes - starts))
        out = {}
        for k, v in first.items():
            plane = v.new_empty((nframes,) + v.shape[1:])
            plane[si] = v
            plane[pi[valid]] = rest[k][valid]
            out[k] = plane
    return {k: out[k].cpu().numpy() for k in ("y", "cb", "cr")}
