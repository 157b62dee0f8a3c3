"""Top-level encode API of the PyTorch port.

encode() runs the all-intra codec on one device: the intra engine
(engine/intra.py, with CUDA kernels A and B on the card), device-side
entropy items and bit packing (bitstream_device.py), and the host splice
plus the 14-byte header.  Only the packed frames (and, if asked, the recon
planes) come back to the host.

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
from .constants import COS_ENC
from .engine.intra import encode_intra_frames
from .tables import pack_header

_INTRA_KEYS = ("y_scan", "y_acflag", "mpm", "mode_bit",
               "cb_scan", "cb_acflag", "cr_scan", "cr_acflag")


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
        raise NotImplementedError(
            "gop_shards / tile_shards > 1: GOP batching and sharding are not ported "
            "yet (ROADMAP.md queue 1 item 11)")
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
    codes, lengths = frame_items_dev({k: out[k] for k in _INTRA_KEYS})
    rows, nbits = _pack_bucketed(codes, lengths)
    bits = pack_header(cfg.height, cfg.width, cfg.qp_dc, cfg.qp_ac,
                       cfg.intra_period) + assemble_frames(rows, nbits)
    rec = None
    if return_recon:
        rec = {k: out[f"recon_{k}"].cpu().numpy() for k in ("y", "cb", "cr")}
    return bits, rec
