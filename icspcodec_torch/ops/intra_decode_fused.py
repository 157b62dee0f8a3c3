"""Intra luma decode wavefront: CUDA kernel C (csrc/intra_decode.cu) and its
plain version.

Counterpart of icspcodec_tpu/ops/pallas_intra.py::intra_luma_decode_fused.
On a CPU tensor the wrapper runs the plain version (the JAX engine's XLA
branch: inverse zig-zag, dequantization, wavefront.idc_dpcm_scan, the
inverse DCT, wavefront.intra_luma_decode_scan_packed); on a CUDA tensor it
launches the kernel or raises.  float64 is bit-identical to the plain
version; float32 takes the separable transform where the plain version on
the card sums the 64x64 product in float64, so a pixel on a truncation
boundary may differ by one (chip_smoke.py counts the differences).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..constants import COS_DEC, IRT2, IZIGZAG
from ..engine.wavefront import idc_dpcm_scan, intra_luma_decode_scan_packed
from ..tables import TABLES, luma_dc_kind, table_key
from .quant import dequant_block
from .scanorder import izigzag
from .transforms import idct
from . import _build

launches = 0  # kernel launches, for showing that a run went through it
_consts: dict = {}


def _lib():
    fn = _build.load("intra_decode").icsp_intra_decode
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, p, p, p, i, i, i, i, i, p, p]
        fn.restype = ctypes.c_int
    return fn


def _tables(key: str, dtype: torch.dtype, gh: int, gw: int, device):
    """Device copies of the kernel's constants: the cosine table then IRT2
    in the working type, the inverse zig-zag and the luma DC kind grid."""
    ck = (key, dtype, gh, gw, str(device))
    if ck not in _consts:
        tabs = np.concatenate([np.asarray(TABLES[key], np.float64).ravel(), [IRT2]])
        _consts[ck] = (torch.from_numpy(tabs).to(device=device, dtype=dtype),
                       torch.from_numpy(IZIGZAG.astype(np.int32)).to(device),
                       torch.from_numpy(luma_dc_kind(gh, gw)).to(device))
    return _consts[ck]


def _to_plane(blocks: torch.Tensor) -> torch.Tensor:
    fdim, gh, gw = blocks.shape[:3]
    return blocks.permute(0, 1, 3, 2, 4).reshape(fdim, gh * 8, gw * 8)


def intra_luma_decode_plain(y_scan, mpm, mode_bit, qdc, qac, table=COS_DEC,
                            dtype=torch.float32):
    """The plain version, as uint8 planes (F, gh*8, gw*8).  Runs on any
    device."""
    q = izigzag(y_scan.to(torch.int32))
    iq = dequant_block(q, qdc, qac)
    gh, gw = q.shape[1:3]
    iq[..., 0, 0] = idc_dpcm_scan(iq[..., 0, 0], luma_dc_kind(gh, gw))
    r = idct(iq, table=table, dtype=dtype)
    rec = intra_luma_decode_scan_packed(r, mpm, mode_bit, dtype=dtype)
    return _to_plane(rec.to(torch.uint8))


def intra_luma_decode_fused(y_scan: torch.Tensor, mpm: torch.Tensor, mode_bit: torch.Tensor,
                            qdc: int, qac: int, table=COS_DEC,
                            dtype=torch.float32) -> torch.Tensor:
    """y_scan: (F, gh, gw, 64) integer symbols in zig-zag order; mpm /
    mode_bit: (F, gh, gw) 0/1 flags.  Returns the reconstructed luma planes
    (F, gh*8, gw*8) uint8.  dtype float32 is the fast path, float64 the
    exact one.

    Symbols wider than int16 are clamped to the int16 domain first, as the
    JAX kernel does: a compliant stream's symbols are far inside it, and
    the clamp keeps what a corrupt one gives deterministic."""
    global launches
    if y_scan.dim() != 4 or y_scan.shape[3] != 64:
        raise ValueError(f"y_scan must be (F, gh, gw, 64), got {tuple(y_scan.shape)}")
    fdim, gh, gw = y_scan.shape[:3]
    if mpm.shape != (fdim, gh, gw) or mode_bit.shape != (fdim, gh, gw):
        raise ValueError("mpm and mode_bit must be (F, gh, gw) like y_scan")
    if gw % 2:
        # odd-width grids put kind-4 cells on the right edge, where the
        # upper-right DC read has no cell (JAX: pallas_intra.py:710-712)
        raise ValueError("intra_luma_decode_fused requires an even block-grid "
                         f"width; got gw={gw}")
    if y_scan.dtype != torch.int16:
        y_scan = torch.clamp(y_scan, -32768, 32767).to(torch.int16)
    mpm, mode_bit = mpm.to(torch.int8), mode_bit.to(torch.int8)
    if y_scan.device.type == "cpu":
        return intra_luma_decode_plain(y_scan, mpm, mode_bit, qdc, qac, table, dtype)
    if y_scan.device.type != "cuda":
        raise ValueError(f"intra_luma_decode_fused runs on cpu or cuda tensors, "
                         f"got {y_scan.device}")
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"dtype must be float32 or float64, got {dtype}")
    dev = y_scan.device
    sc, mp, mb = (t.contiguous() for t in (y_scan, mpm, mode_bit))
    tabs, izz, kind = _tables(table_key(table), dtype, gh, gw, dev)
    plane = torch.empty((fdim, gh * 8, gw * 8), dtype=torch.uint8, device=dev)
    if fdim == 0:
        return plane
    fn = _lib()
    with torch.cuda.device(dev):
        err = fn(sc.data_ptr(), mp.data_ptr(), mb.data_ptr(), int(dtype == torch.float64),
                 kind.data_ptr(), tabs.data_ptr(), izz.data_ptr(), fdim, gh, gw, int(qdc),
                 int(qac), plane.data_ptr(), _build.stream_ptr(dev))
    _build.check(err, "intra_decode kernel")
    launches += 1
    return plane
