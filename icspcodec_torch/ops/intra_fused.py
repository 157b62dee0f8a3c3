"""Intra luma wavefront: CUDA kernel A (csrc/intra_luma.cu) and its plain
version.

Counterpart of icspcodec_tpu/ops/pallas_intra.py::intra_luma_scan_fused.
On a CPU tensor the wrapper runs the plain version
(engine/wavefront.intra_luma_scan_packed); on a CUDA tensor it launches the
kernel or raises.  float64 is bit-identical to the plain version; float32
sums the 64x64 transform products in float32, the plain version on the
card in float64 (ops/transforms.py), so a quantizer tie may flip (chip_smoke.py counts the
differences).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..constants import COS_ENC, IRT2, ZIGZAG
from ..engine.wavefront import intra_luma_scan_packed
from ..tables import TABLES, fdct_matrix, idct_matrix, luma_dc_kind, table_key
from .quant import ac_flag_from_scan
from . import _build

launches = 0  # kernel launches, for showing that a run went through it
_consts: dict = {}


def _lib():
    lib = _build.load("intra_luma")
    fn = lib.icsp_intra_luma
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, ll, ll, ll, ll, ll, i, p, p, p, i, i, i, i, i, p, p, p, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def _tables(key: str, dtype: torch.dtype, gh: int, gw: int, device):
    """Device copies of the kernel's constants: transform tables (float:
    both 64x64 matrices transposed; double: the cosine table then IRT2),
    the zig-zag order and the luma DC kind grid."""
    ck = (key, dtype, gh, gw, str(device))
    if ck not in _consts:
        if dtype == torch.float64:
            mats = np.concatenate([np.asarray(TABLES[key], np.float64).ravel(), [IRT2]])
        else:
            mats = np.concatenate([fdct_matrix(key, "float32").T.ravel(),
                                   idct_matrix(key, "float32").T.ravel()])
        _consts[ck] = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in (
            mats, ZIGZAG.astype(np.int32), luma_dc_kind(gh, gw)))
    return _consts[ck]


def intra_luma_scan_plain(orig, qdc, qac, table=COS_ENC, dtype=torch.float32,
                          want_recon=True, recon_plane=False):
    """The plain version: wavefront.intra_luma_scan_packed, with the
    outputs in the kernel's form.  Runs on any device."""
    out = intra_luma_scan_packed(orig, qdc, qac, table=table, dtype=dtype)
    res = dict(
        scan=out["scan"].to(torch.int16),
        mpm=out["mpm"].to(torch.int8),
        mode_bit=out["mode_bit"].to(torch.int8),
        acflag=ac_flag_from_scan(out["scan"]).to(torch.int8),
    )
    if want_recon:
        rec = out["recon"].to(torch.uint8)
        if recon_plane:
            fdim, gh, gw = rec.shape[:3]
            res["recon_plane"] = rec.permute(0, 1, 3, 2, 4).reshape(fdim, gh * 8, gw * 8)
        else:
            res["recon"] = rec
    return res


def intra_luma_scan_fused(orig: torch.Tensor, qdc: int, qac: int, table=COS_ENC,
                          dtype=torch.float32, want_recon: bool = True,
                          recon_plane: bool = False):
    """orig: (F, gh, gw, 8, 8) blocks of pixel values (any integer dtype;
    a strided view of the planes is fine) -> dict(scan (F,gh,gw,64) int16 in
    zig-zag order, mpm / mode_bit / acflag (F,gh,gw) int8) plus, with
    want_recon, recon: (F,gh,gw,8,8) uint8 blocks, or (F, gh*8, gw*8) uint8
    planes as recon_plane with recon_plane=True.  dtype float32 is the fast
    path, float64 the exact one."""
    global launches
    if orig.dim() != 5 or orig.shape[3:] != (8, 8):
        raise ValueError(f"orig must be (F, gh, gw, 8, 8) blocks, got {tuple(orig.shape)}")
    fdim, gh, gw = orig.shape[:3]
    if gw % 2:
        # odd-width grids put kind-4 cells on the right edge, where the
        # upper-right DC read has no cell (JAX: pallas_intra.py:655-661)
        raise ValueError("intra_luma_scan_fused requires an even block-grid "
                         f"width; got gw={gw}")
    if orig.device.type == "cpu":
        return intra_luma_scan_plain(orig, qdc, qac, table, dtype, want_recon, recon_plane)
    if orig.device.type != "cuda":
        raise ValueError(f"intra_luma_scan_fused runs on cpu or cuda tensors, got {orig.device}")
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"dtype must be float32 or float64, got {dtype}")
    if min(qdc, qac) < 1:
        raise ValueError(f"quantizer steps must be >= 1, got {qdc}, {qac}")
    dev = orig.device
    src = orig if orig.dtype == torch.uint8 else orig.to(torch.uint8)
    mats, zz, kind = _tables(table_key(table), dtype, gh, gw, dev)
    scan = torch.empty((fdim, gh, gw, 64), dtype=torch.int16, device=dev)
    mpm, mbit, acf = (torch.empty((fdim, gh, gw), dtype=torch.int8, device=dev)
                      for _ in range(3))
    plane = (torch.empty((fdim, gh * 8, gw * 8), dtype=torch.uint8, device=dev)
             if want_recon else None)
    res = dict(scan=scan, mpm=mpm, mode_bit=mbit, acflag=acf)
    if want_recon:
        if recon_plane:
            res["recon_plane"] = plane
        else:
            res["recon"] = plane.reshape(fdim, gh, 8, gw, 8).permute(0, 1, 3, 2, 4)
    if fdim == 0:
        return res
    fn = _lib()
    with torch.cuda.device(dev):
        err = fn(src.data_ptr(), *src.stride(), int(dtype == torch.float64),
                 kind.data_ptr(), mats.data_ptr(), zz.data_ptr(), fdim, gh, gw,
                 int(qdc), int(qac), scan.data_ptr(), mpm.data_ptr(), mbit.data_ptr(),
                 acf.data_ptr(), plane.data_ptr() if want_recon else None,
                 _build.stream_ptr(dev))
    _build.check(err, "intra_luma kernel")
    launches += 1
    return res
