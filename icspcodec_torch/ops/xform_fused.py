"""The forward residual chain of the inter encoder: CUDA kernel F
(csrc/xform_fwd.cu) and its plain version.

Counterpart of icspcodec_tpu/ops/pallas_xform.py::xform_fwd_fused: DCT,
DC DPCM, quantization, zig-zag, AC-empty flag, dequantization and IDCT of
(F, gh, gw, 8, 8) integer blocks, luma (inter residuals) or chroma.  On a
CPU tensor the wrapper runs the plain version, the unfused chain of the JAX
package's engine/inter.py:140-152; on a CUDA tensor it launches the kernel
or raises.  float64 is bit-identical to the plain version.  In float32
both take the dense float32 transform matrices with double sums, the kernel
on the FP64 tensor cores in another order; every such sum of integer
inputs is exact in double (csrc/xform_fwd.cu, "Precision"), so the kernel
equals the plain version on the card bit for bit (chip_smoke.py counts the
symbols that differ).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..constants import COS_ENC, IRT2, ZIGZAG
from ..tables import TABLES, fdct_matrix, idct_matrix, table_key
from .dc_fused import dc_dpcm_plain, kind_grid
from .me import device_table
from .quant import ac_flag, c_trunc, dequant_block, quant_block
from .scanorder import zigzag
from .transforms import fdct, idct
from . import _build

launches = 0  # kernel launches, for showing that a run went through it

MAX_CELLS = 1 << 25   # blocks a kernel call takes (csrc/xform_fwd.cu MAX_CELLS)


@functools.lru_cache(maxsize=None)
def _lib():
    fn = _build.load("xform_fwd").icsp_xform_fwd
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, ll, ll, ll, ll, ll, i, i, p, p, p, i, i, i, i, i, p, p, p, p, p, p]
    fn.restype = ctypes.c_int
    return fn


def _fragments(m: np.ndarray) -> np.ndarray:
    """A 64x64 matrix in the order of the kernel's mma.m8n8k4 A fragments:
    out[(mt * 16 + ks) * 32 + lane] = m[mt * 8 + lane // 4][ks * 4 + lane % 4]."""
    return m.reshape(8, 8, 16, 4).transpose(0, 2, 1, 3).ravel()


@functools.lru_cache(maxsize=None)
def _tables(key: str, exact: bool) -> np.ndarray:
    """The kernel's transform tables: float64, the cosine table then IRT2;
    float32, the forward then the inverse 64x64 matrix in fragment order."""
    ct = np.asarray(TABLES[key], np.float64)
    if not np.all(ct[0] == 1.0):
        raise ValueError("kernel F's DC term takes a cosine table whose row 0 is all ones")
    if exact:
        return np.concatenate([ct.ravel(), [IRT2]])
    return np.concatenate([_fragments(fdct_matrix(key, "float32")),
                           _fragments(idct_matrix(key, "float32"))])


@functools.lru_cache(maxsize=None)
def _device_args(key: str, exact: bool, chroma: bool, gh: int, gw: int, device: torch.device):
    """(tables, zig-zag order, kind grid) on the device, copied there once
    per (table, precision, grid, device)."""
    return (device_table(_tables(key, exact), device),
            device_table(ZIGZAG.astype(np.int32), device), kind_grid(gh, gw, chroma, device))


def _kernel_blocks(blocks: torch.Tensor) -> torch.Tensor:
    """int32 blocks in the layout the kernel reads: unit column stride, the
    other strides multiples of 4 and a 16-byte aligned base (a view of
    contiguous int32 planes already is); else a contiguous copy."""
    src = blocks if blocks.dtype == torch.int32 else blocks.to(torch.int32)
    st = src.stride()
    if st[-1] == 1 and all(s % 4 == 0 for s in st[:-1]) and src.data_ptr() % 16 == 0:
        return src
    return src.contiguous()


def _plane_batches(nplanes: int, gh: int, gw: int) -> list[tuple[int, int]]:
    """The kernel calls of one xform_fwd_fused call: [start, stop) ranges of
    planes, each of at most MAX_CELLS blocks (planes are independent).
    The DC walk takes planes of any height (in bands of 512 block rows), so
    every height the header carries (up to 8,190 block rows); a plane of
    more than MAX_CELLS blocks raises ValueError."""
    if gh * gw > MAX_CELLS:
        raise ValueError(f"kernel F takes planes of at most {MAX_CELLS} blocks, "
                         f"got {gh} x {gw}")
    step = MAX_CELLS // (gh * gw)
    return [(p, min(p + step, nplanes)) for p in range(0, nplanes, step)]


def xform_fwd_plain(blocks: torch.Tensor, qdc: int, qac: int, chroma: bool, table=COS_ENC,
                    dtype=torch.float64):
    """The plain version: fdct, the DC chain (dc_fused.dc_dpcm_plain),
    quant_block, zig-zag, AC flag, dequant_block and idct, in the kernel's
    output form.  Runs on any device."""
    d = fdct(blocks, table=table, dtype=dtype)
    q_dc, dq_dc = dc_dpcm_plain(d[..., 0, 0], qdc, chroma)
    q = quant_block(d, qdc, qac, chroma=chroma)
    q[..., 0, 0] = q_dc
    iq = dequant_block(q, qdc, qac)
    iq[..., 0, 0] = dq_dc
    r = idct(iq, table=table, dtype=dtype)
    return dict(scan=zigzag(q).to(torch.int16), acflag=ac_flag(q).to(torch.int8),
                r=r if chroma else c_trunc(r))


def xform_fwd_fused(blocks: torch.Tensor, qdc: int, qac: int, chroma: bool, table=COS_ENC,
                    dtype=torch.float64):
    """blocks: (F, gh, gw, 8, 8) integer blocks with |v| <= 255 (a strided
    view of planes is fine).  Returns dict(scan (F, gh, gw, 64) int16 in
    zig-zag order, acflag (F, gh, gw) int8, r (F, gh, gw, 8, 8)): r is
    trunc(idct) int32 for luma and the raw idct in dtype for chroma (the
    caller adds the predictor in float before its (int) cast).  dtype
    float32 is the fast path, float64 the exact one.  On the card, planes
    of any height and at most MAX_CELLS blocks, any number of them: a call
    of more than MAX_CELLS blocks is split over its planes."""
    global launches
    if blocks.dim() != 5 or blocks.shape[3:] != (8, 8):
        raise ValueError(f"blocks must be (F, gh, gw, 8, 8), got {tuple(blocks.shape)}")
    if blocks.dtype.is_floating_point or blocks.dtype == torch.bool:
        raise TypeError(f"xform_fwd_fused takes integer blocks, got {blocks.dtype}")
    if blocks.device.type == "cpu":
        return xform_fwd_plain(blocks, qdc, qac, chroma, table, dtype)
    if blocks.device.type != "cuda":
        raise ValueError(f"xform_fwd_fused runs on cpu or cuda tensors, got {blocks.device}")
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"dtype must be float32 or float64, got {dtype}")
    if min(qdc, qac) < 1:
        raise ValueError(f"quantizer steps must be >= 1, got {qdc}, {qac}")
    fdim, gh, gw = blocks.shape[:3]
    dev = blocks.device
    exact = dtype == torch.float64
    batches = _plane_batches(fdim, gh, gw)
    src = _kernel_blocks(blocks)
    tab, zz, kind = _device_args(table_key(table), exact, bool(chroma), gh, gw, dev)
    scan = torch.empty((fdim, gh, gw, 64), dtype=torch.int16, device=dev)
    acf = torch.empty((fdim, gh, gw), dtype=torch.int8, device=dev)
    r = torch.empty((fdim, gh * 8, gw * 8), dtype=dtype if chroma else torch.int32, device=dev)
    out = dict(scan=scan, acflag=acf, r=r.reshape(fdim, gh, 8, gw, 8).permute(0, 1, 3, 2, 4))
    if fdim == 0:
        return out
    # scratch: (q, dq) of each block's DC, then the DC terms of planes too
    # large for the first launch's shared memory
    ncp = gh * gw
    ncell = (batches[0][1] - batches[0][0]) * ncp
    ws = torch.empty(ncell * (8 + dtype.itemsize), dtype=torch.uint8, device=dev)
    fn = _lib()
    with _build.on_device(dev):
        for p0, p1 in batches:
            err = fn(src[p0].data_ptr(), *src.stride(), int(exact), int(chroma), tab.data_ptr(),
                     zz.data_ptr(), kind.data_ptr(), p1 - p0, gh, gw, int(qdc), int(qac),
                     ws.data_ptr() + ncell * 8, ws.data_ptr(), scan[p0].data_ptr(),
                     acf[p0].data_ptr(), r[p0].data_ptr(), _build.stream_ptr(dev))
            _build.check(err, "xform_fwd kernel")
            with _build.count_lock:
                launches += 1
    return out
