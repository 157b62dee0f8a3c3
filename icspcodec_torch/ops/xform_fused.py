"""The forward residual chain of the inter encoder: CUDA kernel F
(csrc/xform_fwd.cu) and its plain version.

Counterpart of icspcodec_tpu/ops/pallas_xform.py::xform_fwd_fused: DCT,
DC DPCM, quantization, zig-zag, AC-empty flag, dequantization and IDCT of
(F, gh, gw, 8, 8) integer blocks, luma (inter residuals) or chroma.  On a
CPU tensor the wrapper runs the plain version, the unfused chain of the JAX
package's engine/inter.py:140-152; on a CUDA tensor it launches the kernel
or raises.  float64 is bit-identical to the plain version; in float32 both
take the dense float32 transform matrices with double sums, in another
order, so a result may round to another float on rare occasions
(chip_smoke.py counts the symbols that differ).
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


def _lib():
    fn = _build.load("xform_fwd").icsp_xform_fwd
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, ll, ll, ll, ll, ll, i, i, p, p, p, i, i, i, i, i, p, p, p, p, p, p]
        fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _tables(key: str, exact: bool) -> np.ndarray:
    """The kernel's transform tables: float64, the cosine table then IRT2;
    float32, both 64x64 matrices, transposed (m_t[k * 64 + o] = M[o][k])."""
    if exact:
        return np.concatenate([np.asarray(TABLES[key], np.float64).ravel(), [IRT2]])
    return np.concatenate([fdct_matrix(key, "float32").T.ravel(),
                           idct_matrix(key, "float32").T.ravel()])


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
    float32 is the fast path, float64 the exact one."""
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
    src = blocks if blocks.dtype == torch.int32 else blocks.to(torch.int32)
    tab = device_table(_tables(table_key(table), dtype == torch.float64), dev)
    zz = device_table(ZIGZAG.astype(np.int32), dev)
    kind = kind_grid(gh, gw, chroma, dev)
    scan = torch.empty((fdim, gh, gw, 64), dtype=torch.int16, device=dev)
    acf = torch.empty((fdim, gh, gw), dtype=torch.int8, device=dev)
    r = torch.empty((fdim, gh * 8, gw * 8), dtype=dtype if chroma else torch.int32, device=dev)
    out = dict(scan=scan, acflag=acf, r=r.reshape(fdim, gh, 8, gw, 8).permute(0, 1, 3, 2, 4))
    if fdim == 0:
        return out
    dc = torch.empty((fdim, gh, gw), dtype=dtype, device=dev)        # scratch
    qdq = torch.empty((fdim, gh, gw, 2), dtype=torch.int32, device=dev)
    fn = _lib()
    with torch.cuda.device(dev):
        err = fn(src.data_ptr(), *src.stride(), int(dtype == torch.float64), int(chroma),
                 tab.data_ptr(), zz.data_ptr(), kind.data_ptr(), fdim, gh, gw, int(qdc),
                 int(qac), dc.data_ptr(), qdq.data_ptr(), scan.data_ptr(), acf.data_ptr(),
                 r.data_ptr(), _build.stream_ptr(dev))
    _build.check(err, "xform_fwd kernel")
    launches += 1
    return out
