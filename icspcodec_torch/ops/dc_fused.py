"""DC DPCM chains: CUDA kernels B (forward) and B' (inverse), two entry
points of csrc/dc_dpcm.cu, and their plain versions.

Counterparts of icspcodec_tpu/ops/pallas_dc.py::dc_dpcm_fused and
idc_dpcm_fused.  On a CPU tensor each wrapper runs its plain version
(engine/wavefront.dc_dpcm_scan / idc_dpcm_scan); on a CUDA tensor it
launches its kernel or raises.  B is bit-identical to its plain version in
float32 and float64; B' is all integer, so bit-identical too.  Each kernel
has its own launch counter.
"""
from __future__ import annotations

import ctypes

import torch

from ..engine.wavefront import dc_dpcm_scan, idc_dpcm_scan
from ..tables import chroma_dc_kind, luma_dc_kind
from . import _build

launches = 0      # kernel B launches, for showing that a run went through it
launches_inv = 0  # kernel B' launches
_kinds: dict = {}


def _lib():
    lib = _build.load("dc_dpcm")
    fn = lib.icsp_dc_dpcm_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, i, i, i, i, i, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def _lib_inv():
    fn = _build.load("dc_dpcm").icsp_dc_dpcm_inv
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, i, i, i, p, p]
        fn.restype = ctypes.c_int
    return fn


def kind_grid(gh: int, gw: int, chroma: bool, device) -> torch.Tensor:
    """The chroma or luma DC kind grid on the device, copied there once."""
    key = (gh, gw, chroma, str(device))
    if key not in _kinds:
        grid = (chroma_dc_kind if chroma else luma_dc_kind)(gh, gw)
        _kinds[key] = torch.from_numpy(grid).to(device)
    return _kinds[key]


def dc_dpcm_plain(dc: torch.Tensor, qstep: int, chroma: bool):
    """The plain version: wavefront.dc_dpcm_scan with the chroma or luma
    kind grid.  Runs on any device."""
    gh, gw = dc.shape[1:]
    return dc_dpcm_scan(dc, (chroma_dc_kind if chroma else luma_dc_kind)(gh, gw), qstep, chroma)


def dc_dpcm_fused(dc: torch.Tensor, qstep: int, chroma: bool):
    """dc: (F, gh, gw) float32 or float64 DC values -> (q, dq) int32, the
    contract of wavefront.dc_dpcm_scan with the chroma or luma kind grid."""
    global launches
    fdim, gh, gw = dc.shape
    if dc.device.type == "cpu":
        return dc_dpcm_plain(dc, qstep, chroma)
    if dc.device.type != "cuda":
        raise ValueError(f"dc_dpcm_fused runs on cpu or cuda tensors, got {dc.device}")
    if dc.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"dc_dpcm_fused takes float32 or float64 DCs, got {dc.dtype}")
    if qstep < 1:
        raise ValueError(f"qstep must be >= 1, got {qstep}")
    dc = dc.contiguous()
    q = torch.empty(dc.shape, dtype=torch.int32, device=dc.device)
    dq = torch.empty_like(q)
    if fdim == 0:
        return q, dq
    kind = kind_grid(gh, gw, chroma, dc.device)
    fn = _lib()
    with torch.cuda.device(dc.device):
        err = fn(dc.data_ptr(), int(dc.dtype == torch.float64), kind.data_ptr(), fdim,
                 gh, gw, int(qstep), int(chroma), q.data_ptr(), dq.data_ptr(),
                 _build.stream_ptr(dc.device))
    _build.check(err, "dc_dpcm kernel")
    launches += 1
    return q, dq


def idc_dpcm_plain(iq_dc: torch.Tensor, chroma: bool):
    """The plain version of B': wavefront.idc_dpcm_scan with the chroma or
    luma kind grid.  Runs on any device."""
    gh, gw = iq_dc.shape[1:]
    return idc_dpcm_scan(iq_dc, (chroma_dc_kind if chroma else luma_dc_kind)(gh, gw))


def idc_dpcm_fused(iq_dc: torch.Tensor, chroma: bool):
    """iq_dc: (F, gh, gw) integer dequantized DC residuals -> dq (F, gh, gw)
    int32, the contract of wavefront.idc_dpcm_scan with the chroma or luma
    kind grid."""
    global launches_inv
    fdim, gh, gw = iq_dc.shape
    if iq_dc.device.type == "cpu":
        return idc_dpcm_plain(iq_dc, chroma)
    if iq_dc.device.type != "cuda":
        raise ValueError(f"idc_dpcm_fused runs on cpu or cuda tensors, got {iq_dc.device}")
    if iq_dc.dtype.is_floating_point or iq_dc.dtype == torch.bool:
        raise TypeError(f"idc_dpcm_fused takes integer residuals, got {iq_dc.dtype}")
    iq = iq_dc.to(torch.int32).contiguous()
    dq = torch.empty_like(iq)
    if fdim == 0:
        return dq
    kind = kind_grid(gh, gw, chroma, iq.device)
    fn = _lib_inv()
    with torch.cuda.device(iq.device):
        err = fn(iq.data_ptr(), kind.data_ptr(), fdim, gh, gw, dq.data_ptr(),
                 _build.stream_ptr(iq.device))
    _build.check(err, "idc_dpcm kernel")
    launches_inv += 1
    return dq
