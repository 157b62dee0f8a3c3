"""Motion compensation: CUDA kernel E (csrc/mc_gather.cu) and its plain
version.

Counterpart of icspcodec_tpu/ops/pallas_me.py::_mc_select.  mc_gather builds
the predictor planes from per-block MVs; mc_gather_yc builds the decoder's
luma and both chroma predictors in one launch, from the luma MVs; mc_select
is the exact counterpart of the JAX mc_select_* wrappers (per-block indices
into an offset table, MV = -offset).  On a CPU tensor each wrapper runs the
plain version (ops/me.gather_pred, blocks laid out as planes); on a CUDA
tensor it launches the kernel or raises.  Both are integer copies:
bit-identical.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..engine.intra import from_blocks
from .me import device_table, gather_pred
from . import _build

launches = 0  # kernel launches, for showing that a run went through it


@functools.lru_cache(maxsize=None)
def _lib(name: str):
    fn = getattr(_build.load("mc_gather"), name)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = ([p, p, i, i, i, i, p, p] if name == "icsp_mc_gather"
                   else [p, p, p, i, i, i, p, p, p])
    fn.restype = ctypes.c_int
    return fn


def chroma_mv(mv: torch.Tensor) -> torch.Tensor:
    """The chroma MV of a luma MV: mv / 2 with C truncation
    (CmotionCompensation enc src:2538)."""
    return torch.sign(mv) * torch.div(mv.abs(), 2, rounding_mode="floor")


def _mv_arg(mv: torch.Tensor, device) -> torch.Tensor:
    """mv as the kernel takes it: contiguous int32 on the device."""
    if mv.dtype == torch.int32 and mv.device == device and mv.is_contiguous():
        return mv
    return mv.to(device=device, dtype=torch.int32).contiguous()


def _check_planes(pad: torch.Tensor, mv: torch.Tensor, block: int, what: str):
    if pad.dim() != 3 or mv.dim() != 4 or mv.shape[-1] != 2:
        raise ValueError(f"{what}: pad must be (B, PH, PW) and mv (B, nby, nbx, 2), got "
                         f"{tuple(pad.shape)} and {tuple(mv.shape)}")
    b, nby, nbx = mv.shape[:3]
    if pad.shape != (b, (nby + 2) * block, (nbx + 2) * block):
        raise ValueError(f"{what}: pad {tuple(pad.shape)} does not match mv {tuple(mv.shape)} "
                         f"padded by {block}")
    if pad.dtype != torch.uint8:
        raise TypeError(f"{what} takes uint8 planes, got {pad.dtype}")
    if pad.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda tensors, got {pad.device}")


def mc_gather_plain(pad: torch.Tensor, mv: torch.Tensor, block: int) -> torch.Tensor:
    """The plain version: gather_pred, then the (block x block) blocks laid
    out as planes (for 16-px luma blocks the same as from_blocks of
    mb_to_grid8, the JAX decoder's order).  Runs on any device."""
    return from_blocks(gather_pred(pad, mv, block))


def mc_gather(pad: torch.Tensor, mv: torch.Tensor, block: int) -> torch.Tensor:
    """pad: (B, H+2p, W+2p) uint8, the previous planes padded by p = block
    (ops/pad.pad_image); mv: (B, H/block, W/block, 2) integer MVs in the
    stream's (x, y) order.  Returns pred (B, H, W) uint8: each block read at
    origin - mv + p, its window start mapped into the padded frame as
    ops/me.window_start says.  The kernel takes blocks of 8 or 16 px."""
    global launches
    _check_planes(pad, mv, block, "mc_gather")
    if pad.device.type == "cpu":
        return mc_gather_plain(pad, mv, block)
    if block not in (8, 16):
        raise ValueError(f"kernel E takes blocks of 8 or 16 px, got {block}")
    b, nby, nbx = mv.shape[:3]
    dev = pad.device
    src = pad.contiguous()
    mvi = _mv_arg(mv, dev)
    pred = torch.empty((b, nby * block, nbx * block), dtype=torch.uint8, device=dev)
    if b == 0:
        return pred
    fn = _lib("icsp_mc_gather")
    with _build.on_device(dev):
        err = fn(src.data_ptr(), mvi.data_ptr(), b, nby, nbx, int(block), pred.data_ptr(),
                 _build.stream_ptr(dev))
    _build.check(err, "mc_gather kernel")
    with _build.count_lock:
        launches += 1
    return pred


def mc_gather_yc_plain(pad_y: torch.Tensor, pad_c: torch.Tensor, mv: torch.Tensor):
    """The plain version of mc_gather_yc: two mc_gather_plain calls, the
    chroma one at chroma_mv(mv) for the Cb and the Cr planes.  Runs on any
    device."""
    mvc = chroma_mv(mv)
    return mc_gather_plain(pad_y, mv, 16), mc_gather_plain(pad_c, torch.cat([mvc, mvc]), 8)


def mc_gather_yc(pad_y: torch.Tensor, pad_c: torch.Tensor, mv: torch.Tensor):
    """The decoder's predictors in one launch.  pad_y: (B, H+32, W+32) uint8
    luma planes padded by 16; pad_c: (2B, H/2+16, W/2+16) uint8, the Cb
    planes then the Cr planes, padded by 8; mv: (B, H/16, W/16, 2) integer
    luma MVs in (x, y) order.  Returns (pred_y (B, H, W), pred_c (2B, H/2,
    W/2)): mc_gather(pad_y, mv, 16) and mc_gather(pad_c, [chroma_mv(mv)] * 2,
    8)."""
    global launches
    _check_planes(pad_y, mv, 16, "mc_gather_yc")
    b, nby, nbx = mv.shape[:3]
    want_c = (2 * b, (nby + 2) * 8, (nbx + 2) * 8)
    if pad_c.shape != want_c or pad_c.dtype != torch.uint8 or pad_c.device != pad_y.device:
        raise ValueError(f"mc_gather_yc: pad_c must be {want_c} uint8 on {pad_y.device}, got "
                         f"{tuple(pad_c.shape)} {pad_c.dtype} on {pad_c.device}")
    if pad_y.device.type == "cpu":
        return mc_gather_yc_plain(pad_y, pad_c, mv)
    dev = pad_y.device
    src_y, src_c = pad_y.contiguous(), pad_c.contiguous()
    mvi = _mv_arg(mv, dev)
    pred_y = torch.empty((b, nby * 16, nbx * 16), dtype=torch.uint8, device=dev)
    pred_c = torch.empty((2 * b, nby * 8, nbx * 8), dtype=torch.uint8, device=dev)
    if b == 0:
        return pred_y, pred_c
    fn = _lib("icsp_mc_gather_yc")
    with _build.on_device(dev):
        err = fn(src_y.data_ptr(), src_c.data_ptr(), mvi.data_ptr(), b, nby, nbx,
                 pred_y.data_ptr(), pred_c.data_ptr(), _build.stream_ptr(dev))
    _build.check(err, "mc_gather_yc kernel")
    with _build.count_lock:
        launches += 1
    return pred_y, pred_c


def mc_select(pad: torch.Tensor, idx: torch.Tensor, offsets, block: int) -> torch.Tensor:
    """Predictor planes from per-block indices into an offset table: the
    contract of the JAX package's mc_select_* (offsets SPIRAL, CHROMA_OFFSETS,
    SPIRAL_UNION or CHROMA_U_OFFSETS; pad by p = block).  idx: (B, H/block,
    W/block) integer; the MV of a block is -offsets[idx]."""
    neg = device_table(-np.asarray(offsets, np.int32), pad.device)
    return mc_gather(pad, neg[idx.to(torch.int64)], block)
