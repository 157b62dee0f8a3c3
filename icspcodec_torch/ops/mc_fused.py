"""Motion compensation: CUDA kernel E (csrc/mc_gather.cu) and its plain
version.

Counterpart of icspcodec_tpu/ops/pallas_me.py::_mc_select.  mc_gather builds
the predictor planes from per-block MVs; mc_select is the exact counterpart
of the JAX mc_select_* wrappers (per-block indices into an offset table,
MV = -offset).  On a CPU tensor the wrapper runs the plain version
(ops/me.gather_pred, blocks laid out as planes); on a CUDA tensor it
launches the kernel or raises.  Both are integer copies: bit-identical.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..engine.intra import from_blocks
from .me import device_table, gather_pred
from . import _build

launches = 0  # kernel launches, for showing that a run went through it


def _lib():
    fn = _build.load("mc_gather").icsp_mc_gather
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, i, i, i, i, p, p]
        fn.restype = ctypes.c_int
    return fn


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
    ops/me.window_start says."""
    global launches
    if pad.dim() != 3 or mv.dim() != 4 or mv.shape[-1] != 2:
        raise ValueError(f"pad must be (B, PH, PW) and mv (B, nby, nbx, 2), got "
                         f"{tuple(pad.shape)} and {tuple(mv.shape)}")
    b, nby, nbx = mv.shape[:3]
    if pad.shape != (b, (nby + 2) * block, (nbx + 2) * block):
        raise ValueError(f"pad {tuple(pad.shape)} does not match mv {tuple(mv.shape)} "
                         f"padded by {block}")
    if pad.dtype != torch.uint8:
        raise TypeError(f"mc_gather takes uint8 planes, got {pad.dtype}")
    if pad.device.type == "cpu":
        return mc_gather_plain(pad, mv, block)
    if pad.device.type != "cuda":
        raise ValueError(f"mc_gather runs on cpu or cuda tensors, got {pad.device}")
    src = pad.contiguous()
    mvi = mv.to(device=pad.device, dtype=torch.int32).contiguous()
    pred = torch.empty((b, nby * block, nbx * block), dtype=torch.uint8, device=pad.device)
    if b == 0:
        return pred
    fn = _lib()
    with torch.cuda.device(pad.device):
        err = fn(src.data_ptr(), mvi.data_ptr(), b, nby, nbx, int(block), pred.data_ptr(),
                 _build.stream_ptr(pad.device))
    _build.check(err, "mc_gather kernel")
    launches += 1
    return pred


def mc_select(pad: torch.Tensor, idx: torch.Tensor, offsets, block: int) -> torch.Tensor:
    """Predictor planes from per-block indices into an offset table: the
    contract of the JAX package's mc_select_* (offsets SPIRAL, CHROMA_OFFSETS,
    SPIRAL_UNION or CHROMA_U_OFFSETS; pad by p = block).  idx: (B, H/block,
    W/block) integer; the MV of a block is -offsets[idx]."""
    neg = device_table(-np.asarray(offsets, np.int32), pad.device)
    return mc_gather(pad, neg[idx.to(torch.int64)], block)
