"""The motion search: CUDA kernels D (sad_mc_best) and G (sad_union_extra)
of the encoder, and the unfused search entry points sad_best and sad_union,
all in csrc/sad_mc.cu, with their plain versions.

Counterparts of icspcodec_tpu/ops/pallas_me.py::sad_mc_best,
::sad_union_extra, ::sad_best and ::sad_union.  On a CPU tensor each
wrapper runs its plain version (ops/me.sad_dense and the selections); on a
CUDA tensor it launches its kernel or raises.  All are integer:
bit-identical.  Each wrapper has its own launch counter.  sad_best and
sad_union lie on no codec path (the encoder takes D and G): they are the
public search entry points of the JAX package's kernel module, which its
tools and tests call.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..constants import SPIRAL, SPIRAL_STATE_IDX, SPIRAL_UNION
from ..tables import N_CANON, NEG_SPIRAL
from .mc_fused import mc_gather_plain
from .me import _select_from_seq, device_table, sad_dense
from . import _build

launches = 0        # kernel D launches, for showing that a run went through it
launches_extra = 0  # kernel G launches
launches_best = 0   # sad_best launches
launches_union = 0  # sad_union launches (G's entry point at all 129 union offsets)


def _lib_d():
    fn = _build.load("sad_mc").icsp_sad_mc_best
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, i, i, i, p, p, i, p, p, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def _lib_g():
    fn = _build.load("sad_mc").icsp_sad_offsets
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, i, i, i, p, i, p, p]
        fn.restype = ctypes.c_int
    return fn


def _lib_best():
    fn = _build.load("sad_mc").icsp_sad_best
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, i, i, i, p, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def _check(cur: torch.Tensor, pad: torch.Tensor, what: str):
    if cur.dim() != 3 or pad.dim() != 3:
        raise ValueError(f"{what}: cur must be (G, H, W) and pad (G, H+32, W+32), got "
                         f"{tuple(cur.shape)} and {tuple(pad.shape)}")
    g, h, w = cur.shape
    if h % 16 or w % 16 or pad.shape != (g, h + 32, w + 32):
        raise ValueError(f"{what}: cur {tuple(cur.shape)} must be whole macroblocks and pad "
                         f"{tuple(pad.shape)} cur padded by 16")
    if cur.dtype != torch.uint8 or pad.dtype != torch.uint8:
        raise TypeError(f"{what} takes uint8 planes, got {cur.dtype} and {pad.dtype}")
    if cur.device != pad.device:
        raise ValueError(f"{what}: cur on {cur.device}, pad on {pad.device}")
    if cur.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda tensors, got {cur.device}")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor whose data starts on 16 bytes, as the kernels'
    16-byte loads and stores need: the tensor itself when it is one."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def sad_mc_best_plain(cur: torch.Tensor, pad: torch.Tensor):
    """The plain version of D: the canonical SAD rows by sad_dense, the
    first strict minimum of the 64-step walk, the zero count and the
    predictor gathered at the winning offset.  Runs on any device."""
    dev = cur.device
    sads_c = sad_dense(cur, pad, SPIRAL_UNION[:N_CANON])
    seq = sads_c[:, device_table(SPIRAL_STATE_IDX[0].astype(np.int64), dev)]
    best = torch.argmin(seq, dim=1)                                  # the first minimum
    zc = (seq == 0).sum(dim=1, dtype=torch.int32)
    pred = mc_gather_plain(pad, device_table(NEG_SPIRAL, dev)[best], 16)
    return best.to(torch.int32), zc, sads_c, pred


def sad_mc_best(cur: torch.Tensor, pad: torch.Tensor):
    """cur: (G, H, W) uint8 frames; pad: (G, H+32, W+32) uint8, the previous
    reconstructions padded by 16 (ops/pad.pad_image).  Returns (best, zc,
    sads_c, pred): best (G, mbh, mbw) int32, the spiral rank of the first
    strict minimum (no second-zero override, so exact only where no MB has
    zc >= 2); zc (G, mbh, mbw) int32, the zero-SAD steps of the canonical
    walk; sads_c (G, N_CANON, mbh, mbw) int32, the SADs at the canonical
    union rows; pred (G, H, W) uint8, the predictor at best."""
    global launches
    _check(cur, pad, "sad_mc_best")
    if cur.device.type == "cpu":
        return sad_mc_best_plain(cur, pad)
    g, h, w = cur.shape
    dev = cur.device
    mb = (g, h // 16, w // 16)
    best = torch.empty(mb, dtype=torch.int32, device=dev)
    zc = torch.empty_like(best)
    sads_c = torch.empty((g, N_CANON) + mb[1:], dtype=torch.int32, device=dev)
    pred = torch.empty((g, h, w), dtype=torch.uint8, device=dev)
    if g == 0:
        return best, zc, sads_c, pred
    offs = device_table(SPIRAL.astype(np.int32), dev)
    rows = device_table(SPIRAL_STATE_IDX[0].astype(np.int32), dev)
    src, padc = _aligned(cur), _aligned(pad)
    fn = _lib_d()
    with torch.cuda.device(dev):
        err = fn(src.data_ptr(), padc.data_ptr(), g, h, w, offs.data_ptr(), rows.data_ptr(),
                 N_CANON, best.data_ptr(), zc.data_ptr(), sads_c.data_ptr(), pred.data_ptr(),
                 _build.stream_ptr(dev))
    _build.check(err, "sad_mc_best kernel")
    with _build.count_lock:
        launches += 1
    return best, zc, sads_c, pred


def sad_union_extra_plain(cur: torch.Tensor, pad: torch.Tensor) -> torch.Tensor:
    """The plain version of G: sad_dense at the non-canonical union
    offsets.  Runs on any device."""
    return sad_dense(cur, pad, SPIRAL_UNION[N_CANON:])


def _sad_offsets(cur: torch.Tensor, pad: torch.Tensor, offsets: np.ndarray, what: str):
    """Launch G's entry point at `offsets` ((n, 2) within +-16, n <= 160) on
    checked CUDA tensors: (G, n, mbh, mbw) int32.  Returns (out, launched)."""
    g, h, w = cur.shape
    dev = cur.device
    n = len(offsets)
    out = torch.empty((g, n, h // 16, w // 16), dtype=torch.int32, device=dev)
    if g == 0:
        return out, False
    offs = device_table(offsets.astype(np.int32), dev)
    src, padc = _aligned(cur), _aligned(pad)
    fn = _lib_g()
    with torch.cuda.device(dev):
        err = fn(src.data_ptr(), padc.data_ptr(), g, h, w, offs.data_ptr(), n, out.data_ptr(),
                 _build.stream_ptr(dev))
    _build.check(err, f"{what} kernel")
    return out, True


def sad_union_extra(cur: torch.Tensor, pad: torch.Tensor) -> torch.Tensor:
    """The SADs at the 66 non-canonical union offsets: (G, 66, mbh, mbw)
    int32 in union-row order (rows N_CANON.. of the union), for the same
    inputs as sad_mc_best.  Appended to its sads_c they give the whole
    129-row union tensor that ops/me.stateful_select takes."""
    global launches_extra
    _check(cur, pad, "sad_union_extra")
    if cur.device.type == "cpu":
        return sad_union_extra_plain(cur, pad)
    out, launched = _sad_offsets(cur, pad, SPIRAL_UNION[N_CANON:], "sad_union_extra")
    with _build.count_lock:
        launches_extra += launched
    return out


def sad_best_plain(cur: torch.Tensor, pad: torch.Tensor):
    """The plain version of sad_best: the SADs of the 64 spiral steps by
    sad_dense, the reference's selection (ops/me._select_from_seq) and the
    count of zero-SAD steps.  Runs on any device."""
    seq = sad_dense(cur, pad, SPIRAL)
    best, _ = _select_from_seq(seq)
    return best, (seq == 0).sum(dim=1, dtype=torch.int32)


def sad_best(cur: torch.Tensor, pad: torch.Tensor):
    """The unfused search with the reference's whole selection rule, for
    the same inputs as sad_mc_best.  Returns (best, zc), (G, mbh, mbw)
    int32: best is the spiral step selected (the MV is -SPIRAL[best]): the
    first strict minimum, overridden by the second zero-SAD step when an MB
    has two (steps 0 and 1 are both (0, 0), so a static MB gives 1); zc is
    the number of zero-SAD steps.  best equals D's wherever zc < 2.  It
    models no walk state across MBs, so its MVs are the stateful search's
    (ops/me.spiral_search) only on frames where no MB has zc >= 2."""
    global launches_best
    _check(cur, pad, "sad_best")
    if cur.device.type == "cpu":
        return sad_best_plain(cur, pad)
    g, h, w = cur.shape
    dev = cur.device
    best = torch.empty((g, h // 16, w // 16), dtype=torch.int32, device=dev)
    zc = torch.empty_like(best)
    if g == 0:
        return best, zc
    offs = device_table(SPIRAL.astype(np.int32), dev)
    src, padc = _aligned(cur), _aligned(pad)
    fn = _lib_best()
    with torch.cuda.device(dev):
        err = fn(src.data_ptr(), padc.data_ptr(), g, h, w, offs.data_ptr(), best.data_ptr(),
                 zc.data_ptr(), _build.stream_ptr(dev))
    _build.check(err, "sad_best kernel")
    with _build.count_lock:
        launches_best += 1
    return best, zc


def sad_union_plain(cur: torch.Tensor, pad: torch.Tensor) -> torch.Tensor:
    """The plain version of sad_union: sad_dense at every union offset.
    Runs on any device."""
    return sad_dense(cur, pad, SPIRAL_UNION)


def sad_union(cur: torch.Tensor, pad: torch.Tensor) -> torch.Tensor:
    """The SADs at all 129 stateful-union offsets: (G, 129, mbh, mbw) int32
    in SPIRAL_UNION row order, for the same inputs as sad_mc_best; the input
    of ops/me.stateful_select.  Equal to D's sads_c followed by G's rows."""
    global launches_union
    _check(cur, pad, "sad_union")
    if cur.device.type == "cpu":
        return sad_union_plain(cur, pad)
    out, launched = _sad_offsets(cur, pad, SPIRAL_UNION, "sad_union")
    with _build.count_lock:
        launches_union += launched
    return out
