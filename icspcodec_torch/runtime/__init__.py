"""The decoder's bitstream parser and the host writer's bit packer: host C
(runtime/vlcparse.c), built by the host compiler at first use into
build/icspcodec_torch/ (ops/_build.py) and bound with ctypes.

A copy of the JAX package's runtime.parse_body with narrow outputs: every
symbol of a stream the parser accepts fits int16 (the parser rejects VLC
exponents beyond the encoder's domain), so coefficients and MV differences
come back as int16 and flags as int8.  The values equal the JAX parser's.
pack_items_native is the JAX package's packer (runtime/__init__.py there).
"""
from __future__ import annotations

import ctypes

import numpy as np

from ..ops import _build

_ERRORS = {
    -1: "truncated bitstream",
    -2: "corrupt bitstream: a VLC exponent beyond 14 (|v| >= 2^15), outside "
        "the encoder's domain",
}


def _parse_frames():
    fn = _build.load("vlcparse").parse_frames
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 9
        fn.restype = ctypes.c_long
    return fn


def _pack_items():
    fn = _build.load("vlcparse").pack_items
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p]
        fn.restype = ctypes.c_long
    return fn


def pack_items_native(codes: np.ndarray, lengths: np.ndarray) -> bytes:
    """MSB-first pack of (code, length) items, code bits right-aligned, with
    the reference's tail rule: the final partial byte keeps its bits LOW,
    and a zero byte follows a stream that ends byte-aligned.  Lengths must
    lie in [0, 56]."""
    c = np.ascontiguousarray(codes, np.uint64).ravel()
    n = np.ascontiguousarray(lengths, np.int64).ravel()
    if c.size != n.size:
        raise ValueError(f"{c.size} codes but {n.size} lengths")
    if n.size and (int(n.min()) < 0 or int(n.max()) > 56):
        raise ValueError("item lengths must lie in [0, 56] bits")
    out = np.zeros(int(n.sum()) // 8 + 1, dtype=np.uint8)
    used = _pack_items()(c.ctypes.data_as(ctypes.c_void_p), n.ctypes.data_as(ctypes.c_void_p),
                         c.size, out.ctypes.data_as(ctypes.c_void_p))
    return out[:used].tobytes()


def parse_body(body: bytes, nframes: int, height: int, width: int, period: int):
    """Parse the bitstream body into fixed-shape symbol arrays: y/cb/cr_scan
    and mv_diff int16, the flags int8.  Raises ValueError on a truncated
    stream and on a code outside the encoder's VLC domain."""
    mbh, mbw = height // 16, width // 16
    gh, gw = 2 * mbh, 2 * mbw
    out = dict(
        y_scan=np.zeros((nframes, gh, gw, 64), np.int16),
        y_acflag=np.zeros((nframes, gh, gw), np.int8),
        mpm=np.zeros((nframes, gh, gw), np.int8),
        mode_bit=np.zeros((nframes, gh, gw), np.int8),
        cb_scan=np.zeros((nframes, mbh, mbw, 64), np.int16),
        cb_acflag=np.zeros((nframes, mbh, mbw), np.int8),
        cr_scan=np.zeros((nframes, mbh, mbw, 64), np.int16),
        cr_acflag=np.zeros((nframes, mbh, mbw), np.int8),
        mv_diff=np.zeros((nframes, mbh, mbw, 2), np.int16),
    )
    used = _parse_frames()(
        body, len(body), nframes, mbh, mbw, period,
        *(out[k].ctypes.data_as(ctypes.c_void_p) for k in (
            "y_scan", "y_acflag", "mpm", "mode_bit", "cb_scan", "cb_acflag",
            "cr_scan", "cr_acflag", "mv_diff")),
    )
    if used < 0:
        raise ValueError(_ERRORS[used])
    return out
