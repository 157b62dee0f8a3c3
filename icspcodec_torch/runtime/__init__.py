"""The decoder's bitstream parser: host C (runtime/vlcparse.c), built by the
host compiler at first use into build/icspcodec_torch/ (ops/_build.py) and
bound with ctypes.

A copy of the JAX package's runtime.parse_body with narrow outputs: every
symbol of a stream the parser accepts fits int16 (the parser rejects VLC
exponents beyond the encoder's domain), so coefficients and MV differences
come back as int16 and flags as int8.  The values equal the JAX parser's.
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
