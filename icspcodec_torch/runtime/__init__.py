"""The decoder's bitstream parser and the host writer's bit packer: host C
(runtime/vlcparse.c), built by the host compiler at first use into
build/icspcodec_torch/ (ops/_build.py) and bound with ctypes.

The JAX package's runtime.parse_body with three changes:

- narrow outputs: every symbol of a stream the parser accepts fits int16
  (the parser rejects VLC exponents beyond the encoder's domain), so
  coefficients and MV differences come back as int16 and flags as int8;
- the stream's tail is read the way the writer writes it.  The writer
  (pack_items, bitstream_device.assemble_frames: the reference's
  convention) keeps the final partial byte's r bits in its LOW positions
  and appends a zero byte to a byte-aligned stream; the JAX parser reads
  every byte MSB-first, so it can misread the last bits of any stream
  whose final byte is not zero.  Here each r with t < 2^r (t the final byte) is
  a reading, accepted when the stream parses to exactly 8*(nbytes-1) + r
  bits with t moved to its high end;
- the end is checked: no accepted reading raises "truncated bitstream"
  (cut short, bytes appended, or a frame count other than the stream's),
  and readings that give different symbols raise "ambiguous stream tail":
  the reference's format cannot tell them apart, so no guess is returned.

On every other stream the values equal the JAX parser's reading of the
stream with its final byte moved to its high end.  pack_items_native is
the JAX package's packer (runtime/__init__.py there).
"""
from __future__ import annotations

import ctypes

import numpy as np

from ..ops import _build

_ERRORS = {
    -1: "truncated bitstream: no reading of its final byte ends the parse of the "
        "requested frames at the stream's end (the stream is cut short, has bytes "
        "appended, or holds another number of frames); check the file and the "
        "frame count",
    -2: "corrupt bitstream: a VLC exponent beyond 14 (|v| >= 2^15), outside "
        "the encoder's domain",
    -4: "out of memory while reading the stream's last macroblock",
}


class AmbiguousTailError(ValueError):
    """Two or more readings of the stream's final byte each end the parse at
    the stream's end, with different symbols.  readings: their bit counts r
    in the final byte."""

    def __init__(self, message: str, readings: tuple[int, ...]):
        super().__init__(message)
        self.readings = readings


def _parse_frames():
    fn = _build.load("vlcparse").parse_frames
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 9 + [
                       ctypes.POINTER(ctypes.c_int)]
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
    and mv_diff int16, the flags int8.  The final byte is read by the
    writer's tail convention (module docstring).  Raises ValueError when no
    reading of it ends the parse at the stream's end ("truncated
    bitstream"), when two readings give different symbols ("ambiguous
    stream tail", AmbiguousTailError), and on a code outside the encoder's
    VLC domain."""
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
    readings = ctypes.c_int(0)
    used = _parse_frames()(
        body, len(body), nframes, mbh, mbw, period,
        *(out[k].ctypes.data_as(ctypes.c_void_p) for k in (
            "y_scan", "y_acflag", "mpm", "mode_bit", "cb_scan", "cb_acflag",
            "cr_scan", "cr_acflag", "mv_diff")),
        ctypes.byref(readings),
    )
    if used == -3:
        rs = tuple(r for r in range(8) if readings.value >> r & 1)
        raise AmbiguousTailError(
            f"ambiguous stream tail: the final byte {body[-1]:#010b} read with {list(rs)} "
            "bits each ends the parse at the stream's end, with different symbols in the "
            "last macroblock; the reference's tail convention (the last bits kept low in "
            "the final byte, no bit count) cannot tell them apart, so no reading is "
            "returned.  Re-encode the sequence (another QP or frame count changes the "
            "tail) if it must be decoded", rs)
    if used < 0:
        raise ValueError(_ERRORS[used])
    return out
