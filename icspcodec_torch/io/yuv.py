"""Planar YUV420 file I/O (reference: YCbCrLoad, enc src:247-283).

A copy of the JAX package's io/yuv.py, so that the port imports nothing of
that package.  Frames load into whole (F, H, W) uint8 arrays; blocking is a
reshape at compute time.
"""
from __future__ import annotations

import numpy as np


def load_yuv420(path_or_bytes, width: int, height: int, nframes: int | None = None):
    """Return (Y, Cb, Cr) uint8 arrays of shape (F,H,W) / (F,H/2,W/2).

    Raises ValueError on macroblock-unaligned dimensions or a file too
    short for the requested frame count (the reference error-exits via
    print_error_message, enc src:64-81; silently truncating would encode
    garbage)."""
    if width <= 0 or height <= 0 or width % 16 or height % 16:
        raise ValueError(
            f"frame dimensions must be positive multiples of 16 "
            f"(macroblock size); got {width}x{height}"
        )
    if isinstance(path_or_bytes, (bytes, bytearray)):
        raw = np.frombuffer(path_or_bytes, dtype=np.uint8)
    else:
        raw = np.fromfile(path_or_bytes, dtype=np.uint8)
    cw, ch = width // 2, height // 2
    fsz = width * height + 2 * cw * ch
    total = raw.size // fsz
    if nframes is None:
        nframes = total
    if nframes <= 0:
        raise ValueError(f"need at least one frame, got nframes={nframes}")
    if total < nframes:
        raise ValueError(
            f"input holds only {total} complete {width}x{height} YUV420 "
            f"frames ({raw.size} bytes); {nframes} requested"
        )
    raw = raw[: nframes * fsz].reshape(nframes, fsz)
    y = raw[:, : width * height].reshape(nframes, height, width)
    cb = raw[:, width * height: width * height + cw * ch].reshape(nframes, ch, cw)
    cr = raw[:, width * height + cw * ch:].reshape(nframes, ch, cw)
    return y.copy(), cb.copy(), cr.copy()


def save_yuv420(path, y: np.ndarray, cb: np.ndarray, cr: np.ndarray):
    nframes = y.shape[0]
    with open(path, "wb") as f:
        for n in range(nframes):
            f.write(y[n].tobytes())
            f.write(cb[n].tobytes())
            f.write(cr[n].tobytes())


def frames_to_planes(y, cb, cr):
    """(F,...) arrays -> list of per-frame (y, cb, cr) tuples."""
    return [(y[i], cb[i], cr[i]) for i in range(y.shape[0])]
