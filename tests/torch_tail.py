"""The JAX package as the arbiter of a stream's tail, for the port's tests.

The writer keeps a stream's last r bits (r in 0..7) in the LOW positions of
its final byte t, and the stream does not carry r.  The JAX package's parser
reads every byte MSB-first, so it reads a stream as written only once t's
bits are moved to its high end.  jax_readings tries each r with t < 2^r and
keeps the ones the JAX package confirms: its parser's symbols of the
realigned stream, written again by its host writer, give the stream's own
bytes.  For t != 0 that holds only when the parse ends exactly at bit
8*(nbytes-1) + r; for t == 0 every r is confirmed, with the same symbols.
Two confirmed readings with different symbols make an ambiguous stream;
the writer's reading is always among the confirmed ones.
"""
import numpy as np

import chip_smoke
from icspcodec_tpu import bitstream as jbs
from icspcodec_tpu import oracle as joracle
from icspcodec_tpu.runtime import parse_body as jparse_body

INTRA_KEYS = ("y_scan", "y_acflag", "mpm", "mode_bit", "cb_scan", "cb_acflag", "cr_scan",
              "cr_acflag")
INTER_KEYS = ("y_scan", "y_acflag", "mv_diff", "cb_scan", "cb_acflag", "cr_scan", "cr_acflag")


def jax_readings(data: bytes, nframes: int) -> dict:
    """{r: (the stream realigned for r, the JAX parser's symbols of it)} for
    every reading r of the final byte that the JAX writer confirms."""
    h, w, qdc, qac, period = joracle.parse_header(data[:14])
    eff = 1 if period == 0 else period
    idx = np.arange(nframes)
    ii, pi = idx[idx % eff == 0], idx[idx % eff != 0]
    out = {}
    for r in range(8):
        if data[-1] >> r:
            continue
        body = chip_smoke.realign_tail(data[14:], r)
        try:
            s = jparse_body(body, nframes, h, w, period)
        except ValueError:
            continue
        si = {k: s[k][ii] for k in INTRA_KEYS}
        sp = {k: s[k][pi] for k in INTER_KEYS} if len(pi) else None
        again = jbs.write_bitstream_grouped(si, ii, sp, pi if len(pi) else None, nframes, h, w,
                                            qdc, qac, period)
        if again == data:
            out[r] = (data[:14] + body, s)
    return out


def differ(a: dict, b: dict) -> bool:
    return any(not np.array_equal(a[k], b[k]) for k in a)


def jax_realigned(data: bytes, nframes: int) -> bytes:
    """The stream realigned for its confirmed reading (the bytes the JAX
    decoder reads as written); fails on an ambiguous stream."""
    readings = list(jax_readings(data, nframes).values())
    assert readings, "no reading of the final byte is confirmed"
    assert not any(differ(readings[0][1], s) for _, s in readings[1:]), "ambiguous tail"
    return readings[0][0]
