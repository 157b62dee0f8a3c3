"""The port's parser reads a stream's tail the way the writer writes it.

The writer keeps the stream's last r bits (r in 0..7) in the LOW positions
of its final byte, and appends a zero byte to a byte-aligned stream (the
reference's convention); the stream does not carry r.  The port's parser
(runtime/vlcparse.c) accepts a reading r when the stream, its final byte
moved to the high end, parses to exactly 8*(nbytes-1) + r bits; it refuses
a stream that no reading fits ("truncated bitstream") and one that two
readings fit with different symbols (AmbiguousTailError).

Streams are the port's encodes of 5 frames of 64x96 noise on the CPU
(chip_smoke.TAIL_CASES, the set chip_smoke.py checks on the card).  The
arbiters are the writer's own symbols and bit count, and the JAX package
given the realigned bytes (tests/torch_tail.py); the encoder's recon is
not one (an exact decode of noise may differ from it by a level, as the
reference's does).
"""
import numpy as np
import pytest

import chip_smoke
from icspcodec_tpu import codec as jcodec
from icspcodec_torch import codec as tcodec
from icspcodec_torch.config import CodecConfig
from icspcodec_torch.runtime import AmbiguousTailError, parse_body
from tests.torch_tail import differ, jax_readings, jax_realigned

F, H, W = (chip_smoke.TAIL_SHAPE[k] for k in ("nframes", "height", "width"))
SEED = 3


def _stream(kind, seed, precision, qp_dc, qp_ac, intra_period):
    cfg = CodecConfig(width=W, height=H, qp_dc=qp_dc, qp_ac=qp_ac, intra_period=intra_period,
                      precision=precision)
    return chip_smoke.tail_stream(*chip_smoke.tail_content(kind, seed), cfg, "cpu")


@pytest.mark.parametrize("case", chip_smoke.TAIL_CASES,
                         ids=lambda c: "-".join(str(v) for v in c.values()))
def test_seeded_streams_parse_to_the_writers_symbols(case):
    """The stream parses to the symbols its writer wrote, or is refused as
    ambiguous, and then the JAX package confirms the same readings of the
    final byte, with different symbols."""
    bits, want, nbits, _ = _stream(seed=SEED, **case)
    verdict = chip_smoke.tail_verdict(bits, want, nbits, F, case["intra_period"])
    assert verdict in ("right", "ambiguous"), (bits[-1], nbits % 8)
    if verdict == "ambiguous":
        with pytest.raises(AmbiguousTailError) as e:
            parse_body(bits[14:], F, H, W, case["intra_period"])
        readings = jax_readings(bits, F)
        assert sorted(readings) == sorted(e.value.readings)
        syms = [s for _, s in readings.values()]
        assert any(differ(syms[0], s) for s in syms[1:])


# ROADMAP's repro: uniform noise at period 3 that the parser before the
# tail reading refused as truncated
REPRO = [(1, "exact", 8, 16), (2, "fast", 8, 16), (2, "fast", 16, 16)]


@pytest.mark.parametrize("seed,precision,qp_dc,qp_ac", REPRO)
def test_repro_streams_decode_to_the_jax_decode_of_the_realigned_bytes(seed, precision,
                                                                      qp_dc, qp_ac):
    bits, want, nbits, _ = _stream("noise", seed, precision, qp_dc, qp_ac, 3)
    assert bits[-1] != 0 and nbits % 8
    assert chip_smoke.tail_verdict(bits, want, nbits, F, 3) == "right"
    dt = tcodec.decode(bits, F, precision=precision, device="cpu")
    dj = jcodec.decode(jax_realigned(bits, F), F, precision=precision)
    for k in ("y", "cb", "cr"):
        assert np.array_equal(dt[k], dj[k]), k


def test_ambiguous_tail_is_refused():
    """Uniform noise, seed 1, exact, QP 8/16, all-intra: the final byte
    0b00000100 read with 4 bits (the writer's) or with 6 ends the parse at
    the stream's end, with different symbols; no check of range or flags
    tells them apart, so the parser and the decoder refuse it."""
    bits, want, nbits, _ = _stream("noise", 1, "exact", 8, 16, 0)
    assert bits[-1] == 0b100 and nbits % 8 == 4
    with pytest.raises(AmbiguousTailError, match="ambiguous stream tail") as e:
        parse_body(bits[14:], F, H, W, 0)
    assert e.value.readings == (4, 6)
    with pytest.raises(AmbiguousTailError):
        tcodec.decode(bits, F, device="cpu")
    readings = jax_readings(bits, F)
    assert sorted(readings) == [4, 6]
    assert differ(readings[4][1], readings[6][1]) and not differ(want, readings[4][1])


@pytest.mark.parametrize("change", ["drop the final byte", "append 0xff", "append 0x5a",
                                    "one frame fewer", "one frame more"])
def test_a_stream_that_no_reading_fits_is_truncated(change):
    """A stream cut short, with a byte appended, or read for another frame
    count.  (An appended zero byte can make another valid stream, the
    writer's form of a byte-aligned one, as it does for this stream: no
    parser can tell that from the stream alone.)"""
    bits, want, nbits, _ = _stream("noise", 1, "exact", 8, 16, 3)
    assert chip_smoke.tail_verdict(bits, want, nbits, F, 3) == "right"
    body, n = bits[14:], F
    if change == "drop the final byte":
        body = body[:-1]
    elif change.startswith("append"):
        body = body + bytes([int(change[-4:], 16)])
    else:
        n = F - 1 if change == "one frame fewer" else F + 1
    with pytest.raises(ValueError, match="truncated bitstream"):
        parse_body(body, n, H, W, 3)
