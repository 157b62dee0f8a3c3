"""decode: one codec.decode call takes the stream's bytes and gives the
decoded planes.

The stream is the program's encode of the clip, made once in set-up.  The
reference works it out again from the clip, and the check compares it
byte for byte, then each decoded plane (the parser and the decode
engines).
"""
from benchlib.cell import diff_bytes, diff_pixels, psnr_y

DECODES = True      # the reference decodes its own stream


def request(program, clip):
    """The payload of every call: the program's stream of the clip."""
    return program.encode(clip)[0]


def call(program, stream):
    return program.decode(stream)


def compare(samples, stream, ref) -> dict:
    """samples: (call index, output) of the calls compared."""
    return {"input_stream_bytes_differing": diff_bytes(stream, ref["stream"]),
            "decoded_px_differing": max(diff_pixels(o, ref["decoded"]) for _, o in samples)}


def describe(out, clip) -> dict:
    return {"psnr_y_db": psnr_y(out["y"], clip[0])}
