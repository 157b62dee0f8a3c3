"""encode: one codec.encode call takes the clip's host planes and gives the
stream's bytes and the recon planes.

Both are compared with the plain reference's: the bytes (the header, the
entropy coder and through them every symbol of the engines) and the recon
planes (the engines' reconstruction loop).
"""
from benchlib.cell import diff_bytes, diff_pixels, psnr_y

DECODES = False     # the reference need not decode its stream


def request(program, clip):
    """The payload of every call: the clip itself."""
    return clip


def call(program, clip):
    return program.encode(clip)


def compare(samples, clip, ref) -> dict:
    """samples: (call index, output) of the calls compared."""
    return {"stream_bytes_differing": max(diff_bytes(o[0], ref["stream"]) for _, o in samples),
            "recon_px_differing": max(diff_pixels(o[1], ref["recon"]) for _, o in samples)}


def describe(out, clip) -> dict:
    return {"stream_bytes": len(out[0]), "psnr_y_db": psnr_y(out[1]["y"], clip[0])}
