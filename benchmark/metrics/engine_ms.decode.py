"""engine_ms.decode (ms, the benchmark's span): the intra decode engine
(engine/intra.decode_intra_frames: kernel C and the chroma chain with B'),
from uploaded symbols to planes on the device.
The median over the traced window's calls of the span around
icspcodec_torch.codec's global decode_intra_frames, which synchronises the devices at both
ends (benchlib/spans.py)."""
from benchlib import stats

SPANS = ("decode_intra_frames",)


def read(run):
    times = (run.spans or {}).get("decode_intra_frames")
    if not times:
        return None
    return stats.median(times) * 1e3
