"""entropy_ms (ms, the benchmark's span): the device entropy of codec.encode's
unsharded route (codec.write_stream: bitstream_device items and packing,
the pull of the packed frames, the host splice and header).
The median over the traced window's calls of the span around
icspcodec_torch.codec's global write_stream, which synchronises the devices at both
ends (benchlib/spans.py)."""
from benchlib import stats

SPANS = ("write_stream",)


def read(run):
    times = (run.spans or {}).get("write_stream")
    if not times:
        return None
    return stats.median(times) * 1e3
