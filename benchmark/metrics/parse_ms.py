"""parse_ms (ms, the benchmark's span): the host parser of codec.decode
(runtime/__init__.parse_body over runtime/vlcparse.c): stream bytes to
symbol arrays.
The median over the traced window's calls of the span around
icspcodec_torch.codec's global parse_body, which synchronises the devices at both
ends (benchlib/spans.py)."""
from benchlib import stats

SPANS = ("parse_body",)


def read(run):
    times = (run.spans or {}).get("parse_body")
    if not times:
        return None
    return stats.median(times) * 1e3
