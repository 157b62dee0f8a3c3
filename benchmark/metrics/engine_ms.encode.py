"""engine_ms.encode (ms, the benchmark's span): the encode engines
(codec.encode_symbols: engine/intra, engine/inter and their kernels),
from uploaded planes to symbols and recon on the device.
The median over the traced window's calls of the span around
icspcodec_torch.codec's global encode_symbols, which synchronises the devices at both
ends (benchlib/spans.py)."""
from benchlib import stats

SPANS = ("encode_symbols",)


def read(run):
    times = (run.spans or {}).get("encode_symbols")
    if not times:
        return None
    return stats.median(times) * 1e3
