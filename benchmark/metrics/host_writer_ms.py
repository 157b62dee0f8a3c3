"""host_writer_ms (ms, the benchmark's span): the host writer of the
sharded route (bitstream.write_bitstream_grouped: numpy items and the C
packer), after the symbols are pulled.
The median over the traced window's calls of the span around
icspcodec_torch.codec's global write_bitstream_grouped, which synchronises the devices at both
ends (benchlib/spans.py)."""
from benchlib import stats

SPANS = ("write_bitstream_grouped",)


def read(run):
    times = (run.spans or {}).get("write_bitstream_grouped")
    if not times:
        return None
    return stats.median(times) * 1e3
