"""encode_p95_ms (ms, host clock): the 95th percentile of the latency of all
the window's codec.encode calls, each timed on the host from its start to
its return (planes and bytes on the host)."""
from benchlib import stats


def read(run):
    if run.op != "encode" or not run.calls:
        return None
    return stats.percentile(run.latencies, 95.0) * 1e3
