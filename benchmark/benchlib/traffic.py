"""The one general generator of the benchmark's traffic.

A traffic mix is a data file (benchmark/traffic/<name>.json) whose one key,
"op", names the call a client makes: a module benchmark/ops/<op>.py
(manifest.op) that gives the payload made in set-up (request), the call
(call), the comparison with the plain reference (compare, with DECODES:
whether the reference decodes its stream) and the earlier lines' numbers
(describe).  A new kind of call is a new op file; no file here changes.

The generator runs one closed-loop client: each call after the previous
one returned, on the payload that the configuration's clip gives.
"""
from __future__ import annotations

import time


def op_name(mix: dict) -> str:
    """The op that a mix's parameters name; any other key is refused."""
    if set(mix) != {"op"}:
        raise ValueError(f"a traffic mix has the one key 'op', not {sorted(mix)}")
    return mix["op"]


def closed_loop(call, seconds: float, keep):
    """Calls call() back to back until `seconds` have passed since the
    first began.  keep(i, output) sees each call's output.  Returns (the
    (start, end) host times of the calls that returned, the number that
    raised, the window's (start, end of its last call))."""
    calls, failed = [], 0
    t0 = last = time.perf_counter()
    while True:
        s = time.perf_counter()
        if s - t0 >= seconds:
            break
        try:
            out = call()
        except Exception:   # a call that raises is counted and the loop goes on
            import traceback

            failed += 1
            if failed == 1:
                traceback.print_exc()
            out = None
        e = last = time.perf_counter()
        if out is not None:
            calls.append((s, e))
            keep(len(calls) - 1, out)
    return calls, failed, (t0, last)
