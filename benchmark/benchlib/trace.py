"""The traced stretch of a run: torch.profiler over a few calls, read back
from its Chrome trace.

The profiler records the device's kernels, copies and memsets (CUPTI) and
the host's annotations: the stretch itself ("bench.window") and the spans
that spans.py opens around the program's layers ("bench.<layer>").  Both
sit on one clock in the exported trace, in microseconds.  The profiler on
the card has been seen to drop records, or all of them: a stretch that
recorded no device event is traced again, up to `tries` times.
"""
from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field

from . import stats

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench.window"


@dataclass
class Trace:
    window: tuple[float, float]                       # seconds, trace clock
    devices: dict[int, list] = field(default_factory=dict)   # index -> [(s, e, name)]
    spans: dict[str, list] = field(default_factory=dict)     # layer -> [(s, e)]

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy(self, device: int, within=None) -> float:
        """Seconds in which some operation ran on the device, inside the
        window, or inside the union of the intervals `within`."""
        ev = stats.clip_to([(s, e) for s, e, _ in self.devices.get(device, [])], *self.window)
        if within is None:
            return stats.covered(ev)
        return sum(stats.covered(stats.clip_to(ev, s, e)) for s, e in stats.union(within))

    def busy_mean(self, devices) -> float:
        return sum(self.busy(d) for d in devices) / len(devices)

    def top_ops(self, n: int = 10) -> list:
        """The device operations that took most time, summed by name."""
        lo, hi = self.window
        tot: dict[str, float] = {}
        for evs in self.devices.values():
            for s, e, name in evs:
                if min(e, hi) > max(s, lo):
                    tot[name] = tot.get(name, 0.0) + min(e, hi) - max(s, lo)
        return sorted(([k, v] for k, v in tot.items()), key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, device: int, n: int = 10) -> list:
        """The longest stretches of the window in which the device ran
        nothing, each named by the layer span that covers most of it (what
        the host was doing), else "host outside the spanned layers"."""
        ev = [(s, e) for s, e, _ in self.devices.get(device, [])]
        out = []
        for s, e in stats.gaps(ev, *self.window):
            name, most = "host outside the spanned layers", 0.0
            for layer, ivs in self.spans.items():
                inside = stats.covered(stats.clip_to(ivs, s, e))
                if inside > most:
                    name, most = f"host in {layer}", inside
            out.append([name, e - s])
        return sorted(out, key=lambda kv: -kv[1])[:n]


def read_chrome_trace(path: str) -> Trace | None:
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    window, devices, spans = None, {}, {}
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        s = float(ev["ts"]) / 1e6
        e = s + float(ev["dur"]) / 1e6
        cat, name = ev.get("cat", ""), str(ev.get("name", ""))
        if cat in DEVICE_CATS:
            if name.startswith("Activity Buffer"):
                continue
            dev = int(ev.get("args", {}).get("device", 0))
            devices.setdefault(dev, []).append((s, e, name))
        elif cat == "user_annotation" and name.startswith("bench."):
            if name == WINDOW:
                window = (s, e)
            else:
                spans.setdefault(name[len("bench."):], []).append((s, e))
    if window is None or not devices:
        return None
    return Trace(window=window, devices=devices, spans=spans)


def profile(stretch, sync, tries: int = 3) -> Trace:
    """Run stretch() under torch.profiler inside a "bench.window"
    annotation that ends with sync(), and read the trace back."""
    import torch
    from torch.profiler import ProfilerActivity, record_function

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        for _ in range(tries):
            with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                                    ProfilerActivity.CUDA]) as prof:
                with record_function(WINDOW):
                    stretch()
                    sync()
            prof.export_chrome_trace(path)
            got = read_chrome_trace(path)
            if got is not None:
                return got
    raise RuntimeError(f"torch.profiler recorded no device event in {tries} traced stretches")
