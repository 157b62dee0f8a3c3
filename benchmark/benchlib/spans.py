"""The benchmark's own spans around the program's layers.

The program's entry points call their layers through the module globals of
icspcodec_torch.codec (encode_symbols, write_stream,
write_bitstream_grouped, parse_body, decode_intra_frames, ...).  In a
traced run each named global is replaced by a wrapper that opens a
"bench.<name>" annotation for the profiler.  Given a `sync`, the wrapper
also synchronises the devices of the run at both ends, so that the span
holds its layer's device work and nothing else, and records the span's
host time; without one it adds no synchronisation, and the program runs
as it does untraced.  No program file changes; the timed entry is still
codec.encode / codec.decode.
"""
from __future__ import annotations

import contextlib
import functools
import time


class Spans:
    def __init__(self, module, names, sync=None):
        self.module, self.names, self.sync = module, sorted(set(names)), sync
        self.times: dict[str, list[float]] = {n: [] for n in self.names}
        self._orig: dict = {}

    def _wrap(self, name, fn):
        from torch.profiler import record_function

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with record_function(f"bench.{name}"):
                if self.sync is None:
                    return fn(*args, **kwargs)
                self.sync()
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                self.sync()
                self.times[name].append(time.perf_counter() - t0)
            return out

        return wrapper

    @contextlib.contextmanager
    def installed(self):
        """The wrappers in place of the module's globals, restored on exit."""
        for n in self.names:
            if not hasattr(self.module, n):
                raise AttributeError(f"{self.module.__name__} has no layer {n!r} to span")
            self._orig[n] = getattr(self.module, n)
            setattr(self.module, n, self._wrap(n, self._orig[n]))
        try:
            yield self
        finally:
            for n, fn in self._orig.items():
                setattr(self.module, n, fn)
            self._orig.clear()
