"""One run of one cell: set-up, the measured window, the traced stretches,
the check against the plain reference, and the metrics.

The system under test is icspcodec_torch, reached only through the entry
points users call, codec.encode and codec.decode, at the configuration's
settings.  run.py calls run_cell on the card; the CPU tests call it with
device_kind="cpu" at a smaller size, with the program broken underneath,
to see `correct` come out false.
"""
from __future__ import annotations

import random
import sys
import time
from dataclasses import dataclass, field

import numpy as np

from . import content, manifest, stats, trace, traffic

FOREIGN = ("jax", "jaxlib", "flax", "icspcodec_tpu")
SAMPLES = 3                 # calls of the window compared, drawn from the seed
TRACE_MIN_CALLS, TRACE_MIN_S, TRACE_MAX_CALLS = 3, 1.0, 20


def foreign_modules() -> list[str]:
    """The loaded modules whose top-level name (the part before the first
    dot, compared whole) is JAX's or the JAX package's."""
    return sorted({m.partition(".")[0] for m in list(sys.modules)} & set(FOREIGN))


class Program:
    """icspcodec_torch's two entry points at one configuration."""

    def __init__(self, conf: dict, device_kind: str = "cuda"):
        from icspcodec_torch import codec
        from icspcodec_torch.config import CodecConfig

        self.codec = codec
        self.cfg = CodecConfig(width=conf["width"], height=conf["height"], qp_dc=conf["qp_dc"],
                               qp_ac=conf["qp_ac"], intra_period=conf["intra_period"],
                               precision=conf["precision"], gop_shards=conf["gop_shards"],
                               tile_shards=conf["tile_shards"], entropy=conf["entropy"])
        self.frames = conf["frames"]
        shards = max(self.cfg.gop_shards, self.cfg.tile_shards)
        if device_kind == "cuda":
            self.indexes = list(range(shards))
            names = [f"cuda:{i}" for i in self.indexes]
        else:
            self.indexes = []
            names = [device_kind] * shards
        self.device = names if shards > 1 else names[0]

    def sync(self) -> None:
        if self.indexes:
            import torch

            for i in self.indexes:
                torch.cuda.synchronize(i)

    def encode(self, clip):
        return self.codec.encode(*clip, self.cfg, device=self.device)

    def decode(self, stream: bytes):
        return self.codec.decode(stream, self.frames, precision=self.cfg.precision,
                                 device=self.device, gop_shards=self.cfg.gop_shards,
                                 tile_shards=self.cfg.tile_shards)


@dataclass
class Run:
    """What a metric's reader reads (benchmark/metrics/<name>.py)."""

    workload: str
    op: str
    config: dict
    frames: int
    setup_s: float
    calls: list                      # (start, end) host seconds of each call that returned
    window: tuple                    # (start, end of its last call) host seconds
    devices: list                    # CUDA indexes the run uses
    spans: dict | None = None        # traced run: layer -> [seconds per call]
    trace: trace.Trace | None = None  # traced run: the profiled stretch, spans unsynchronised
    synced_trace: trace.Trace | None = None   # a stretch with the spans synchronised
    work: dict = field(default_factory=dict)   # counted from the reference's output

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def latencies(self) -> list:
        return [e - s for s, e in self.calls]


def diff_bytes(a: bytes, b: bytes) -> int:
    """Byte positions at which two streams differ, a length difference
    counting each missing or extra byte."""
    n = min(len(a), len(b))
    x = np.frombuffer(a, np.uint8, n) != np.frombuffer(b, np.uint8, n)
    return int(np.count_nonzero(x)) + abs(len(a) - len(b))


def diff_pixels(a: dict, b: dict) -> int:
    """Pixels at which two sets of planes differ; a plane of another shape
    counts whole."""
    out = 0
    for k in ("y", "cb", "cr"):
        x, y = np.asarray(a[k]), np.asarray(b[k])
        out += int(np.count_nonzero(x != y)) if x.shape == y.shape else max(x.size, y.size)
    return out


def psnr_y(a, b) -> float:
    mse = ((a.astype(np.float64) - b.astype(np.float64)) ** 2).mean(axis=(-2, -1))
    return float((20 * np.log10(255.0 / np.sqrt(np.maximum(mse, 1e-12)))).mean())


def compare(op, samples: list, payload, ref: dict) -> dict:
    """The numbers that the op's comparison gives, each with its limit:
    exact comparisons, so every limit is 0.  samples: (call index, output)
    of the window's calls drawn from the seed."""
    return {k: {"value": v, "limit": 0} for k, v in op.compare(samples, payload, ref).items()}


def rate_by_quarter(calls: list, window: tuple, frames: int) -> list:
    """Frames a second in each quarter of the window, a call counted in the
    quarter in which it ended: how the rate moves within a window."""
    t0, t1 = window
    q = (t1 - t0) / 4
    if q <= 0:
        return []
    ends = [min(int((e - t0) / q), 3) for _, e in calls]
    return [frames * ends.count(i) / q for i in range(4)]


def card_info() -> str:
    """The cards' names and power limits as nvidia-smi reads them."""
    import subprocess

    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=index,name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           timeout=30)
        return r.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable ({exc})"


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def run_cell(workload: str, seed: int, seconds: float, traced: bool, t_start: float | None = None,
             device_kind: str = "cuda", overrides: dict | None = None, workers: int | None = None,
             root=manifest.ROOT, bench_dir=manifest.BENCH_DIR):
    """One run of a cell.  Returns (result, info): the result line's object
    (its keys in the order the line has them, the checks last) and the
    earlier lines' numbers.  overrides: configuration keys replaced (the
    CPU tests' smaller clips)."""
    t_start = time.perf_counter() if t_start is None else t_start
    man = manifest.load(root)
    wl = manifest.workload(man, workload)
    conf = {**manifest.config(man, wl["config"], root), **(overrides or {})}
    op_name = traffic.op_name(manifest.traffic(wl["traffic"], bench_dir))
    op = manifest.op(op_name, bench_dir)
    metric_defs = manifest.metrics_for(man, workload, traced)
    readers = {m["name"]: manifest.reader(m["name"], bench_dir) for m in metric_defs}
    split = {}

    t = time.perf_counter()
    import torch

    program = Program(conf, device_kind)
    split["program_import_s"] = time.perf_counter() - t
    t = time.perf_counter()
    for i in program.indexes:
        torch.zeros(1, device=f"cuda:{i}")
    program.sync()
    split["cuda_contexts_s"] = time.perf_counter() - t
    t = time.perf_counter()
    clip = content.clip(conf["content"], seed, conf["frames"], conf["width"], conf["height"])
    split["content_s"] = time.perf_counter() - t
    t = time.perf_counter()
    payload = op.request(program, clip)
    program.sync()
    split["request_s"] = time.perf_counter() - t
    t = time.perf_counter()

    def call():
        return op.call(program, payload)

    call()                              # the warm-up: the cell's own shapes, once
    program.sync()
    split["warm_call_s"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start

    rng = random.Random(int(seed))
    samples: list = []

    def keep(i, out):
        if len(samples) < SAMPLES:
            samples.append((i, out))
        else:
            j = rng.randrange(i + 1)
            if j < SAMPLES:
                samples[j] = (i, out)

    span_names = sorted({n for r in readers.values() for n in getattr(r, "SPANS", ())})
    spans = tr = synced_tr = None
    if traced:
        from .spans import Spans

        def stretch():
            n, t0 = 0, time.perf_counter()
            while n < TRACE_MAX_CALLS and (n < TRACE_MIN_CALLS
                                           or time.perf_counter() - t0 < TRACE_MIN_S):
                call()
                n += 1

        # the window and, where a reader asks for it, a traced stretch with
        # the spans synchronised at both ends: each span holds its layer's
        # device work
        synced = Spans(program.codec, span_names, program.sync)
        with synced.installed():
            calls, failed, window = traffic.closed_loop(call, seconds, keep)
            spans = {k: list(v) for k, v in synced.times.items()}
            if any(getattr(r, "SYNCED_TRACE", False) for r in readers.values()):
                synced_tr = trace.profile(stretch, program.sync)
        # the device's busy and idle time and the breakdown: a stretch with
        # the spans as annotations only, the program as it runs untraced
        with Spans(program.codec, span_names).installed():
            tr = trace.profile(stretch, program.sync)
    else:
        calls, failed, window = traffic.closed_loop(call, seconds, keep)
    program.sync()
    found = foreign_modules()
    memory_peak = max((torch.cuda.max_memory_allocated(i) for i in program.indexes), default=0)
    kind = torch.cuda.get_device_name(0) if program.indexes else device_kind
    run = Run(workload=workload, op=op_name, config=conf, frames=conf["frames"],
              setup_s=setup_s, calls=calls, window=window, devices=program.indexes, spans=spans,
              trace=tr, synced_trace=synced_tr)
    del program
    if torch.cuda.is_available():
        torch.cuda.empty_cache()

    # the plain reference, once the window has closed and the peak is read
    t = time.perf_counter()
    from benchref.clip import encode_clip

    y, cb, cr = clip
    ref = encode_clip(y, cb, cr, conf["qp_dc"], conf["qp_ac"], conf["intra_period"],
                      decode=op.DECODES, workers=workers)
    reference_s = time.perf_counter() - t
    period = conf["intra_period"]
    eff = 1 if period == 0 else period
    run.work = dict(nonzero=ref["nonzero"], frames=conf["frames"], width=conf["width"],
                    height=conf["height"], intra_frames=len(range(0, conf["frames"], eff)))

    checks = compare(op, samples, payload, ref) if samples else {}
    correct = bool(samples) and failed == 0 and all(c["value"] <= c["limit"]
                                                    for c in checks.values())
    metrics = {}
    for m in metric_defs:
        value = readers[m["name"]].read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device = {"platform": "gpu" if device_kind == "cuda" else device_kind, "kind": kind,
              "count": wl["chips"], "memory_peak_bytes": int(memory_peak)}
    if tr is not None:
        device["busy_s"] = tr.busy_mean(program_devices(run))
        device["window_s"] = tr.window_s
    result = {"correct": correct, "attempted": len(calls) + failed, "failed": failed,
              "metrics": metrics, "device": device}
    if tr is not None:
        result["breakdown"] = {"device_ops": [[n[:100], v] for n, v in tr.top_ops(10)],
                               "idle_gaps": tr.idle_gaps(program_devices(run)[0], 10)}
    result["checks"] = checks
    out = samples[0][1] if samples else None
    info = dict(workload=workload, seed=seed, traced=traced, calls=len(calls), failed=failed,
                window_s=run.window_s,
                rate_by_quarter=rate_by_quarter(calls, window, conf["frames"]),
                calls_compared=[i for i, _ in samples], setup_s=setup_s, setup_split=split,
                reference_s=reference_s, reference_stream_bytes=len(ref["stream"]),
                foreign_modules=found, spanned=span_names)
    if out is not None:
        info.update(op.describe(out, clip))
    return result, info


def program_devices(run: Run) -> list:
    """The CUDA indexes a traced run reads: those it used, else the first."""
    return run.devices or [0]
