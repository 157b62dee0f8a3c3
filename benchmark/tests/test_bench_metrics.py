"""The benchmark's arithmetic on hand-worked numbers: the window's rate,
the tail over all calls, the union of device intervals and the idle
share, the reading of a Chrome trace, and the roofline's work."""
import importlib.util
import json

import pytest

from benchlib import cell, manifest, stats, trace


def _reader(name):
    return manifest.reader(name)


def _run(**kw):
    base = dict(workload="w", op="encode", config={}, frames=300, setup_s=12.5,
                calls=[(0.0, 0.1), (0.1, 0.25), (0.25, 0.3), (0.3, 1.0)], window=(0.0, 1.0),
                devices=[0])
    base.update(kw)
    return cell.Run(**base)


def test_window_rate_counts_all_work_over_all_time():
    run = _run()
    assert _reader("encode_fps").read(run) == pytest.approx(300 * 4 / 1.0)
    assert _reader("decode_fps").read(run) is None
    assert _reader("setup_s").read(run) == 12.5


def test_p95_is_over_every_call():
    lat = [float(i) for i in range(1, 101)]   # 1..100 ms
    run = _run(calls=[(0.0, x / 1e3) for x in lat], window=(0.0, 5.0))
    # numpy's linear method: rank 0.95 * 99 = 94.05 between 95 and 96
    assert _reader("encode_p95_ms").read(run) == pytest.approx(95.05)
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.median([1.0, 2.0, 10.0]) == 2.0


def test_union_and_gaps():
    ivs = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (8, 8)]
    assert stats.union(ivs) == [(0, 3), (5, 6)]
    assert stats.covered(ivs) == 4
    assert stats.gaps(ivs, -1, 7) == [(-1, 0), (3, 5), (6, 7)]
    assert stats.clip_to(ivs, 1.5, 5.2) == [(1.5, 2), (1.5, 3), (5, 5.2)]


def _chrome(tmp_path, events):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


def test_trace_idle_share_is_one_minus_the_union(tmp_path):
    # a window of 1,000 us; on device 0 two overlapping kernels (100-300,
    # 200-400) and a copy (600-700): busy 400 us; the span of the engine
    # covers 150-350
    path = _chrome(tmp_path, [
        _x("user_annotation", "bench.window", 0, 1000),
        _x("user_annotation", "bench.encode_symbols", 150, 200),
        _x("user_annotation", "bench.write_stream", 500, 400),
        _x("kernel", "kA", 100, 200, device=0),
        _x("kernel", "kB", 200, 200, device=0),
        _x("gpu_memcpy", "Memcpy DtoH", 600, 100, device=0),
        _x("cpu_op", "aten::add", 0, 10),
    ])
    tr = trace.read_chrome_trace(path)
    assert tr.window_s == pytest.approx(1e-3)
    assert tr.busy(0) == pytest.approx(400e-6)
    assert tr.busy(0, within=tr.spans["encode_symbols"]) == pytest.approx(200e-6)
    run = _run(trace=tr)
    assert _reader("device_idle_pct.encode").read(run) == pytest.approx(60.0)
    assert _reader("device_idle_pct.decode").read(run) is None
    gaps = tr.idle_gaps(0)
    # gaps 700-1000 and 400-600 (the writer's span covers most of each) and 0-100
    assert gaps == [["host in write_stream", pytest.approx(300e-6)],
                    ["host in write_stream", pytest.approx(200e-6)],
                    ["host outside the spanned layers", pytest.approx(100e-6)]]
    assert tr.top_ops(1) == [["kA", pytest.approx(200e-6)]]


def test_trace_without_device_events_reads_nothing(tmp_path):
    path = _chrome(tmp_path, [_x("user_annotation", "bench.window", 0, 1000)])
    assert trace.read_chrome_trace(path) is None


def test_rate_by_quarter():
    # a 4-s window of 150-frame calls ending at 0.5, 0.9, 1.5, 3.9 and 4.0 s
    calls = [(0.0, 0.5), (0.5, 0.9), (0.9, 1.5), (1.5, 3.9), (3.9, 4.0)]
    assert cell.rate_by_quarter(calls, (0.0, 4.0), 150) == [300.0, 150.0, 0.0, 300.0]
    assert cell.rate_by_quarter([], (1.0, 1.0), 150) == []


def test_spans_synchronise_only_when_asked():
    import types

    from benchlib.spans import Spans

    mod = types.SimpleNamespace(__name__="m", layer=lambda x: x + 1)
    synced = []
    for sync in (None, lambda: synced.append(1)):
        sp = Spans(mod, ["layer"], sync)
        with sp.installed():
            assert mod.layer(1) == 2
        assert mod.layer(1) == 2          # restored
        assert len(sp.times["layer"]) == (0 if sync is None else 1)
    assert len(synced) == 2               # both ends of the one synchronised call


def test_spans_give_the_median():
    run = _run(spans={"parse_body": [0.2, 0.1, 0.3], "encode_symbols": [0.004]})
    assert _reader("parse_ms").read(run) == pytest.approx(200.0)
    assert _reader("engine_ms.encode").read(run) == pytest.approx(4.0)
    assert _reader("host_writer_ms").read(run) is None


def test_roofline_work_on_a_hand_worked_shape():
    roof = _reader("engine_roofline_pct")
    # 32x16: 8 luma blocks, 2 MBs (4 chroma blocks) a frame; 3 frames, 1 intra
    w = dict(frames=3, width=32, height=16, intra_frames=1, nonzero=100)
    got = roof.work(w)
    blocks = 3 * (8 + 4)
    # the forward transform separable: 2 passes x 64 outputs x 8 multiply-adds
    assert got["flops"] == blocks * 1024 * 2 + 100 * 64 * 2
    assert got["diffs"] == 2 * 2 * 64 * 256
    plane = 32 * 16 * 3 // 2
    assert got["bytes"] == 3 * plane + 2 * plane + blocks * 129 + 8 * 2 + 2 * 2 * 4 + 3 * plane
    assert got["seconds"] == max(got["flops"] / 67e12, got["diffs"] / (4 * 33.5e12),
                                 got["bytes"] / 3.35e12)
    # the share: the work of 2 calls over the device time inside their spans
    tr = trace.Trace(window=(0.0, 1.0),
                     devices={0: [(0.1, 0.1 + got["seconds"]), (0.5, 0.5 + 3 * got["seconds"])]},
                     spans={"encode_symbols": [(0.0, 0.4), (0.4, 0.9)]})
    tr.devices[0] = [(s, e, "k") for s, e in tr.devices[0]]
    assert roof.read(_run(trace=tr, work=w)) is None      # reads the synchronised stretch
    assert roof.read(_run(synced_trace=tr, work=w)) == pytest.approx(50.0)


def test_metric_modules_are_standalone_files():
    for m in manifest.load()["per_layer"] + manifest.load()["end_to_end"]:
        path = manifest.BENCH_DIR / "metrics" / f"{m['name']}.py"
        assert importlib.util.spec_from_file_location("x", path) is not None
        assert callable(manifest.reader(m["name"]).read)
