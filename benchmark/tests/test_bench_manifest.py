"""BENCHMARK.json against the rules it is held to, and discovery: a
configuration, a traffic mix and a metric added as new files in a copy of
the benchmark are found by name, with no edit to an existing file."""
import json
import re
import shutil

import pytest

from benchlib import cell, manifest, traffic

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def man():
    return manifest.load()


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text \
        and "\t" not in text


def test_keys_names_and_units(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert man["paths"] == ["benchmark"] and man["command"][1] == "benchmark/run.py"
    assert 1 <= man["run_seconds"] <= 51 and isinstance(man["run_seconds"], int)
    names = []
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and c["file"].startswith("benchmark/")
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert w["config"] in names and NAME.match(w["traffic"])
    assert len({(w["config"], w["traffic"]) for w in man["workloads"]}) == len(man["workloads"])
    four = sum(w["chips"] == 4 for w in man["workloads"])
    assert four <= max(1, len(man["workloads"]) // 4)
    for m in man["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in man["end_to_end"]}
    assert "setup_s" in e2e
    for m in man["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and _line(m["layer"]) and m["source"] in SOURCES
    every = man["configs"] + man["workloads"] + man["end_to_end"] + man["per_layer"]
    for e in every:
        assert NAME.match(e["name"]), e["name"]
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for group in (man["configs"], man["workloads"], man["end_to_end"] + man["per_layer"]):
        assert len({e["name"] for e in group}) == len(group)
    assert len(json.dumps(man)) <= 64 * 1024


def test_every_cell_reports_what_it_must(man):
    layers = {}
    for m in man["per_layer"]:
        layers.setdefault(m["layer"], set()).add(m["name"])
    for w in man["workloads"]:
        e2e = {m["name"] for m in manifest.metrics_for(man, w["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        per = manifest.metrics_for(man, w["name"], True)
        assert per and all(m["moves"] in e2e for m in per), w["name"]


def test_every_part_is_a_file_found_by_name(man):
    for w in man["workloads"]:
        conf = manifest.config(man, w["config"])
        assert conf["frames"] >= 1 and conf["precision"] == "exact"
        op = manifest.op(traffic.op_name(manifest.traffic(w["traffic"])))
        assert callable(op.request) and callable(op.call) and callable(op.compare)
    for m in man["end_to_end"] + man["per_layer"]:
        assert callable(manifest.reader(m["name"]).read)
    for path in manifest.BENCH_DIR.rglob("*"):
        rel = path.relative_to(manifest.ROOT).as_posix()
        if "__pycache__" not in rel:
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_a_mix_names_only_its_op():
    assert traffic.op_name({"op": "decode"}) == "decode"
    with pytest.raises(ValueError):
        traffic.op_name({"op": "encode", "clients": 2})


def test_added_files_are_found_without_editing_any(tmp_path, man):
    """A copy of the benchmark gains a configuration, a mix with an op of
    its own, a metric and a cell that uses them, each a new file or a new
    entry; a CPU run of the new cell finds all four by name."""
    root = tmp_path / "checkout"
    bench = root / "benchmark"
    shutil.copytree(manifest.BENCH_DIR, bench, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(bench): p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    conf = json.loads((bench / "configs" / "cif_ai.json").read_text())
    conf.update(qp_dc=8, qp_ac=8, frames=2)
    (bench / "configs" / "cif_ai_q8.json").write_text(json.dumps(conf))
    (bench / "traffic" / "encode_bytes_only.json").write_text(json.dumps(dict(op="bytes_only")))
    (bench / "ops" / "bytes_only.py").write_text(
        "from benchlib.cell import diff_bytes\n"
        "DECODES = False\n"
        "def request(program, clip):\n    return clip\n"
        "def call(program, clip):\n"
        "    return program.codec.encode(*clip, program.cfg, return_recon=False,\n"
        "                                device=program.device)[0]\n"
        "def compare(samples, clip, ref):\n"
        "    return {'bytes_differing': max(diff_bytes(o, ref['stream']) for _, o in samples)}\n"
        "def describe(out, clip):\n    return {'stream_bytes': len(out)}\n")
    (bench / "metrics" / "calls_done.py").write_text(
        "def read(run):\n    return float(len(run.calls))\n")
    new = dict(man)
    new["configs"] = man["configs"] + [dict(name="cif_ai_q8", source="x",
                                            file="benchmark/configs/cif_ai_q8.json",
                                            reduced=[], why="x")]
    new["workloads"] = man["workloads"] + [dict(name="cif_ai_q8.bytes", config="cif_ai_q8",
                                                traffic="encode_bytes_only", chips=1, why="x")]
    new["end_to_end"] = man["end_to_end"] + [dict(name="calls_done", unit="calls",
                                                  better="higher", bound=0.25,
                                                  source="host_clock",
                                                  workloads=["cif_ai_q8.bytes"])]
    (root / "BENCHMARK.json").write_text(json.dumps(new))
    result, info = cell.run_cell("cif_ai_q8.bytes", 5, 0.2, False, device_kind="cpu",
                                 workers=1, root=root, bench_dir=bench)
    assert result["correct"]
    assert result["metrics"]["calls_done"]["value"] == info["calls"] >= 1
    assert set(result["metrics"]) == {"calls_done", "setup_s"}
    assert set(result["checks"]) == {"bytes_differing"} and info["stream_bytes"] > 0
    after = {p.relative_to(bench): p.read_bytes() for p in bench.rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items())
