"""Finding a cell's parts by name: BENCHMARK.json at the checkout's root,
and under the benchmark's folder one file per configuration, traffic mix
and metric.

- configs: the file that BENCHMARK.json's `configs` entry names
  (benchmark/configs/<name>.json);
- traffic mixes: benchmark/traffic/<traffic>.json, parameters that the one
  general generator (traffic.py) reads, whose "op" names a module
  benchmark/ops/<op>.py: the call a client makes, and its check;
- metrics, end-to-end and per-layer alike: benchmark/metrics/<name>.py,
  each a small reader `read(run) -> float | None` (None: nothing to read,
  and the metric is left out of the line), with an optional SPANS tuple of
  the program's layers it needs spanned in a traced run, and an optional
  SYNCED_TRACE = True when it reads the stretch traced with those spans
  synchronised (run.synced_trace).

A later change adds a cell, a configuration, a mix or a metric by adding
files and entries; no file here needs an edit.
"""
from __future__ import annotations

import importlib.util
import json
import pathlib

BENCH_DIR = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load(root: pathlib.Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as fh:
        return json.load(fh)


def _entry(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json has no {what} named {name!r}")


def workload(manifest: dict, name: str) -> dict:
    return _entry(manifest["workloads"], name, "workload")


def config(manifest: dict, name: str, root: pathlib.Path = ROOT) -> dict:
    with open(root / _entry(manifest["configs"], name, "configuration")["file"]) as fh:
        return json.load(fh)


def traffic(name: str, bench_dir: pathlib.Path = BENCH_DIR) -> dict:
    with open(bench_dir / "traffic" / f"{name}.json") as fh:
        return json.load(fh)


def metrics_for(manifest: dict, workload_name: str, traced: bool) -> list[dict]:
    """The metrics a run of the cell reports: with tracing, the per-layer
    ones, else the end-to-end ones; each that lists the cell under
    `workloads`, or lists no cells and moves (or is) a metric the cell
    reports."""
    e2e = [m for m in manifest["end_to_end"]
           if workload_name in m.get("workloads", [workload_name])]
    if not traced:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in manifest["per_layer"]
            if (workload_name in m["workloads"] if "workloads" in m else m["moves"] in names)]


def _module(folder: str, name: str, bench_dir: pathlib.Path):
    """The module benchmark/<folder>/<name>.py, loaded by its path."""
    path = bench_dir / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_{folder}_" + name.replace(".", "__"),
                                                  path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no module for {name!r} at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str, bench_dir: pathlib.Path = BENCH_DIR):
    """The reader of the metric `name`: benchmark/metrics/<name>.py."""
    return _module("metrics", name, bench_dir)


def op(name: str, bench_dir: pathlib.Path = BENCH_DIR):
    """The call that a traffic mix names: benchmark/ops/<name>.py."""
    return _module("ops", name, bench_dir)
