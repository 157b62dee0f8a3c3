"""Run one cell of the benchmark of icspcodec_torch once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  BENCHMARK.json names the cells; each cell's
configuration, traffic mix and metrics are files under benchmark/
(benchlib/manifest.py).  With --trace 0 the last line of standard output
is the result with the cell's end-to-end metrics; with --trace 1 it has
the per-layer ones, the device's busy seconds and a breakdown.  The
numbers compared against the plain reference, each with its limit, are
the last lines of standard error and the last key of the result.

The run needs the CUDA cards the cell asks for: without them it exits
with code 2 and prints no result.  It also prints no result (exit code 3)
when JAX or the JAX package was loaded into this process.  On every path
out it ends and waits for any child process it started.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = pathlib.Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def fixed_caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout.
    The program builds its own kernels into build/icspcodec_torch there."""
    cache = ROOT / "build" / "bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv")
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(BENCH_DIR))
    sys.path.insert(0, str(ROOT))
    fixed_caches()
    from benchlib import cell, children

    try:
        return run(args)
    finally:
        children.end_all(cell.log)


def run(args) -> int:
    from benchlib import cell, children, manifest

    chips = manifest.workload(manifest.load(ROOT), args.workload)["chips"]
    import torch

    t_torch = time.perf_counter()
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        cell.log(f"run.py: the cell {args.workload} needs {chips} CUDA card(s); "
                 f"this machine has {n}. No result.")
        return 2
    t_check = time.perf_counter()
    result, info = cell.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                 t_start=T_START)
    info["setup_split"] = {"python_and_torch_import_s": t_torch - T_START,
                           "cuda_check_s": t_check - t_torch, **info["setup_split"]}
    found = sorted(set(info["foreign_modules"]) | set(cell.foreign_modules()))
    if found:
        cell.log(f"run.py: modules of JAX or the JAX package were loaded: {found}. No result.")
        return 3
    info["cards"] = cell.card_info()
    children.end_all(cell.log)          # before the result, whose checks end standard error
    print("run: " + json.dumps(info), flush=True)
    for name, c in result["checks"].items():
        cell.log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
