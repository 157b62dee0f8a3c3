"""The control of a cell's correctness check, and the sound readings beside it.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...] [--calls K]

For each seed, in one process: the clip of the cell, then K calls of the
program as the configuration states it (exact mode, float64) and K calls
of the control, the program's own lower precision (precision="fast",
float32, in set-up too: a decode cell's control decodes its own float32
stream), each compared with the plain reference by the cell's own
comparison.  It prints one JSON line per seed with both sides' readings
and a last line with the largest sound reading and the smallest control
reading of each number.  The benchmark's runs never run it.  It needs
the card(s) the cell asks for.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

BENCH_DIR = pathlib.Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def readings(workload: str, seeds, calls: int = 1, device_kind: str = "cuda",
             overrides: dict | None = None, workers: int | None = None):
    """Yields (seed, sound readings, control readings) for each seed."""
    from benchlib import cell, content, manifest, traffic
    from benchref.clip import encode_clip

    man = manifest.load(ROOT)
    wl = manifest.workload(man, workload)
    conf = {**manifest.config(man, wl["config"], ROOT), **(overrides or {})}
    op = manifest.op(traffic.op_name(manifest.traffic(wl["traffic"], BENCH_DIR)), BENCH_DIR)
    sound = cell.Program(conf, device_kind)
    control = cell.Program({**conf, "precision": "fast"}, device_kind)
    for seed in seeds:
        clip = content.clip(conf["content"], seed, conf["frames"], conf["width"],
                            conf["height"])
        ref = encode_clip(*clip, conf["qp_dc"], conf["qp_ac"], conf["intra_period"],
                          decode=op.DECODES, workers=workers)
        got = []
        for p in (sound, control):
            payload = op.request(p, clip)
            outs = [(i, op.call(p, payload)) for i in range(calls)]
            got.append(cell.compare(op, outs, payload, ref))
        yield seed, *got


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--calls", type=int, default=1)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(BENCH_DIR))
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("control.py: no CUDA card", file=sys.stderr)
        return 2
    worst: dict = {}
    for seed, good, ctl in readings(args.workload, args.seeds, args.calls):
        print(json.dumps(dict(workload=args.workload, seed=seed,
                              sound={k: v["value"] for k, v in good.items()},
                              control={k: v["value"] for k, v in ctl.items()})), flush=True)
        for k in good:
            w = worst.setdefault(k, {"sound_max": 0, "control_min": None})
            w["sound_max"] = max(w["sound_max"], good[k]["value"])
            c = ctl[k]["value"]
            w["control_min"] = c if w["control_min"] is None else min(w["control_min"], c)
    print(json.dumps(dict(workload=args.workload, seeds=args.seeds, readings=worst)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
