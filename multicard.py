"""Check of the sharded paths across several CUDA cards.

    python3 multicard.py            # every card (at least 2)
    python3 multicard.py --cpu 4    # rehearsal: 4 "cpu" shards, gloo

The tests and chip_smoke.py check the sharded and tiled paths over one
device named several times.  This check runs them over distinct cards,
where the shards' threads each drive their own card, the tiles' halos
cross between cards and the multi-process path runs nccl:

  1. gop      gop_shards = the card count with device=None (every card):
              codec.encode of 60 seeded CIF frames at period 10 and
              all-intra, codec.decode and encode_streaming at period 10,
              fast: the single card's bytes, recon and planes
  2. tiles    tile_shards=2 over cards 0 and 1, and tile_shards=11 over the
              cards taken in turn: the exact encode and decode of 10 CIF
              frames at period 10 equal the single card's
  3. procs    one process a card (nccl, rank r on card r), each encoding its
              own 2 GOPs of 2 CIF frames: the all-gathered symbols and recon
              equal a single-process encode_gop of all the GOPs

Prints each call's wall time beside the single card's (one call each, the
kernels built first), the cards' name and power limit, and as its last line
{"ok": true, "device": {...}}.  Exits non-zero on any mismatch, and without
two cards.
"""
from __future__ import annotations

import json
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

W, H, NF, PERIOD = 352, 288, 60, 10
GOPS_A_PROC, GOP_FRAMES = 2, 2


def content(nframes: int, seed: int = 0):
    """Seeded CIF frames: a textured pan with noise, a static black block
    (its zero SADs fire the encoder's early break) and smooth chroma."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    base = 120 + 50 * np.sin(xx / 11.0) + 30 * np.cos(yy / 5.0)
    y = np.stack([np.roll(base, 2 * t, axis=1) for t in range(nframes)])
    y = np.clip(y + rng.normal(0, 6, y.shape), 0, 255).astype(np.uint8)
    y[:, :16, :32] = 0
    cy, cx = np.mgrid[0:H // 2, 0:W // 2]
    cb = np.stack([128 + 30 * np.sin((cx + t) / 9.0) for t in range(nframes)])
    cr = np.stack([128 + 30 * np.cos((cy + t) / 7.0) for t in range(nframes)])
    return y, cb.astype(np.uint8), cr.astype(np.uint8)


def gop_inputs(nproc: int):
    """The GOP batch of check 3: (G, P, H, W) CIF, G = 2 a process."""
    g = GOPS_A_PROC * nproc
    return tuple(a.reshape((g, GOP_FRAMES) + a.shape[1:]) for a in content(g * GOP_FRAMES, 1))


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"multicard: FAILED: {what}")


def worker(rank: int, nproc: int, port: int, outdir: str, cpu: bool) -> None:
    """One process of check 3: encode this rank's GOPs on its device and
    dump the all-gathered global arrays."""
    import torch
    import torch.distributed as dist

    from icspcodec_torch.parallel import distributed
    from icspcodec_torch.parallel.gop import encode_gops_padded

    if not cpu:
        torch.cuda.set_device(rank)
    distributed.initialize(f"localhost:{port}", nproc, rank, backend="gloo" if cpu else "nccl")
    mesh = distributed.global_gop_mesh(["cpu"] if cpu else [f"cuda:{rank}"])
    y, cb, cr = gop_inputs(nproc)
    lo, hi = rank * GOPS_A_PROC, (rank + 1) * GOPS_A_PROC
    intra, inter = encode_gops_padded(*distributed.host_local_gop_batch(
        y[lo:hi], cb[lo:hi], cr[lo:hi], mesh), 16, 16, mesh, dtype=torch.float32)
    tree = {f"intra_{k}": v for k, v in intra.items()}
    tree.update({f"inter_{k}": v for k, v in inter.items()})
    np.savez(Path(outdir) / f"proc{rank}.npz", **distributed.all_gather_tree(tree))
    dist.destroy_process_group()


def main(cpu_shards: int | None) -> int:
    import torch

    from icspcodec_torch.codec import decode, encode
    from icspcodec_torch.config import CodecConfig
    from icspcodec_torch.engine.inter import encode_gop
    from icspcodec_torch.metrics import MetricsLog
    from icspcodec_torch.ops import _build
    from icspcodec_torch.streaming import encode_streaming

    if cpu_shards is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
            print("multicard: needs at least two CUDA cards", file=sys.stderr)
            return 1
        n = torch.cuda.device_count()
        cards, one, every = [f"cuda:{i}" for i in range(n)], "cuda:0", None
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip()
        _build.build(["intra_luma", "dc_dpcm", "intra_decode", "mc_gather", "sad_mc",
                      "xform_fwd", "vlcparse"])
    else:
        n = cpu_shards
        cards = every = ["cpu"] * n
        one, smi = "cpu", "cpu rehearsal"

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        for i in range(torch.cuda.device_count() if cpu_shards is None else 0):
            torch.cuda.synchronize(i)
        return out, (time.perf_counter() - t0) * 1e3

    y, cb, cr = content(NF)
    res = {"cards": n}

    # ---- 1. GOP shards over every card ------------------------------------
    for name, period in (("period10", PERIOD), ("all_intra", 0)):
        base = dict(width=W, height=H, qp_dc=16, qp_ac=16, intra_period=period,
                    precision="fast")
        encode(y, cb, cr, CodecConfig(**base), device=one)    # warm-up
        (b1, r1), t1 = timed(lambda: encode(y, cb, cr, CodecConfig(**base), device=one))
        (bn, rn), tn = timed(lambda: encode(y, cb, cr, CodecConfig(**base, gop_shards=n),
                                            device=every))
        check(bn == b1 and all(np.array_equal(rn[k], r1[k]) for k in r1),
              f"gop_shards={n} {name} encode differs from the single card's")
        res[f"gop_encode_{name}_ms"], res[f"single_card_encode_{name}_ms"] = tn, t1
        if period:
            d1, td1 = timed(lambda: decode(b1, NF, "fast", device=one))
            dn, tdn = timed(lambda: decode(b1, NF, "fast", device=every, gop_shards=n))
            check(all(np.array_equal(dn[k], d1[k]) for k in d1),
                  f"gop_shards={n} decode differs from the single card's")
            res.update(gop_decode_ms=tdn, single_card_decode_ms=td1)
            with tempfile.TemporaryDirectory() as wd:
                bs, ts = timed(lambda: encode_streaming(
                    y, cb, cr, CodecConfig(**base, gop_shards=n), wd, metrics=MetricsLog(),
                    device=every))
            check(bs == b1, f"gop_shards={n} streaming differs from the single card's")
            res["gop_stream_ms"] = ts
    print(f"gop_shards={n} over {cards}: " + json.dumps(res), flush=True)

    # ---- 2. tiles across cards --------------------------------------------
    clip = (y[:PERIOD], cb[:PERIOD], cr[:PERIOD])
    xt = dict(width=W, height=H, qp_dc=16, qp_ac=16, intra_period=PERIOD, precision="exact")
    b1, r1 = encode(*clip, CodecConfig(**xt), device=one)
    d1 = decode(b1, PERIOD, "exact", device=one)
    for k in (2, 11):
        mesh = [cards[i % n] for i in range(k)]
        (bt, rt), tt = timed(lambda: encode(*clip, CodecConfig(**xt, tile_shards=k),
                                            device=mesh))
        dt, tdt = timed(lambda: decode(b1, PERIOD, "exact", device=mesh, tile_shards=k))
        check(bt == b1 and all(np.array_equal(rt[c], r1[c]) for c in r1),
              f"tile_shards={k} over {mesh}: the exact encode differs from the single card's")
        check(all(np.array_equal(dt[c], d1[c]) for c in d1),
              f"tile_shards={k} over {mesh}: the exact decode differs from the single card's")
        res[f"tiles{k}_exact_encode_ms"], res[f"tiles{k}_exact_decode_ms"] = tt, tdt
    print("tiles across cards (exact, 10 CIF frames, period 10; the single card's bytes and "
          "planes): " + json.dumps({k: v for k, v in res.items() if k.startswith("tiles")}),
          flush=True)

    # ---- 3. one process a card --------------------------------------------
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    root = Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory() as td:
        args = ["--cpu"] if cpu_shards is not None else []
        procs = [subprocess.Popen([sys.executable, str(root / "multicard.py"), "--worker",
                                   str(r), str(n), str(port), td, *args], cwd=root,
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(n)]
        try:
            outs = [p.communicate(timeout=600)[0] for p in procs]
        finally:
            for p in procs:
                p.kill()
        check(all(p.returncode == 0 for p in procs),
              "a worker failed: " + " | ".join(o[-2000:] for o in outs))
        dumps = [dict(np.load(Path(td) / f"proc{r}.npz")) for r in range(n)]
    intra, inter = encode_gop(*(torch.from_numpy(a).to(one) for a in gop_inputs(n)), 16, 16,
                              dtype=torch.float32)
    want = {f"{tag}_{k}": v.cpu().numpy() for tag, tree in (("intra", intra), ("inter", inter))
            for k, v in tree.items()}
    for r, d in enumerate(dumps):
        check(d.keys() == want.keys() and all(np.array_equal(d[k], want[k]) for k in want),
              f"process {r}'s gathered arrays differ from the single-process encode_gop")
    print(f"{n} processes, one device each ({'gloo' if cpu_shards else 'nccl'}): every "
          f"process holds the single-process encode_gop of {GOPS_A_PROC * n} GOPs", flush=True)
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "cpu" if cpu_shards else "gpu",
        "kind": "cpu" if cpu_shards else torch.cuda.get_device_name(0), "count": n}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        worker(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5],
               "--cpu" in sys.argv[6:])
        sys.exit(0)
    sys.exit(main(int(sys.argv[2]) if len(sys.argv) > 2 and sys.argv[1] == "--cpu" else None))
