"""Two-process GOP sharding of the port (icspcodec_torch/parallel/distributed.py):
the counterpart of tests/test_multihost.py.

Two processes join a gloo process group on localhost, each with a device
list of two "cpu" shards; each feeds only its own 2 of 4 GOPs (2 frames of
64x64), encodes them over its list (parallel/gop.encode_gops_padded), and
all-gathers the global symbol and recon arrays, which it dumps.  Both
dumps must equal each other and a single-process encode_gop of the same
data, array for array (a checksum could hide compensating errors).
"""
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import torch

from icspcodec_torch.engine.inter import encode_gop
from icspcodec_torch.parallel import distributed

REPO = pathlib.Path(__file__).resolve().parents[1]
G, P, H, W = 4, 2, 64, 64

WORKER = r"""
import pathlib, sys
pid, nproc, port, outdir = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
sys.path.insert(0, sys.argv[5])
import numpy as np
import torch
from icspcodec_torch.parallel import distributed
from icspcodec_torch.parallel.gop import encode_gops_padded
from tests.test_torch_distributed import inputs

distributed.initialize(f"localhost:{port}", nproc, pid, backend="gloo")
assert distributed.process_count() == nproc and distributed.process_index() == pid
mesh = distributed.global_gop_mesh(["cpu"] * 2)
y, cb, cr = inputs()
per = y.shape[0] // nproc
lo, hi = pid * per, (pid + 1) * per   # this process's GOPs
local = distributed.host_local_gop_batch(y[lo:hi], cb[lo:hi], cr[lo:hi], mesh)
intra, inter = encode_gops_padded(*local, 16, 16, mesh, dtype=torch.float32)
tree = {f"intra_{k}": v for k, v in intra.items()}
tree.update({f"inter_{k}": v for k, v in inter.items()})
full = distributed.all_gather_tree(tree)
np.savez(pathlib.Path(outdir) / f"proc{pid}.npz", **full)
import torch.distributed as dist
dist.destroy_process_group()
print(f"proc {pid}: wrote {len(full)} arrays")
"""


def inputs():
    rng = np.random.default_rng(0)
    y = rng.integers(0, 256, (G, P, H, W), dtype=np.uint8)
    cb = rng.integers(0, 256, (G, P, H // 2, W // 2), dtype=np.uint8)
    cr = rng.integers(0, 256, (G, P, H // 2, W // 2), dtype=np.uint8)
    return y, cb, cr


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_gop_sharding_matches_single(tmp_path):
    port = _free_port()
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="2")
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(pid), "2", str(port),
                               str(tmp_path), str(REPO)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for pid in range(2)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o

    dumps = [dict(np.load(tmp_path / f"proc{i}.npz")) for i in range(2)]
    assert dumps[0].keys() == dumps[1].keys()
    for k in dumps[0]:
        assert np.array_equal(dumps[0][k], dumps[1][k]), k

    intra, inter = encode_gop(*(torch.from_numpy(a) for a in inputs()), 16, 16,
                              dtype=torch.float32)
    want = {f"{tag}_{k}": v.numpy() for tag, tree in (("intra", intra), ("inter", inter))
            for k, v in tree.items()}
    assert dumps[0].keys() == want.keys()
    for k in want:
        assert dumps[0][k].dtype == want[k].dtype and np.array_equal(dumps[0][k], want[k]), k


def test_single_process_is_a_no_op():
    distributed.initialize(None, 1, 0)
    assert distributed.process_count() == 1 and distributed.process_index() == 0
    y, cb, cr = (a[:2] for a in inputs())
    assert all(a is not None for a in distributed.host_local_gop_batch(y, cb, cr, ["cpu"] * 2))
    got = distributed.all_gather_tree({"y": torch.from_numpy(y)})
    assert np.array_equal(got["y"], y)
