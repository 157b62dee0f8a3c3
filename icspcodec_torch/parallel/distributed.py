"""Multi-process GOP sharding: each process encodes its own GOPs on its own
devices, then an all-gather gives every process the global result.

Counterpart of icspcodec_tpu/parallel/distributed.py.  The reference is
single-process (pthreads and shared memory); the JAX package runs one SPMD
program over a global `gop` mesh under jax.distributed.  Here the global
mesh is the concatenation, in rank order, of every process's device list:
a process feeds only its host-local GOPs (host_local_gop_batch), encodes
them on its local devices (parallel/gop.py), and all_gather_tree assembles
the global (G_local * world_size, ...) arrays on every process.  Closed GOPs
need no traffic between processes until that gather.

torch.distributed is imported only on this multi-process path.  A cluster
is not discovered: the caller passes the coordinator's address, the
number of processes and its own rank.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from .gop import mesh_for


def _group():
    """torch.distributed when this process is in a process group, else None;
    imports nothing (a process group exists only after initialize)."""
    dist = sys.modules.get("torch.distributed")
    return dist if dist is not None and dist.is_available() and dist.is_initialized() else None


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, backend: str | None = None):
    """Bring up torch.distributed (a no-op for one process).
    coordinator_address: "host:port" of rank 0 (or a full init URL);
    backend: "gloo" or "nccl", by default nccl when CUDA is available,
    else gloo."""
    if num_processes is None or num_processes <= 1:
        return
    import torch.distributed as dist

    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=url, world_size=num_processes,
                            rank=process_id)


def process_count() -> int:
    dist = _group()
    return 1 if dist is None else dist.get_world_size()


def process_index() -> int:
    dist = _group()
    return 0 if dist is None else dist.get_rank()


def global_gop_mesh(devices=None) -> list[torch.device]:
    """This process's share of the global `gop` mesh: its local device list
    (every local CUDA device when None).  The global mesh is these lists
    of all processes in rank order."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return mesh_for(len(devices), devices)


def host_local_gop_batch(y, cb, cr, mesh):
    """This process's GOPs (G_local, P, H, W) as its slice of the global
    batch, rows [rank * G_local, (rank + 1) * G_local).  Every process must
    hold the same number of GOPs, a multiple of its device count; checked
    across processes.  Returns (y, cb, cr) as numpy arrays."""
    y, cb, cr = (np.ascontiguousarray(a) for a in (y, cb, cr))
    g = y.shape[0]
    if g % len(mesh):
        raise ValueError(f"{g} local GOPs do not split over {len(mesh)} local devices")
    if process_count() > 1:
        counts = all_gather_tree({"g": torch.tensor([g], dtype=torch.int64)})["g"]
        if not np.all(counts == g):
            raise ValueError(f"every process must feed the same number of GOPs, got {counts}")
    return y, cb, cr


def all_gather_tree(tree: dict) -> dict:
    """Concatenate a dict of equally shaped arrays (numpy or tensors) on
    axis 0 across all processes, in rank order; returns host numpy arrays.
    Each array travels as its bytes, so any dtype goes through gloo and
    nccl alike."""
    dist = _group()
    if dist is None:
        return {k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
                for k, v in tree.items()}
    out = {}
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend() == "nccl" else torch.device("cpu")
    n = dist.get_world_size()
    for k, v in tree.items():
        a = v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        a = np.ascontiguousarray(a)
        raw = torch.from_numpy(a.reshape(-1).view(np.uint8).copy()).to(dev)
        bufs = [torch.empty_like(raw) for _ in range(n)]
        dist.all_gather(bufs, raw)
        out[k] = np.concatenate([b.cpu().numpy().view(a.dtype).reshape(a.shape) for b in bufs])
    return out
