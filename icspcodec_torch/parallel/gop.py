"""GOP parallelism over a device list: the sharded encode and decode.

Counterpart of icspcodec_tpu/parallel/gop.py.  The reference's only
parallelism is a pthread pool over closed GOPs (ICSP_thread.cpp:39-77,
reachable from the CLI flag --EnMultiThread, enc src:150-157): GOPs never
reference each other, so they are embarrassingly parallel.  The JAX package
shards the (G, P, H, W) GOP batch on G over a `gop` mesh axis; here a
"mesh" is a plain list of torch.devices, one per shard.  The G axis is
padded with zero GOPs up to a multiple of the shard count, split into
contiguous equal chunks, and chunk i runs the single-device engine
(engine/inter.encode_gop, engine/intra.encode_intra_frames, or the decode
engines) on device i, on CUDA from a thread of its own, so that shards on
different cards overlap; shards on one card share its stream.  Nothing
crosses between shards: the results are gathered to the first device of
the list, and the padding is dropped.  Each shard runs the kernels its engine runs,
so the output equals the unsharded engine's, byte for byte.

A list may name one device more than once (["cpu"] * 3 in the tests,
["cuda:0"] * 2 on a one-card machine): the shards then take turns on it.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..codec import _DEC_INTER_KEYS, _DEC_INTRA_KEYS, decode_gop
from ..constants import COS_DEC, COS_ENC
from ..engine.inter import encode_gop
from ..engine.intra import decode_intra_frames, encode_intra_frames


def mesh_for(shards: int, devices=None, axis: str = "gop") -> list[torch.device]:
    """The device list of a sharded encode or decode along `axis` ("gop" or
    "tile"): the first `shards` of `devices`, or of every CUDA device when
    None (both precisions run on the card: its float64 is IEEE).
    ValueError when there are fewer."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if len(devices) < shards:
        raise ValueError(f"{axis}_shards={shards} but only {len(devices)} devices are available")
    return devices[:shards]


def _pad_to(n: int, mult: int) -> int:
    return (-n) % mult


def _as_tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))


def _pad_tree(tree: dict, pad: int) -> dict:
    """Append `pad` zero entries on axis 0 of every array of the dict."""
    if not pad:
        return tree
    return {k: torch.cat([v, v.new_zeros((pad,) + v.shape[1:])]) for k, v in tree.items()}


def run_shards(fn, args: dict, mesh: list[torch.device]) -> list:
    """Split every tensor of `args` into len(mesh) contiguous equal chunks
    on axis 0 and call fn(chunk dict) with chunk i on mesh[i].  Returns the
    shards' results in order.  On CUDA each shard is issued from a thread of
    its own, so that shards on different cards overlap and one shard's
    host work overlaps another's device work; CPU shards run one after
    another, since they share the host's cores and torch's intra-op threads
    already."""
    n = len(mesh)
    mesh = [torch.device(d) for d in mesh]

    def shard(i: int):
        dev = mesh[i]
        part = {k: v.chunk(n)[i].to(dev) for k, v in args.items()}
        if dev.type != "cuda":
            return fn(part)
        with torch.cuda.device(dev):
            out = fn(part)
            torch.cuda.current_stream(dev).synchronize()
            return out

    if n == 1 or all(d.type == "cpu" for d in mesh):
        return [shard(i) for i in range(n)]
    with ThreadPoolExecutor(max_workers=n) as pool:
        return [f.result() for f in [pool.submit(shard, i) for i in range(n)]]


def gather(parts: list, device, keep: int | None = None):
    """Concatenate the shards' results (dicts of tensors, None passed
    through) on axis 0 on `device`, keeping the first `keep` entries."""
    if parts[0] is None:
        return None
    return {k: torch.cat([p[k].to(device) for p in parts])[:keep] for k in parts[0]}


def _padded_batch(arrays: dict, mesh) -> tuple[dict, int]:
    tree = {k: _as_tensor(v) for k, v in arrays.items()}
    g = next(iter(tree.values())).shape[0]
    return _pad_tree(tree, _pad_to(g, len(mesh))), g


def encode_gops_sharded(y, cb, cr, qdc: int, qac: int, mesh, dtype=torch.float32):
    """Encode (G, P, H, W) GOPs with G split over the device list.

    G must be divisible by the number of devices (encode_gops_padded takes
    any G).  Returns the (intra, inter) dicts of engine/inter.encode_gop,
    gathered on mesh[0], with leading axis G."""
    g = _as_tensor(y).shape[0]
    if g % len(mesh):
        raise ValueError(f"{g} GOPs do not split over {len(mesh)} shards; use encode_gops_padded")

    def fn(a):
        return encode_gop(a["y"], a["cb"], a["cr"], qdc, qac, table=COS_ENC, dtype=dtype)

    parts = run_shards(fn, {"y": _as_tensor(y), "cb": _as_tensor(cb), "cr": _as_tensor(cr)},
                       mesh)
    return gather([p[0] for p in parts], mesh[0]), gather([p[1] for p in parts], mesh[0])


def encode_gops_padded(y, cb, cr, qdc: int, qac: int, mesh, dtype=torch.float32):
    """encode_gops_sharded for any G: pads the GOP axis with zero GOPs up to
    a multiple of the shard count (closed GOPs are independent, so the
    padding changes nothing), runs the shards and drops the padding.
    Returns (intra, inter) like encode_gop, gathered on mesh[0], with
    leading axis G."""
    tree, g = _padded_batch({"y": y, "cb": cb, "cr": cr}, mesh)
    intra, inter = encode_gops_sharded(tree["y"], tree["cb"], tree["cr"], qdc, qac, mesh,
                                       dtype=dtype)
    return ({k: v[:g] for k, v in intra.items()},
            None if inter is None else {k: v[:g] for k, v in inter.items()})


def encode_intra_padded(y, cb, cr, qdc: int, qac: int, mesh, dtype=torch.float32):
    """Sharded all-intra encode of (F, H, W) frames: the frame axis is the
    data-parallel axis (every intra frame is independent), padded with zero
    frames up to a multiple of the shard count.  Returns the
    encode_intra_frames dict gathered on mesh[0]."""
    tree, f = _padded_batch({"y": y, "cb": cb, "cr": cr}, mesh)

    def fn(a):
        return encode_intra_frames(a["y"], a["cb"], a["cr"], qdc, qac, table=COS_ENC,
                                   dtype=dtype)

    return gather(run_shards(fn, tree, mesh), mesh[0], f)


# ---------------------------------------------------------------------------
# decode.  The reference decoder is strictly serial (decoder src:2083-2272
# per-frame loop), but GOPs are as independent on decode as on encode, so
# the same split applies: each shard decodes its GOPs with the recon carry
# local to it.
# ---------------------------------------------------------------------------

def decode_gops_padded(sym_i: dict, sym_p: dict, qdc: int, qac: int, mesh,
                       dtype=torch.float32):
    """Sharded decode of G GOPs: sym_i (G, ...) intra symbols, sym_p
    (G, P-1, ...) inter symbols.  Pads G with zero-symbol GOPs (decoded,
    then dropped: shards never interact) up to a multiple of the shard
    count.  Returns (first, rest) plane dicts gathered on mesh[0], leading
    axis G."""
    args = {f"i_{k}": sym_i[k] for k in _DEC_INTRA_KEYS}
    args.update({f"p_{k}": sym_p[k] for k in _DEC_INTER_KEYS})
    tree, g = _padded_batch(args, mesh)

    def fn(a):
        return decode_gop({k: a[f"i_{k}"] for k in _DEC_INTRA_KEYS},
                          {k: a[f"p_{k}"] for k in _DEC_INTER_KEYS}, qdc, qac, dtype=dtype)

    parts = run_shards(fn, tree, mesh)
    return gather([p[0] for p in parts], mesh[0], g), gather([p[1] for p in parts], mesh[0], g)


def decode_intra_padded(sym: dict, qdc: int, qac: int, mesh, dtype=torch.float32):
    """Sharded decode of F independent intra frames (keys _DEC_INTRA_KEYS).
    Returns dict(y, cb, cr) of planes gathered on mesh[0]."""
    tree, f = _padded_batch({k: sym[k] for k in _DEC_INTRA_KEYS}, mesh)

    def fn(a):
        return decode_intra_frames(*(a[k] for k in _DEC_INTRA_KEYS), qdc, qac, table=COS_DEC,
                                   dtype=dtype)

    return gather(run_shards(fn, tree, mesh), mesh[0], f)
