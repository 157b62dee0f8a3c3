"""Streaming / resumable encoding: per-GOP durable output.

Counterpart of the JAX package's streaming.py.  Closed GOPs are
independent, so an encoded GOP is a durable unit ("the bitstream is a
restartable artifact per GOP", SURVEY.md section 5): encode_streaming
encodes pending GOPs in rounds of up to 16 GOPs of equal length, writes
one chunk per GOP to a work directory (atomically, by os.replace), and on
a later call skips every GOP whose chunk exists.  A chunk carries a
fingerprint of its frames and of the configuration, the same hash as the
JAX package's, so a chunk written by either package resumes under the
other, and a stale chunk is refused.

Two chunk kinds, as in the JAX package: a device chunk (entropy "auto" or
"device") holds the GOP's frames packed on the card (packed, nbits); a
host chunk (entropy "host") holds the GOP's (codes, lengths) items from
the numpy writer.  Both reduce to bit rows, which the final assembly
splices at bit granularity, so the container is byte-identical to
codec.encode's output.

cfg.gop_shards > 1 encodes the pending GOPs in rounds of gop_shards over a
device list (parallel/gop.py), as the JAX package does over its `gop`
mesh, and writes host chunks: the chunks, the resume and the bytes are
those of the unsharded run.
"""
from __future__ import annotations

import hashlib
import json
import os
import pathlib
import time

import numpy as np
import torch

from .bitstream import frame_rows
from .bitstream_device import assemble_frames
from .codec import (_check_supported, encode_symbols, host_symbols, packed_rows,
                    resolve_device, shard_mesh)
from .config import CodecConfig
from .metrics import GopRecord, MetricsLog, psnr_y
from .tables import pack_header

# Bump when the encoder's output for identical (config, content) changes;
# stale chunks from an older format version are rejected on resume.
FORMAT_VERSION = 1
ROUND_GOPS = 16   # GOPs encoded per round (each still gets its own chunk)


def _gop_fingerprint(y, cb, cr, cfg: CodecConfig) -> str:
    """Content+config fingerprint of one GOP job.

    Resume must never splice a chunk produced from different input frames,
    a different QP/period/precision, or an older encoder format into the
    bitstream (the chunk filename only encodes the GOP index)."""
    h = hashlib.sha256()
    h.update(
        json.dumps(
            [FORMAT_VERSION, cfg.width, cfg.height, cfg.qp_dc, cfg.qp_ac,
             cfg.intra_period, cfg.precision],
        ).encode()
    )
    for arr in (y, cb, cr):
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


def _pack_row(codes, lengths):
    """Host MSB-first bit pack of VLC items into ONE row: (bytes, nbits).

    The per-GOP analog of bitstream_device.pack_frames_dev (no tail
    convention -- that is applied once by assemble_frames at the end).
    Used to splice host "items" chunks together with device-packed chunks
    at bit granularity."""
    L = np.asarray(lengths, np.int64).ravel()
    c = np.asarray(codes, np.uint64).ravel()
    total = int(L.sum())
    if total == 0:
        return np.zeros(0, np.uint8), 0
    j = np.arange(int(L.max()), dtype=np.int64)
    shift = L[:, None] - 1 - j                     # (n, maxlen)
    bits = ((c[:, None] >> np.maximum(shift, 0).astype(np.uint64)) & 1).astype(np.uint8)
    return np.packbits(bits[shift >= 0]), total    # row-major: MSB-first per item


def _stack_rows(rows):
    """Stack packed byte rows of unequal bucket widths (intra vs inter
    packs bucket separately) into one zero-padded (F, maxbytes) array."""
    m = max(r.shape[0] for r in rows)
    out = np.zeros((len(rows), m), np.uint8)
    for i, r in enumerate(rows):
        out[i, :r.shape[0]] = r
    return out


def _psnr_from_mse(mse: np.ndarray) -> float:
    """metrics.psnr_y convention: mean over frames of per-frame PSNR."""
    mse = np.maximum(np.asarray(mse, np.float64), 1e-12)
    return float((20 * np.log10(255.0 / np.sqrt(mse))).mean())


def _encode_round(y, cb, cr, cfg: CodecConfig, dev: torch.device, mesh=None):
    """Upload a (G, P, ...) batch of equal-length GOPs as G*P frames and run
    the engines on it (codec.encode_symbols: one (G, P) GOP batch, or the
    intra batch when P == 1; sharded over the device list `mesh` when given,
    dev then its first device).  Returns (g, p, frames on the device, the
    engines' (intra, inter, recon))."""
    g, p = y.shape[:2]
    frames = [torch.from_numpy(np.ascontiguousarray(a, np.uint8)).to(dev).flatten(0, 1)
              for a in (y, cb, cr)]
    return g, p, frames, encode_symbols(*frames, cfg, mesh=mesh)


def _encode_gop_batch_dev(y, cb, cr, cfg: CodecConfig, dev: torch.device):
    """Device-entropy encode of a (G, P, ...) GOP batch: the symbols never
    leave the card; frame items and bit packing run there and only the
    packed frames and per-frame MSE scalars are pulled.  Returns per GOP
    (rows (P, maxbytes) uint8, nbits (P,) int64, psnr_y float)."""
    g, p, (yt, _, _), ((isyms, iidx), inter, rec) = _encode_round(y, cb, cr, cfg, dev)
    rows, nbits = packed_rows(isyms, iidx, *(inter or (None, None)), g * p)
    d = rec["y"].to(torch.float32) - yt.to(torch.float32)
    mse = (d * d).mean(dim=(-2, -1)).cpu().numpy().astype(np.float64).reshape(g, p)
    return [(_stack_rows(rows[gi * p:(gi + 1) * p]),
             np.asarray(nbits[gi * p:(gi + 1) * p], np.int64), _psnr_from_mse(mse[gi]))
            for gi in range(g)]


def _encode_gop_batch(y, cb, cr, cfg: CodecConfig, dev: torch.device, mesh=None):
    """Host-entropy encode of a (G, P, ...) GOP batch, on `dev` or sharded
    over the device list `mesh`: the symbols are pulled and the numpy writer
    builds the items.  Returns per GOP (codes, lengths, psnr_y): the GOP's
    items in display order, 1-D."""
    g, p, _, ((isyms, iidx), inter, rec) = _encode_round(y, cb, cr, cfg, dev, mesh)
    psyms, pidx = inter or (None, None)
    rows_c, rows_l = frame_rows(host_symbols(isyms), iidx, host_symbols(psyms), pidx, g * p)
    recon_y = rec["y"].cpu().numpy().reshape(y.shape)
    return [(np.concatenate(rows_c[gi * p:(gi + 1) * p]),
             np.concatenate(rows_l[gi * p:(gi + 1) * p]), psnr_y(recon_y[gi], y[gi]))
            for gi in range(g)]


def encode_streaming(y, cb, cr, cfg: CodecConfig, workdir: str, seq_name: str = "seq",
                     metrics: MetricsLog | None = None, device=None) -> bytes:
    """Encode with per-GOP durability; resumes from `workdir` if partial
    results exist.  Returns the complete bitstream, byte-identical to
    codec.encode's.

    device: where to run, as codec.encode takes it: None means the CUDA
    card, and raises when there is none.  cfg.gop_shards > 1 encodes the
    pending GOPs in rounds of gop_shards GOPs split over a list of devices
    (device: the list, or None for every CUDA device; a single device
    raises ValueError) and writes host chunks.  tile_shards > 1 raises
    ValueError (the tiled engines shard single frames, not GOP batches)."""
    if cfg.tile_shards > 1:
        raise ValueError(
            "encode_streaming does not support tile_shards > 1; use "
            "gop_shards for sharded streaming or codec.encode for tiling"
        )
    _check_supported(cfg)
    mesh = shard_mesh(cfg.gop_shards, 1, device)
    dev = resolve_device(device) if mesh is None else mesh[0]
    wd = pathlib.Path(workdir)
    wd.mkdir(parents=True, exist_ok=True)
    nf = y.shape[0]
    eff = cfg.eff_period
    gops = [
        (g, list(range(g * eff, min((g + 1) * eff, nf))))
        for g in range((nf + eff - 1) // eff)
    ]
    metrics = metrics or MetricsLog(str(wd / "metrics.jsonl"))

    fps = {g: _gop_fingerprint(y[idxs], cb[idxs], cr[idxs], cfg) for g, idxs in gops}
    # done[g] = (rows list of uint8 arrays, nbits list): the bit-row form
    # both chunk kinds reduce to
    done: dict = {}
    pending = []
    for g, idxs in gops:
        chunk = wd / f"gop_{g:05d}.npz"
        if chunk.exists():
            data = np.load(chunk)
            stored = str(data["fingerprint"]) if "fingerprint" in data else None
            if stored != fps[g]:
                raise ValueError(
                    f"{chunk} was produced from different input/config "
                    f"(fingerprint {stored} != {fps[g]}); refusing to resume -- "
                    "use a fresh workdir or delete the stale chunks"
                )
            if "packed" in data:       # device-entropy chunk: per-frame rows
                done[g] = (list(data["packed"]), list(data["nbits"]))
            else:                      # items chunk: one row for the GOP
                row, nb = _pack_row(data["codes"], data["lengths"])
                done[g] = ([row], [nb])
        else:
            pending.append((g, idxs))

    # pending GOPs of equal length form rounds of up to ROUND_GOPS, or of
    # gop_shards when sharded (a shorter tail GOP its own round): one
    # batched encode a round, one durable chunk a GOP
    rsize = cfg.gop_shards if mesh is not None else ROUND_GOPS
    rounds: list[list] = []
    for g, idxs in pending:
        if rounds and len(rounds[-1]) < rsize and len(rounds[-1][0][1]) == len(idxs):
            rounds[-1].append((g, idxs))
        else:
            rounds.append([(g, idxs)])
    # the sharded path writes host chunks (their kind is part of the resume
    # contract)
    dev_entropy = mesh is None and cfg.entropy != "host"
    for batch in rounds:
        t0 = time.time()
        stack = lambda a: np.stack([a[idxs] for _, idxs in batch])  # noqa: E731
        if dev_entropy:
            items = _encode_gop_batch_dev(stack(y), stack(cb), stack(cr), cfg, dev)
        else:
            items = _encode_gop_batch(stack(y), stack(cb), stack(cr), cfg, dev, mesh)
        wall = (time.time() - t0) / len(batch)
        for (g, idxs), res in zip(batch, items):
            chunk = wd / f"gop_{g:05d}.npz"
            tmp = chunk.with_suffix(".tmp.npz")
            if dev_entropy:
                rows, nbits, psnr = res
                # uncompressed: chunks are ephemeral workdir artifacts
                np.savez(tmp, packed=rows, nbits=nbits, fingerprint=fps[g])
                bits_total = int(nbits.sum())
                done[g] = (list(rows), list(nbits))
            else:
                codes, lengths, psnr = res
                np.savez(tmp, codes=codes, lengths=lengths, fingerprint=fps[g])
                bits_total = int(lengths.sum())
                row, nb = _pack_row(codes, lengths)
                done[g] = ([row], [nb])
            os.replace(tmp, chunk)  # atomic: a crash never leaves a bad chunk
            metrics.add(GopRecord(seq=seq_name, gop_index=g, frames=len(idxs), bits=bits_total,
                                  wall_s=wall, psnr_y_db=psnr, process_index=0))

    rows_all: list = []
    nbits_all: list = []
    for g, _ in gops:
        r, n = done[g]
        rows_all += r
        nbits_all += n
    body = assemble_frames(rows_all, nbits_all)
    return pack_header(cfg.height, cfg.width, cfg.qp_dc, cfg.qp_ac, cfg.intra_period) + body
