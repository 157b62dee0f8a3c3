"""Top-level encode and decode API of the PyTorch port.

encode() runs the codec at any intra period on one device.  All-intra:
the intra engine (engine/intra.py, with CUDA kernels A and F on the card).
With P-frames: closed GOPs batched as the JAX package batches them, the
full GOPs as one (G, P) batch and a shorter last GOP as another, through
engine/inter.encode_gop (kernels A and F for the GOPs' first frames, then
per P-frame position kernels D, E, F and, where the reference's walk breaks
early, G).  Then device-side entropy items and bit packing
(bitstream_device.py), and the host splice plus the 14-byte header.  Only
the packed frames (and, if asked, the recon planes) come back to the host.
With cfg.entropy="host" the symbols come back instead and the numpy writer
(bitstream.py) packs them: the same bytes.

decode() reads any stream the codec writes, at every intra period: the
host parser (runtime/) produces fixed-shape symbol arrays, which go to the
device once; the intra frames of all GOPs decode as one batch (kernels C
and B'), the MVs of all P-frames in one batched walk, then each P-frame
position of the GOPs as one batched step (kernels B' and E).  The decode
side always uses the decoder-regime double table COS_DEC.

Two precision regimes (cfg.precision):
  exact -- float64 with the encoder's float-rounded cosine table: the
           bitstream is byte-identical to the JAX package's exact mode, and
           so to the C++ reference encoder.  The H100's float64 is IEEE, so
           exact mode runs on the card.
  fast  -- float32; identical structure, a quantizer rounding tie may flip.

Sharding, as in the JAX package, over a list of devices: cfg.gop_shards > 1
splits the GOP batches over the list (parallel/gop.py: each shard runs the
engines above, with their kernels, on its device) and cfg.tile_shards > 1
splits each frame's MB columns over it (parallel/tiles.py: the tiled
wavefronts with halo exchange).  Both write with the host writer, and give
the unsharded bytes and planes at any shard count.
"""
from __future__ import annotations

import numpy as np
import torch

from .bitstream import write_bitstream_grouped
from .bitstream_device import assemble_frames, frame_items_dev, pack_frames_dev
from .config import CodecConfig
from .constants import COS_DEC, COS_ENC
from .engine.inter import decode_gop_mvs, decode_inter_frame, encode_gop
from .engine.intra import decode_intra_frames, encode_intra_frames
from .runtime import parse_body
from .tables import pack_header, parse_header

_INTRA_KEYS = ("y_scan", "y_acflag", "mpm", "mode_bit",
               "cb_scan", "cb_acflag", "cr_scan", "cr_acflag")
_INTER_KEYS = ("y_scan", "y_acflag", "mv_diff", "cb_scan", "cb_acflag", "cr_scan", "cr_acflag")
_DEC_INTRA_KEYS = ("y_scan", "mpm", "mode_bit", "cb_scan", "cr_scan")
_DEC_INTER_KEYS = ("y_scan", "mv_diff", "cb_scan", "cr_scan")


def resolve_device(device=None) -> torch.device:
    """The device to run on: the given one (the first of a list), else the
    current CUDA device.  With no GPU and no device given this raises
    rather than falling back to the CPU, where the plain versions stand in
    for the kernels."""
    if isinstance(device, (list, tuple)):
        if not device:
            raise ValueError("the device list is empty")
        device = device[0]
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run "
                           "the plain PyTorch versions of the kernels on the CPU")
    return torch.device("cuda")


def shard_mesh(gop_shards: int, tile_shards: int, device=None):
    """The device list of a sharded run, or None for an unsharded one.
    device: a list of devices, one per shard (it may name one device more
    than once), or None for every CUDA device; a single device raises."""
    if gop_shards > 1 and tile_shards > 1:
        raise ValueError("gop_shards and tile_shards are mutually exclusive")
    if gop_shards == 1 and tile_shards == 1:
        return None
    axis, shards = ("gop", gop_shards) if gop_shards > 1 else ("tile", tile_shards)
    if device is not None and not isinstance(device, (list, tuple)):
        raise ValueError(f"{axis}_shards={shards} runs over a list of devices, one per shard: "
                         f"pass device=[{str(device)!r}] * {shards} (or None for every CUDA "
                         f"device), not the single device {device!r}")
    from .parallel.gop import mesh_for

    return mesh_for(shards, device, axis)


def _check_supported(cfg: CodecConfig) -> None:
    if cfg.intra_period < 0:
        raise ValueError(f"intra_period must be >= 0, got {cfg.intra_period}")
    if cfg.precision not in ("exact", "fast"):
        raise ValueError(f"precision must be exact|fast, got {cfg.precision!r}")


def _pack_bucketed(codes: torch.Tensor, lengths: torch.Tensor, slab: int = 32):
    """Pack (F, N) device items into per-frame byte rows on the host.

    Pulls the per-frame bit counts first to size one byte bucket (a multiple
    of 8 KB), then packs `slab` frames per call to bound the expand buffers;
    every slab is queued before the first row is pulled.  The bytes do not
    depend on the bucket or the slab."""
    nb = lengths.sum(dim=1, dtype=torch.int64).cpu().numpy()
    maxbytes = int(-(-int(nb.max()) // (8 * 8192)) * 8192)
    f = codes.shape[0]
    packed = [pack_frames_dev(codes[s:s + slab], lengths[s:s + slab], maxbytes)[0]
              for s in range(0, f, slab)]
    rows = [r for p in packed for r in p.cpu().numpy()]
    return rows, [int(b) for b in nb]


def packed_rows(intra_syms, intra_idx, inter_syms, inter_idx, nframes: int):
    """Entropy-code and pack batched symbol groups on their device: (rows,
    nbits), per frame in display order, the packed bytes (numpy uint8) and
    their bit counts.  *_syms: dicts of (n, ...) symbol tensors on one
    device (inter frames carry mv_diff), or None; *_idx: the display index
    of each of their frames."""
    rows, nbits = [None] * nframes, [None] * nframes
    for syms, idx, is_intra in ((intra_syms, intra_idx, True), (inter_syms, inter_idx, False)):
        if syms is None:
            continue
        codes, lengths = frame_items_dev(syms, is_intra)
        for n, row, nb in zip(idx, *_pack_bucketed(codes, lengths)):
            rows[int(n)], nbits[int(n)] = row, nb
    return rows, nbits


def write_stream(intra_syms, intra_idx, inter_syms, inter_idx, nframes: int, height: int,
                 width: int, qdc: int, qac: int, period: int) -> bytes:
    """Serialize batched symbol groups, intra and inter, into one stream in
    display order on their device (packed_rows), then splice the frames on
    the host: the device-side counterpart of bitstream.write_bitstream_grouped."""
    rows, nbits = packed_rows(intra_syms, intra_idx, inter_syms, inter_idx, nframes)
    return pack_header(height, width, qdc, qac, period) + assemble_frames(rows, nbits)


def _acflag(scan: np.ndarray) -> np.ndarray:
    return (np.count_nonzero(scan[..., 1:], axis=-1) == 0).astype(np.int32)


def host_symbols(syms: dict | None) -> dict | None:
    """Symbol tensors (or numpy arrays) pulled to numpy for the host writer,
    with y_acflag computed on the host from y_scan, as the JAX package's host
    route does."""
    if syms is None:
        return None
    out = {k: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
           for k, v in syms.items() if k != "y_acflag"}
    out["y_acflag"] = _acflag(out["y_scan"])
    return out


def gop_spans(nf: int, eff: int) -> list[tuple[int, int, int]]:
    """The GOP batches of nf frames at an effective intra period eff, as
    (first frame, G, P): the full GOPs as one (G, P) batch and a shorter
    last GOP as another (P = 1: intra only); all-intra is one (nf, 1)."""
    nfull, rem = divmod(nf, eff)
    return ([(0, nfull, eff)] if nfull else []) + ([(nfull * eff, 1, rem)] if rem else [])


def _engines(cfg: CodecConfig, return_recon: bool, mesh):
    """(intra, gop): the encode engines for planes on one device, each
    returning its dicts of tensors on one device.  intra(y, cb, cr) encodes
    (F, ...) intra frames (engine/intra.encode_intra_frames), gop(y, cb,
    cr) a (G, P, ...) batch of closed GOPs (engine/inter.encode_gop).  With
    a device list `mesh`, their sharded counterparts: GOP shards
    (cfg.gop_shards > 1, parallel/gop.py) or MB column tiles
    (cfg.tile_shards > 1, parallel/tiles.py), gathered on mesh[0]."""
    dtype = torch.float64 if cfg.precision == "exact" else torch.float32
    q = (cfg.qp_dc, cfg.qp_ac)
    if mesh is None:
        return (lambda y, cb, cr: encode_intra_frames(y, cb, cr, *q, table=COS_ENC, dtype=dtype,
                                                      return_recon=return_recon),
                lambda y, cb, cr: encode_gop(y, cb, cr, *q, table=COS_ENC, dtype=dtype))
    if cfg.tile_shards > 1:
        from .parallel import tiles

        return (lambda y, cb, cr: tiles.encode_intra_frames_tiled(y, cb, cr, *q, mesh,
                                                                  dtype=dtype),
                lambda y, cb, cr: tiles.encode_gop_tiled(y, cb, cr, *q, mesh, dtype=dtype))
    from .parallel import gop

    return (lambda y, cb, cr: gop.encode_intra_padded(y, cb, cr, *q, mesh, dtype=dtype),
            lambda y, cb, cr: gop.encode_gops_padded(y, cb, cr, *q, mesh, dtype=dtype))


def encode_symbols(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor, cfg: CodecConfig,
                   return_recon: bool = True, mesh=None):
    """The engines' half of encode(): planes (F, ...) uint8 on one device ->
    (intra, inter, recon).  intra = (symbols, display indexes) of the intra
    frames; inter likewise for the P-frames, or None; symbols are dicts of
    (n, ...) tensors on the device, as write_stream takes them.  recon: dict
    of (F, ...) uint8 planes on the device, or None.  mesh: a device list
    (codec.shard_mesh) to shard the engines over, the results gathered on
    mesh[0], or None.

    GOPs are batched as the JAX package batches them: the full GOPs as one
    (G, P) batch, a shorter last GOP as another; a one-frame last GOP is
    intra only."""
    intra_fn, gop_fn = _engines(cfg, return_recon, mesh)
    nf, eff = y.shape[0], cfg.eff_period
    if eff == 1:
        out = intra_fn(y, cb, cr)
        rec = {k: out[f"recon_{k}"] for k in ("y", "cb", "cr")} if return_recon else None
        return ({k: out[k] for k in _INTRA_KEYS}, np.arange(nf)), None, rec
    isyms, iidx, psyms, pidx = [], [], [], []
    for start, g, p in gop_spans(nf, eff):
        idx = np.arange(start, start + g * p).reshape(g, p)
        if p == 1:
            intra, inter = intra_fn(*(a[start:start + 1] for a in (y, cb, cr))), None
        else:
            intra, inter = gop_fn(*(a[start:start + g * p].reshape((g, p) + a.shape[1:])
                                    for a in (y, cb, cr)))
        isyms.append(intra)
        iidx.append(idx[:, 0])
        if inter is not None:
            psyms.append({k: v.flatten(0, 1) for k, v in inter.items()})
            pidx.append(idx[:, 1:].ravel())
    cat = lambda outs, keys: {k: torch.cat([o[k] for o in outs]) for k in keys}  # noqa: E731
    rec = None
    if return_recon:
        rec = {}
        order = np.argsort(np.concatenate(iidx + pidx))
        for k in ("y", "cb", "cr"):
            planes = torch.cat([o[f"recon_{k}"] for o in isyms + psyms])
            rec[k] = planes[torch.from_numpy(order).to(planes.device)]
    inter = (cat(psyms, _INTER_KEYS), np.concatenate(pidx)) if psyms else None
    return (cat(isyms, _INTRA_KEYS), np.concatenate(iidx)), inter, rec


def _host(tree):
    return None if tree is None else {k: v.cpu().numpy() for k, v in tree.items()}


def encode(y: np.ndarray, cb: np.ndarray, cr: np.ndarray, cfg: CodecConfig,
           return_recon: bool = True, device=None):
    """y: (F, H, W) uint8; cb/cr: (F, H/2, W/2) uint8.  Returns (bitstream
    bytes, recon dict of (F, ...) uint8 numpy planes, or None with
    return_recon=False).  Any intra period; the bytes of exact mode equal the
    JAX package's.

    device: where to run; None means the CUDA card, and raises when there is
    none.  device="cpu" runs the plain versions of the kernels (the tests do).
    cfg.entropy: "auto" and "device" entropy-code and pack on the device and
    pull only the packed frames; "host" pulls the symbols and packs them
    with the numpy writer.  The bytes are the same.

    cfg.gop_shards > 1 splits the GOP batches over a list of devices
    (parallel/gop.py; the --EnMultiThread analog, reference enc src:150-157
    and ICSP_thread.cpp:39-77) and cfg.tile_shards > 1 splits each frame's
    MB columns over it (parallel/tiles.py).  Then device is that list, one
    device per shard (it may name one device more than once), or None for
    every CUDA device; a single device raises ValueError, as do fewer
    devices than shards.  The sharded paths write with the host writer
    (entropy="device" raises ValueError there) and give the unsharded bytes
    and recon at any shard count.
    """
    _check_supported(cfg)
    if y.shape[0] == 0:
        raise ValueError("need at least one frame")
    mesh = shard_mesh(cfg.gop_shards, cfg.tile_shards, device)
    if cfg.entropy == "device" and mesh is not None:
        raise ValueError("entropy='device' requires the unsharded path "
                         "(gop_shards == tile_shards == 1); use entropy='auto'")
    dev = resolve_device(device) if mesh is None else mesh[0]
    yt, cbt, crt = (torch.from_numpy(np.ascontiguousarray(a, np.uint8)).to(dev)
                    for a in (y, cb, cr))
    (isyms, iidx), inter, rec = encode_symbols(yt, cbt, crt, cfg, return_recon, mesh)
    psyms, pidx = inter if inter is not None else (None, None)
    args = (y.shape[0], cfg.height, cfg.width, cfg.qp_dc, cfg.qp_ac, cfg.intra_period)
    # the sharded paths write with the host writer, as the JAX package's do
    if cfg.entropy == "host" or mesh is not None:
        bits = write_bitstream_grouped(host_symbols(isyms), iidx, host_symbols(psyms), pidx,
                                       *args)
    else:
        bits = write_stream(isyms, iidx, psyms, pidx, *args)
    if rec is not None:
        rec = {k: v.cpu().numpy() for k, v in rec.items()}
    return bits, rec


def decode_gop(sym_i: dict, sym_p: dict, qdc: int, qac: int, dtype=torch.float64,
               gop_frames=None):
    """Decode closed GOPs: frame 0 intra, the rest P-frames.

    sym_i: intra symbols (G, ...); sym_p: inter symbols (G, P-1, ...), all
    on one device.  gop_frames: each GOP's frame count, non-increasing (a
    shorter last GOP); None means P for all.  Symbols of frames past a
    GOP's count are ignored and their planes left zero.  Returns (first,
    rest): dicts of uint8 planes (G, ...) and (G, P-1, ...).

    The MV reconstruction depends only on the mv_diff symbols, so it runs
    once for all P-frames; then each P-frame position is one step batched
    over the GOPs that have it, carrying the previous planes."""
    first = decode_intra_frames(*(sym_i[k] for k in _DEC_INTRA_KEYS), qdc, qac,
                                table=COS_DEC, dtype=dtype)
    g, pm1 = sym_p["y_scan"].shape[:2]
    lens = [pm1 + 1] * g if gop_frames is None else [int(n) for n in gop_frames]
    if len(lens) != g or any(a < b for a, b in zip(lens, lens[1:])):
        raise ValueError(f"gop_frames must give {g} non-increasing counts, got {lens}")
    mv = decode_gop_mvs(sym_p["mv_diff"])
    rest = {k: v.new_zeros((g, pm1) + v.shape[1:]) for k, v in first.items()}
    carry = first
    for k in range(pm1):
        n = sum(1 for length in lens if length > k + 1)  # a prefix of the GOPs
        if n == 0:
            break
        sym = dict(y_scan=sym_p["y_scan"][:n, k], cb_scan=sym_p["cb_scan"][:n, k],
                   cr_scan=sym_p["cr_scan"][:n, k], mv=mv[:n, k])
        carry = decode_inter_frame(sym, carry["y"][:n], carry["cb"][:n], carry["cr"][:n],
                                   qdc, qac, table=COS_DEC, dtype=dtype)
        for c, v in carry.items():
            rest[c][:n, k] = v
    return first, rest


def _decode_sharded(syms: dict, nframes: int, eff: int, qdc: int, qac: int, dtype, mesh,
                    tiled: bool) -> dict:
    """decode() over a device list: GOP shards, or MB column tiles when
    `tiled`; the GOPs batched as the JAX package batches them (the full
    GOPs, then a shorter last one)."""
    if tiled:
        from .parallel import tiles

        def intra_fn(sym):
            return _host(tiles.decode_intra_frames_tiled(sym, qdc, qac, mesh, dtype=dtype))

        def gop_fn(sym_i, sym_p):
            return tuple(map(_host, tiles.decode_gop_tiled(sym_i, sym_p, qdc, qac, mesh,
                                                           dtype=dtype)))
    else:
        from .parallel import gop

        def intra_fn(sym):
            return _host(gop.decode_intra_padded(sym, qdc, qac, mesh, dtype=dtype))

        def gop_fn(sym_i, sym_p):
            return tuple(map(_host, gop.decode_gops_padded(sym_i, sym_p, qdc, qac, mesh,
                                                           dtype=dtype)))

    out = {}
    for start, g, p in gop_spans(nframes, eff):
        idx = np.arange(start, start + g * p).reshape(g, p)
        sym_i = {k: syms[k][idx[:, 0]] for k in _DEC_INTRA_KEYS}
        if p == 1:
            first, rest = intra_fn(sym_i), None
        else:
            first, rest = gop_fn(sym_i, {k: syms[k][idx[:, 1:]] for k in _DEC_INTER_KEYS})
        for k, v in first.items():
            plane = out.setdefault(k, np.zeros((nframes,) + v.shape[1:], np.uint8))
            plane[idx[:, 0]] = v
            if rest is not None:
                plane[idx[:, 1:]] = rest[k]
    return out


def decode(data: bytes, nframes: int, precision: str = "exact", device=None,
           gop_shards: int = 1, tile_shards: int = 1):
    """Decode a bitstream of `nframes` frames; returns dict(y, cb, cr) of
    (F, ...) uint8 numpy planes.

    precision: "exact" (float64: the JAX package's exact planes, byte for
    byte, of the stream as written: its final byte realigned, as the JAX
    parser needs) or "fast" (float32).  device: where to run; None means
    the CUDA card, and raises when there is none; device="cpu" runs the
    plain versions of the kernels (the tests do).

    The stream must hold exactly nframes frames: runtime.parse_body reads
    its final byte as the writer writes it and raises ValueError when no
    reading of that byte ends the stream ("truncated bitstream", also for a
    stream holding more frames) or when two do with different symbols
    (runtime.AmbiguousTailError).

    gop_shards > 1 decodes the GOP batches split over a list of devices
    (parallel/gop.py), tile_shards > 1 each frame's MB columns split over
    it (parallel/tiles.py; mutually exclusive with gop_shards).  device is
    then that list, as codec.encode takes it.  The planes equal the
    unsharded ones at any shard count; the reference decoder is serial, so
    this has no referent and mirrors the encode-side sharding."""
    if precision not in ("exact", "fast"):
        raise ValueError(f"precision must be exact|fast, got {precision!r}")
    if nframes < 1:
        raise ValueError("need at least one frame")
    mesh = shard_mesh(gop_shards, tile_shards, device)
    dev = resolve_device(device) if mesh is None else None
    dtype = torch.float64 if precision == "exact" else torch.float32
    height, width, qdc, qac, period = parse_header(data[:14])
    syms = parse_body(data[14:], nframes, height, width, period)
    eff = 1 if period == 0 else period
    if mesh is not None:
        return _decode_sharded(syms, nframes, eff, qdc, qac, dtype, mesh, tile_shards > 1)
    keys = _DEC_INTRA_KEYS if eff == 1 else _DEC_INTRA_KEYS + ("mv_diff",)
    up = {k: torch.from_numpy(syms[k]).to(dev) for k in keys}
    if eff == 1:
        out = decode_intra_frames(*(up[k] for k in _DEC_INTRA_KEYS), qdc, qac,
                                  table=COS_DEC, dtype=dtype)
    else:
        starts = np.arange(0, nframes, eff)
        pidx = starts[:, None] + np.arange(1, eff)[None, :]        # (G, P-1)
        valid = torch.from_numpy(pidx < nframes).to(dev)
        si = torch.from_numpy(starts).to(dev)
        pi = torch.from_numpy(np.minimum(pidx, nframes - 1)).to(dev)
        first, rest = decode_gop({k: up[k][si] for k in _DEC_INTRA_KEYS},
                                 {k: up[k][pi] for k in _DEC_INTER_KEYS}, qdc, qac,
                                 dtype=dtype, gop_frames=np.minimum(eff, nframes - starts))
        out = {}
        for k, v in first.items():
            plane = v.new_empty((nframes,) + v.shape[1:])
            plane[si] = v
            plane[pi[valid]] = rest[k][valid]
            out[k] = plane
    return {k: out[k].cpu().numpy() for k in ("y", "cb", "cr")}
