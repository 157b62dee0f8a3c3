"""The plain reference over a whole clip, spread over the host's cores.

Drives the frozen oracle (oracle.py) frame by frame in all-intra clips and
GOP by GOP in clips with P-frames: both are independent units, so each is
one job of a pool of worker processes.  A job encodes its frames, writes
their bits with the oracle's own writer (one BitWriter per job, without
the header or the final byte's convention), and optionally decodes its
frames back from the symbols it wrote.  The parent joins the jobs' bits
in display order and ends the stream as the reference's writer does: the
final partial byte keeps its bits in the LOW positions, and a byte-aligned
stream gets one extra zero byte (oracle.BitWriter.tobytes).  The pool's
processes, and the resource tracker that multiprocessing starts beside a
spawn pool, have ended when encode_clip returns.

It imports nothing of the program, of the JAX package or of JAX.
"""
from __future__ import annotations

import gc
import multiprocessing
import os

import numpy as np

from . import oracle


def _units(nframes: int, period: int) -> list[tuple[int, int]]:
    """(first frame, frame count) of each independent unit: every frame of
    an all-intra clip, every closed GOP of a clip with P-frames."""
    eff = 1 if period == 0 else period
    return [(s, min(eff, nframes - s)) for s in range(0, nframes, eff)]


def _job(args):
    y, cb, cr, qdc, qac, period, decode = args
    frames = [(y[i], cb[i], cr[i]) for i in range(y.shape[0])]
    recons, syms = oracle.encode_sequence(frames, qdc, qac, period)
    bw = oracle.BitWriter()
    h, w = y.shape[1:]
    mbw = w // 16
    for sym in syms:
        for mb in range((h // 16) * mbw):
            by, bx = divmod(mb, mbw)
            if not sym.is_intra:
                bw.put(1)
                bw.extend(oracle.vlc_bits(int(sym.mv_diff[by, bx, 0])))
                bw.extend(oracle.vlc_bits(int(sym.mv_diff[by, bx, 1])))
            for k in range(4):
                gy, gx = 2 * by + k // 2, 2 * bx + k % 2
                if sym.is_intra:
                    bw.put(int(sym.mpm_flag[gy, gx]))
                    bw.put(int(sym.mode_bit[gy, gx]))
                oracle._write_coeff_block(bw, sym.y_scan[gy, gx], int(sym.y_acflag[gy, gx]))
            oracle._write_coeff_block(bw, sym.cb_scan[by, bx], int(sym.cb_acflag[by, bx]))
            oracle._write_coeff_block(bw, sym.cr_scan[by, bx], int(sym.cr_acflag[by, bx]))
    bits = np.asarray(bw.bits, np.uint8)
    # the values that enter the inverse transforms: the dequantized blocks
    # that are nonzero, the DCs rebuilt through the inverse DC chain
    nonzero = 0
    for sym in syms:
        nonzero += int(np.count_nonzero(oracle._decode_dc_chain(sym.y_scan, qdc, qac,
                                                                sym.y_scan.shape[1], True)))
        for scan in (sym.cb_scan, sym.cr_scan):
            nonzero += int(np.count_nonzero(oracle._decode_dc_chain(scan, qdc, qac,
                                                                    scan.shape[1], False)))
    out = dict(bits=np.packbits(bits), nbits=int(bits.size), nonzero=nonzero,
               recon={k: np.stack([getattr(r, k) for r in recons]) for k in ("y", "cb", "cr")})
    if decode:
        dec = []
        for sym in syms:
            if sym.is_intra:
                dec.append(oracle.decode_frame_intra(sym, qdc, qac, h, w))
            else:
                dec.append(oracle.decode_frame_inter(sym, dec[-1], qdc, qac, h, w))
        out["decoded"] = {k: np.stack([getattr(r, k) for r in dec]) for k in ("y", "cb", "cr")}
    return out


def stop_resource_tracker() -> None:
    """Ends the resource tracker that a spawn pool starts as a child of this
    process, and waits for it.  It ignores SIGTERM and ends only when the
    last copy of its pipe closes, so on Pythons without cpython gh-88887's
    fix (3.12.3 among them) it outlives the process that started it."""
    from multiprocessing import resource_tracker

    tracker = resource_tracker._resource_tracker
    stop = getattr(tracker, "_stop", None)
    if stop is not None:
        stop()
        return
    if tracker._fd is not None:
        os.close(tracker._fd)
        tracker._fd = None
    if tracker._pid is not None:
        os.waitpid(tracker._pid, 0)
        tracker._pid = None


def stream_bytes(bit_parts: list[tuple[np.ndarray, int]]) -> bytes:
    """The body of a stream from its units' packed bits, in order: the bits
    joined, then oracle.BitWriter.tobytes' ending."""
    bits = np.concatenate([np.unpackbits(p)[:n] for p, n in bit_parts])
    n = bits.size
    full = n // 8
    out = np.zeros(full + 1, np.uint8)
    out[:full] = np.packbits(bits[:full * 8])
    acc = 0
    for bit in bits[full * 8:]:
        acc = ((acc << 1) | int(bit)) & 0xFF
    out[full] = acc
    return out.tobytes()


def encode_clip(y, cb, cr, qdc: int, qac: int, period: int, decode: bool = False,
                workers: int | None = None) -> dict:
    """The reference's encode of a clip (F, H, W) / (F, H/2, W/2) uint8:
    dict(stream=bytes with the header, recon=dict of (F, ...) planes,
    nonzero=the nonzero dequantized values of every block, and, with
    `decode`, decoded=the planes a decoder gives from the stream's
    symbols).  Jobs run in a pool of `workers` processes (os.cpu_count()
    by default; 1 runs them in this process)."""
    units = _units(y.shape[0], period)
    jobs = [(y[s:s + n], cb[s:s + n], cr[s:s + n], qdc, qac, period, decode) for s, n in units]
    workers = min(workers or os.cpu_count() or 1, len(jobs))
    if workers == 1:
        parts = [_job(j) for j in jobs]
    else:
        pool = multiprocessing.get_context("spawn").Pool(workers)
        try:
            parts = pool.map(_job, jobs, chunksize=1)
        finally:
            pool.close()
            pool.join()
            pool.terminate()    # runs the pool's finalizer, which holds its queues until exit
            del pool
            gc.collect()        # the queues' semaphores unlinked while the tracker runs
            stop_resource_tracker()
    h, w = y.shape[1:]
    out = dict(stream=oracle.pack_header(h, w, qdc, qac, period)
               + stream_bytes([(p["bits"], p["nbits"]) for p in parts]),
               nonzero=sum(p["nonzero"] for p in parts))
    for key in ("recon", "decoded") if decode else ("recon",):
        out[key] = {k: np.concatenate([p[key][k] for p in parts]) for k in ("y", "cb", "cr")}
    return out
