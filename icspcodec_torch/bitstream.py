"""The host bitstream writer: vectorized numpy serialization (entropy="host").

A copy of the JAX package's bitstream.py, so that the port imports nothing
of that package; the bytes equal the device writer's (bitstream_device.py).

The reference emits bits one at a time through a byte-shift loop
(intraBody/interBody, enc src:4923-5236).  Rebuilt as whole-frame numpy
array ops: every bitstream item (flag bits, VLC codes, the 63 zero bits
of an empty AC block) becomes one (code, length) pair; the native packer
(runtime/vlcparse.c pack_items) concatenates them MSB-first.

Key equivalence used for the empty-AC case: when acflag==1 the reference
writes 63 literal zero bits -- exactly one '0' per AC coefficient -- so the
item structure per coefficient block is *constant* (DC, acflag, 63 AC
items) with AC item length 1 when acflag==1, making the whole frame
vectorizable with no data-dependent layout.
"""
from __future__ import annotations

import numpy as np

from .runtime import pack_items_native
from .tables import pack_header


def vlc_encode(values: np.ndarray):
    """Vectorized 13-category VLC (DCentropy enc src:5417-5602).

    Returns (codes uint64, lengths int64); code bits are right-aligned.
    """
    x = values.astype(np.int64)
    v = np.abs(x)
    sign = (x >= 0).astype(np.uint64)
    # exponent = floor(log2(v)) for v >= 2
    exp = np.zeros_like(v)
    nz = v > 0
    exp[nz] = np.floor(np.log2(v[nz])).astype(np.int64)
    payload = (v - (np.int64(1) << np.maximum(exp, 0))).astype(np.uint64)

    codes = np.zeros(x.shape, dtype=np.uint64)
    lengths = np.zeros(x.shape, dtype=np.int64)

    m = v == 0
    codes[m], lengths[m] = 0, 2

    m = v == 1
    codes[m] = (np.uint64(0b010) << np.uint64(1)) | sign[m]
    lengths[m] = 4

    prefix_small = {1: 0b011, 2: 0b100, 3: 0b101, 4: 0b110}
    for e, p in prefix_small.items():
        m = (v >= 2) & (exp == e)
        codes[m] = (
            ((np.uint64(p) << np.uint64(1)) | sign[m]) << np.uint64(e)
        ) | payload[m]
        lengths[m] = 3 + 1 + e

    m = exp >= 5
    if m.any():
        e = exp[m].astype(np.uint64)
        ones = ((np.uint64(1) << (e - np.uint64(2))) - np.uint64(1)) << np.uint64(1)
        codes[m] = (((ones << np.uint64(1)) | sign[m]) << e) | payload[m]
        lengths[m] = 2 * exp[m]
    return codes, lengths


def pack_items(codes: np.ndarray, lengths: np.ndarray) -> bytes:
    """Concatenate right-aligned codes MSB-first into the reference's byte
    stream: the final partial byte keeps its bits in the LOW positions and
    one extra zero byte is appended when the stream ends byte-aligned.
    The native packer (runtime/vlcparse.c); item lengths must be <= 56
    bits."""
    return pack_items_native(codes, lengths)


# ---------------------------------------------------------------------------
# frame item assembly
# ---------------------------------------------------------------------------


def _coeff_block_items(scan: np.ndarray, acflag: np.ndarray):
    """(..., 64) scan + (...,) acflag -> (..., 65) (codes, lengths) items:
    DC VLC, acflag bit, 63 AC items (1 zero bit each when acflag==1)."""
    dc_c, dc_l = vlc_encode(scan[..., 0])
    ac_c, ac_l = vlc_encode(scan[..., 1:])
    flag = acflag.astype(np.uint64)
    empty = (acflag == 1)[..., None]
    ac_c = np.where(empty, np.uint64(0), ac_c)
    ac_l = np.where(empty, 1, ac_l)
    codes = np.concatenate([dc_c[..., None], flag[..., None], ac_c], axis=-1)
    lengths = np.concatenate(
        [dc_l[..., None], np.ones(flag.shape + (1,), np.int64), ac_l], axis=-1
    )
    return codes, lengths


def _y_subblocks(arr: np.ndarray, lead: int):
    """(..., gh, gw, *rest) -> (..., nmb, 4, *rest) in MB/sub-block order."""
    gh, gw = arr.shape[lead], arr.shape[lead + 1]
    head = arr.shape[:lead]
    rest = arr.shape[lead + 2:]
    x = arr.reshape(head + (gh // 2, 2, gw // 2, 2) + rest)
    x = np.moveaxis(x, lead + 2, lead + 1)  # (..., mbh, mbw, sy, sx, *rest)
    return x.reshape(head + ((gh // 2) * (gw // 2), 4) + rest)


def frame_items(syms: dict, is_intra: bool):
    """Build (codes, lengths) item arrays for a *batch* of frames.

    syms fields carry a leading frame axis F: y_scan (F,gh,gw,64),
    y_acflag/mpm/mode_bit (F,gh,gw), cb/cr_scan (F,mbh,mbw,64) + acflags,
    mv_diff (F,mbh,mbw,2).  Returns (codes, lengths) of shape (F, nitems)
    -- nitems is constant per frame type, so batching is a pure reshape.
    """
    f = syms["y_scan"].shape[0]
    ysc = _y_subblocks(syms["y_scan"], 1)        # (F, nmb, 4, 64)
    yac = _y_subblocks(syms["y_acflag"], 1)      # (F, nmb, 4)
    nmb = ysc.shape[1]
    yc, yl = _coeff_block_items(ysc, yac)        # (F, nmb, 4, 65)

    if is_intra:
        mpm = _y_subblocks(syms["mpm"], 1).astype(np.uint64)
        bit = _y_subblocks(syms["mode_bit"], 1).astype(np.uint64)
        yc = np.concatenate([mpm[..., None], bit[..., None], yc], axis=3)
        yl = np.concatenate([np.ones((f, nmb, 4, 2), np.int64), yl], axis=3)
        head_c = np.zeros((f, nmb, 0), np.uint64)
        head_l = np.zeros((f, nmb, 0), np.int64)
    else:
        mvd = syms["mv_diff"].reshape(f, nmb, 2)
        mvx_c, mvx_l = vlc_encode(mvd[..., 0])
        mvy_c, mvy_l = vlc_encode(mvd[..., 1])
        one = np.ones((f, nmb), np.uint64)
        head_c = np.stack([one, mvx_c, mvy_c], axis=2)
        head_l = np.stack([np.ones((f, nmb), np.int64), mvx_l, mvy_l], axis=2)

    cbc, cbl = _coeff_block_items(
        syms["cb_scan"].reshape(f, nmb, 64), syms["cb_acflag"].reshape(f, nmb)
    )
    crc, crl = _coeff_block_items(
        syms["cr_scan"].reshape(f, nmb, 64), syms["cr_acflag"].reshape(f, nmb)
    )
    all_c = np.concatenate(
        [head_c, yc.reshape(f, nmb, -1), cbc, crc], axis=2
    ).reshape(f, -1)
    all_l = np.concatenate(
        [head_l, yl.reshape(f, nmb, -1), cbl, crl], axis=2
    ).reshape(f, -1)
    return all_c, all_l


def frame_rows(intra_syms, intra_idx, inter_syms, inter_idx, nframes: int):
    """Per-frame item rows in display order: (codes, lengths), two lists of
    nframes 1-D arrays, from batched symbol groups (intra frames and inter
    frames, either None) and the display index of each of their frames."""
    rows_c: list = [None] * nframes
    rows_l: list = [None] * nframes
    for syms, idx, is_intra in ((intra_syms, intra_idx, True), (inter_syms, inter_idx, False)):
        if syms is None:
            continue
        c, l = frame_items(syms, is_intra)
        for j, n in enumerate(np.asarray(idx)):
            rows_c[int(n)], rows_l[int(n)] = c[j], l[j]
    return rows_c, rows_l


def write_bitstream_grouped(
    intra_syms: dict | None,
    intra_idx: np.ndarray | None,
    inter_syms: dict | None,
    inter_idx: np.ndarray | None,
    nframes: int,
    height: int,
    width: int,
    qdc: int,
    qac: int,
    period: int,
) -> bytes:
    """Serialize from batched symbol groups (intra frames + inter frames)
    interleaved into display order by their frame indices."""
    rows_c, rows_l = frame_rows(intra_syms, intra_idx, inter_syms, inter_idx, nframes)
    body = pack_items(np.concatenate(rows_c), np.concatenate(rows_l))
    return pack_header(height, width, qdc, qac, period) + body
