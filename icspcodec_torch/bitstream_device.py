"""Device-side entropy coding and bit packing, in plain torch.

The symbols stay on the device: frame_items_dev turns them into
per-frame (code, length) items, pack_frames_dev packs MSB-first bytes on
the device, and only the packed frames come to the host, where
assemble_frames splices them at bit granularity and applies the
reference's tail convention (pack_items, enc src:4849-4900).

Codes are int64 tensors here (right-aligned, at most 32 bits): torch's
uint32 lacks the shifts and comparisons this needs.
"""
from __future__ import annotations

import numpy as np
import torch


# ---------------------------------------------------------------------------
# VLC: the 13-category code of DCentropy (enc src:5417-5602)
# ---------------------------------------------------------------------------


def _pow2(e: torch.Tensor) -> torch.Tensor:
    return torch.bitwise_left_shift(torch.ones_like(e), e)


def vlc_encode_dev(values: torch.Tensor):
    """Elementwise VLC: (codes int64, lengths int32), code bits right-aligned.

    DOMAIN: |v| < 2**15 (codes of at most 32 bits); the codec's symbols are
    far inside it (the longest real code is 22 bits, a DC residual at QP 1).
    torch has no count-leading-zeros, so the exponent floor(log2(v)) comes
    from frexp of the float32 value, which is exact for integers below 2**24.
    """
    x = values.to(torch.int64)
    v = x.abs()
    sign = (x >= 0).to(torch.int64)
    exp = torch.frexp(v.clamp(min=1).to(torch.float32)).exponent.to(torch.int64) - 1
    exp = torch.where(v >= 2, exp, 0)
    payload = v - _pow2(exp)

    # categories exp 1..4: 3-bit prefix + sign + exp payload bits
    prefix_tab = torch.tensor([0, 0b011, 0b100, 0b101, 0b110] + [0] * 17,
                              dtype=torch.int64, device=v.device)
    pre = prefix_tab[exp]
    code_small = (((pre << 1) | sign) << exp) | payload
    len_small = 4 + exp
    # exp >= 5: (exp-2) ones, 0, sign, exp payload bits == 2*exp bits
    ones = (_pow2((exp - 2).clamp(min=0)) - 1) << 1
    code_big = (((ones << 1) | sign) << exp) | payload
    len_big = 2 * exp
    code1 = (0b010 << 1) | sign

    codes = torch.where(v == 0, 0, torch.where(
        v == 1, code1, torch.where(exp <= 4, code_small, code_big)))
    lengths = torch.where(v == 0, 2, torch.where(
        v == 1, 4, torch.where(exp <= 4, len_small, len_big)))
    return codes, lengths.to(torch.int32)


# ---------------------------------------------------------------------------
# frame item assembly: mirrors the host writer's frame_items
# ---------------------------------------------------------------------------


def _coeff_block_items(scan, acflag):
    """(..., 64) scan + (...,) acflag -> (..., 65) (codes, lengths): the DC
    code, the AC-empty flag bit, then 63 AC codes (one literal 0 bit each
    when the block's AC is empty, so the layout is static)."""
    dc_c, dc_l = vlc_encode_dev(scan[..., 0])
    ac_c, ac_l = vlc_encode_dev(scan[..., 1:])
    empty = (acflag == 1)[..., None]
    ac_c = torch.where(empty, 0, ac_c)
    ac_l = torch.where(empty, 1, ac_l)
    codes = torch.cat([dc_c[..., None], acflag.to(torch.int64)[..., None], ac_c], dim=-1)
    lengths = torch.cat([dc_l[..., None], torch.ones_like(dc_l)[..., None], ac_l], dim=-1)
    return codes, lengths


def _y_subblocks(arr, lead: int):
    """(..., gh, gw, *rest) -> (..., nmb, 4, *rest) in MB / sub-block order."""
    gh, gw = arr.shape[lead], arr.shape[lead + 1]
    head = arr.shape[:lead]
    rest = arr.shape[lead + 2:]
    x = arr.reshape(head + (gh // 2, 2, gw // 2, 2) + rest)
    x = x.movedim(lead + 2, lead + 1)
    return x.reshape(head + ((gh // 2) * (gw // 2), 4) + rest)


def frame_items_dev(syms: dict, is_intra: bool):
    """Frames' items, in bitstream order: (codes int64, lengths int32) of
    shape (F, N).  Per MB: for an intra frame, 4 luma sub-blocks of (mpm
    flag, mode bit, coefficient items); for an inter frame, the MV-mode bit
    and the two MV-difference VLCs (syms["mv_diff"], (F, mbh, mbw, 2)),
    then the 4 luma sub-blocks' coefficient items; then Cb, then Cr."""
    f = syms["y_scan"].shape[0]
    ysc = _y_subblocks(syms["y_scan"], 1)
    yac = _y_subblocks(syms["y_acflag"], 1)
    nmb = ysc.shape[1]
    yc, yl = _coeff_block_items(ysc, yac)
    dev = yl.device
    if is_intra:
        mpm = _y_subblocks(syms["mpm"], 1).to(torch.int64)
        bit = _y_subblocks(syms["mode_bit"], 1).to(torch.int64)
        yc = torch.cat([mpm[..., None], bit[..., None], yc], dim=3)
        yl = torch.cat([torch.ones((f, nmb, 4, 2), dtype=torch.int32, device=dev), yl], dim=3)
        head_c = torch.zeros((f, nmb, 0), dtype=torch.int64, device=dev)
        head_l = torch.zeros((f, nmb, 0), dtype=torch.int32, device=dev)
    else:
        mvd = syms["mv_diff"].reshape(f, nmb, 2)
        mvx_c, mvx_l = vlc_encode_dev(mvd[..., 0])
        mvy_c, mvy_l = vlc_encode_dev(mvd[..., 1])
        one = torch.ones((f, nmb), dtype=torch.int64, device=dev)
        head_c = torch.stack([one, mvx_c, mvy_c], dim=2)
        head_l = torch.stack([one.to(torch.int32), mvx_l, mvy_l], dim=2)
    cbc, cbl = _coeff_block_items(syms["cb_scan"].reshape(f, nmb, 64),
                                  syms["cb_acflag"].reshape(f, nmb))
    crc, crl = _coeff_block_items(syms["cr_scan"].reshape(f, nmb, 64),
                                  syms["cr_acflag"].reshape(f, nmb))
    all_c = torch.cat([head_c, yc.reshape(f, nmb, -1), cbc, crc], dim=2).reshape(f, -1)
    all_l = torch.cat([head_l, yl.reshape(f, nmb, -1), cbl, crl], dim=2).reshape(f, -1)
    return all_c, all_l


# ---------------------------------------------------------------------------
# bit packing
# ---------------------------------------------------------------------------


def pack_frames_dev(codes: torch.Tensor, lengths: torch.Tensor, maxbytes: int):
    """Pack per-frame items into MSB-first bytes.

    codes: (F, N) int64 right-aligned; lengths: (F, N) int32 >= 1.  Returns
    (packed (F, maxbytes) uint8, nbits (F,) int64); bits past a frame's end
    are zero.  Expand by prefix sum: mark each item's start bit, cumsum to
    find the item owning each bit position, gather (code, length, offset)
    there and extract the bit.  maxbytes * 8 must cover the largest frame:
    scatter_add_ takes only in-range indices.
    """
    f = codes.shape[0]
    nbits_pad = maxbytes * 8
    lengths = lengths.to(torch.int64)
    off = torch.cumsum(lengths, dim=1) - lengths            # exclusive
    nbits = off[:, -1] + lengths[:, -1]
    mark = torch.zeros((f, nbits_pad), dtype=torch.int32, device=codes.device)
    mark.scatter_add_(1, off, torch.ones_like(off, dtype=torch.int32))
    itemid = torch.cumsum(mark, dim=1, dtype=torch.int64) - 1

    o = torch.gather(off, 1, itemid)
    ln = torch.gather(lengths, 1, itemid)
    c = torch.gather(codes, 1, itemid)
    pos = torch.arange(nbits_pad, device=codes.device)[None, :]
    j = pos - o
    valid = (j >= 0) & (j < ln)
    shift = (ln - 1 - j).clamp(0, 63)
    bits = torch.where(valid, (c >> shift) & 1, 0)
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int64,
                           device=codes.device)
    packed = (bits.reshape(f, maxbytes, 8) * weights).sum(-1).to(torch.uint8)
    return packed, nbits


# ---------------------------------------------------------------------------
# host assembly: splice display-ordered packed frames at bit granularity
# ---------------------------------------------------------------------------


def assemble_frames(rows, nbits) -> bytes:
    """rows: iterable of (maxbytes,) uint8 numpy arrays (MSB-first packed,
    zero-padded), display order; nbits: matching bit counts.  Returns the
    reference byte stream: bits concatenated MSB-first, final partial byte
    moved to the LOW positions, one extra zero byte appended when the stream
    ends byte-aligned (pack_items convention, enc src:4849-4900)."""
    total = int(sum(int(b) for b in nbits))
    out = np.zeros(total // 8 + 2, np.uint8)
    bitpos = 0
    for row, nb in zip(rows, nbits):
        nb = int(nb)
        nbytes = (nb + 7) // 8
        src = np.asarray(row[:nbytes], np.uint8)
        base, k = bitpos >> 3, bitpos & 7
        if k == 0:
            out[base:base + nbytes] |= src
        else:
            out[base:base + nbytes] |= src >> k
            out[base + 1:base + 1 + nbytes] |= (src << (8 - k)).astype(np.uint8)
        bitpos += nb
    rem = total & 7
    nfull = total >> 3
    if rem == 0:
        return out[:nfull].tobytes() + b"\x00"
    tail = out[nfull] >> (8 - rem)  # partial byte: bits in LOW positions
    return out[:nfull].tobytes() + bytes([tail])
