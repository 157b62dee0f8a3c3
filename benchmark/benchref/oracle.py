"""Pure-NumPy behavioral oracle of the reference codec: the benchmark's
plain reference.

A frozen copy of icspcodec_torch/oracle.py (itself a copy of the JAX
package's oracle), kept here so that the yardstick does not move when the
program does; it imports nothing of either package.  It
reproduces the reference C++ encoder and decoder bit-for-bit (the
repository's oracle tests hold the original against the compiled binaries
and the C++ hashes; benchmark/tests holds this copy against the program on
the CPU), including every rounding quirk:

* forward DCT in double arithmetic with float-rounded cosine constants
  (encoder regime) vs. double constants (decoder regime) -- constants.py
* luma quantization ``(int)(v+0.5)/Q``: truncation toward zero, then C
  integer division (enc src:2780); chroma uses ``(int)floor(v+0.5)/Q``
  (enc src:4642)
* DC-mode intra prediction value ``(L+U)/16`` kept in double, residual and
  reconstruction truncated toward zero (enc src:644-850)
* replicate padding with the reference's off-by-one: 16 (8 chroma) rows/cols
  of replication on top/left but only 15 (7) on bottom/right, the final row
  and column staying zero (getPaddingImage, enc src:2227-2269)
* spiral motion search with first-strict-minimum selection and the
  second-zero-SAD early-exit (enc src:2112-2145)
* MV prediction median with the ``(y1>x3)`` typo (enc src:2399/2418/2472/2491)
* MSB-first bit packing whose final partial byte keeps its bits in the LOW
  bit positions, plus one extra zero byte when the stream ends byte-aligned
  (allintraBody/interBody fwrite ``cntbits/8+1``)

It is intentionally written in clear vectorized NumPy with unified
neighbor-topology rules (derived from the reference's 16-way switch blocks)
rather than a transliteration; the unified rules are what the engines
implement too.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .constants import COS_DEC, COS_ENC, IRT2, IZIGZAG, SPIRAL, ZIGZAG

# ---------------------------------------------------------------------------
# small helpers: exact C arithmetic
# ---------------------------------------------------------------------------


def c_trunc(x: np.ndarray) -> np.ndarray:
    """(int)double_value — truncation toward zero."""
    return np.trunc(x).astype(np.int64)


def c_div(a: np.ndarray, q: int) -> np.ndarray:
    """C integer division (truncates toward zero), a int64."""
    a = np.asarray(a, dtype=np.int64)
    return np.sign(a) * (np.abs(a) // q)


def c_median3(a, b, c):
    """The reference's 3-way median (used for DC and mode predictors).

    ``if a>b and a>c: max(b,c) elif b>a and b>c: max(a,c) else: max(a,b)``
    — a true median, order independent.
    """
    a, b, c = (np.asarray(v, dtype=np.int64) for v in (a, b, c))
    m1 = np.maximum(b, c)
    m2 = np.maximum(a, c)
    m3 = np.maximum(a, b)
    return np.where((a > b) & (a > c), m1, np.where((b > a) & (b > c), m2, m3))


def c_median3_mv_y(y1, y2, y3, x3):
    """MV y-component median with the reference's typo: the middle branch
    compares y1 against *x3* (mvPrediction enc src:2399/2418)."""
    y1, y2, y3, x3 = (np.asarray(v, dtype=np.int64) for v in (y1, y2, y3, x3))
    m1 = np.maximum(y2, y3)
    m2 = np.where(y1 > x3, y1, y3)
    m3 = np.maximum(y1, y2)
    return np.where((y1 > y2) & (y1 > y3), m1, np.where((y2 > y1) & (y2 > y3), m2, m3))


# ---------------------------------------------------------------------------
# transforms (batched over leading axes, exact C summation order)
# ---------------------------------------------------------------------------


def fdct(err: np.ndarray, table: np.ndarray = COS_ENC) -> np.ndarray:
    """Forward 8x8 DCT, DCT_block (enc src:2685-2749).

    err: (..., 8, 8) integer residuals.  Double arithmetic throughout,
    accumulation order x=0..7 then y=0..7 as in the C loops, then row/col 0
    scaled by 1/sqrt(2) ([0][0] twice) and everything by 1/4.
    """
    e = err.astype(np.float64)
    # temp[v,u] = sum_x e[v,x] * ct[u,x]
    t1 = np.zeros_like(e)
    for x in range(8):
        t1 = t1 + e[..., :, x, None] * table[None, :, x]
    # out[v,u] = sum_y t1[y,u] * ct[v,y]
    out = np.zeros_like(e)
    for y in range(8):
        out = out + t1[..., y, None, :] * table[:, y][:, None]
    out = out.copy()
    out[..., 0, :] = out[..., 0, :] * IRT2
    out[..., :, 0] = out[..., :, 0] * IRT2
    return out * 0.25


def idct(iq: np.ndarray, table: np.ndarray) -> np.ndarray:
    """Inverse 8x8 DCT, IDCT_block (enc src:2825-2893 / dec src:3331-3445).

    iq: (..., 8, 8) dequantized integers.  Per-term order is
    ``Cu[u] * (double)iq[y][u] * ct[u][x]`` — the Cu weight multiplies the
    coefficient *before* the cosine.
    """
    q = iq.astype(np.float64)
    cu = np.ones(8)
    cu[0] = IRT2
    m = q * cu[None, :]  # Cu[u] * iq[y][u]
    t1 = np.zeros_like(q)
    for u in range(8):
        t1 = t1 + m[..., :, u, None] * table[None, u, :]
    n = t1 * cu[..., :, None]  # Cv[v] * temp[v][x]
    out = np.zeros_like(q)
    for v in range(8):
        out = out + n[..., v, None, :] * table[v][:, None]
    return out * 0.25


def quant_luma(dct: np.ndarray, qdc: int, qac: int):
    """(int)(v+0.5)/Q with truncation, Quantization_block enc src:2750-2796."""
    t = c_trunc(dct + 0.5)
    q = c_div(t, qac)
    q[..., 0, 0] = c_div(t[..., 0, 0], qdc)
    return q


def quant_chroma(dct: np.ndarray, qdc: int, qac: int):
    """(int)floor(v+0.5)/Q, CQuantization_block enc src:4610-4656."""
    t = np.floor(dct + 0.5).astype(np.int64)
    q = c_div(t, qac)
    q[..., 0, 0] = c_div(t[..., 0, 0], qdc)
    return q


def dequant(q: np.ndarray, qdc: int, qac: int):
    iq = q * qac
    iq[..., 0, 0] = q[..., 0, 0] * qdc
    return iq


def ac_flag(q: np.ndarray) -> np.ndarray:
    """1 iff all 63 AC coefficients are zero (enc src:2784-2792)."""
    flat = q.reshape(q.shape[:-2] + (64,))
    return (np.count_nonzero(flat[..., 1:], axis=-1) == 0).astype(np.int32)


def zigzag(q: np.ndarray) -> np.ndarray:
    """(..., 8, 8) -> (..., 64) in the reference scan order."""
    return q.reshape(q.shape[:-2] + (64,))[..., ZIGZAG]


def izigzag(scan: np.ndarray) -> np.ndarray:
    return scan[..., IZIGZAG].reshape(scan.shape[:-1] + (8, 8))


# ---------------------------------------------------------------------------
# padding (getPaddingImage, enc src:2227-2269)
# ---------------------------------------------------------------------------


def pad_image(img: np.ndarray, padlen: int) -> np.ndarray:
    """Replicate-pad with the reference quirk: bottom/right replication is
    one short (padlen-1 rows/cols) and the final padded row+column are 0."""
    h, w = img.shape
    out = np.zeros((h + 2 * padlen, w + 2 * padlen), dtype=img.dtype)
    out[padlen:padlen + h, padlen:padlen + w] = img
    out[:padlen, padlen:padlen + w] = img[0]
    out[padlen + h - 1:padlen + h - 1 + padlen, padlen:padlen + w] = img[-1]
    out[padlen:padlen + h, :padlen] = img[:, :1]
    out[padlen:padlen + h, w + padlen - 1:w + 2 * padlen - 1] = img[:, -1:]
    # corners
    out[:padlen, :padlen] = img[0, 0]
    out[:padlen, w + padlen - 1:w + 2 * padlen - 1] = img[0, -1]
    out[padlen + h - 1:padlen + h - 1 + padlen, :padlen] = img[-1, 0]
    out[padlen + h - 1:padlen + h - 1 + padlen, w + padlen - 1:w + 2 * padlen - 1] = img[-1, -1]
    # final row / column remain zero (indices h+2p-1 and w+2p-1)
    out[-1, :] = 0
    out[:, -1] = 0
    return out


# ---------------------------------------------------------------------------
# block <-> plane views
# ---------------------------------------------------------------------------


def to_blocks8(plane: np.ndarray) -> np.ndarray:
    """(H, W) -> (H//8, W//8, 8, 8)"""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)


def from_blocks8(blocks: np.ndarray) -> np.ndarray:
    gh, gw = blocks.shape[:2]
    return blocks.transpose(0, 2, 1, 3).reshape(gh * 8, gw * 8)


def to_blocks16(plane: np.ndarray) -> np.ndarray:
    h, w = plane.shape
    return plane.reshape(h // 16, 16, w // 16, 16).transpose(0, 2, 1, 3)


# ---------------------------------------------------------------------------
# neighbor topology on the global 8x8-block grid
# ---------------------------------------------------------------------------
# Sub-block k of macroblock (by, bx) sits at global block (gy, gx) =
# (2*by + k//2, 2*bx + k%2).  The reference's 16-way switch blocks reduce to:
#   * availability: upper neighbor exists iff gy>0, left iff gx>0
#   * intra-mode MPM context: both>0 -> median(left, upper-left, upper);
#     single neighbor -> that neighbor's mode; block (0,0) forced DC.
#   * DC predictor: (0,0) -> 1024; gy==0 -> left; gx==0 -> upper; else for
#     sub positions 3 (gy&gx odd) -> median(l,ul,u); sub 1 (gx odd, gy even)
#     at the right grid edge -> median(l,ul,u); everything else ->
#     median(l,u,ur).   (DPCM_DC_block enc src:3643-3990)


def dc_neighbor_kind(gy: int, gx: int, grid_w: int) -> str:
    if gy == 0 and gx == 0:
        return "const1024"
    if gy == 0:
        return "left"
    if gx == 0:
        return "upper"
    odd_y, odd_x = gy % 2 == 1, gx % 2 == 1
    if odd_y and odd_x:
        return "l_ul_u"
    if (not odd_y) and odd_x and gx == grid_w - 1:
        return "l_ul_u"
    return "l_u_ur"


# ---------------------------------------------------------------------------
# VLC (DCentropy/ACentropy/MVentropy, enc src:5417-6334)
# ---------------------------------------------------------------------------


def vlc_bits(val: int) -> list[int]:
    sign = 1 if val >= 0 else 0
    v = abs(int(val))
    if v == 0:
        return [0, 0]
    if v == 1:
        return [0, 1, 0, sign]
    exp = v.bit_length() - 1
    payload = v - (1 << exp)
    pl = [(payload >> (exp - 1 - i)) & 1 for i in range(exp)]
    if exp == 1:
        return [0, 1, 1, sign] + pl
    if exp == 2:
        return [1, 0, 0, sign] + pl
    if exp == 3:
        return [1, 0, 1, sign] + pl
    if exp == 4:
        return [1, 1, 0, sign] + pl
    return [1] * (exp - 2) + [0, sign] + pl


class BitWriter:
    """MSB-first bit packer replicating the reference's byte-shift scheme."""

    def __init__(self):
        self.bits: list[int] = []

    def put(self, bit: int):
        self.bits.append(bit)

    def extend(self, bits):
        self.bits.extend(bits)

    def tobytes(self) -> bytes:
        """fwrite(frame, cntbits/8 + 1, 1, fp): the final partial byte keeps
        its bits in the LOW positions; one extra zero byte if aligned."""
        n = len(self.bits)
        nbytes = n // 8 + 1
        arr = np.zeros(nbytes, dtype=np.uint8)
        full = n // 8
        if full:
            b = np.array(self.bits[: full * 8], dtype=np.uint8).reshape(full, 8)
            arr[:full] = (b << np.arange(7, -1, -1, dtype=np.uint8)).sum(axis=1)
        rem = self.bits[full * 8:]
        acc = 0
        for bit in rem:
            acc = ((acc << 1) | bit) & 0xFF
        if full < nbytes:
            arr[full] = acc
        return arr.tobytes()


class BitReader:
    def __init__(self, data: bytes):
        self.arr = np.unpackbits(np.frombuffer(data, dtype=np.uint8))
        self.pos = 0

    def get(self) -> int:
        b = int(self.arr[self.pos])
        self.pos += 1
        return b

    def read_vlc(self) -> int:
        """Prefix-decode one symbol of the category code."""
        a = self.arr
        p = self.pos
        if a[p] == 0:
            if a[p + 1] == 0:
                self.pos = p + 2
                return 0
            # 01x
            if a[p + 2] == 0:  # 010 s
                sign = int(a[p + 3])
                self.pos = p + 4
                return 1 if sign else -1
            exp = 1  # 011
            p += 3
        else:
            ones = 0
            while a[p + ones] == 1:
                ones += 1
            if ones == 1:  # 10x -> exp 2 or 3
                exp = 2 + int(a[p + 2])
                p += 3
            elif ones == 2:  # 110 -> exp 4
                exp = 4
                p += 3
            else:  # exp = ones + 2 >= 5
                exp = ones + 2
                p += ones + 1
        sign = int(a[p])
        p += 1
        payload = 0
        for _ in range(exp):
            payload = (payload << 1) | int(a[p])
            p += 1
        self.pos = p
        v = (1 << exp) + payload
        return v if sign else -v


# ---------------------------------------------------------------------------
# header (headerinit, enc src:4901-4922; struct header enc hdr:201-212)
# ---------------------------------------------------------------------------


def pack_header(height: int, width: int, qdc: int, qac: int, period: int) -> bytes:
    out = bytearray()
    out += bytes([0, 73, 67, 83, 80])  # "\0ICSP"
    out += int(height).to_bytes(2, "little")
    out += int(width).to_bytes(2, "little")
    out += bytes([qdc, qac, 0])  # QP_DC, QP_AC, DPCMmode
    outro = 0
    for i in range(6):
        outro = (outro << 1) | ((period >> (5 - i)) & 1)
    outro <<= 7  # intraPred flag 0 + 6 zero bits
    out += int(outro).to_bytes(2, "little")
    return bytes(out)


def parse_header(data: bytes):
    """Parse the 14-byte header (readHeader, dec src:14-37).

    Raises ValueError (not assert — asserts vanish under -O) on a short
    or wrong-magic header."""
    if len(data) < 14:
        raise ValueError(f"bitstream header needs 14 bytes, got {len(data)}")
    if data[:5] != bytes([0, 73, 67, 83, 80]):
        raise ValueError("bad bitstream magic (expected \\0ICSP)")
    height = int.from_bytes(data[5:7], "little")
    width = int.from_bytes(data[7:9], "little")
    qdc, qac = data[9], data[10]
    outro = int.from_bytes(data[12:14], "little")
    period = (outro & 0x1F80) >> 7
    if height <= 0 or width <= 0 or height % 16 or width % 16:
        raise ValueError(f"corrupt header: dimensions {width}x{height}")
    if qdc < 1 or qac < 1:
        raise ValueError(f"corrupt header: QP {qdc}/{qac}")
    return height, width, qdc, qac, period


# ---------------------------------------------------------------------------
# encoder frame state
# ---------------------------------------------------------------------------


@dataclass
class FrameSymbols:
    """Everything the bitstream writer needs for one frame."""

    is_intra: bool
    # luma, global 8x8 grid (gh, gw)
    mpm_flag: np.ndarray | None = None    # (gh, gw) int
    mode_bit: np.ndarray | None = None    # (gh, gw) int
    y_scan: np.ndarray = None             # (gh, gw, 64) zigzagged quant
    y_acflag: np.ndarray = None           # (gh, gw)
    cb_scan: np.ndarray = None            # (ch, cw, 64)
    cb_acflag: np.ndarray = None
    cr_scan: np.ndarray = None
    cr_acflag: np.ndarray = None
    mv_diff: np.ndarray | None = None     # (mbh, mbw, 2) differential (x, y)


@dataclass
class Recon:
    y: np.ndarray
    cb: np.ndarray
    cr: np.ndarray


# ---------------------------------------------------------------------------
# intra luma: sequential wavefront over the global 8x8 grid
# ---------------------------------------------------------------------------


def encode_intra_luma(y_plane: np.ndarray, qdc: int, qac: int):
    """DPCM_pix_block + transform chain + IDPCM_pix_block, raster order.

    Returns (recon_plane u8, FrameSymbols fields for luma)."""
    h, w = y_plane.shape
    gh, gw = h // 8, w // 8
    orig = to_blocks8(y_plane).astype(np.int64)

    recon = np.zeros((gh, gw, 8, 8), dtype=np.int64)
    modes = np.zeros((gh, gw), dtype=np.int64)
    dq_dc = np.zeros((gh, gw), dtype=np.int64)
    mpm = np.zeros((gh, gw), dtype=np.int64)
    mode_bit = np.zeros((gh, gw), dtype=np.int64)
    scan = np.zeros((gh, gw, 64), dtype=np.int64)
    acfl = np.zeros((gh, gw), dtype=np.int64)

    for mb in range((gh // 2) * (gw // 2)):
        by, bx = divmod(mb, gw // 2)
        for k in range(4):
            gy, gx = 2 * by + k // 2, 2 * bx + k % 2
            cur = orig[gy, gx]
            has_up, has_left = gy > 0, gx > 0
            up_row = recon[gy - 1, gx, 7, :] if has_up else None
            left_col = recon[gy, gx - 1, :, 7] if has_left else None

            # --- mode search (DPCM_pix_block) ---
            # candidate residuals + SAE
            if has_up:
                e0 = cur - up_row[None, :]
                sae0 = int(np.abs(e0).sum())
            if has_left:
                e1 = cur - left_col[:, None]
                sae1 = int(np.abs(e1).sum())
            lsum = int(left_col.sum()) if has_left else 1024
            usum = int(up_row.sum()) if has_up else 1024
            # err = (int)(cur - (L+U)/16): exact as trunc of (16*cur-(L+U))/16
            d16 = 16 * cur - (lsum + usum)
            e2 = np.sign(d16) * (np.abs(d16) // 16)
            sae2 = int(np.abs(e2).sum())

            if not has_up and not has_left:
                mode, err = 2, e2  # first block: forced DC
            elif has_up and has_left:
                m = min(sae0, sae1, sae2)
                if m == sae0:
                    mode, err = 0, e0
                elif m == sae1:
                    mode, err = 1, e1
                else:
                    mode, err = 2, e2
            elif has_left:  # first grid row: modes {1, 2}, tie -> 2
                mode, err = (1, e1) if sae2 > sae1 else (2, e2)
            else:  # first grid column: modes {0, 2}, tie -> 2
                mode, err = (0, e0) if sae2 > sae0 else (2, e2)

            # --- MPM flag / remainder bit ---
            if not has_up and not has_left:
                mpm[gy, gx], mode_bit[gy, gx] = 0, 0
            else:
                if has_up and has_left:
                    pred = int(
                        c_median3(modes[gy, gx - 1], modes[gy - 1, gx - 1], modes[gy - 1, gx])
                    )
                elif has_left:
                    pred = int(modes[gy, gx - 1])
                else:
                    pred = int(modes[gy - 1, gx])
                if mode == pred:
                    mpm[gy, gx], mode_bit[gy, gx] = 1, 0
                else:
                    rem = sorted({0, 1, 2} - {pred})
                    mpm[gy, gx], mode_bit[gy, gx] = 0, rem.index(mode)
            modes[gy, gx] = mode

            # --- transform chain ---
            d = fdct(err, COS_ENC)
            # DC DPCM (transform domain, dequantized-neighbor predictors)
            kind = dc_neighbor_kind(gy, gx, gw)
            if kind == "const1024":
                dc_pred = 1024
            elif kind == "left":
                dc_pred = int(dq_dc[gy, gx - 1])
            elif kind == "upper":
                dc_pred = int(dq_dc[gy - 1, gx])
            elif kind == "l_ul_u":
                dc_pred = int(
                    c_median3(dq_dc[gy, gx - 1], dq_dc[gy - 1, gx - 1], dq_dc[gy - 1, gx])
                )
            else:
                dc_pred = int(
                    c_median3(dq_dc[gy, gx - 1], dq_dc[gy - 1, gx], dq_dc[gy - 1, gx + 1])
                )
            d[0, 0] -= dc_pred
            q = quant_luma(d, qdc, qac)
            scan[gy, gx] = zigzag(q)
            acfl[gy, gx] = ac_flag(q)
            iq = dequant(q, qdc, qac)
            iq[0, 0] += dc_pred
            dq_dc[gy, gx] = iq[0, 0]
            r = idct(iq, COS_ENC)

            # --- pixel reconstruction (IDPCM_pix_*) ---
            if mode == 0:
                pred = up_row[None, :] if has_up else np.full((8, 8), 128)
                rec = c_trunc(r + pred)
            elif mode == 1:
                pred = left_col[:, None] if has_left else np.full((8, 8), 128)
                rec = c_trunc(r + pred)
            else:
                pv = (lsum + usum) / 16.0
                rec = c_trunc(r + pv)
            recon[gy, gx] = np.clip(rec, 0, 255)

    return (
        from_blocks8(recon).astype(np.uint8),
        dict(mpm_flag=mpm, mode_bit=mode_bit, y_scan=scan, y_acflag=acfl),
    )


# ---------------------------------------------------------------------------
# chroma (intra and inter share the transform/DC chain; flat 8x8 grid)
# ---------------------------------------------------------------------------


def encode_chroma_plane(err_blocks: np.ndarray, qdc: int, qac: int):
    """CDCT -> CDPCM_DC -> CQuant -> zigzag -> dequant -> CIDPCM -> CIDCT.

    err_blocks: (ch, cw, 8, 8) int (raw pixels for intra, residuals for
    inter).  Returns (idct float64 blocks, scan, acflag)."""
    ch, cw = err_blocks.shape[:2]
    d = fdct(err_blocks, COS_ENC)
    scan = np.zeros((ch, cw, 64), dtype=np.int64)
    acfl = np.zeros((ch, cw), dtype=np.int64)
    dq_dc = np.zeros((ch, cw), dtype=np.int64)
    iq_all = np.zeros((ch, cw, 8, 8), dtype=np.int64)
    for gy in range(ch):
        for gx in range(cw):
            blk = d[gy, gx].copy()
            if gy == 0 and gx == 0:
                pred = 1024
            elif gy == 0:
                pred = int(dq_dc[gy, gx - 1])
            elif gx == 0:
                pred = int(dq_dc[gy - 1, gx])
            elif gx == cw - 1:
                pred = int(c_median3(dq_dc[gy, gx - 1], dq_dc[gy - 1, gx - 1], dq_dc[gy - 1, gx]))
            else:
                pred = int(c_median3(dq_dc[gy, gx - 1], dq_dc[gy - 1, gx], dq_dc[gy - 1, gx + 1]))
            blk[0, 0] -= pred
            q = quant_chroma(blk, qdc, qac)
            scan[gy, gx] = zigzag(q)
            acfl[gy, gx] = ac_flag(q)
            iq = dequant(q, qdc, qac)
            iq[0, 0] += pred
            dq_dc[gy, gx] = iq[0, 0]
            iq_all[gy, gx] = iq
    return idct(iq_all, COS_ENC), scan, acfl


def encode_intra_chroma(plane: np.ndarray, qdc: int, qac: int):
    blocks = to_blocks8(plane).astype(np.int64)
    r, scan, acfl = encode_chroma_plane(blocks, qdc, qac)
    # recon = clamp((int)idct) — truncation toward zero then clamp
    rec = np.clip(c_trunc(r), 0, 255).astype(np.uint8)
    return from_blocks8(rec), scan, acfl


# ---------------------------------------------------------------------------
# inter: motion estimation / compensation / residual chain
# ---------------------------------------------------------------------------


def _sad_dense(cur_y: np.ndarray, pad: np.ndarray, offsets: np.ndarray) -> np.ndarray:
    """Dense SADs at `offsets` for every MB: (len(offsets), mbh, mbw)."""
    h, w = cur_y.shape
    mbh, mbw = h // 16, w // 16
    cur = to_blocks16(cur_y).astype(np.int64)
    sads = np.zeros((len(offsets), mbh, mbw), dtype=np.int64)
    for i, (ox, oy) in enumerate(offsets):
        win = pad[16 + oy: 16 + oy + h, 16 + ox: 16 + ox + w]
        sads[i] = np.abs(cur - to_blocks16(win)).sum(axis=(2, 3))
    return sads


def _select_from_seq(seq: np.ndarray):
    """Reference selection over a (64, mbh, mbw) SAD sequence: first strict
    minimum (`min > SAD`, enc src:2128), overridden by the *second* zero-SAD
    evaluation (the `else if (SAD==0)` break, enc src:2136-2141, fires only
    once min is already 0).  Returns (best_step, steps_taken)."""
    best = np.argmin(seq, axis=0)  # first occurrence of the minimum
    zeros = seq == 0
    nz = zeros.cumsum(axis=0)
    is2 = zeros & (nz == 2)
    two_plus = is2.any(axis=0)
    second_zero = np.argmax(is2, axis=0)
    best = np.where(two_plus, second_zero, best)
    steps = np.where(two_plus, second_zero + 1, 64)
    return best, steps


def motion_estimation(cur_y: np.ndarray, prev_recon_y: np.ndarray) -> np.ndarray:
    """Stateful spiral full-pel search; returns mv (mbh, mbw, 2) with the
    reference sign convention mv = origin - best (minus the walk offset).

    Models the full flag/xflag/yflag carry-over (motionEstimation enc
    src:2073-2155): the walk state persists across MBs within the frame,
    and a SAD==0 early break exits mid-run leaving the state mirrored, so
    subsequent MBs walk one of the four state-machine spirals
    (constants.SPIRAL_STATES).  Break-free frames reduce to the canonical
    fixed-table search."""
    from .constants import SPIRAL_STATE_IDX, SPIRAL_TRANS, SPIRAL_UNION

    h, w = cur_y.shape
    mbh, mbw = h // 16, w // 16
    pad = pad_image(prev_recon_y, 16).astype(np.int64)
    ncanon = int(SPIRAL_STATE_IDX[0].max()) + 1  # canonical-unique prefix rows
    sads_c = _sad_dense(cur_y, pad, SPIRAL_UNION[:ncanon])
    seq0 = sads_c[SPIRAL_STATE_IDX[0]]           # canonical 64-step sequence
    best0, steps0 = _select_from_seq(seq0)
    if (steps0 == 64).all():
        # no MB breaks early -> every MB walks the canonical spiral
        mv = -SPIRAL_UNION[SPIRAL_STATE_IDX[0][best0]]
        return mv.astype(np.int64)

    sads = np.concatenate(
        [sads_c, _sad_dense(cur_y, pad, SPIRAL_UNION[ncanon:])], axis=0
    )
    # per entry state: chosen step + steps taken, then propagate the state
    # across the MB raster exactly like the C++ (nblck loop, enc src:2104)
    nstates = SPIRAL_STATE_IDX.shape[0]
    best_u = np.zeros((nstates, mbh, mbw), np.int64)
    steps = np.zeros((nstates, mbh, mbw), np.int64)
    for s in range(nstates):
        b, t = _select_from_seq(sads[SPIRAL_STATE_IDX[s]])
        best_u[s], steps[s] = SPIRAL_STATE_IDX[s][b], t
    mv = np.zeros((mbh, mbw, 2), np.int64)
    state = 0
    for n in range(mbh * mbw):
        by, bx = divmod(n, mbw)
        mv[by, bx] = -SPIRAL_UNION[best_u[state, by, bx]]
        state = int(SPIRAL_TRANS[state, steps[state, by, bx]])
    return mv


def gather_pred16(pad: np.ndarray, mv: np.ndarray, bs: int) -> np.ndarray:
    """Fetch the (bs x bs) predictor for each MB at origin - mv + pad."""
    mbh, mbw = mv.shape[:2]
    out = np.zeros((mbh, mbw, bs, bs), dtype=pad.dtype)
    for by in range(mbh):
        for bx in range(mbw):
            ry = by * bs - int(mv[by, bx, 1]) + bs
            rx = bx * bs - int(mv[by, bx, 0]) + bs
            out[by, bx] = pad[ry:ry + bs, rx:rx + bs]
    return out


def mv_predict_parallel(mv: np.ndarray) -> np.ndarray:
    """Differential MVs (mvPrediction enc src:2353-2425).

    The reconstruction loop (ImvPrediction) adds the identical predictor
    back, so Reconstructedmv == mv and the predictors can be computed from
    the original field in parallel."""
    mbh, mbw = mv.shape[:2]
    diff = np.zeros_like(mv)
    for by in range(mbh):
        for bx in range(mbw):
            if by == 0 and bx == 0:
                px, py = 8, 8
            elif by == 0:
                px, py = mv[by, bx - 1]
            elif bx == 0:
                px, py = mv[by - 1, bx]
            else:
                if bx == mbw - 1:
                    xs = (mv[by, bx - 1, 0], mv[by - 1, bx - 1, 0], mv[by - 1, bx, 0])
                    ys = (mv[by, bx - 1, 1], mv[by - 1, bx - 1, 1], mv[by - 1, bx, 1])
                else:
                    xs = (mv[by, bx - 1, 0], mv[by - 1, bx, 0], mv[by - 1, bx + 1, 0])
                    ys = (mv[by, bx - 1, 1], mv[by - 1, bx, 1], mv[by - 1, bx + 1, 1])
                px = int(c_median3(*xs))
                py = int(c_median3_mv_y(*ys, xs[2]))
            diff[by, bx, 0] = mv[by, bx, 0] - px
            diff[by, bx, 1] = mv[by, bx, 1] - py
    return diff


def encode_inter_luma(cur_y: np.ndarray, prev_recon_y: np.ndarray, qdc: int, qac: int):
    h, w = cur_y.shape
    gh, gw = h // 8, w // 8
    mv = motion_estimation(cur_y, prev_recon_y)
    pad = pad_image(prev_recon_y, 16).astype(np.int64)
    pred = gather_pred16(pad, mv, 16)
    resid16 = to_blocks16(cur_y).astype(np.int64) - pred
    # (mbh, mbw, 16, 16) -> global 8x8 grid
    resid8 = (
        resid16.reshape(h // 16, w // 16, 2, 8, 2, 8)
        .transpose(0, 2, 1, 4, 3, 5)
        .reshape(gh, gw, 8, 8)
    )
    d = fdct(resid8, COS_ENC)
    # DC wavefront (sequential dequantized-DC chain)
    scan = np.zeros((gh, gw, 64), dtype=np.int64)
    acfl = np.zeros((gh, gw), dtype=np.int64)
    dq_dc = np.zeros((gh, gw), dtype=np.int64)
    iq_all = np.zeros((gh, gw, 8, 8), dtype=np.int64)
    for mb in range((gh // 2) * (gw // 2)):
        by, bx = divmod(mb, gw // 2)
        for k in range(4):
            gy, gx = 2 * by + k // 2, 2 * bx + k % 2
            blk = d[gy, gx].copy()
            kind = dc_neighbor_kind(gy, gx, gw)
            if kind == "const1024":
                p = 1024
            elif kind == "left":
                p = int(dq_dc[gy, gx - 1])
            elif kind == "upper":
                p = int(dq_dc[gy - 1, gx])
            elif kind == "l_ul_u":
                p = int(c_median3(dq_dc[gy, gx - 1], dq_dc[gy - 1, gx - 1], dq_dc[gy - 1, gx]))
            else:
                p = int(c_median3(dq_dc[gy, gx - 1], dq_dc[gy - 1, gx], dq_dc[gy - 1, gx + 1]))
            blk[0, 0] -= p
            q = quant_luma(blk, qdc, qac)
            scan[gy, gx] = zigzag(q)
            acfl[gy, gx] = ac_flag(q)
            iq = dequant(q, qdc, qac)
            iq[0, 0] += p
            dq_dc[gy, gx] = iq[0, 0]
            iq_all[gy, gx] = iq
    r = idct(iq_all, COS_ENC)
    # mergeBlock INTER: (int) cast of the double IDCT output (enc src:4812)
    inv_resid = c_trunc(r)
    inv16 = (
        inv_resid.reshape(h // 16, 2, w // 16, 2, 8, 8)
        .transpose(0, 2, 1, 4, 3, 5)
        .reshape(h // 16, w // 16, 16, 16)
    )
    recon16 = np.clip(pred + inv16, 0, 255)
    recon = (
        recon16.reshape(h // 16, w // 16, 16, 16)
        .transpose(0, 2, 1, 3)
        .reshape(h, w)
        .astype(np.uint8)
    )
    mv_diff = mv_predict_parallel(mv)
    return recon, mv, mv_diff, dict(y_scan=scan, y_acflag=acfl)


def encode_inter_chroma(plane: np.ndarray, prev_recon: np.ndarray, mv: np.ndarray, qdc: int, qac: int):
    """interCbCr for one chroma plane: mv/2 (C division), 8px padding."""
    h, w = plane.shape
    pad = pad_image(prev_recon, 8).astype(np.int64)
    mvc = np.sign(mv) * (np.abs(mv) // 2)  # Reconstructedmv/2, C division
    pred = gather_pred16(pad, mvc, 8)
    err = to_blocks8(plane).astype(np.int64) - pred
    r, scan, acfl = encode_chroma_plane(err, qdc, qac)
    # recon = clamp((int)(pad_pixel + idct)): double sum truncated toward 0
    rec = np.clip(c_trunc(pred.astype(np.float64) + r), 0, 255)
    return from_blocks8(rec).astype(np.uint8), scan, acfl


# ---------------------------------------------------------------------------
# full encoder
# ---------------------------------------------------------------------------


def encode_frame_intra(y, cb, cr, qdc, qac) -> tuple[Recon, FrameSymbols]:
    recon_y, lum = encode_intra_luma(y, qdc, qac)
    recon_cb, cb_scan, cb_ac = encode_intra_chroma(cb, qdc, qac)
    recon_cr, cr_scan, cr_ac = encode_intra_chroma(cr, qdc, qac)
    sym = FrameSymbols(
        is_intra=True,
        cb_scan=cb_scan,
        cb_acflag=cb_ac,
        cr_scan=cr_scan,
        cr_acflag=cr_ac,
        **lum,
    )
    return Recon(recon_y, recon_cb.astype(np.uint8), recon_cr.astype(np.uint8)), sym


def encode_frame_inter(y, cb, cr, prev: Recon, qdc, qac) -> tuple[Recon, FrameSymbols]:
    recon_y, mv, mv_diff, lum = encode_inter_luma(y, prev.y, qdc, qac)
    recon_cb, cb_scan, cb_ac = encode_inter_chroma(cb, prev.cb, mv, qdc, qac)
    recon_cr, cr_scan, cr_ac = encode_inter_chroma(cr, prev.cr, mv, qdc, qac)
    sym = FrameSymbols(
        is_intra=False,
        cb_scan=cb_scan,
        cb_acflag=cb_ac,
        cr_scan=cr_scan,
        cr_acflag=cr_ac,
        mv_diff=mv_diff,
        **lum,
    )
    return Recon(recon_y, recon_cb, recon_cr), sym


def encode_sequence(frames_yuv, qdc: int, qac: int, period: int):
    """frames_yuv: list of (y, cb, cr) uint8 arrays.  period 0 = all-intra
    (reference ALL_INTRA mode); period >= 1 = intra every `period` frames.
    Returns (recons, symbols)."""
    recons, syms = [], []
    prev = None
    eff = period if period >= 1 else 1
    for n, (y, cb, cr) in enumerate(frames_yuv):
        if period == 0 or n % eff == 0:
            rec, sym = encode_frame_intra(y, cb, cr, qdc, qac)
        else:
            rec, sym = encode_frame_inter(y, cb, cr, prev, qdc, qac)
        recons.append(rec)
        syms.append(sym)
        prev = rec
    return recons, syms


# ---------------------------------------------------------------------------
# bitstream serialization (allintraBody/intraBody/interBody)
# ---------------------------------------------------------------------------


def _write_coeff_block(bw: BitWriter, scan_row: np.ndarray, acflag: int):
    bw.extend(vlc_bits(int(scan_row[0])))
    bw.put(int(acflag))
    if acflag:
        bw.extend([0] * 63)
    else:
        for v in scan_row[1:]:
            bw.extend(vlc_bits(int(v)))


def write_bitstream(syms: list[FrameSymbols], height: int, width: int, qdc: int, qac: int, period: int) -> bytes:
    bw = BitWriter()
    mbw = width // 16
    cw = width // 16  # chroma grid width == number of MBs per row
    for sym in syms:
        gh, gw = sym.y_scan.shape[:2]
        for mb in range((gh // 2) * (gw // 2)):
            by, bx = divmod(mb, gw // 2)
            if not sym.is_intra:
                bw.put(1)  # mv mode flag
                bw.extend(vlc_bits(int(sym.mv_diff[by, bx, 0])))
                bw.extend(vlc_bits(int(sym.mv_diff[by, bx, 1])))
            for k in range(4):
                gy, gx = 2 * by + k // 2, 2 * bx + k % 2
                if sym.is_intra:
                    bw.put(int(sym.mpm_flag[gy, gx]))
                    bw.put(int(sym.mode_bit[gy, gx]))
                _write_coeff_block(bw, sym.y_scan[gy, gx], int(sym.y_acflag[gy, gx]))
            _write_coeff_block(bw, sym.cb_scan[by, bx], int(sym.cb_acflag[by, bx]))
            _write_coeff_block(bw, sym.cr_scan[by, bx], int(sym.cr_acflag[by, bx]))
    return pack_header(height, width, qdc, qac, period) + bw.tobytes()


def encode(frames_yuv, qdc: int, qac: int, period: int) -> tuple[bytes, list[Recon]]:
    h, w = frames_yuv[0][0].shape
    recons, syms = encode_sequence(frames_yuv, qdc, qac, period)
    return write_bitstream(syms, h, w, qdc, qac, period), recons


# ---------------------------------------------------------------------------
# decoder (double costable regime)
# ---------------------------------------------------------------------------


def parse_bitstream(data: bytes, nframes: int):
    """readBlockData (dec src:38-404): sequential parse into FrameSymbols."""
    height, width, qdc, qac, period = parse_header(data[:14])
    br = BitReader(data[14:])
    gh, gw = height // 8, width // 8
    mbh, mbw = height // 16, width // 16
    syms = []
    for n in range(nframes):
        is_intra = period == 0 or (n % period == 0)
        sym = FrameSymbols(
            is_intra=is_intra,
            mpm_flag=np.zeros((gh, gw), np.int64),
            mode_bit=np.zeros((gh, gw), np.int64),
            y_scan=np.zeros((gh, gw, 64), np.int64),
            y_acflag=np.zeros((gh, gw), np.int64),
            cb_scan=np.zeros((mbh, mbw, 64), np.int64),
            cb_acflag=np.zeros((mbh, mbw), np.int64),
            cr_scan=np.zeros((mbh, mbw, 64), np.int64),
            cr_acflag=np.zeros((mbh, mbw), np.int64),
            mv_diff=np.zeros((mbh, mbw, 2), np.int64),
        )
        for mb in range(mbh * mbw):
            by, bx = divmod(mb, mbw)
            if not is_intra:
                br.get()  # mv mode flag (always 1)
                sym.mv_diff[by, bx, 0] = br.read_vlc()
                sym.mv_diff[by, bx, 1] = br.read_vlc()
            for k in range(4):
                gy, gx = 2 * by + k // 2, 2 * bx + k % 2
                if is_intra:
                    sym.mpm_flag[gy, gx] = br.get()
                    sym.mode_bit[gy, gx] = br.get()
                sym.y_scan[gy, gx, 0] = br.read_vlc()
                sym.y_acflag[gy, gx] = br.get()
                if sym.y_acflag[gy, gx]:
                    br.pos += 63
                else:
                    for i in range(1, 64):
                        sym.y_scan[gy, gx, i] = br.read_vlc()
            for (cscan, cac) in ((sym.cb_scan, sym.cb_acflag), (sym.cr_scan, sym.cr_acflag)):
                cscan[by, bx, 0] = br.read_vlc()
                cac[by, bx] = br.get()
                if cac[by, bx]:
                    br.pos += 63
                else:
                    for i in range(1, 64):
                        cscan[by, bx, i] = br.read_vlc()
        syms.append(sym)
    return (height, width, qdc, qac, period), syms


def _decode_dc_chain(scan, qdc, qac, grid_kind_w, luma: bool):
    """Inverse DC DPCM over a grid: returns dequantized blocks (int64)."""
    gh, gw = scan.shape[:2]
    q = izigzag(scan)
    iq = dequant(q.astype(np.int64), qdc, qac)
    dq_dc = np.zeros((gh, gw), dtype=np.int64)
    if luma:
        order = [
            (2 * by + k // 2, 2 * bx + k % 2)
            for mb in range((gh // 2) * (gw // 2))
            for by, bx in [divmod(mb, gw // 2)]
            for k in range(4)
        ]
    else:
        order = [(gy, gx) for gy in range(gh) for gx in range(gw)]
    for gy, gx in order:
        if luma:
            kind = dc_neighbor_kind(gy, gx, gw)
        else:
            if gy == 0 and gx == 0:
                kind = "const1024"
            elif gy == 0:
                kind = "left"
            elif gx == 0:
                kind = "upper"
            elif gx == gw - 1:
                kind = "l_ul_u"
            else:
                kind = "l_u_ur"
        if kind == "const1024":
            p = 1024
        elif kind == "left":
            p = int(dq_dc[gy, gx - 1])
        elif kind == "upper":
            p = int(dq_dc[gy - 1, gx])
        elif kind == "l_ul_u":
            p = int(c_median3(dq_dc[gy, gx - 1], dq_dc[gy - 1, gx - 1], dq_dc[gy - 1, gx]))
        else:
            p = int(c_median3(dq_dc[gy, gx - 1], dq_dc[gy - 1, gx], dq_dc[gy - 1, gx + 1]))
        iq[gy, gx, 0, 0] += p
        dq_dc[gy, gx] = iq[gy, gx, 0, 0]
    return iq


def decode_frame_intra(sym: FrameSymbols, qdc, qac, height, width, table=COS_DEC) -> Recon:
    gh, gw = height // 8, width // 8
    iq = _decode_dc_chain(sym.y_scan, qdc, qac, gw, luma=True)
    r = idct(iq, table)
    recon = np.zeros((gh, gw, 8, 8), dtype=np.int64)
    modes = np.zeros((gh, gw), dtype=np.int64)
    for mb in range((gh // 2) * (gw // 2)):
        by, bx = divmod(mb, gw // 2)
        for k in range(4):
            gy, gx = 2 * by + k // 2, 2 * bx + k % 2
            has_up, has_left = gy > 0, gx > 0
            if not has_up and not has_left:
                mode = 2
            else:
                if has_up and has_left:
                    pred = int(c_median3(modes[gy, gx - 1], modes[gy - 1, gx - 1], modes[gy - 1, gx]))
                elif has_left:
                    pred = int(modes[gy, gx - 1])
                else:
                    pred = int(modes[gy - 1, gx])
                if sym.mpm_flag[gy, gx]:
                    mode = pred
                else:
                    rem = sorted({0, 1, 2} - {pred})
                    mode = rem[int(sym.mode_bit[gy, gx])]
            modes[gy, gx] = mode
            up_row = recon[gy - 1, gx, 7, :] if has_up else None
            left_col = recon[gy, gx - 1, :, 7] if has_left else None
            if mode == 0:
                pred_px = up_row[None, :] if has_up else np.full((8, 8), 128)
                rec = c_trunc(r[gy, gx] + pred_px)
            elif mode == 1:
                pred_px = left_col[:, None] if has_left else np.full((8, 8), 128)
                rec = c_trunc(r[gy, gx] + pred_px)
            else:
                lsum = int(left_col.sum()) if has_left else 1024
                usum = int(up_row.sum()) if has_up else 1024
                rec = c_trunc(r[gy, gx] + (lsum + usum) / 16.0)
            recon[gy, gx] = np.clip(rec, 0, 255)
    y = from_blocks8(recon).astype(np.uint8)
    cb = _decode_chroma_intra(sym.cb_scan, qdc, qac, table)
    cr = _decode_chroma_intra(sym.cr_scan, qdc, qac, table)
    return Recon(y, cb, cr)


def _decode_chroma_intra(scan, qdc, qac, table):
    iq = _decode_dc_chain(scan, qdc, qac, scan.shape[1], luma=False)
    r = idct(iq, table)
    return from_blocks8(np.clip(c_trunc(r), 0, 255)).astype(np.uint8)


def mv_reconstruct(mv_diff: np.ndarray) -> np.ndarray:
    """ImvPrediction sequential reconstruction (dec src:4301-4370)."""
    mbh, mbw = mv_diff.shape[:2]
    mv = np.zeros_like(mv_diff)
    for by in range(mbh):
        for bx in range(mbw):
            if by == 0 and bx == 0:
                px, py = 8, 8
            elif by == 0:
                px, py = mv[by, bx - 1]
            elif bx == 0:
                px, py = mv[by - 1, bx]
            else:
                if bx == mbw - 1:
                    xs = (mv[by, bx - 1, 0], mv[by - 1, bx - 1, 0], mv[by - 1, bx, 0])
                    ys = (mv[by, bx - 1, 1], mv[by - 1, bx - 1, 1], mv[by - 1, bx, 1])
                else:
                    xs = (mv[by, bx - 1, 0], mv[by - 1, bx, 0], mv[by - 1, bx + 1, 0])
                    ys = (mv[by, bx - 1, 1], mv[by - 1, bx, 1], mv[by - 1, bx + 1, 1])
                px = int(c_median3(*xs))
                py = int(c_median3_mv_y(*ys, xs[2]))
            mv[by, bx, 0] = mv_diff[by, bx, 0] + px
            mv[by, bx, 1] = mv_diff[by, bx, 1] + py
    return mv


def decode_frame_inter(sym: FrameSymbols, prev: Recon, qdc, qac, height, width, table=COS_DEC) -> Recon:
    gh, gw = height // 8, width // 8
    mv = mv_reconstruct(sym.mv_diff)
    iq = _decode_dc_chain(sym.y_scan, qdc, qac, gw, luma=True)
    inv_resid = c_trunc(idct(iq, table))
    inv16 = (
        inv_resid.reshape(height // 16, 2, width // 16, 2, 8, 8)
        .transpose(0, 2, 1, 4, 3, 5)
        .reshape(height // 16, width // 16, 16, 16)
    )
    pad = pad_image(prev.y, 16).astype(np.int64)
    pred = gather_pred16(pad, mv, 16)
    recon16 = np.clip(pred + inv16, 0, 255)
    y = (
        recon16.transpose(0, 2, 1, 3).reshape(height, width).astype(np.uint8)
    )
    mvc = np.sign(mv) * (np.abs(mv) // 2)

    def chroma(scan, prev_plane):
        iqc = _decode_dc_chain(scan, qdc, qac, scan.shape[1], luma=False)
        r = idct(iqc, table)
        padc = pad_image(prev_plane, 8).astype(np.int64)
        predc = gather_pred16(padc, mvc, 8)
        rec = np.clip(c_trunc(predc.astype(np.float64) + r), 0, 255)
        return from_blocks8(rec).astype(np.uint8)

    return Recon(y, chroma(sym.cb_scan, prev.cb), chroma(sym.cr_scan, prev.cr))


def decode(data: bytes, nframes: int, table=COS_DEC) -> list[Recon]:
    (height, width, qdc, qac, period), syms = parse_bitstream(data, nframes)
    out: list[Recon] = []
    for n, sym in enumerate(syms):
        if sym.is_intra:
            out.append(decode_frame_intra(sym, qdc, qac, height, width, table))
        else:
            out.append(decode_frame_inter(sym, out[-1], qdc, qac, height, width, table))
    return out
