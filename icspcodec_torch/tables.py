"""Numpy-only tables of the port: the constants it carries across from the
JAX package, rebuilt here (the codec has no weights; these are its
parameters).

* ``diag_layout``, ``luma_dc_kind``, ``chroma_dc_kind`` and
  ``intra_lane_tables``: the 2*gy+gx anti-diagonal wavefront schedule and
  the DC-predictor kind grids (JAX: engine/wavefront.py).
* ``fdct_matrix`` / ``idct_matrix``: the 64x64 transform matrices of the
  fast float32 path (JAX: ops/transforms.py).
* ``pack_header`` / ``parse_header``: the 14-byte stream header (JAX:
  oracle.py).
* the motion-compensation offset tables ``NEG_SPIRAL``, ``NEG_UNION``,
  ``N_CANON``, ``CHROMA_OFFSETS``, ``SPIRAL_TO_CHROMA``,
  ``CHROMA_U_OFFSETS`` and ``UNION_TO_CHROMA_U`` (JAX: ops/pallas_me.py).

tests/test_torch_tables.py, test_torch_mc.py and test_torch_parse.py hold
every table equal to its JAX original.
"""
from __future__ import annotations

import functools

import numpy as np

from .constants import COS_DEC, COS_ENC, IRT2, SPIRAL, SPIRAL_STATE_IDX, SPIRAL_UNION


@functools.lru_cache(maxsize=None)
def luma_dc_kind(gh: int, gw: int) -> np.ndarray:
    """0=const1024 1=left 2=upper 3=med(l,ul,u) 4=med(l,u,ur)."""
    k = np.zeros((gh, gw), dtype=np.int32)
    for gy in range(gh):
        for gx in range(gw):
            if gy == 0 and gx == 0:
                k[gy, gx] = 0
            elif gy == 0:
                k[gy, gx] = 1
            elif gx == 0:
                k[gy, gx] = 2
            elif (gy % 2 == 1 and gx % 2 == 1) or (gx % 2 == 1 and gx == gw - 1):
                k[gy, gx] = 3
            else:
                k[gy, gx] = 4
    return k


@functools.lru_cache(maxsize=None)
def chroma_dc_kind(gh: int, gw: int) -> np.ndarray:
    k = np.zeros((gh, gw), dtype=np.int32)
    for gy in range(gh):
        for gx in range(gw):
            if gy == 0 and gx == 0:
                k[gy, gx] = 0
            elif gy == 0:
                k[gy, gx] = 1
            elif gx == 0:
                k[gy, gx] = 2
            elif gx == gw - 1:
                k[gy, gx] = 3
            else:
                k[gy, gx] = 4
    return k


@functools.lru_cache(maxsize=None)
def diag_layout(gh: int, gw: int):
    """Packed-diagonal layout of a (gh, gw) grid: (nsteps, nmax, pack_idx,
    cell_step, cell_lane, shifts).  pack_idx[d, lane] is the flat cell
    gy*gw+gx of lane `lane` of diagonal d (gh*gw past the diagonal's end)."""
    nsteps = 2 * (gh - 1) + gw
    gy_min = np.zeros(nsteps + 3, dtype=np.int64)  # +3: safe d-3 lookups
    counts = np.zeros(nsteps, dtype=np.int64)
    for d in range(nsteps):
        lo = max(0, (d - (gw - 1) + 1) // 2)
        hi = min(gh - 1, d // 2)
        gy_min[d] = lo
        counts[d] = max(0, hi - lo + 1)
    nmax = int(counts.max())
    pack_idx = np.full((nsteps, nmax), gh * gw, dtype=np.int64)  # OOB sentinel
    cell_step = np.zeros((gh, gw), dtype=np.int64)
    cell_lane = np.zeros((gh, gw), dtype=np.int64)
    for gy in range(gh):
        for gx in range(gw):
            d = 2 * gy + gx
            lane = gy - gy_min[d]
            pack_idx[d, lane] = gy * gw + gx
            cell_step[gy, gx] = d
            cell_lane[gy, gx] = lane
    shifts = np.zeros((nsteps, 4), dtype=np.int64)  # l, u, ul, ur lane shifts
    for d in range(nsteps):
        shifts[d, 0] = gy_min[d] - gy_min[d - 1] if d >= 1 else 0
        shifts[d, 1] = gy_min[d] - 1 - gy_min[d - 2] if d >= 2 else 0
        shifts[d, 2] = gy_min[d] - 1 - gy_min[d - 3] if d >= 3 else 0
        shifts[d, 3] = gy_min[d] - 1 - gy_min[d - 1] if d >= 1 else 0
    return nsteps, nmax, pack_idx, cell_step, cell_lane, shifts


@functools.lru_cache(maxsize=None)
def intra_lane_tables(gh: int, gw: int):
    """Per-(step, lane) cell metadata of the wavefront: valid, has_up,
    has_left (bool) and the luma DC kind, all (nsteps, nmax)."""
    nsteps, nmax, pack_idx, _, _, _ = diag_layout(gh, gw)
    valid = pack_idx != gh * gw
    gy = np.where(valid, pack_idx // gw, 0)
    gx = np.where(valid, pack_idx % gw, 0)
    has_up = valid & (gy > 0)
    has_left = valid & (gx > 0)
    kind = luma_dc_kind(gh, gw)[gy, gx]
    return valid, has_up, has_left, kind.astype(np.int32)


TABLES = {"enc": COS_ENC, "dec": COS_DEC}


def table_key(table: np.ndarray) -> str:
    """Map a cosine table to its key; any table but COS_ENC / COS_DEC is an
    error (a custom table cached under a regime key would hand wrong
    constants to every later caller of that regime)."""
    table = np.asarray(table)
    for key, known in TABLES.items():
        if table.shape == known.shape and np.array_equal(table, known):
            return key
    raise ValueError("only the COS_ENC / COS_DEC cosine tables are supported")


@functools.lru_cache(maxsize=None)
def fdct_matrix(key: str, dtype: str) -> np.ndarray:
    """64x64 forward-DCT matrix: out[vu, yx] = s[v,u] * C[v,y] * C[u,x]
    with s folding the irt2 row/col weights and the global 1/4."""
    ct = np.asarray(TABLES[key], dtype=np.float64)
    s = np.ones((8, 8))
    s[0, :] *= IRT2
    s[:, 0] *= IRT2
    s *= 0.25
    m = np.einsum("vu,vy,ux->vuyx", s, ct, ct).reshape(64, 64)
    return m.astype(dtype)


@functools.lru_cache(maxsize=None)
def idct_matrix(key: str, dtype: str) -> np.ndarray:
    """64x64 inverse-DCT matrix: out[yx, vu] = Cu[u]*Cv[v]/4 * C[v,y]*C[u,x]."""
    ct = np.asarray(TABLES[key], dtype=np.float64)
    cu = np.ones(8)
    cu[0] = IRT2
    m = np.einsum("v,u,vy,ux->yxvu", cu * 0.5, cu * 0.5, ct, ct).reshape(64, 64)
    return m.astype(dtype)


def pack_header(height: int, width: int, qdc: int, qac: int, period: int) -> bytes:
    """The 14-byte header (headerinit, enc src:4901-4922)."""
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
    """Parse the 14-byte header (readHeader, dec src:14-37) into (height,
    width, qp_dc, qp_ac, period).  Raises ValueError on a short or
    wrong-magic header and on impossible dimensions or QPs."""
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
# motion-compensation offset tables.  An MV in the stream is minus one of the
# spiral offsets: one of the 64 canonical ones, or of the 129 of the union
# when the encoder's zero-SAD break mirrored the walk.  Chroma MC uses mv/2
# with C truncation (enc src:2538), so a chroma window offset is
# sign(o) * (|o| // 2).
# ---------------------------------------------------------------------------


def _chroma_table():
    """Unique chroma window offsets and the spiral-index -> chroma-index map."""
    c = np.sign(SPIRAL) * (np.abs(SPIRAL) // 2)
    uniq, inv = np.unique(c, axis=0, return_inverse=True)
    return uniq.astype(np.int32), inv.astype(np.int32)


def _chroma_union_table():
    """Unique chroma window offsets of the 129 union rows, in order of first
    appearance, so that the canonical chroma offsets form a prefix."""
    c = np.sign(SPIRAL_UNION) * (np.abs(SPIRAL_UNION) // 2)
    seen: dict = {}
    uniq = []
    inv = np.zeros(len(c), np.int32)
    for i, o in enumerate(map(tuple, c)):
        if o not in seen:
            seen[o] = len(uniq)
            uniq.append(o)
        inv[i] = seen[o]
    return np.asarray(uniq, np.int32), inv


CHROMA_OFFSETS, SPIRAL_TO_CHROMA = _chroma_table()
NEG_SPIRAL = (-SPIRAL).astype(np.int32)
N_CANON = int(SPIRAL_STATE_IDX[0].max()) + 1  # canonical-unique union prefix
CHROMA_U_OFFSETS, UNION_TO_CHROMA_U = _chroma_union_table()
NEG_UNION = (-SPIRAL_UNION).astype(np.int32)
