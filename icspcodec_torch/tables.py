"""Numpy-only tables of the port: the constants it carries across from the
JAX package, rebuilt here (the codec has no weights; these are its
parameters).

* ``diag_layout``, ``luma_dc_kind``, ``chroma_dc_kind`` and
  ``intra_lane_tables``: the 2*gy+gx anti-diagonal wavefront schedule and
  the DC-predictor kind grids (JAX: engine/wavefront.py).
* ``fdct_matrix`` / ``idct_matrix``: the 64x64 transform matrices of the
  fast float32 path (JAX: ops/transforms.py).
* ``pack_header``: the 14-byte stream header (JAX: oracle.py).

tests/test_torch_tables.py holds every table equal to its JAX original.
"""
from __future__ import annotations

import functools

import numpy as np

from .constants import COS_DEC, COS_ENC, IRT2


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
