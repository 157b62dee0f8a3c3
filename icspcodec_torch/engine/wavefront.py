"""Plain PyTorch wavefronts of the sequentially dependent codec stages.

These are the reference formulations the CUDA kernels are held against
(ops/dc_fused.py, ops/intra_fused.py, ops/intra_decode_fused.py), and what
those wrappers run on a CPU tensor.

The reference walks macroblocks in raster order, but every sequential
dependency (intra pixel prediction from reconstructed neighbours, the
transform-domain DC DPCM chain, MPM mode prediction) reads only the left,
upper-left, upper and upper-right neighbours on the global 8x8-block grid,
so any topological order gives the same values.  Both functions walk the
2*gy+gx anti-diagonals in a Python loop, each step one batched update of
every block on the diagonal in every frame.  The JAX package packs the
diagonals into rows and reads neighbours by lane shifts, a TPU layout
trick; here the per-cell state stays on the (F, gh, gw) grid and each
step gathers its neighbours by index.  Neighbour reads are clamped to the
grid; a clamped read is only ever consumed where the JAX packed form
reads the same cell (even luma grid widths: see intra_luma_scan_packed).

DC predictor kinds (tables.luma_dc_kind / chroma_dc_kind): 0 -> 1024,
1 -> left, 2 -> upper, 3 -> med(l, ul, u), 4 -> med(l, u, ur).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..constants import COS_ENC
from ..ops.medians import median3
from ..ops.quant import c_div, c_trunc, dequant_block, quant_block
from ..ops.scanorder import zigzag
from ..ops.transforms import fdct, idct
from ..tables import diag_layout, intra_lane_tables, luma_dc_kind


def _dc_pred(kind, l, ul, u, ur):
    """Select the DC predictor per kind code (all int32 tensors)."""
    med_lulu = median3(l, ul, u)
    med_luur = median3(l, u, ur)
    return torch.where(
        kind == 0, torch.full_like(l, 1024),
        torch.where(kind == 1, l, torch.where(
            kind == 2, u, torch.where(kind == 3, med_lulu, med_luur))),
    )


@functools.lru_cache(maxsize=None)
def _diagonals(gh: int, gw: int, device: torch.device):
    """Per diagonal: (gy, gx, gy-1, gx-1, gx+1) index tensors of its cells,
    clamped to the grid, from the packed layout of tables.py; made on the
    device once per grid."""
    nsteps, _, pack_idx, _, _, _ = diag_layout(gh, gw)
    valid = intra_lane_tables(gh, gw)[0]
    out = []
    for d in range(nsteps):
        cells = pack_idx[d][valid[d]]
        gy, gx = cells // gw, cells % gw
        idx = (gy, gx, np.maximum(gy - 1, 0), np.maximum(gx - 1, 0),
               np.minimum(gx + 1, gw - 1))
        out.append(tuple(torch.from_numpy(a).to(device) for a in idx))
    return out


def dc_dpcm_scan(dc: torch.Tensor, kind: np.ndarray, qstep: int, chroma: bool):
    """Forward DC chain: per block, subtract the predictor (from already
    dequantized neighbour DCs), quantize, dequantize.

    dc: (F, gh, gw) float DCT DC values.  Returns (q_dc, dq_dc) int32.
    """
    fdim, gh, gw = dc.shape
    kind_t = torch.from_numpy(np.asarray(kind, np.int32)).to(dc.device)
    q = torch.zeros((fdim, gh, gw), dtype=torch.int32, device=dc.device)
    dq = torch.zeros_like(q)
    for gy, gx, gyu, gxl, gxr in _diagonals(gh, gw, dc.device):
        pred = _dc_pred(kind_t[gy, gx][None], dq[:, gy, gxl], dq[:, gyu, gxl],
                        dq[:, gyu, gx], dq[:, gyu, gxr])
        resid = dc[:, gy, gx] - pred.to(dc.dtype)
        half = resid + 0.5
        t = torch.floor(half).to(torch.int32) if chroma else c_trunc(half)
        qv = c_div(t, qstep)
        q[:, gy, gx] = qv
        dq[:, gy, gx] = qv * qstep + pred
    return q, dq


def idc_dpcm_scan(iq_dc: torch.Tensor, kind: np.ndarray):
    """Inverse DC chain (decoder): dq = iq + predictor, along the wavefront.

    iq_dc: (F, gh, gw) integer dequantized DC residuals.  Returns the
    reconstructed dequantized DC field (F, gh, gw) int32.
    """
    fdim, gh, gw = iq_dc.shape
    kind_t = torch.from_numpy(np.asarray(kind, np.int32)).to(iq_dc.device)
    iq = iq_dc.to(torch.int32)
    dq = torch.zeros_like(iq)
    for gy, gx, gyu, gxl, gxr in _diagonals(gh, gw, iq_dc.device):
        pred = _dc_pred(kind_t[gy, gx][None], dq[:, gy, gxl], dq[:, gyu, gxl],
                        dq[:, gyu, gx], dq[:, gyu, gxr])
        dq[:, gy, gx] = iq[:, gy, gx] + pred
    return dq


def intra_encode_cells(cur, up_row, left_col, has_up, has_left, l_md, ul_md, u_md, kind,
                       l_dc, ul_dc, u_dc, ur_dc, qdc: int, qac: int, table, dtype):
    """One wavefront step of the intra luma encoder on N cells of F frames.

    cur: (F, N, 8, 8) original blocks; up_row / left_col: (F, N, 8) the
    bottom pixel row of the upper neighbour and the right pixel column of
    the left one; has_up / has_left: (1, N) bool; l_md / ul_md / u_md: the
    neighbours' intra modes and l_dc / ul_dc / u_dc / ur_dc their
    dequantized DCs, (F, N) int32; kind: (1, N) DC predictor kinds.
    Returns (rec (F, N, 8, 8) int32, mode, dequantized DC, q (F, N, 8, 8),
    MPM flag (bool), remainder bit).  Shared by the single-device wavefront
    and the tiled one (parallel/tiles.py), which gathers the neighbours
    across tile seams."""
    first = ~has_up & ~has_left
    cur = cur.to(torch.int32)

    # --- candidate residuals and SAEs ---
    e0 = cur - up_row[..., None, :]
    e1 = cur - left_col[..., :, None]
    lsum = torch.where(has_left, left_col.sum(-1, dtype=torch.int32), 1024)
    usum = torch.where(has_up, up_row.sum(-1, dtype=torch.int32), 1024)
    d16 = 16 * cur - (lsum + usum)[..., None, None]
    e2 = torch.sign(d16) * torch.div(d16.abs(), 16, rounding_mode="floor")
    sae0 = e0.abs().sum((-2, -1))
    sae1 = e1.abs().sum((-2, -1))
    sae2 = e2.abs().sum((-2, -1))
    mode_both = torch.where((sae0 <= sae1) & (sae0 <= sae2), 0,
                            torch.where(sae1 <= sae2, 1, 2))
    mode = torch.where(first, 2, torch.where(
        has_up & has_left, mode_both,
        torch.where(has_left, torch.where(sae2 > sae1, 1, 2),
                    torch.where(sae2 > sae0, 0, 2)))).to(torch.int32)
    m = mode[..., None, None]
    err = torch.where(m == 0, e0, torch.where(m == 1, e1, e2))

    # --- MPM flag / remainder bit ---
    pred_mode = torch.where(has_up & has_left, median3(l_md, ul_md, u_md),
                            torch.where(has_left, l_md, u_md))
    flag = (mode == pred_mode) & ~first
    bit = torch.where(flag | first, 0, torch.where(
        pred_mode == 2, (mode == 1).to(torch.int32), (mode == 2).to(torch.int32)))

    # --- transform chain ---
    d = fdct(err, table=table, dtype=dtype)
    dc_pred = _dc_pred(kind, l_dc, ul_dc, u_dc, ur_dc)
    # the predictor is subtracted before the quantizer's +0.5, in the C
    # order (d - pred) + 0.5
    d[..., 0, 0] = d[..., 0, 0] - dc_pred.to(dtype)
    q = quant_block(d, qdc, qac, chroma=False)
    iq = dequant_block(q, qdc, qac)
    iq[..., 0, 0] += dc_pred
    r = idct(iq, table=table, dtype=dtype)

    # --- pixel reconstruction ---
    pred0 = torch.where(has_up[..., None, None], up_row[..., None, :].to(dtype),
                        128.0).expand(r.shape)
    pred1 = torch.where(has_left[..., None, None], left_col[..., :, None].to(dtype),
                        128.0).expand(r.shape)
    pv = ((lsum + usum).to(dtype) / 16.0)[..., None, None]
    predsel = torch.where(m == 0, pred0, torch.where(m == 1, pred1, pv))
    rec = torch.clamp(c_trunc(r + predsel), 0, 255)
    return rec, mode, iq[..., 0, 0], q, flag, bit


def intra_luma_scan_packed(orig: torch.Tensor, qdc: int, qac: int,
                           table=COS_ENC, dtype=torch.float64):
    """Encode one batch of intra luma planes along the wavefront.

    orig: (F, gh, gw, 8, 8) int original blocks.  Returns dict with recon
    (F,gh,gw,8,8) int32, scan (F,gh,gw,64) int32 in zig-zag order and
    mpm / mode_bit (F,gh,gw) int32 -- the contract of the JAX package's
    intra_luma_scan_packed, computed expression for expression.

    Odd grid widths are refused: there the right-edge kind-4 cells read an
    upper-right neighbour that does not exist, and the JAX packed and grid
    forms already disagree on what it holds.  Luma gw = W/8 with
    W % 16 == 0 is always even.
    """
    fdim, gh, gw = orig.shape[:3]
    if gw % 2:
        raise ValueError(f"the intra luma wavefront needs an even block-grid width; got gw={gw}")
    dev = orig.device
    kind_g = torch.from_numpy(luma_dc_kind(gh, gw)).to(dev)
    i32 = dict(dtype=torch.int32, device=dev)
    rc = torch.zeros((fdim, gh, gw, 8), **i32)     # right pixel column
    br = torch.zeros((fdim, gh, gw, 8), **i32)     # bottom pixel row
    modes = torch.zeros((fdim, gh, gw), **i32)
    dqdc = torch.zeros((fdim, gh, gw), **i32)
    recon = torch.zeros((fdim, gh, gw, 8, 8), **i32)
    scanq = torch.zeros((fdim, gh, gw, 64), **i32)
    mpmf = torch.zeros((fdim, gh, gw), **i32)
    mbit = torch.zeros((fdim, gh, gw), **i32)

    for gy, gx, gyu, gxl, gxr in _diagonals(gh, gw, dev):
        rec, mode, dq_dc, q, flag, bit = intra_encode_cells(
            orig[:, gy, gx], br[:, gyu, gx], rc[:, gy, gxl], (gy > 0)[None], (gx > 0)[None],
            modes[:, gy, gxl], modes[:, gyu, gxl], modes[:, gyu, gx], kind_g[gy, gx][None],
            dqdc[:, gy, gxl], dqdc[:, gyu, gxl], dqdc[:, gyu, gx], dqdc[:, gyu, gxr],
            qdc, qac, table, dtype)
        recon[:, gy, gx] = rec
        rc[:, gy, gx] = rec[..., :, 7]
        br[:, gy, gx] = rec[..., 7, :]
        modes[:, gy, gx] = mode
        dqdc[:, gy, gx] = dq_dc
        scanq[:, gy, gx] = zigzag(q)
        mpmf[:, gy, gx] = flag.to(torch.int32)
        mbit[:, gy, gx] = bit
    return dict(recon=recon, scan=scanq, mpm=mpmf, mode_bit=mbit)


def intra_decode_cells(rr, up_row, left_col, has_up, has_left, l_md, ul_md, u_md, fl, bt,
                       dtype):
    """One wavefront step of the intra luma decoder on N cells of F frames.

    rr: (F, N, 8, 8) inverse-DCT blocks; up_row / left_col / has_up /
    has_left / l_md / ul_md / u_md as intra_encode_cells takes them; fl /
    bt: (F, N) MPM flag and remainder bit.  Returns (rec (F, N, 8, 8)
    int32, mode).  Shared by the single-device wavefront and the tiled one
    (parallel/tiles.py)."""
    first = ~has_up & ~has_left
    pred_mode = torch.where(has_up & has_left, median3(l_md, ul_md, u_md),
                            torch.where(has_left, l_md, u_md))
    lo = torch.where(pred_mode == 0, 1, 0)
    hi = torch.where(pred_mode == 2, 1, 2)
    mode = torch.where(first, 2, torch.where(fl == 1, pred_mode,
                                             torch.where(bt == 0, lo, hi))).to(torch.int32)

    lsum = torch.where(has_left, left_col.sum(-1, dtype=torch.int32), 1024)
    usum = torch.where(has_up, up_row.sum(-1, dtype=torch.int32), 1024)
    m = mode[..., None, None]
    pred0 = torch.where(has_up[..., None, None], up_row[..., None, :].to(dtype),
                        128.0).expand(rr.shape)
    pred1 = torch.where(has_left[..., None, None], left_col[..., :, None].to(dtype),
                        128.0).expand(rr.shape)
    pv = ((lsum + usum).to(dtype) / 16.0)[..., None, None]
    predsel = torch.where(m == 0, pred0, torch.where(m == 1, pred1, pv))
    return torch.clamp(c_trunc(rr + predsel), 0, 255), mode


def intra_luma_decode_scan_packed(r: torch.Tensor, mpmf: torch.Tensor, mbit: torch.Tensor,
                                  dtype=torch.float64):
    """Reconstruct intra luma pixels from inverse-DCT blocks and mode bits.

    r: (F, gh, gw, 8, 8) float inverse-DCT output (DC chain already applied);
    mpmf / mbit: (F, gh, gw) MPM flag and remainder bit.  Returns recon
    blocks (F, gh, gw, 8, 8) int32: the contract of the JAX package's
    intra_luma_decode_scan_packed, computed expression for expression.  The
    mode is the MPM prediction when the flag is set, else the remainder bit
    picks one of the other two modes (IDPCM_pix_block dec src:3643-3990).
    """
    fdim, gh, gw = r.shape[:3]
    dev = r.device
    i32 = dict(dtype=torch.int32, device=dev)
    rc = torch.zeros((fdim, gh, gw, 8), **i32)     # right pixel column
    br = torch.zeros((fdim, gh, gw, 8), **i32)     # bottom pixel row
    modes = torch.zeros((fdim, gh, gw), **i32)
    recon = torch.zeros((fdim, gh, gw, 8, 8), **i32)
    rd = r.to(dtype)
    for gy, gx, gyu, gxl, _ in _diagonals(gh, gw, dev):
        rec, mode = intra_decode_cells(
            rd[:, gy, gx], br[:, gyu, gx], rc[:, gy, gxl], (gy > 0)[None], (gx > 0)[None],
            modes[:, gy, gxl], modes[:, gyu, gxl], modes[:, gyu, gx], mpmf[:, gy, gx],
            mbit[:, gy, gx], dtype)
        recon[:, gy, gx] = rec
        rc[:, gy, gx] = rec[..., :, 7]
        br[:, gy, gx] = rec[..., 7, :]
        modes[:, gy, gx] = mode
    return recon
