"""Inter frame engine, decode side: MV reconstruction and the inverse inter
pipeline.

Counterpart of the decode half of icspcodec_tpu/engine/inter.py.  The
residual chain is batched tensor ops over all blocks of all frames, with
the inverse DC chains through kernel B' (ops/dc_fused.py); motion
compensation gathers each predictor block at its reconstructed MV through
kernel E (ops/mc_fused.py), as the JAX package's me="xla" decode does, so
no MV is mapped back to an offset-table index.  The MV reconstruction is a
plain loop over the MB-grid diagonals, batched over every frame given.
"""
from __future__ import annotations

import torch

from ..constants import COS_DEC
from ..ops.dc_fused import idc_dpcm_fused, kind_grid
from ..ops.mc_fused import mc_gather
from ..ops.medians import median3, median3_mv_y
from ..ops.pad import pad_image
from ..ops.quant import c_trunc, dequant_block
from ..ops.scanorder import izigzag
from ..ops.transforms import idct
from .intra import decode_chroma_idct, from_blocks
from .wavefront import _diagonals


def mb_to_grid8(resid16: torch.Tensor) -> torch.Tensor:
    """(..., mbh, mbw, 16, 16) -> (..., 2*mbh, 2*mbw, 8, 8) global grid."""
    lead = resid16.shape[:-4]
    mbh, mbw = resid16.shape[-4], resid16.shape[-3]
    n = len(lead)
    # (..., mbh, mbw, sy, py, sx, px) -> (..., mbh, sy, mbw, sx, py, px)
    x = resid16.reshape(lead + (mbh, mbw, 2, 8, 2, 8))
    x = x.permute(*range(n), n, n + 2, n + 1, n + 4, n + 3, n + 5)
    return x.reshape(lead + (2 * mbh, 2 * mbw, 8, 8))


def grid8_to_mb(blocks: torch.Tensor) -> torch.Tensor:
    """(..., 2*mbh, 2*mbw, 8, 8) -> (..., mbh, mbw, 16, 16)."""
    lead = blocks.shape[:-4]
    gh, gw = blocks.shape[-4], blocks.shape[-3]
    n = len(lead)
    # (..., mbh, sy, mbw, sx, py, px) -> (..., mbh, mbw, sy, py, sx, px)
    x = blocks.reshape(lead + (gh // 2, 2, gw // 2, 2, 8, 8))
    x = x.permute(*range(n), n, n + 2, n + 1, n + 4, n + 3, n + 5)
    return x.reshape(lead + (gh // 2, gw // 2, 16, 16))


def mv_reconstruct_scan(mv_diff: torch.Tensor) -> torch.Tensor:
    """Sequential MV reconstruction on the MB grid (ImvPrediction).

    mv_diff: (F, mbh, mbw, 2) integer, (x, y) order.  Walks the MB-grid
    diagonals; the predictor kinds are those of chroma_dc_kind (the same
    first-row / first-column / right-edge topology), with the constant
    predictor (8, 8) and the y-median typo.  Returns (F, mbh, mbw, 2) int32.
    """
    fdim, mbh, mbw = mv_diff.shape[:3]
    dev = mv_diff.device
    kindg = kind_grid(mbh, mbw, True, dev)
    diff = mv_diff.to(torch.int32)
    mv = torch.zeros_like(diff)
    for gy, gx, gyu, gxl, gxr in _diagonals(mbh, mbw, dev):
        l, u = mv[:, gy, gxl], mv[:, gyu, gx]
        ul, ur = mv[:, gyu, gxl], mv[:, gyu, gxr]
        kv = kindg[gy, gx][None]
        # median triples: kind 3 -> (l, ul, u); kind 4 -> (l, u, ur)
        bx = torch.where(kv == 3, ul[..., 0], u[..., 0])
        by = torch.where(kv == 3, ul[..., 1], u[..., 1])
        cx = torch.where(kv == 3, u[..., 0], ur[..., 0])
        cy = torch.where(kv == 3, u[..., 1], ur[..., 1])
        medx = median3(l[..., 0], bx, cx)
        medy = median3_mv_y(l[..., 1], by, cy, cx)
        px = torch.where(kv == 0, 8, torch.where(kv == 1, l[..., 0], torch.where(
            kv == 2, u[..., 0], medx)))
        py = torch.where(kv == 0, 8, torch.where(kv == 1, l[..., 1], torch.where(
            kv == 2, u[..., 1], medy)))
        mv[:, gy, gx] = diff[:, gy, gx] + torch.stack([px, py], dim=-1)
    return mv


def decode_gop_mvs(mv_diff: torch.Tensor) -> torch.Tensor:
    """Reconstruct the MVs of a whole (G, P-1, mbh, mbw, 2) symbol batch in
    one wavefront walk (frames are independent given their mv_diff).
    Returns (G, P-1, mbh, mbw, 2) int32."""
    g, pm1, mbh, mbw = mv_diff.shape[:4]
    return mv_reconstruct_scan(mv_diff.reshape(g * pm1, mbh, mbw, 2)).reshape(
        g, pm1, mbh, mbw, 2)


def decode_inter_frame(sym: dict, prev_y, prev_cb, prev_cr, qdc: int, qac: int,
                       table=COS_DEC, dtype=torch.float64):
    """Inverse inter pipeline for a batch of frames (symbols -> planes).

    sym: y_scan (F, gh, gw, 64), cb/cr_scan (F, gh/2, gw/2, 64) and either
    the reconstructed "mv" (F, mbh, mbw, 2) (decode_gop_mvs, hoisted out of
    the frame loop) or "mv_diff".  prev_*: the previous frames' planes.
    Returns dict(y, cb, cr) of uint8 planes."""
    f = prev_cb.shape[0]
    mv = sym["mv"] if "mv" in sym else mv_reconstruct_scan(sym["mv_diff"])
    q = izigzag(sym["y_scan"].to(torch.int32))
    iq = dequant_block(q, qdc, qac)
    iq[..., 0, 0] = idc_dpcm_fused(iq[..., 0, 0], chroma=False)
    inv_f = from_blocks(c_trunc(idct(iq, table=table, dtype=dtype)))
    predf = mc_gather(pad_image(prev_y, 16), mv, 16)
    # chroma MV: mv/2 with C truncation (CmotionCompensation enc src:2538)
    mvc = torch.sign(mv) * torch.div(mv.abs(), 2, rounding_mode="floor")
    predcf = mc_gather(pad_image(torch.cat([prev_cb, prev_cr]), 8), torch.cat([mvc, mvc]), 8)
    # mergeBlock INTER casts the double IDCT to int before the add
    out = dict(y=torch.clamp(predf.to(torch.int32) + inv_f, 0, 255).to(torch.uint8))
    rc = from_blocks(decode_chroma_idct(sym["cb_scan"], sym["cr_scan"], qdc, qac,
                                        table=table, dtype=dtype))
    # chroma: the predictor is added in float BEFORE the (int) cast (the
    # reference sums in double, then casts)
    rec = torch.clamp(c_trunc(predcf.to(dtype) + rc), 0, 255).to(torch.uint8)
    out["cb"], out["cr"] = rec[:f], rec[f:]
    return out
