"""Inter frame engine: the encode half (motion search, motion compensation,
the residual chains, the GOP scan) and the decode half (MV reconstruction
and the inverse inter pipeline).

Counterpart of icspcodec_tpu/engine/inter.py.  The encoder takes the JAX
package's fused route, me="pallas", in both precisions: kernel D
(ops/me_fused.py) gives the canonical search, its zero counts, the
canonical SAD rows and the luma predictor in one pass; only when some MB
of the batch breaks the reference's walk early (two zero SADs) does
kernel G add the non-canonical union SADs and the stateful selection
(ops/me.stateful_select) decide.  Kernel E (ops/mc_fused.py) builds the
predictors that D does not, and kernel F (ops/xform_fused.py) runs the
luma and chroma residual chains.  The search's integer outputs are
exact, so in float64 the stream equals the JAX package's exact route
(me="xla").  The GOP scan is a Python loop over the P-frame positions,
each one step batched over the GOPs.

The decoder's residual chain is batched tensor ops over all blocks of all
frames, with the inverse DC chains through kernel B' (ops/dc_fused.py);
motion compensation gathers each predictor block at its reconstructed MV
through kernel E, as the JAX package's me="xla" decode does, so no MV is
mapped back to an offset-table index; one launch (mc_gather_yc) builds a
step's luma and chroma predictors.  The MV reconstruction is a plain
loop over the MB-grid diagonals, batched over every frame given.
"""
from __future__ import annotations

import torch

from ..constants import COS_DEC, COS_ENC, SPIRAL_UNION
from ..ops.dc_fused import idc_dpcm_fused, kind_grid
from ..ops.mc_fused import mc_gather_yc, mc_select
from ..ops.me import device_table, mv_diff_field, stateful_select
from ..ops.me_fused import sad_mc_best, sad_union_extra
from ..ops.medians import median3, median3_mv_y
from ..ops.pad import pad_image
from ..ops.quant import c_trunc, dequant_block
from ..ops.scanorder import izigzag
from ..ops.transforms import idct
from ..ops.xform_fused import xform_fwd_fused
from ..tables import (CHROMA_OFFSETS, CHROMA_U_OFFSETS, NEG_SPIRAL, NEG_UNION, SPIRAL_TO_CHROMA,
                      UNION_TO_CHROMA_U)
from .intra import (decode_chroma_idct, encode_chroma_batch, encode_intra_frames, from_blocks,
                    to_blocks)
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


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------


def encode_inter_frame(cur_y, cur_cb, cur_cr, prev_y, prev_cb, prev_cr, qdc: int, qac: int,
                       table=COS_ENC, dtype=torch.float64):
    """Encode a batch of P-frames, one per GOP.

    cur_*: (G, H, W) / (G, H/2, W/2) uint8 frames; prev_*: the previous
    frames' recon planes.  Returns dict(recon_y / recon_cb / recon_cr uint8,
    y_scan int16, y_acflag int8, mv_diff int16 (G, mbh, mbw, 2), cb / cr_scan
    int16, cb / cr_acflag int8).

    The branch between the canonical search and the stateful one is taken
    on the host, once a step, as the JAX package's lax.cond does: it reads
    back whether any MB has zc >= 2."""
    g = cur_cb.shape[0]
    dev = cur_y.device
    pad = pad_image(prev_y, 16)
    padc = pad_image(torch.cat([prev_cb, prev_cr]), 8)
    best, zc, sads_c, pred_y = sad_mc_best(cur_y, pad)
    if bool((zc >= 2).any()):
        # an MB breaks the walk early and mirrors the walk state for the
        # rest of the frame: select over the 129 union offsets
        best_u = stateful_select(torch.cat([sads_c, sad_union_extra(cur_y, pad)], dim=1))
        bu = best_u.to(torch.int64)
        mv = device_table(NEG_UNION, dev)[bu]
        pred_y = mc_select(pad, best_u, SPIRAL_UNION, 16)
        cidx = device_table(UNION_TO_CHROMA_U, dev)[bu]
        pred_c = mc_select(padc, torch.cat([cidx, cidx]), CHROMA_U_OFFSETS, 8)
    else:
        bi = best.to(torch.int64)
        mv = device_table(NEG_SPIRAL, dev)[bi]
        cidx = device_table(SPIRAL_TO_CHROMA, dev)[bi]
        pred_c = mc_select(padc, torch.cat([cidx, cidx]), CHROMA_OFFSETS, 8)

    pred_i = pred_y.to(torch.int32)
    lum = xform_fwd_fused(to_blocks(cur_y.to(torch.int32) - pred_i), qdc, qac, chroma=False,
                          table=table, dtype=dtype)
    # mergeBlock INTER casts the double IDCT to int before the add (enc src:4812)
    out = dict(recon_y=torch.clamp(pred_i + from_blocks(lum["r"]), 0, 255).to(torch.uint8),
               y_scan=lum["scan"], y_acflag=lum["acflag"],
               mv_diff=mv_diff_field(mv).to(torch.int16))
    # chroma: Cb and Cr stacked into one batch, one kernel F launch; the
    # predictor is added in float BEFORE the (int) cast (enc src:2538 ff.)
    err = to_blocks(torch.cat([cur_cb, cur_cr]).to(torch.int32) - pred_c.to(torch.int32))
    c = encode_chroma_batch(err, qdc, qac, table=table, dtype=dtype)
    rec = torch.clamp(c_trunc(pred_c.to(dtype) + from_blocks(c["idct"])), 0, 255).to(torch.uint8)
    for i, name in enumerate(("cb", "cr")):
        sl = slice(i * g, (i + 1) * g)
        out[f"recon_{name}"] = rec[sl]
        out[f"{name}_scan"] = c["scan"][sl]
        out[f"{name}_acflag"] = c["acflag"][sl]
    return out


def encode_gop(y, cb, cr, qdc: int, qac: int, table=COS_ENC, dtype=torch.float64):
    """Encode closed GOPs: frame 0 intra, the rest P-frames.

    y: (G, P, H, W) uint8, G independent GOPs of P frames; cb / cr (G, P,
    H/2, W/2).  Returns (intra, inter): the intra frames' symbols and recon
    planes (G, ...), as encode_intra_frames gives them, and the P-frames'
    (G, P-1, ...), as encode_inter_frame gives them, or None when P == 1.
    Each P-frame position is one step batched over the GOPs, carrying the
    previous recon planes."""
    p = y.shape[1]
    intra = encode_intra_frames(y[:, 0], cb[:, 0], cr[:, 0], qdc, qac, table=table,
                                dtype=dtype)
    if p == 1:
        return intra, None
    carry = (intra["recon_y"], intra["recon_cb"], intra["recon_cr"])
    steps = []
    for k in range(1, p):
        o = encode_inter_frame(y[:, k], cb[:, k], cr[:, k], *carry, qdc, qac, table=table,
                               dtype=dtype)
        carry = (o["recon_y"], o["recon_cb"], o["recon_cr"])
        steps.append(o)
    return intra, {k: torch.stack([o[k] for o in steps], dim=1) for k in steps[0]}


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


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
    # luma and chroma predictors in one launch; the chroma MVs are mv/2 with
    # C truncation (CmotionCompensation enc src:2538), derived in the kernel
    predf, predcf = mc_gather_yc(pad_image(prev_y, 16),
                                 pad_image(torch.cat([prev_cb, prev_cr]), 8), mv)
    # mergeBlock INTER casts the double IDCT to int before the add
    out = dict(y=torch.clamp(predf.to(torch.int32) + inv_f, 0, 255).to(torch.uint8))
    rc = from_blocks(decode_chroma_idct(sym["cb_scan"], sym["cr_scan"], qdc, qac,
                                        table=table, dtype=dtype))
    # chroma: the predictor is added in float BEFORE the (int) cast (the
    # reference sums in double, then casts)
    rec = torch.clamp(c_trunc(predcf.to(dtype) + rc), 0, 255).to(torch.uint8)
    out["cb"], out["cr"] = rec[:f], rec[f:]
    return out
