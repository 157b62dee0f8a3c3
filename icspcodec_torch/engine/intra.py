"""Intra frame engine: batched whole-frame encode and decode.

Everything embarrassingly parallel (chroma DCT, AC quantization, IDCT,
plane assembly) is one batched tensor op over all blocks of all frames;
the sequential chains go through the kernel wrappers: the luma pixel
wavefronts (ops/intra_fused.py, kernel A, to encode; ops/intra_decode_fused.py,
kernel C, to decode) and the chroma DC chains (ops/dc_fused.py, kernels B
and B').  Each wrapper runs its CUDA kernel on a CUDA tensor and its plain
version on a CPU tensor, in float32 and float64.
"""
from __future__ import annotations

import torch

from ..constants import COS_DEC, COS_ENC
from ..ops.dc_fused import dc_dpcm_fused, idc_dpcm_fused
from ..ops.intra_decode_fused import intra_luma_decode_fused
from ..ops.intra_fused import intra_luma_scan_fused
from ..ops.quant import ac_flag, c_trunc, dequant_block, quant_block
from ..ops.scanorder import izigzag, zigzag
from ..ops.transforms import fdct, idct


def to_blocks(plane: torch.Tensor, bs: int = 8) -> torch.Tensor:
    """(..., H, W) -> (..., H//bs, W//bs, bs, bs), a view."""
    h, w = plane.shape[-2:]
    lead = plane.shape[:-2]
    x = plane.reshape(lead + (h // bs, bs, w // bs, bs))
    return x.movedim(-3, -2)


def from_blocks(blocks: torch.Tensor) -> torch.Tensor:
    gh, gw, bs = blocks.shape[-4], blocks.shape[-3], blocks.shape[-1]
    x = blocks.movedim(-2, -3)
    return x.reshape(blocks.shape[:-4] + (gh * bs, gw * bs))


def encode_chroma_batch(planes: torch.Tensor, qdc: int, qac: int, table=COS_ENC,
                        dtype=torch.float64):
    """Forward chroma chain for (F, H, W) pixel planes.  Returns dict(scan,
    acflag, idct); idct is the float inverse-DCT output, which callers turn
    into pixels their own way."""
    blocks = to_blocks(planes).to(torch.int32)
    d = fdct(blocks, table=table, dtype=dtype)
    q_dc, dq_dc = dc_dpcm_fused(d[..., 0, 0], qdc, chroma=True)
    q = quant_block(d, qdc, qac, chroma=True)
    q[..., 0, 0] = q_dc
    sc = zigzag(q)
    acf = ac_flag(q)
    iq = dequant_block(q, qdc, qac)
    iq[..., 0, 0] = dq_dc
    r = idct(iq, table=table, dtype=dtype)
    return dict(scan=sc, acflag=acf, idct=r)


def encode_intra_frames(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor, qdc: int,
                        qac: int, table=COS_ENC, dtype=torch.float64,
                        return_recon: bool = True):
    """Encode a batch of intra frames.

    y: (F, H, W) uint8; cb/cr: (F, H/2, W/2) uint8, all on one device.
    Returns the bitstream symbols (y_scan int16 in zig-zag order, y_acflag,
    mpm, mode_bit int8; cb/cr_scan int16, cb/cr_acflag int8) and, with
    return_recon, the recon planes recon_y / recon_cb / recon_cr (uint8).
    """
    lum = intra_luma_scan_fused(to_blocks(y), qdc, qac, table=table, dtype=dtype,
                                want_recon=return_recon, recon_plane=True)
    out = dict(y_scan=lum["scan"], y_acflag=lum["acflag"], mpm=lum["mpm"],
               mode_bit=lum["mode_bit"])
    if return_recon:
        out["recon_y"] = lum["recon_plane"]
    # Cb and Cr share the chain: one batch, one DC chain launch
    f = cb.shape[0]
    c = encode_chroma_batch(torch.cat([cb, cr]), qdc, qac, table=table, dtype=dtype)
    if return_recon:
        # intra chroma recon = clamp((int)idct) (intraImgReconstruct enc
        # src:1944-1960: truncation toward zero, then clamp)
        rec = from_blocks(torch.clamp(c_trunc(c["idct"]), 0, 255).to(torch.uint8))
    for i, name in enumerate(("cb", "cr")):
        sl = slice(i * f, (i + 1) * f)
        if return_recon:
            out[f"recon_{name}"] = rec[sl]
        out[f"{name}_scan"] = c["scan"][sl].to(torch.int16)
        out[f"{name}_acflag"] = c["acflag"][sl].to(torch.int8)
    return out


def decode_chroma_idct(cb_scan: torch.Tensor, cr_scan: torch.Tensor, qdc: int, qac: int,
                       table=COS_DEC, dtype=torch.float64) -> torch.Tensor:
    """Inverse chroma chain of Cb and Cr stacked into one batch (one DC chain
    launch): (F, ch, cw, 64) symbols each -> the float inverse-DCT output
    (2F, ch, cw, 8, 8), which callers turn into pixels their own way."""
    qc = izigzag(torch.cat([cb_scan, cr_scan]).to(torch.int32))
    iqc = dequant_block(qc, qdc, qac)
    iqc[..., 0, 0] = idc_dpcm_fused(iqc[..., 0, 0], chroma=True)
    return idct(iqc, table=table, dtype=dtype)


def decode_intra_frames(y_scan, mpm, mode_bit, cb_scan, cr_scan, qdc: int, qac: int,
                        table=COS_DEC, dtype=torch.float64):
    """Inverse pipeline for a batch of intra frames (symbols -> planes).

    y_scan: (F, gh, gw, 64) zig-zag symbols; mpm / mode_bit (F, gh, gw);
    cb/cr_scan (F, gh/2, gw/2, 64).  Luma goes through kernel C, Cb and Cr
    through the inverse DC chain (kernel B') and the batched IDCT.  Returns
    dict(y, cb, cr) of uint8 planes."""
    out = dict(y=intra_luma_decode_fused(y_scan, mpm, mode_bit, qdc, qac, table=table,
                                         dtype=dtype))
    f = cb_scan.shape[0]
    # intra chroma recon = clamp((int)idct) (intraImgReconstruct: truncation
    # toward zero, then clamp)
    r = decode_chroma_idct(cb_scan, cr_scan, qdc, qac, table=table, dtype=dtype)
    rec = from_blocks(torch.clamp(c_trunc(r), 0, 255).to(torch.uint8))
    out["cb"], out["cr"] = rec[:f], rec[f:]
    return out
