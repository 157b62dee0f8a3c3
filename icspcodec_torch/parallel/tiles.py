"""Spatial (macroblock-column tile) parallelism with halo exchange.

Counterpart of icspcodec_tpu/parallel/tiles.py.  The reference has no
intra-frame parallelism: its raster wavefront is strictly sequential
(SURVEY.md section 2.3).  Here each frame's MB columns are split into
`ntiles` tiles, tile t held on device t of a device list (the `tile`
mesh), with bit-exact codec semantics at the seams:

* the anti-diagonal wavefront advances in global lockstep on every tile
  (tiled_schedule, the JAX package's schedule);
* after each step a tile's just-computed last-column state (right pixel
  column, intra mode, dequantized DC) is copied one tile to the right, and
  its first-column dequantized DC one tile to the left (the DC
  predictor's upper-right neighbour is the only leftward dependency): the
  JAX package's lax.ppermute, here an explicit .to(device) of the halo
  slices at the same point of each step;
* each tile keeps per-row boundary buffers of everything received, so a
  first-column cell reads its left and upper-left neighbours exactly as the
  single-device engine does.

The rest crosses seams as in the JAX package: motion search and
compensation read the previous recon through pixel halos one search range
deep (_pad_tiled); the sequential chains that need no per-step halo (the
forward residual chains with their DC DPCM, the inverse DC chains, the
walk-state composition of the search, the MV reconstruction) are gathered
onto the first tile's device, computed once there, and their columns sent
back (the JAX package's all_gather and replicated compute).

The tiled wavefronts are plain torch, as the JAX package's are plain XLA:
no kernel takes a per-step halo.  Every other stage calls the kernel whose
function it computes: the gathered forward residual chains (kernel F, luma
and chroma, as the untiled encoder runs them), the gathered inverse DC
chains (kernel B'), the per-tile union SADs (sad_union, kernel G's entry
point at all 129 offsets) and the per-tile motion compensation (kernel E);
on a CPU tensor each wrapper runs its plain version.  The results equal
the untiled engines' byte for byte, in both precisions
(tests/test_torch_tiles.py).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..codec import _DEC_INTER_KEYS, _DEC_INTRA_KEYS
from ..constants import COS_DEC, COS_ENC
from ..engine.inter import mv_reconstruct_scan
from ..engine.intra import from_blocks, to_blocks
from ..engine.wavefront import intra_decode_cells, intra_encode_cells
from ..ops.dc_fused import idc_dpcm_fused
from ..ops.mc_fused import chroma_mv, mc_gather, mc_gather_yc
from ..ops.me import compose_select, device_table, mv_diff_field, state_tables
from ..ops.me_fused import sad_union
from ..ops.quant import ac_flag_from_scan, c_trunc, dequant_block
from ..ops.scanorder import izigzag, zigzag
from ..ops.transforms import idct
from ..ops.xform_fused import xform_fwd_fused
from ..tables import NEG_UNION, luma_dc_kind
from .gop import mesh_for


# the JAX package's tile_mesh_for(shards, devices=None)
tile_mesh_for = functools.partial(mesh_for, axis="tile")


# ---------------------------------------------------------------------------
# per-tile schedules
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def tiled_schedule(gh: int, gw: int, ntiles: int):
    """Global-lockstep wavefront schedule split into column tiles.

    Returns numpy arrays indexed [tile, step, lane]:
      gy, gxl (local column), valid -- plus per [tile, step]:
      send_r_gy  (row of the last-column cell computed this step, -1 if none)
      send_l_gy  (row of the first-column cell computed this step, -1 if none)
    """
    assert gw % ntiles == 0
    gwl = gw // ntiles
    nsteps = 2 * (gh - 1) + gw
    nmax = min(gh, (gwl + 1) // 2 + 1)
    gys = np.full((ntiles, nsteps, nmax), gh, dtype=np.int32)
    gxs = np.full((ntiles, nsteps, nmax), gwl, dtype=np.int32)
    valid = np.zeros((ntiles, nsteps, nmax), dtype=bool)
    send_r = np.full((ntiles, nsteps), -1, dtype=np.int32)
    send_l = np.full((ntiles, nsteps), -1, dtype=np.int32)
    for t in range(ntiles):
        x0 = t * gwl
        for d in range(nsteps):
            lane = 0
            for gy in range(gh):
                gx = d - 2 * gy
                if x0 <= gx < x0 + gwl:
                    gys[t, d, lane] = gy
                    gxs[t, d, lane] = gx - x0
                    valid[t, d, lane] = True
                    if gx - x0 == gwl - 1:
                        send_r[t, d] = gy
                    if gx - x0 == 0:
                        send_l[t, d] = gy
                    lane += 1
    return gys, gxs, valid, send_r, send_l


@functools.lru_cache(maxsize=None)
def _tile_steps(gh: int, gw: int, ntiles: int, t: int, device: torch.device):
    """Per step of tiled_schedule, tile t's cells as index tensors on its
    device, or None where the tile has no cell: (gy, gx local, gy - 1, gx
    - 1 and gx + 1 clamped to the tile, first-column and last-column masks
    (1, N), has_up and has_left (1, N), the luma DC kinds (1, N))."""
    gys, gxs, valid, _, _ = tiled_schedule(gh, gw, ntiles)
    gwl = gw // ntiles
    kind = luma_dc_kind(gh, gw)[:, t * gwl:(t + 1) * gwl]
    out = []
    for d in range(gys.shape[1]):
        gy, gx = gys[t, d][valid[t, d]], gxs[t, d][valid[t, d]]
        if gy.size == 0:
            out.append(None)
            continue
        cols = (gy, gx, np.maximum(gy - 1, 0), np.maximum(gx - 1, 0),
                np.minimum(gx + 1, gwl - 1))
        masks = (gx == 0, gx == gwl - 1, gy > 0, gx + t * gwl > 0, kind[gy, gx])
        out.append(tuple(torch.from_numpy(np.asarray(a, np.int64)).to(device) for a in cols)
                   + tuple(torch.from_numpy(np.asarray(a)[None]).to(device) for a in masks))
    return out


def _split(x, mesh, axis: int) -> list[torch.Tensor]:
    """Split x into len(mesh) equal chunks along `axis`, chunk t on mesh[t]."""
    x = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
    return [c.to(dev).contiguous() for c, dev in zip(x.chunk(len(mesh), dim=axis), mesh)]


def _cat(parts: list[torch.Tensor], axis: int) -> torch.Tensor:
    """Concatenate per-tile tensors along `axis` on the first tile's device."""
    lead = parts[0].device
    return torch.cat([p.to(lead) for p in parts], dim=axis)


def _scatter(full: torch.Tensor, like: list[torch.Tensor], axis: int) -> list[torch.Tensor]:
    """Cut a gathered tensor back into the tiles' column ranges, each on its
    tile's device (like: the tiles whose widths along `axis` it takes)."""
    out, start = [], 0
    for t in like:
        n = t.shape[axis]
        out.append(full.narrow(axis, start, n).to(t.device))
        start += n
    return out


def _gather_tiles(tiles: list[dict]) -> dict:
    """Per-tile output dicts -> one dict on the first tile's device: planes
    (recon_*, y / cb / cr) along the pixel width, symbol grids along their
    block-column axis 2."""
    return {k: _cat([t[k] for t in tiles],
                    -1 if k.startswith("recon") or k in ("y", "cb", "cr") else 2)
            for k in tiles[0]}


# ---------------------------------------------------------------------------
# tiled intra luma wavefront
# ---------------------------------------------------------------------------


def intra_luma_scan_tiled(orig: list[torch.Tensor], qdc: int, qac: int, gw: int,
                          table=COS_ENC, dtype=torch.float32) -> list[dict]:
    """The tiled intra luma encoder.

    orig: per tile (F, gh, gwl, 8, 8) integer blocks, each on its device.
    Returns per tile dict(recon (F, gh, gwl, 8, 8) int32, scan (.., 64)
    int32 in zig-zag order, mpm, mode_bit (F, gh, gwl) int32): the tile's
    columns of engine/wavefront.intra_luma_scan_packed's output."""
    n = len(orig)
    fdim, gh, gwl = orig[0].shape[:3]
    _, _, _, send_r, send_l = tiled_schedule(gh, gw, n)
    st = []
    for o in orig:
        def z(*shape, dev=o.device):
            return torch.zeros((fdim,) + shape, dtype=torch.int32, device=dev)
        st.append(dict(recon=z(gh, gwl, 8, 8), rc=z(gh, gwl, 8), br=z(gh, gwl, 8),
                       modes=z(gh, gwl), dqdc=z(gh, gwl), scan=z(gh, gwl, 64),
                       mpm=z(gh, gwl), mode_bit=z(gh, gwl),
                       lb_col=z(gh, 8), lb_mode=z(gh), lb_dqdc=z(gh), rb_dqdc=z(gh)))
    steps = [_tile_steps(gh, gw, n, t, o.device) for t, o in enumerate(orig)]
    for d in range(send_r.shape[1]):
        for t in range(n):
            if steps[t][d] is None:
                continue
            gy, gx, gyu, gxl, gxr, fc, lc, has_up, has_left, kind = steps[t][d]
            s = st[t]
            rec, mode, dq_dc, q, flag, bit = intra_encode_cells(
                orig[t][:, gy, gx], s["br"][:, gyu, gx],
                torch.where(fc[..., None], s["lb_col"][:, gy], s["rc"][:, gy, gxl]),
                has_up, has_left,
                torch.where(fc, s["lb_mode"][:, gy], s["modes"][:, gy, gxl]),
                torch.where(fc, s["lb_mode"][:, gyu], s["modes"][:, gyu, gxl]),
                s["modes"][:, gyu, gx], kind,
                torch.where(fc, s["lb_dqdc"][:, gy], s["dqdc"][:, gy, gxl]),
                torch.where(fc, s["lb_dqdc"][:, gyu], s["dqdc"][:, gyu, gxl]),
                s["dqdc"][:, gyu, gx],
                torch.where(lc, s["rb_dqdc"][:, gyu], s["dqdc"][:, gyu, gxr]),
                qdc, qac, table, dtype)
            s["recon"][:, gy, gx] = rec
            s["rc"][:, gy, gx] = rec[..., :, 7]
            s["br"][:, gy, gx] = rec[..., 7, :]
            s["modes"][:, gy, gx] = mode
            s["dqdc"][:, gy, gx] = dq_dc
            s["scan"][:, gy, gx] = zigzag(q)
            s["mpm"][:, gy, gx] = flag.to(torch.int32)
            s["mode_bit"][:, gy, gx] = bit
        # the halo exchange of this step: the last column's state one tile
        # to the right, the first column's DC one tile to the left
        for t in range(n):
            r, l = int(send_r[t, d]), int(send_l[t, d])
            if r >= 0 and t + 1 < n:
                src, dst = st[t], st[t + 1]
                dev = dst["rc"].device
                dst["lb_col"][:, r] = src["rc"][:, r, gwl - 1].to(dev)
                dst["lb_mode"][:, r] = src["modes"][:, r, gwl - 1].to(dev)
                dst["lb_dqdc"][:, r] = src["dqdc"][:, r, gwl - 1].to(dev)
            if l >= 0 and t > 0:
                dst = st[t - 1]
                dst["rb_dqdc"][:, l] = st[t]["dqdc"][:, l, 0].to(dst["rc"].device)
    return [{k: s[k] for k in ("recon", "scan", "mpm", "mode_bit")} for s in st]


def encode_intra_luma_tiled(y, qdc: int, qac: int, mesh, dtype=torch.float32) -> dict:
    """Driver: split (F, H, W) luma frames column-wise over the device list
    and run the tiled wavefront.  Returns dict(recon_y uint8 planes, y_scan,
    mpm, mode_bit) gathered on mesh[0]."""
    y = y if isinstance(y, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(y))
    gw = y.shape[-1] // 8
    out = intra_luma_scan_tiled(_split(to_blocks(y).to(torch.int32), mesh, 2), qdc, qac, gw,
                                dtype=dtype)
    full = {k: _cat([o[k] for o in out], 2) for k in out[0]}
    return dict(recon_y=from_blocks(full["recon"].to(torch.uint8)), y_scan=full["scan"],
                mpm=full["mpm"], mode_bit=full["mode_bit"])


# ---------------------------------------------------------------------------
# the gathered chains and the pixel halos
# ---------------------------------------------------------------------------


def _xform_tiled(blocks: list[torch.Tensor], qdc: int, qac: int, chroma: bool, table,
                 dtype) -> list[dict]:
    """The forward residual chain across tiles: gather the (F, gh, gwl, 8, 8)
    integer blocks, run the whole chain once (kernel F on the card, as the
    untiled encoder does; its DC DPCM crosses every seam) and send each
    tile its columns of xform_fwd_fused's scan, acflag and r."""
    out = xform_fwd_fused(_cat(blocks, 2), qdc, qac, chroma, table, dtype)
    parts = {k: _scatter(v, blocks, 2) for k, v in out.items()}
    return [{k: v[t] for k, v in parts.items()} for t in range(len(blocks))]


def _idc_chain_tiled(iq_dc: list[torch.Tensor], chroma: bool) -> list[torch.Tensor]:
    """The inverse DC chain across tiles: gathered, run once (kernel B' on
    the card) and scattered back."""
    return _scatter(idc_dpcm_fused(_cat(iq_dc, 2).contiguous(), chroma), iq_dc, 2)


def _pad_tiled(prev: list[torch.Tensor], p: int) -> list[torch.Tensor]:
    """Reference-exact padding of the column tiles of a previous recon:
    (..., H, Wl) -> (..., H+2p, Wl+2p), each tile on its device.

    Inner seams take `p`-column halos from the neighbour tiles, copied
    with their top and bottom padding already applied, so the corners need
    no second exchange; the outer tiles replicate their edge column with
    the reference's off-by-one (pad_image: the final padded row and column
    are zero).  Together the tiles equal ops/pad.pad_image of the frame."""
    h = prev[0].shape[-2]
    cores = []
    for x in prev:
        rows = torch.arange(-p, h + p, device=x.device).clamp(0, h - 1)
        core = x[..., rows, :]
        core[..., -1, :] = 0  # the bottom zero row (reference quirk)
        cores.append(core)
    out = []
    for t, core in enumerate(cores):
        dev = core.device
        if t == 0:
            left = core[..., :1].expand(core.shape[:-1] + (p,))
        else:
            left = cores[t - 1][..., -p:].to(dev)
        if t == len(cores) - 1:
            right = core[..., -1:].repeat((1,) * (core.dim() - 1) + (p,))
            right[..., -1] = 0
        else:
            right = cores[t + 1][..., :p].to(dev)
        out.append(torch.cat([left, core, right], dim=-1))
    return out


# ---------------------------------------------------------------------------
# tiled chroma, intra frame and inter frame
# ---------------------------------------------------------------------------


def encode_chroma_tiled(blocks: list[torch.Tensor], qdc: int, qac: int, table=COS_ENC,
                        dtype=torch.float32) -> list[dict]:
    """The forward chroma chain on column tiles: per tile (F2, ch, cwl, 8, 8)
    integer blocks (intra pixels or inter residuals), through kernel F
    gathered (_xform_tiled).  Returns per tile dict(scan, acflag, idct), as
    engine/intra.encode_chroma_batch gives them for the whole frame."""
    return [dict(scan=o["scan"], acflag=o["acflag"], idct=o["r"])
            for o in _xform_tiled(blocks, qdc, qac, True, table, dtype)]


def encode_intra_frame_tiled(y: list, cb: list, cr: list, qdc: int, qac: int, gw: int,
                             table=COS_ENC, dtype=torch.float32) -> list[dict]:
    """Full intra frame encode (luma wavefront and chroma) on column tiles
    of (F, H, Wl) / (F, H/2, Wl/2) uint8 planes.  Returns per tile the dict
    of engine/intra.encode_intra_frames (symbols and recon planes)."""
    lum = intra_luma_scan_tiled([to_blocks(p).to(torch.int32) for p in y], qdc, qac, gw,
                                table=table, dtype=dtype)
    f = cb[0].shape[0]
    chroma = encode_chroma_tiled([to_blocks(torch.cat([b, r])).to(torch.int32)
                                  for b, r in zip(cb, cr)], qdc, qac, table=table, dtype=dtype)
    out = []
    for lm, c in zip(lum, chroma):
        o = dict(recon_y=from_blocks(lm["recon"]).to(torch.uint8),
                 y_scan=lm["scan"].to(torch.int16),
                 y_acflag=ac_flag_from_scan(lm["scan"]).to(torch.int8),
                 mpm=lm["mpm"].to(torch.int8), mode_bit=lm["mode_bit"].to(torch.int8))
        # intra chroma recon = clamp((int)idct), as the untiled engine
        rec = from_blocks(torch.clamp(c_trunc(c["idct"]), 0, 255).to(torch.uint8))
        for i, name in enumerate(("cb", "cr")):
            sl = slice(i * f, (i + 1) * f)
            o[f"recon_{name}"] = rec[sl]
            o[f"{name}_scan"] = c["scan"][sl].to(torch.int16)
            o[f"{name}_acflag"] = c["acflag"][sl].to(torch.int8)
        out.append(o)
    return out


def encode_inter_frame_tiled(cur: tuple, prev: tuple, qdc: int, qac: int, table=COS_ENC,
                             dtype=torch.float32) -> list[dict]:
    """P-frame encode on column tiles.  cur / prev: (y, cb, cr), each a list
    of per-tile (G, H, Wl) / (G, H/2, Wl/2) uint8 planes; prev the previous
    recon.  Returns per tile the dict of engine/inter.encode_inter_frame.

    The union SADs are tile-local: the 129 offsets reach +-16 px, exactly
    the pixel halo.  The stateful walk crosses every seam of the MB raster,
    so the per-state selection tables (G, 4, mbh, mbwl) are gathered and
    composed once (ops/me.compose_select), as the MV differences and the
    DC chains are."""
    cur_y, cur_cb, cur_cr = cur
    prev_y, prev_cb, prev_cr = prev
    lead = cur_y[0].device
    pads = _pad_tiled(prev_y, 16)
    tabs = [state_tables(sad_union(c, p)) for c, p in zip(cur_y, pads)]
    best_u = compose_select(_cat([b for b, _ in tabs], -1), _cat([s for _, s in tabs], -1))
    mv_full = device_table(NEG_UNION, lead)[best_u.to(torch.int64)]    # (G, mbh, mbw, 2)
    like = [b[:, 0] for b, _ in tabs]  # per tile (G, mbh, mbwl): its MB columns
    mv = _scatter(mv_full, like, 2)
    mvd = _scatter(mv_diff_field(mv_full).to(torch.int16), like, 2)

    preds = [mc_gather(p, m, 16) for p, m in zip(pads, mv)]
    lum = _xform_tiled([to_blocks(c.to(torch.int32) - pr.to(torch.int32))
                        for c, pr in zip(cur_y, preds)], qdc, qac, False, table, dtype)

    g = cur_cb[0].shape[0]
    padc = _pad_tiled([torch.cat([b, r]) for b, r in zip(prev_cb, prev_cr)], 8)
    predc = [mc_gather(p, torch.cat([chroma_mv(m)] * 2), 8) for p, m in zip(padc, mv)]
    chroma = encode_chroma_tiled(
        [to_blocks(torch.cat([b, r]).to(torch.int32) - pc.to(torch.int32))
         for b, r, pc in zip(cur_cb, cur_cr, predc)], qdc, qac, table=table, dtype=dtype)
    out = []
    for t, lm in enumerate(lum):
        # mergeBlock INTER casts the double IDCT to int before the add
        o = dict(recon_y=torch.clamp(preds[t].to(torch.int32) + from_blocks(lm["r"]), 0, 255)
                 .to(torch.uint8), y_scan=lm["scan"], y_acflag=lm["acflag"], mv_diff=mvd[t])
        # the chroma predictor is added in float before the (int) cast
        c = chroma[t]
        rec = torch.clamp(c_trunc(predc[t].to(dtype) + from_blocks(c["idct"])), 0, 255)
        for i, name in enumerate(("cb", "cr")):
            sl = slice(i * g, (i + 1) * g)
            o[f"recon_{name}"] = rec[sl].to(torch.uint8)
            o[f"{name}_scan"] = c["scan"][sl].to(torch.int16)
            o[f"{name}_acflag"] = c["acflag"][sl].to(torch.int8)
        out.append(o)
    return out


def _check_tiles(w: int, mesh) -> None:
    if (w // 16) % len(mesh):
        raise ValueError(f"ntiles={len(mesh)} must divide {w // 16} MB columns")


def encode_intra_frames_tiled(y, cb, cr, qdc: int, qac: int, mesh, dtype=torch.float32) -> dict:
    """Driver: tiled intra encode of (F, H, W) frames, the width split over
    the device list.  Returns the engine/intra.encode_intra_frames dict
    gathered on mesh[0]."""
    _check_tiles(y.shape[-1], mesh)
    return _gather_tiles(encode_intra_frame_tiled(
        _split(y, mesh, -1), _split(cb, mesh, -1), _split(cr, mesh, -1), qdc, qac,
        y.shape[-1] // 8, dtype=dtype))


def encode_gop_tiled(y, cb, cr, qdc: int, qac: int, mesh, dtype=torch.float32):
    """Driver: tiled encode of (G, P, H, W) closed GOPs, the tile-parallel
    counterpart of engine/inter.encode_gop.  The recon carry stays on the
    tiles; only halos and the gathered chains cross seams each step.
    Returns (intra, inter) like encode_gop, gathered on mesh[0]."""
    _check_tiles(y.shape[-1], mesh)
    p = y.shape[1]
    ys, cbs, crs = (_split(a, mesh, -1) for a in (y, cb, cr))
    intra = encode_intra_frame_tiled([a[:, 0] for a in ys], [a[:, 0] for a in cbs],
                                     [a[:, 0] for a in crs], qdc, qac, y.shape[-1] // 8,
                                     dtype=dtype)
    if p == 1:
        return _gather_tiles(intra), None
    carry = tuple([o[f"recon_{c}"] for o in intra] for c in ("y", "cb", "cr"))
    steps = []
    for k in range(1, p):
        o = encode_inter_frame_tiled(tuple([a[:, k] for a in tiles] for tiles in (ys, cbs, crs)),
                                     carry, qdc, qac, dtype=dtype)
        carry = tuple([t[f"recon_{c}"] for t in o] for c in ("y", "cb", "cr"))
        steps.append(_gather_tiles(o))
    return _gather_tiles(intra), {k: torch.stack([s[k] for s in steps], dim=1)
                                  for k in steps[0]}


def encode_inter_frames_tiled(cur: dict, prev: dict, qdc: int, qac: int, mesh,
                              dtype=torch.float32) -> dict:
    """Driver: encode a batch of P-frames with the width split over the
    device list.  cur / prev: dicts of (F, H, W) y / cb / cr planes.  Tiles
    must be macroblock-aligned: the tile count divides W / 16 (22 for CIF)."""
    _check_tiles(cur["y"].shape[-1], mesh)
    split = lambda d: tuple(_split(d[c], mesh, -1) for c in ("y", "cb", "cr"))  # noqa: E731
    return _gather_tiles(encode_inter_frame_tiled(split(cur), split(prev), qdc, qac,
                                                  dtype=dtype))


# ---------------------------------------------------------------------------
# tiled decode: the intra wavefront with recon / mode halos, inter MC with
# pixel halos.  The reference decoder is serial (decoder src:2083-2272);
# the seams follow the encode-side tiling exactly.
# ---------------------------------------------------------------------------


def intra_luma_decode_scan_tiled(r: list[torch.Tensor], mpm: list[torch.Tensor],
                                 mbit: list[torch.Tensor], gw: int,
                                 dtype=torch.float32) -> list[torch.Tensor]:
    """The tiled intra luma decode wavefront.  r: per tile (F, gh, gwl, 8, 8)
    inverse-DCT blocks (DC chain applied); mpm / mbit: (F, gh, gwl).  Only
    the right pixel column and the intra mode cross seams, rightward: the
    decode wavefront has no leftward dependency.  Returns per tile the
    recon blocks (F, gh, gwl, 8, 8) int32."""
    n = len(r)
    fdim, gh, gwl = r[0].shape[:3]
    send_r = tiled_schedule(gh, gw, n)[3]
    st = []
    for x in r:
        def z(*shape, dev=x.device):
            return torch.zeros((fdim,) + shape, dtype=torch.int32, device=dev)
        st.append(dict(recon=z(gh, gwl, 8, 8), rc=z(gh, gwl, 8), br=z(gh, gwl, 8),
                       modes=z(gh, gwl), lb_col=z(gh, 8), lb_mode=z(gh)))
    steps = [_tile_steps(gh, gw, n, t, x.device) for t, x in enumerate(r)]
    rd = [x.to(dtype) for x in r]
    for d in range(send_r.shape[1]):
        for t in range(n):
            if steps[t][d] is None:
                continue
            gy, gx, gyu, gxl, _, fc, _, has_up, has_left, _ = steps[t][d]
            s = st[t]
            rec, mode = intra_decode_cells(
                rd[t][:, gy, gx], s["br"][:, gyu, gx],
                torch.where(fc[..., None], s["lb_col"][:, gy], s["rc"][:, gy, gxl]),
                has_up, has_left,
                torch.where(fc, s["lb_mode"][:, gy], s["modes"][:, gy, gxl]),
                torch.where(fc, s["lb_mode"][:, gyu], s["modes"][:, gyu, gxl]),
                s["modes"][:, gyu, gx], mpm[t][:, gy, gx], mbit[t][:, gy, gx], dtype)
            s["recon"][:, gy, gx] = rec
            s["rc"][:, gy, gx] = rec[..., :, 7]
            s["br"][:, gy, gx] = rec[..., 7, :]
            s["modes"][:, gy, gx] = mode
        for t in range(n - 1):
            row = int(send_r[t, d])
            if row >= 0:
                dst = st[t + 1]
                dev = dst["rc"].device
                dst["lb_col"][:, row] = st[t]["rc"][:, row, gwl - 1].to(dev)
                dst["lb_mode"][:, row] = st[t]["modes"][:, row, gwl - 1].to(dev)
    return [s["recon"] for s in st]


def _dequant_tiled(scan: list[torch.Tensor], qdc: int, qac: int, chroma: bool):
    """Inverse zig-zag and dequantization of per-tile symbols, with the
    inverse DC chain run across the tiles."""
    iq = [dequant_block(izigzag(s.to(torch.int32)), qdc, qac) for s in scan]
    for x, dq in zip(iq, _idc_chain_tiled([x[..., 0, 0].contiguous() for x in iq], chroma)):
        x[..., 0, 0] = dq
    return iq


def decode_intra_frame_tiled(sym: list[dict], qdc: int, qac: int, gw: int, table=COS_DEC,
                             dtype=torch.float32) -> list[dict]:
    """Intra decode on column tiles: per tile symbols (y_scan, mpm,
    mode_bit, cb_scan, cr_scan) -> per tile dict(y, cb, cr) of uint8
    planes, as engine/intra.decode_intra_frames gives them."""
    iq = _dequant_tiled([s["y_scan"] for s in sym], qdc, qac, chroma=False)
    recon = intra_luma_decode_scan_tiled(
        [idct(x, table=table, dtype=dtype) for x in iq],
        [s["mpm"].to(torch.int32) for s in sym], [s["mode_bit"].to(torch.int32) for s in sym],
        gw, dtype=dtype)
    f = sym[0]["cb_scan"].shape[0]
    iqc = _dequant_tiled([torch.cat([s["cb_scan"], s["cr_scan"]]) for s in sym], qdc, qac,
                         chroma=True)
    out = []
    for rec, x in zip(recon, iqc):
        c = from_blocks(torch.clamp(c_trunc(idct(x, table=table, dtype=dtype)), 0, 255)
                        .to(torch.uint8))
        out.append(dict(y=from_blocks(rec).to(torch.uint8), cb=c[:f], cr=c[f:]))
    return out


def decode_inter_frame_tiled(sym: list[dict], prev: tuple, qdc: int, qac: int, table=COS_DEC,
                             dtype=torch.float32) -> list[dict]:
    """Inter decode on column tiles.  sym: per tile y_scan, cb_scan, cr_scan
    and the reconstructed "mv" (decode_gop_tiled reconstructs the MVs of
    all frames at once); prev: (y, cb, cr) lists of the previous planes'
    tiles.  Motion compensation (kernel E on the card) reads the previous
    recon through pixel halos.  Returns per tile dict(y, cb, cr)."""
    prev_y, prev_cb, prev_cr = prev
    iq = _dequant_tiled([s["y_scan"] for s in sym], qdc, qac, chroma=False)
    f = sym[0]["cb_scan"].shape[0]
    iqc = _dequant_tiled([torch.cat([s["cb_scan"], s["cr_scan"]]) for s in sym], qdc, qac,
                         chroma=True)
    pads = _pad_tiled(prev_y, 16)
    padc = _pad_tiled([torch.cat([b, r]) for b, r in zip(prev_cb, prev_cr)], 8)
    out = []
    for t, s in enumerate(sym):
        predf, predcf = mc_gather_yc(pads[t], padc[t], s["mv"])
        inv_f = from_blocks(c_trunc(idct(iq[t], table=table, dtype=dtype)))
        rc = from_blocks(idct(iqc[t], table=table, dtype=dtype))
        rec = torch.clamp(c_trunc(predcf.to(dtype) + rc), 0, 255).to(torch.uint8)
        out.append(dict(y=torch.clamp(predf.to(torch.int32) + inv_f, 0, 255).to(torch.uint8),
                        cb=rec[:f], cr=rec[f:]))
    return out


def _split_syms(sym: dict, keys, mesh, axis: int) -> list[dict]:
    parts = {k: _split(sym[k], mesh, axis) for k in keys}
    return [{k: parts[k][t] for k in keys} for t in range(len(mesh))]


def decode_intra_frames_tiled(sym: dict, qdc: int, qac: int, mesh,
                              dtype=torch.float32) -> dict:
    """Driver: tiled decode of F intra frames.  sym: the full-frame arrays
    y_scan, mpm, mode_bit, cb_scan, cr_scan.  Returns dict(y, cb, cr)
    gathered on mesh[0]."""
    gw = sym["y_scan"].shape[2]
    _check_tiles(gw * 8, mesh)
    return _gather_tiles(decode_intra_frame_tiled(_split_syms(sym, _DEC_INTRA_KEYS, mesh, 2),
                                                  qdc, qac, gw, dtype=dtype))


def decode_gop_tiled(sym_i: dict, sym_p: dict, qdc: int, qac: int, mesh,
                     dtype=torch.float32):
    """Driver: tiled decode of G GOPs: the intra first frames, then each
    P-frame position with the recon carry on the tiles.  sym_i: (G, ...)
    intra symbols; sym_p: (G, P-1, ...) inter symbols.  The MVs of all
    P-frames are reconstructed at once on the gathered MB grid, and each
    tile keeps its columns.  Returns (first, rest) plane dicts like
    codec.decode_gop, gathered on mesh[0]."""
    gw = sym_i["y_scan"].shape[2]
    _check_tiles(gw * 8, mesh)
    first = decode_intra_frame_tiled(_split_syms(sym_i, _DEC_INTRA_KEYS, mesh, 2), qdc, qac, gw,
                                     dtype=dtype)
    sp = _split_syms(sym_p, _DEC_INTER_KEYS, mesh, 3)
    mvd = _cat([s["mv_diff"].to(torch.int32) for s in sp], 3)        # (G, P-1, mbh, mbw, 2)
    g, pm1 = mvd.shape[:2]
    mv_full = mv_reconstruct_scan(mvd.flatten(0, 1)).reshape(mvd.shape)
    for s, m in zip(sp, _scatter(mv_full, [s["mv_diff"] for s in sp], 3)):
        s["mv"] = m
    carry = tuple([o[c] for o in first] for c in ("y", "cb", "cr"))
    steps = []
    for k in range(pm1):
        o = decode_inter_frame_tiled(
            [{n: s[n][:, k] for n in ("y_scan", "cb_scan", "cr_scan", "mv")} for s in sp],
            carry, qdc, qac, dtype=dtype)
        carry = tuple([t[c] for t in o] for c in ("y", "cb", "cr"))
        steps.append(_gather_tiles(o))
    return _gather_tiles(first), {k: torch.stack([s[k] for s in steps], dim=1)
                                  for k in ("y", "cb", "cr")}
