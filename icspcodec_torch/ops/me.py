"""Motion estimation and compensation of the inter codec, in plain torch.

Counterpart of icspcodec_tpu/ops/me.py.  The reference walks a 64-step
spiral per macroblock with early exits (motionEstimation, enc src:2073-2155);
here every candidate SAD of every MB is computed densely (sad_dense) and
the reference's rule is applied afterwards:

* the first *strict* minimum in walk order wins;
* except when two or more evaluations have SAD == 0: the walk breaks at
  the second zero, which wins, and the walk state (flag / xflag / yflag,
  which persist across MBs, enc src:2094-2109) is left mid-cycle, so every
  later MB of the frame walks a mirrored spiral.  The four reachable walk
  states give per-MB selection tables (state_tables); the state entering
  each MB is a prefix composition of per-MB 4-state maps along the raster
  (compose_select), written as a log-depth Hillis-Steele scan.

spiral_search is the plain reference of the whole search: the canonical
selection, and only when some MB breaks early the union offsets and the
state composition.  Its two halves are public too, as in the JAX package:
spiral_search_fixed (every MB walks the canonical spiral) and
spiral_search_union (always the union offsets and the composition).  The
fused search of the encoder (ops/me_fused.py, kernels D and G) produces the
SADs these selections consume.

gather_pred is the plain version of kernel E (ops/mc_fused.py): each
(bs x bs) predictor block is read from the padded previous frame at
origin - mv + pad, with the window origin mapped into the padded frame as
jax.lax.dynamic_slice maps it in the JAX package's gather_pred (window_start
below), so the two agree for any MV, a corrupt one included.  mv_diff_field is the
encoder's differential MV field (mvPrediction enc src:2353-2425).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..constants import N_SPIRAL_STATES, SPIRAL, SPIRAL_STATE_IDX, SPIRAL_TRANS, SPIRAL_UNION
from ..tables import N_CANON, NEG_SPIRAL, NEG_UNION
from .medians import median3, median3_mv_y


@functools.lru_cache(maxsize=None)
def _device_table(data: bytes, dtype: str, shape: tuple, device: torch.device) -> torch.Tensor:
    arr = np.frombuffer(data, dtype).reshape(shape)
    return torch.from_numpy(arr.copy()).to(device)


def device_table(arr: np.ndarray, device) -> torch.Tensor:
    """A numpy table on the device, copied there once per device."""
    arr = np.ascontiguousarray(arr)
    return _device_table(arr.tobytes(), arr.dtype.str, arr.shape, torch.device(device))


def sad_dense(cur_y: torch.Tensor, pad_prev: torch.Tensor, offsets, bs: int = 16) -> torch.Tensor:
    """Dense SADs at `offsets` ((n, 2) in (x, y) order) for every MB:
    (..., n, mbh, mbw) int32.  cur_y: (..., H, W) uint8; pad_prev:
    (..., H+2bs, W+2bs) uint8, the padded previous reconstruction."""
    h, w = cur_y.shape[-2], cur_y.shape[-1]
    mbh, mbw = h // bs, w // bs
    lead = cur_y.shape[:-2]
    cur = cur_y.to(torch.int32).reshape(lead + (mbh, bs, mbw, bs))
    pad = pad_prev.to(torch.int32)
    sads = []
    for ox, oy in np.asarray(offsets).tolist():
        win = pad[..., bs + oy:bs + oy + h, bs + ox:bs + ox + w].reshape(lead + (mbh, bs, mbw, bs))
        sads.append((cur - win).abs().sum(dim=(-3, -1), dtype=torch.int32))
    return torch.stack(sads, dim=-3)


def _select_from_seq(seq: torch.Tensor):
    """The reference's selection over a (..., 64, mbh, mbw) SAD sequence in
    walk order.  Returns (best_step, steps_taken) int32: the first strict
    minimum, overridden by the second zero-SAD evaluation (enc
    src:2128-2141), and how many steps the walk ran (64 without a break)."""
    best = torch.argmin(seq, dim=-3)                 # the first minimum
    zeros = seq == 0
    is2 = zeros & (torch.cumsum(zeros, dim=-3) == 2)
    has2 = is2.any(dim=-3)
    second = torch.argmax(is2.to(torch.uint8), dim=-3)   # the first True
    best = torch.where(has2, second, best)
    steps = torch.where(has2, second + 1, 64)
    return best.to(torch.int32), steps.to(torch.int32)


def state_tables(sads_u: torch.Tensor):
    """Per-entry-state selection tables from the union SADs (..., 129, mbh,
    mbw): (best_u, steps), each (..., S, mbh, mbw) int32, the winning union
    offset and the walk length for every state the walk may enter an MB in."""
    dev = sads_u.device
    sidx = device_table(SPIRAL_STATE_IDX.astype(np.int64), dev)          # (S, 64)
    seq = sads_u[..., sidx, :, :]                                       # (..., S, 64, mbh, mbw)
    best_step, steps = _select_from_seq(seq)                            # (..., S, mbh, mbw)
    s_ix = torch.arange(N_SPIRAL_STATES, device=dev)[:, None, None]
    best_u = sidx.reshape(-1)[s_ix * 64 + best_step.to(torch.int64)]
    return best_u.to(torch.int32), steps


def compose_select(best_u: torch.Tensor, steps: torch.Tensor) -> torch.Tensor:
    """Raster state composition: the per-state tables (..., S, mbh, mbw) ->
    the chosen union offset index (..., mbh, mbw) int32.

    Each MB maps the walk state entering it to the state leaving it (a map
    {0..3} -> {0..3}); these maps compose associatively, so the
    raster-sequential loop of the reference (enc src:2104) becomes an
    inclusive prefix scan over the mbh*mbw MBs in ceil(log2(mbh*mbw))
    rounds (Hillis-Steele), each one gather."""
    lead = best_u.shape[:-3]
    mbh, mbw = best_u.shape[-2], best_u.shape[-1]
    n = mbh * mbw
    dev = best_u.device
    s_ix = torch.arange(N_SPIRAL_STATES, device=dev)[:, None, None]
    trans_t = device_table(SPIRAL_TRANS.astype(np.int64), dev)
    trans = trans_t.reshape(-1)[s_ix * SPIRAL_TRANS.shape[1] + steps.to(torch.int64)]

    def flat(a):  # (..., S, mbh, mbw) -> (..., N, S), raster order
        return a.reshape(lead + (N_SPIRAL_STATES, n)).movedim(-2, -1)

    g = flat(trans)
    d = 1
    while d < n:
        # g[i] is the composition of the maps of MBs i-d+1 .. i; the new
        # g[i] applies g[i-d] first, then g[i]: new[i][s] = g[i][g[i-d][s]]
        head = g[..., :d, :]
        tail = torch.gather(g[..., d:, :], -1, g[..., :-d, :])
        g = torch.cat([head, tail], dim=-2)
        d *= 2
    # the state entering each MB; MB 0 starts in the canonical state 0
    entry = torch.cat([torch.zeros(lead + (1,), dtype=g.dtype, device=dev), g[..., :-1, 0]],
                      dim=-1)
    best = torch.gather(flat(best_u), -1, entry[..., None])[..., 0]
    return best.reshape(lead + (mbh, mbw)).to(torch.int32)


def stateful_select(sads_u: torch.Tensor) -> torch.Tensor:
    """The full stateful selection from the union SADs (..., 129, mbh, mbw):
    the chosen union offset index (..., mbh, mbw) int32."""
    return compose_select(*state_tables(sads_u))


def spiral_search_fixed(cur_y: torch.Tensor, pad_prev: torch.Tensor, bs: int = 16) -> torch.Tensor:
    """The fixed-table search (every MB walks the canonical spiral): mv
    (..., mbh, mbw, 2) int32, -SPIRAL[best].  Exact on break-free content;
    the hybrid's fast branch."""
    best, _ = _select_from_seq(sad_dense(cur_y, pad_prev, SPIRAL, bs))
    return device_table(NEG_SPIRAL, cur_y.device)[best.to(torch.int64)]


def spiral_search_union(cur_y: torch.Tensor, pad_prev: torch.Tensor, bs: int = 16):
    """The stateful-exact search over the full union SADs: (mv (..., mbh,
    mbw, 2) int32, best union-offset index (..., mbh, mbw) int32).  Always
    computes all 129 offsets; spiral_search is the gated hybrid."""
    best = stateful_select(sad_dense(cur_y, pad_prev, SPIRAL_UNION, bs))
    return device_table(NEG_UNION, cur_y.device)[best.to(torch.int64)], best


def spiral_search(cur_y: torch.Tensor, pad_prev: torch.Tensor, bs: int = 16) -> torch.Tensor:
    """The stateful-exact search, plain: mv (..., mbh, mbw, 2) int32 in the
    reference's convention mv = -(chosen offset), (x, y) order.

    Computes the canonical selection; iff some MB breaks early (two zero-SAD
    evaluations in its canonical walk, the only event that changes the
    walk state), it adds the remaining union offsets and the state
    composition.  The branch is taken on the host."""
    dev = cur_y.device
    neg_union = device_table(NEG_UNION, dev)
    step_rows = device_table(SPIRAL_STATE_IDX[0].astype(np.int64), dev)
    sads_c = sad_dense(cur_y, pad_prev, SPIRAL_UNION[:N_CANON], bs)
    best0, steps0 = _select_from_seq(sads_c[..., step_rows, :, :])
    if bool((steps0 < 64).any()):
        extra = sad_dense(cur_y, pad_prev, SPIRAL_UNION[N_CANON:], bs)
        return neg_union[stateful_select(torch.cat([sads_c, extra], dim=-3)).to(torch.int64)]
    return neg_union[step_rows[best0.to(torch.int64)]]


def window_start(start: torch.Tensor, dim: int, bs: int) -> torch.Tensor:
    """A window's start along a padded axis of length dim, as
    jax.lax.dynamic_slice takes it: a negative start counts from the end
    (start + dim), then the start is clamped to [0, dim - bs] so that the
    window lies inside.  An MV of a compliant stream never reaches either
    rule."""
    return torch.where(start < 0, start + dim, start).clamp(0, dim - bs)


def gather_pred(pad: torch.Tensor, mv: torch.Tensor, bs: int) -> torch.Tensor:
    """Per-block predictors: pad (..., PH, PW); mv (..., mbh, mbw, 2) in
    (x, y) order.  Returns (..., mbh, mbw, bs, bs) in pad's dtype."""
    mbh, mbw = mv.shape[-3], mv.shape[-2]
    ph, pw = pad.shape[-2:]
    dev = pad.device
    by = torch.arange(mbh, device=dev) * bs
    bx = torch.arange(mbw, device=dev) * bs
    mv = mv.to(torch.int64)
    ry = window_start(by[:, None] - mv[..., 1] + bs, ph, bs)   # (..., mbh, mbw)
    rx = window_start(bx[None, :] - mv[..., 0] + bs, pw, bs)
    k = torch.arange(bs, device=dev)
    rows = (ry[..., None] + k)[..., :, None]                  # (..., mbh, mbw, bs, 1)
    cols = (rx[..., None] + k)[..., None, :]                  # (..., mbh, mbw, 1, bs)
    lead = pad.shape[:-2]
    flat = pad.reshape((-1, ph * pw))
    idx = (rows * pw + cols).reshape((flat.shape[0], -1))
    return torch.gather(flat, 1, idx).reshape(lead + (mbh, mbw, bs, bs))


def mv_diff_field(mv: torch.Tensor) -> torch.Tensor:
    """Differential MVs of a field (..., mbh, mbw, 2), fully parallel.

    The predictors use the neighbours' reconstructed MVs, which equal the
    original MVs (ImvPrediction adds the identical predictor back), so the
    whole field vectorizes.  Includes the right-edge (l, ul, u) variant and
    the y-median typo."""
    mbh, mbw = mv.shape[-3], mv.shape[-2]
    x, y = mv[..., 0], mv[..., 1]

    def shift(a, dy, dx):
        return torch.roll(a, shifts=(dy, dx), dims=(-2, -1))

    lx, ly = shift(x, 0, 1), shift(y, 0, 1)
    ux, uy = shift(x, 1, 0), shift(y, 1, 0)
    ulx, uly = shift(x, 1, 1), shift(y, 1, 1)
    urx, ury = shift(x, 1, -1), shift(y, 1, -1)

    is_right = torch.arange(mbw, device=mv.device) == mbw - 1
    row0 = (torch.arange(mbh, device=mv.device) == 0)[:, None]
    col0 = (torch.arange(mbw, device=mv.device) == 0)[None, :]
    # interior: right edge -> median(l, ul, u); else median(l, u, ur)
    bx = torch.where(is_right, ulx, ux)
    by_ = torch.where(is_right, uly, uy)
    cx = torch.where(is_right, ux, urx)
    cy = torch.where(is_right, uy, ury)
    px = median3(lx, bx, cx)
    py = median3_mv_y(ly, by_, cy, cx)

    px = torch.where(row0, lx, torch.where(col0, ux, px))
    py = torch.where(row0, ly, torch.where(col0, uy, py))
    px[..., 0, 0] = 8
    py[..., 0, 0] = 8
    return torch.stack([x - px, y - py], dim=-1)
