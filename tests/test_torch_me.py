"""The PyTorch port's motion search against the JAX package's (frames of
32x48, the plain versions of the kernels on the CPU).

* sad_dense, state_tables, stateful_select and spiral_search against
  icspcodec_tpu/ops/me.py on random content, static MBs (the zero-SAD early
  break) and a planted match that only the unmirrored spiral reaches;
* compose_select's log-depth scan against a plain raster loop;
* the plain versions of kernels D (sad_mc_best) and G (sad_union_extra)
  against the Pallas kernels in interpret mode: all integer, so equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icspcodec_tpu.ops import me as jme
from icspcodec_tpu.ops import pallas_me as jpme
from icspcodec_torch.constants import SPIRAL, SPIRAL_TRANS, SPIRAL_UNION
from icspcodec_torch.ops import me as tme
from icspcodec_torch.ops import me_fused
from icspcodec_torch.ops.pad import pad_image
from icspcodec_torch.tables import N_CANON

H, W = 32, 48
# one compiled program per JAX function (eager, each of the 129 window
# slices would compile on its own)
_j_sad_union = jax.jit(lambda c, p: jme.sad_dense(c, p, SPIRAL_UNION))
_j_search = jax.jit(jme.spiral_search)
_j_fixed = jax.jit(jme.spiral_search_fixed)


def _frames(content: str):
    """(cur, pad) numpy: one 32x48 frame against its padded predecessor.
    static: MB (0, 0) repeats its predecessor (two zero SADs: the walk
    breaks early); mirror: also MB (0, 1) equals the predecessor's window at
    a spiral offset whose mirror image is not on the canonical spiral, so
    the canonical and the stateful searches pick different MVs there
    (tests/test_ops.py's trigger content)."""
    rng = np.random.default_rng({"random": 1, "static": 2, "mirror": 3}[content])
    prev = rng.integers(0, 256, (1, H, W), dtype=np.uint8)
    cur = rng.integers(0, 256, (1, H, W), dtype=np.uint8)
    pad = pad_image(torch.from_numpy(prev), 16).numpy()
    if content != "random":
        cur[0, 0:16, 0:16] = prev[0, 0:16, 0:16]
    if content == "mirror":
        canon = {tuple(s) for s in SPIRAL.tolist()}
        ox, oy = next(o for o in SPIRAL.tolist() if (-o[0], -o[1]) not in canon)
        cur[0, 0:16, 16:32] = pad[0, 16 + oy:32 + oy, 32 + ox:48 + ox]
    return cur, pad


@pytest.mark.parametrize("content", ["random", "static", "mirror"])
def test_search_matches_jax(content):
    cur, pad = _frames(content)
    ct, pt = torch.from_numpy(cur), torch.from_numpy(pad)
    sads = tme.sad_dense(ct, pt, SPIRAL_UNION)
    sj = np.asarray(_j_sad_union(cur, pad))
    assert sads.dtype == torch.int32 and np.array_equal(sads.numpy(), sj)
    bj, tj = jme.state_tables(jnp.asarray(sj))
    bt, tt = tme.state_tables(sads)
    assert np.array_equal(bt.numpy(), np.asarray(bj)) and np.array_equal(tt.numpy(), np.asarray(tj))
    sel = tme.stateful_select(sads)
    assert np.array_equal(sel.numpy(), np.asarray(jme.stateful_select(jnp.asarray(sj))))
    mv = tme.spiral_search(ct, pt)
    mj = np.asarray(_j_search(cur, pad))
    assert mv.dtype == torch.int32 and np.array_equal(mv.numpy(), mj)
    if content == "mirror":   # the stateful search moved MB (0, 1) off the canonical pick
        fixed = np.asarray(_j_fixed(cur, pad))
        assert not np.array_equal(fixed[0, 0, 1], mj[0, 0, 1])


def test_compose_select_matches_a_raster_loop():
    """Random 4-state tables on a 3x7 MB grid (21 MBs, not a power of two)
    and a batch of 2: the Hillis-Steele scan against the walk MB by MB."""
    rng = np.random.default_rng(5)
    steps = rng.integers(2, 65, (2, 4, 3, 7)).astype(np.int32)
    best_u = rng.integers(0, 129, (2, 4, 3, 7)).astype(np.int32)
    got = tme.compose_select(torch.from_numpy(best_u), torch.from_numpy(steps)).numpy()
    want = np.zeros((2, 3, 7), np.int32)
    for b in range(2):
        state = 0
        for n in range(21):
            gy, gx = divmod(n, 7)
            want[b, gy, gx] = best_u[b, state, gy, gx]
            state = SPIRAL_TRANS[state, steps[b, state, gy, gx]]
    assert np.array_equal(got, want)


def test_sad_mc_best_plain_matches_pallas():
    """Kernel D's plain version against the Pallas kernel in interpret mode
    on a batch of break-free and trigger frames: every output equal,
    best and pred included (neither applies the second-zero override)."""
    cur = np.concatenate([_frames("random")[0], _frames("mirror")[0]])
    pad = np.concatenate([_frames("random")[1], _frames("mirror")[1]])
    best, zc, sads_c, pred = me_fused.sad_mc_best(torch.from_numpy(cur), torch.from_numpy(pad))
    jb, jz, js, jp = jpme.sad_mc_best(jnp.asarray(cur), jnp.asarray(pad), interpret=True)
    assert np.array_equal(zc.numpy(), np.asarray(jz))
    assert zc[0].max() < 2 and zc[1].max() >= 2
    assert sads_c.shape == (2, N_CANON, 2, 3) and np.array_equal(sads_c.numpy(), np.asarray(js))
    assert best.dtype == torch.int32 and np.array_equal(best.numpy(), np.asarray(jb))
    assert pred.dtype == torch.uint8 and np.array_equal(pred.numpy(), np.asarray(jp))
    # break-free frame: the canonical pick is the full search's
    mv = tme.spiral_search(torch.from_numpy(cur[:1]), torch.from_numpy(pad[:1]))
    assert np.array_equal(mv[0].numpy(), -SPIRAL[best[0].numpy()])


def test_sad_union_extra_plain_matches_pallas():
    cur, pad = _frames("static")
    extra = me_fused.sad_union_extra(torch.from_numpy(cur), torch.from_numpy(pad))
    je = jpme.sad_union_extra(jnp.asarray(cur), jnp.asarray(pad), interpret=True)
    assert extra.shape == (1, len(SPIRAL_UNION) - N_CANON, 2, 3)
    assert np.array_equal(extra.numpy(), np.asarray(je))
