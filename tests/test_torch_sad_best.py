"""The PyTorch port's unfused search entry points, sad_best and sad_union
(ops/me_fused.py), against the JAX package (batches of 2 frames of 64x96,
the plain versions of the kernels on the CPU):

* sad_best's plain version equals the Pallas sad_best in interpret mode on
  random frames, on identical frames (every MB has zc >= 2 and the second
  zero, step 1, wins) and on static-trigger content; where no MB has
  zc >= 2 its best is kernel D's and its MVs are the stateful search's;
* sad_union's plain version equals the JAX sad_dense at the 129 union
  offsets, and D's canonical rows followed by G's rows.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from icspcodec_tpu.ops import me as jme
from icspcodec_tpu.ops import pallas_me as jpme
from icspcodec_torch.constants import SPIRAL, SPIRAL_UNION
from icspcodec_torch.ops import me_fused
from icspcodec_torch.ops.me import spiral_search
from icspcodec_torch.ops.pad import pad_image

H, W = 64, 96
_j_sad_union = jax.jit(lambda c, p: jme.sad_dense(c, p, SPIRAL_UNION))


def _frames(content: str):
    """(cur, pad) numpy: 2 frames of 64x96 against their padded predecessors.
    random: unrelated frames; shifted: each frame its predecessor moved by
    a spiral offset, with noise (no zero SAD); identical: the predecessors
    themselves; static: static_trigger_input() frames 1-2 against 0-1."""
    rng = np.random.default_rng({"random": 1, "shifted": 2, "identical": 3, "static": 4}[content])
    if content == "static":
        y = chip_smoke.static_trigger_input(f=3)[0]
        prev, cur = y[:2], y[1:]
    else:
        prev = rng.integers(0, 256, (2, H, W), dtype=np.uint8)
        cur = rng.integers(0, 256, (2, H, W), dtype=np.uint8)
        if content == "shifted":
            noise = rng.integers(-2, 3, (2, H, W))
            cur = np.clip(np.roll(prev, (2, -3), axis=(1, 2)) + noise, 0, 255).astype(np.uint8)
        elif content == "identical":
            cur = prev.copy()
    return cur, pad_image(torch.from_numpy(prev), 16).numpy()


@pytest.mark.parametrize("content", ["random", "shifted", "identical", "static"])
def test_sad_best_plain_matches_pallas(content):
    cur, pad = _frames(content)
    ct, pt = torch.from_numpy(cur), torch.from_numpy(pad)
    best, zc = me_fused.sad_best(ct, pt)
    jb, jz = jpme.sad_best(jnp.asarray(cur), jnp.asarray(pad), interpret=True)
    assert best.dtype == zc.dtype == torch.int32 and best.shape == (2, H // 16, W // 16)
    assert np.array_equal(best.numpy(), np.asarray(jb))
    assert np.array_equal(zc.numpy(), np.asarray(jz))
    d_best, d_zc = me_fused.sad_mc_best(ct, pt)[:2]
    assert torch.equal(zc, d_zc)
    free = zc < 2
    assert torch.equal(best[free], d_best[free])      # no override there: D's pick
    if content == "identical":
        assert bool((best == 1).all()) and bool((zc >= 2).all())
    if content == "static":
        assert bool((zc >= 2).any()) and bool(free.any())
    if content == "shifted":                              # break-free: the stateful search's MVs
        assert bool(free.all())
        assert np.array_equal(spiral_search(ct, pt).numpy(), -SPIRAL[best.numpy()])


@pytest.mark.parametrize("content", ["random", "static"])
def test_sad_union_plain_matches_jax_and_d_then_g(content):
    cur, pad = _frames(content)
    ct, pt = torch.from_numpy(cur), torch.from_numpy(pad)
    u = me_fused.sad_union(ct, pt)
    assert u.dtype == torch.int32 and u.shape == (2, len(SPIRAL_UNION), H // 16, W // 16)
    assert np.array_equal(u.numpy(), np.asarray(_j_sad_union(cur, pad)))
    d_rows = me_fused.sad_mc_best_plain(ct, pt)[2]
    assert torch.equal(u, torch.cat([d_rows, me_fused.sad_union_extra_plain(ct, pt)], dim=1))


@pytest.mark.parametrize("fn", [me_fused.sad_best, me_fused.sad_union])
def test_wrappers_check_their_inputs(fn):
    cur, pad = (torch.from_numpy(a) for a in _frames("random"))
    with pytest.raises(ValueError, match="padded by 16"):
        fn(cur, pad[:, 1:])
    with pytest.raises(TypeError, match="uint8"):
        fn(cur.to(torch.int32), pad)
    with pytest.raises(ValueError, match="cpu or cuda"):
        fn(cur.to("meta"), pad.to("meta"))
