"""Motion compensation and MV coding of the PyTorch port against the JAX
package, on the same numpy-seeded inputs (frames of at most 64x96): the
spiral and offset tables, the reference's padding, the MV medians, the
per-block predictor gather (the plain version of kernel E), mc_select
against the Pallas kernel in interpret mode, the differential MV field and
the MV reconstruction.  All of it is integer: equality is exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icspcodec_tpu import constants as jconst
from icspcodec_tpu.engine import inter as jinter
from icspcodec_tpu.engine.intra import from_blocks as jfrom_blocks
from icspcodec_tpu.ops import me as jme
from icspcodec_tpu.ops import medians as jmed
from icspcodec_tpu.ops import pad as jpad
from icspcodec_tpu.ops import pallas_me as jpme
from icspcodec_torch import constants as tconst
from icspcodec_torch import tables
from icspcodec_torch.engine import inter as tinter
from icspcodec_torch.ops import me as tme
from icspcodec_torch.ops import medians as tmed
from icspcodec_torch.ops import pad as tpad
from icspcodec_torch.ops.mc_fused import mc_gather, mc_select


def _mvs(rng, shape, far: float = 0.25):
    """MVs from the 129 union offsets, a share of them far outside the
    padded frame (both window-start rules of gather_pred fire)."""
    mv = tables.NEG_UNION[rng.integers(0, len(tables.NEG_UNION), shape)]
    wild = rng.integers(-150, 151, shape + (2,))
    return np.where((rng.random(shape) < far)[..., None], wild, mv).astype(np.int32)


@pytest.mark.parametrize("name", ["SPIRAL", "SPIRAL_UNION", "SPIRAL_STATE_IDX", "SPIRAL_TRANS",
                                  "N_SPIRAL_STATES", "N_SPIRAL_UNION"])
def test_spiral_tables_equal_jax(name):
    a, b = np.asarray(getattr(jconst, name)), np.asarray(getattr(tconst, name))
    assert a.dtype == b.dtype and np.array_equal(a, b)
    assert tconst.SPIRAL_STATES == jconst.SPIRAL_STATES
    assert np.array_equal(tconst.spiral_offsets(64), jconst.spiral_offsets(64))


@pytest.mark.parametrize("name", ["NEG_SPIRAL", "NEG_UNION", "N_CANON", "CHROMA_OFFSETS",
                                  "SPIRAL_TO_CHROMA", "CHROMA_U_OFFSETS", "UNION_TO_CHROMA_U"])
def test_offset_tables_equal_jax(name):
    a, b = np.asarray(getattr(jpme, name)), np.asarray(getattr(tables, name))
    assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("shape,padlen", [((2, 64, 96), 16), ((4, 32, 48), 8), ((16, 16), 16)])
def test_pad_image_matches_jax(shape, padlen):
    img = np.random.default_rng(padlen).integers(0, 256, shape, dtype=np.uint8)
    pj = np.asarray(jpad.pad_image(jnp.asarray(img), padlen))
    pt = tpad.pad_image(torch.from_numpy(img), padlen)
    assert pt.dtype == torch.uint8 and np.array_equal(pj, pt.numpy())
    assert not pt[..., -1, :].any() and not pt[..., :, -1].any()   # the off-by-one


def test_median3_mv_y_matches_jax():
    a = np.random.default_rng(3).integers(-3, 4, (4, 800)).astype(np.int32)  # many ties
    assert np.array_equal(np.asarray(jmed.median3_mv_y(*map(jnp.asarray, a))),
                          tmed.median3_mv_y(*map(torch.from_numpy, a)).numpy())


@pytest.mark.parametrize("bs", [16, 8])
def test_gather_pred_and_mc_gather_match_jax(bs):
    rng = np.random.default_rng(bs)
    b, h, w = 3, 64 * 8 // bs, 96 * 8 // bs
    pad = np.array(jpad.pad_image(jnp.asarray(
        rng.integers(0, 256, (b, h, w), dtype=np.uint8)), bs))
    mv = _mvs(rng, (b, h // bs, w // bs))
    gj = np.asarray(jme.gather_pred(jnp.asarray(pad).astype(jnp.int32), jnp.asarray(mv), bs))
    gt = tme.gather_pred(torch.from_numpy(pad), torch.from_numpy(mv), bs)
    assert np.array_equal(gj, gt.numpy())
    # the plane layout of the JAX decoder: luma through mb_to_grid8
    pj = jfrom_blocks(jinter.mb_to_grid8(gj)) if bs == 16 else jfrom_blocks(gj)
    assert np.array_equal(np.asarray(pj), mc_gather(torch.from_numpy(pad),
                                                    torch.from_numpy(mv), bs).numpy())


def test_mc_select_matches_the_pallas_kernel():
    """mc_select over the 129 union offsets against the JAX package's
    mc_select_luma_union, the Pallas kernel run in interpret mode."""
    rng = np.random.default_rng(5)
    pad = np.array(jpad.pad_image(jnp.asarray(
        rng.integers(0, 256, (1, 32, 48), dtype=np.uint8)), 16))
    idx = rng.integers(0, tconst.N_SPIRAL_UNION, (1, 2, 3)).astype(np.int32)
    pj = jpme.mc_select_luma_union(jnp.asarray(pad), jnp.asarray(idx), interpret=True)
    pt = mc_select(torch.from_numpy(pad), torch.from_numpy(idx), tconst.SPIRAL_UNION, 16)
    assert np.array_equal(np.asarray(pj), pt.numpy())


def test_mb_grid8_conversions_match_jax():
    x = np.random.default_rng(6).integers(-99, 99, (2, 3, 4, 6, 16, 16)).astype(np.int32)
    g = np.array(jinter.mb_to_grid8(jnp.asarray(x)))
    assert np.array_equal(g, tinter.mb_to_grid8(torch.from_numpy(x)).numpy())
    assert np.array_equal(np.asarray(jinter.grid8_to_mb(jnp.asarray(g))),
                          tinter.grid8_to_mb(torch.from_numpy(g)).numpy())


@pytest.mark.parametrize("mbh,mbw", [(4, 6), (3, 5)])
def test_mv_field_and_reconstruction_match_jax(mbh, mbw):
    mv = _mvs(np.random.default_rng(mbh * mbw), (3, mbh, mbw), far=0.1)
    dj = np.asarray(jme.mv_diff_field(jnp.asarray(mv)))
    dt = tme.mv_diff_field(torch.from_numpy(mv))
    assert np.array_equal(dj, dt.numpy())
    # the decoder's walk inverts the field, here and in the JAX package
    rj = np.asarray(jinter.mv_reconstruct_scan(jnp.asarray(dj)))
    rt = tinter.mv_reconstruct_scan(dt)
    assert np.array_equal(rj, rt.numpy()) and np.array_equal(rt.numpy(), mv)
    gj = np.asarray(jinter.decode_gop_mvs(jnp.asarray(dj[None]))[0])
    assert np.array_equal(gj, tinter.decode_gop_mvs(dt[None]).numpy())
