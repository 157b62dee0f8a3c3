"""The intra chroma chain through kernel F, on the CPU at 64x96 frames.

engine/intra.encode_intra_frames sends the Cb and Cr planes of intra frames
through ops/xform_fused.xform_fwd_fused (encode_chroma_batch), where the
JAX package takes batched ops around its DC chain kernel.  Checked here, on
seeded planes at QP 16/16, 1/1 and 8/16:

* encode_chroma_batch equals the JAX package's encode_chroma_batch:
  float64 bit for bit; float32 symbols and flags bit for bit, and idct
  within 1e-4 (the JAX CPU path and the port's CPU path sum the same
  float32 matrix products in orders that may differ, as in
  tests/test_torch_ops.py);
* encode_intra_frames' chroma symbols and recon are those of F's plain
  version.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icspcodec_tpu.engine import intra as jintra
from icspcodec_torch.engine.intra import encode_chroma_batch, encode_intra_frames
from icspcodec_torch.ops import xform_fused

DTYPES = {"float64": (jnp.float64, torch.float64), "float32": (jnp.float32, torch.float32)}


def _planes(seed: int, f: int = 4, h: int = 32, w: int = 48) -> np.ndarray:
    """Chroma-like planes: smooth fields with texture, a flat block and the
    extremes 0 and 255."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    p = 128 + 60 * np.sin(xx / 9.0 + rng.uniform(0, 6, (f, 1, 1))) + 30 * np.cos(yy / 5.0)
    p = p + rng.normal(0, 12, (f, h, w))
    p[0, :8, :8] = 0
    p[-1, -8:, -8:] = 255
    return np.clip(np.rint(p), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("prec", ["float64", "float32"])
@pytest.mark.parametrize("qdc, qac", [(16, 16), (1, 1), (8, 16)])
def test_intra_chroma_through_f_equals_jax(prec, qdc, qac):
    jdt, tdt = DTYPES[prec]
    planes = _planes(qdc + qac)
    n0 = xform_fused.launches
    via_f = encode_chroma_batch(torch.from_numpy(planes), qdc, qac, dtype=tdt)
    assert xform_fused.launches == n0   # the CPU runs the plain version
    assert via_f["idct"].dtype == tdt
    want = jintra.encode_chroma_batch(jnp.asarray(planes), qdc, qac, dtype=jdt)
    assert np.array_equal(via_f["scan"].numpy(), np.asarray(want["scan"]))
    assert np.array_equal(via_f["acflag"].numpy(), np.asarray(want["acflag"]))
    got, ref = via_f["idct"].numpy(), np.asarray(want["idct"])
    if prec == "float64":
        assert np.array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("prec", ["float64", "float32"])
def test_encode_intra_frames_takes_the_f_route(prec):
    _, tdt = DTYPES[prec]
    rng = np.random.default_rng(5)
    y = torch.from_numpy(rng.integers(0, 256, (2, 64, 96), dtype=np.uint8))
    cb, cr = (torch.from_numpy(p) for p in np.split(_planes(9), 2))
    out = encode_intra_frames(y, cb, cr, 16, 16, dtype=tdt)
    f = xform_fused.xform_fwd_plain(torch.cat([cb, cr]).reshape(4, 4, 8, 6, 8).movedim(-3, -2),
                                    16, 16, True, dtype=tdt)
    rec = torch.clamp(torch.trunc(f["r"]), 0, 255).to(torch.uint8)
    rec = rec.movedim(-2, -3).reshape(4, 32, 48)
    for i, name in enumerate(("cb", "cr")):
        assert torch.equal(out[f"{name}_scan"], f["scan"][2 * i:2 * i + 2].to(torch.int16))
        assert torch.equal(out[f"{name}_acflag"], f["acflag"][2 * i:2 * i + 2].to(torch.int8))
        assert torch.equal(out[f"recon_{name}"], rec[2 * i:2 * i + 2])
