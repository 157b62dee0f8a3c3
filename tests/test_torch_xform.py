"""The plain version of kernel F (the inter encoder's forward residual
chain, ops/xform_fused.py) against the JAX package, on a 4x6 grid of luma
blocks and a 2x3 grid of chroma blocks, the plain versions on the CPU.

* float64: bit for bit against the JAX exact chain (fdct, dc_dpcm_scan with
  the luma or chroma kinds, quant_block, zigzag, acflag, dequant_block,
  idct), at QP 16/16 and 1/1;
* float32: against the Pallas kernel xform_fwd_fused in interpret mode.
  The two sum the same float32 products in another order, so a quantizer
  tie may flip: differing symbols are counted and held to 0.1%, and r is
  compared where the block's symbols agree;
* the chroma chain of engine/intra.encode_chroma_batch, which runs through
  kernel F, equals the batched route around kernel B's DC chain (fdct,
  dc_fused.dc_dpcm_fused, quant_block, zigzag, ac_flag, dequant_block,
  idct) in float64.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icspcodec_tpu.constants import COS_ENC
from icspcodec_tpu.engine import wavefront as jwf
from icspcodec_tpu.engine.intra import _acflag_from_scan
from icspcodec_tpu.ops import quant as jq
from icspcodec_tpu.ops import scanorder as jso
from icspcodec_tpu.ops import transforms as jtr
from icspcodec_tpu.ops.pallas_xform import xform_fwd_fused as j_xform
from icspcodec_torch import constants as tconst
from icspcodec_torch.engine.intra import encode_chroma_batch
from icspcodec_torch.ops.dc_fused import dc_dpcm_fused
from icspcodec_torch.ops.quant import ac_flag, dequant_block, quant_block
from icspcodec_torch.ops.scanorder import zigzag
from icspcodec_torch.ops.transforms import fdct, idct
from icspcodec_torch.ops.xform_fused import xform_fwd_fused
from icspcodec_torch.tables import chroma_dc_kind, luma_dc_kind

SHAPES = {False: (2, 4, 6), True: (4, 2, 3)}   # (F, gh, gw): luma, chroma (Cb and Cr)


def _blocks(chroma: bool, seed: int = 0) -> np.ndarray:
    """Residual-like int32 blocks, |v| <= 255, with a few flat blocks (their
    AC quantizes to zero) and a few extreme ones."""
    rng = np.random.default_rng(seed + chroma)
    shape = SHAPES[chroma] + (8, 8)
    b = rng.normal(0, 40, shape) + rng.normal(0, 60, shape[:3])[..., None, None]
    b[0, 0, 1] = 3
    b[-1, -1, -1] = np.where(rng.random((8, 8)) < 0.5, 255, -255)
    return np.clip(np.rint(b), -255, 255).astype(np.int32)


def _jax_chain(blocks, qdc, qac, chroma):
    """The JAX package's unfused float64 chain, as engine/inter.py:140-152
    runs it (luma) and encode_chroma_batch's me="xla" route (chroma)."""
    gh, gw = blocks.shape[1:3]
    d = jtr.fdct(jnp.asarray(blocks), table=COS_ENC, dtype=jnp.float64)
    kind = (chroma_dc_kind if chroma else luma_dc_kind)(gh, gw)
    q_dc, dq_dc = jwf.dc_dpcm_scan(d[..., 0, 0], kind, qdc, chroma=chroma)
    q = jq.quant_block(d, qdc, qac, chroma=chroma).at[..., 0, 0].set(q_dc)
    sc = jso.zigzag(q)
    iq = jq.dequant_block(q, qdc, qac).at[..., 0, 0].set(dq_dc)
    r = jtr.idct(iq, table=COS_ENC, dtype=jnp.float64)
    return dict(scan=np.asarray(sc), acflag=np.asarray(_acflag_from_scan(sc)),
                r=np.asarray(r if chroma else jq.c_trunc(r)))


@pytest.mark.parametrize("chroma", [False, True], ids=["luma", "chroma"])
@pytest.mark.parametrize("qdc,qac", [(16, 16), (1, 1)])
def test_float64_bit_identical_to_the_jax_chain(chroma, qdc, qac):
    blocks = _blocks(chroma)
    got = xform_fwd_fused(torch.from_numpy(blocks), qdc, qac, chroma, dtype=torch.float64)
    want = _jax_chain(blocks, qdc, qac, chroma)
    assert got["scan"].dtype == torch.int16 and got["acflag"].dtype == torch.int8
    assert got["r"].dtype == (torch.float64 if chroma else torch.int32)
    assert got["acflag"].numpy().any() and not got["acflag"].numpy().all()
    for k in ("scan", "acflag", "r"):
        assert np.array_equal(got[k].numpy(), want[k]), k


@pytest.mark.parametrize("chroma", [False, True], ids=["luma", "chroma"])
def test_float32_within_ties_of_the_pallas_kernel(chroma):
    blocks = _blocks(chroma, seed=4)
    got = xform_fwd_fused(torch.from_numpy(blocks), 16, 16, chroma, dtype=torch.float32)
    f, gh, gw = blocks.shape[:3]
    want = jax.jit(lambda b: j_xform(b, 16, 16, chroma=chroma, table=COS_ENC, interpret=True,
                                     r_plane=not chroma))(jnp.asarray(blocks))
    sc = np.asarray(want["scan"])
    differ = got["scan"].numpy() != sc
    assert differ.sum() <= 0.001 * differ.size
    same = ~differ.any(-1)                                  # blocks whose symbols agree
    assert np.array_equal(got["acflag"].numpy()[same], np.asarray(want["acflag"])[same])
    if chroma:
        # float32 sums in another order: the raw IDCT agrees to rounding
        np.testing.assert_allclose(got["r"].numpy()[same], np.asarray(want["r"])[same],
                                   rtol=0, atol=1e-3)
    else:
        rj = np.asarray(want["r_plane"]).reshape(f, gh, 8, gw, 8).transpose(0, 1, 3, 2, 4)
        assert np.array_equal(got["r"].numpy()[same], rj[same])


@pytest.mark.parametrize("qdc,qac", [(16, 16), (8, 4)])
def test_chroma_chain_through_kernel_f_equals_the_intra_route(qdc, qac):
    blocks = torch.from_numpy(_blocks(True, seed=9))
    a = encode_chroma_batch(blocks, qdc, qac, dtype=torch.float64)
    d = fdct(blocks.to(torch.int32), dtype=torch.float64)
    q_dc, dq_dc = dc_dpcm_fused(d[..., 0, 0], qdc, chroma=True)
    q = quant_block(d, qdc, qac, chroma=True)
    q[..., 0, 0] = q_dc
    iq = dequant_block(q, qdc, qac)
    iq[..., 0, 0] = dq_dc
    b = dict(scan=zigzag(q), acflag=ac_flag(q), idct=idct(iq, tconst.COS_ENC, dtype=torch.float64))
    assert torch.equal(a["scan"].to(torch.int32), b["scan"].to(torch.int32))
    assert torch.equal(a["acflag"].to(torch.int32), b["acflag"].to(torch.int32))
    assert torch.equal(a["idct"], b["idct"])
