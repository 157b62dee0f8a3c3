"""Claims behind the H100 designs of kernels B, B' (csrc/dc_dpcm.cu) and C
(csrc/intra_decode.cu), checked on the CPU:

* column 0 of the float32 inverse matrix, the DC's weight in every output,
  is 1/8 for both cosine tables; so the plain version's product of a
  dequantized block, summed in double and rounded once to float32, equals
  its AC part summed in double over the nonzero AC values in any order,
  plus dq / 8, rounded once: what kernel C's float path computes, and why
  it is bit-identical to the plain version on the card;
* kernel C's float table is that matrix with its columns in scan order;
* the plain versions of B and B' (the kernels' references on the card)
  equal the JAX package's DC chains on a plane of 800 block rows, luma and
  chroma kinds: the heights the repaired kernels take now.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icspcodec_tpu.engine import wavefront as jwf
from icspcodec_torch import tables
from icspcodec_torch.constants import COS_DEC, COS_ENC, ZIGZAG
from icspcodec_torch.ops import dc_fused, intra_decode_fused


def _sparse_dequantized(rng, nblk: int, bound: int) -> np.ndarray:
    """(nblk, 64) dequantized values in block order, |v| < bound: a few
    nonzero AC values a block (none in some), any DC; the extremes once."""
    iq = np.where(rng.random((nblk, 64)) < 0.05, rng.integers(-bound + 1, bound, (nblk, 64)), 0)
    iq[rng.random(nblk) < 0.4, 1:] = 0
    iq[:, 0] = rng.integers(-bound + 1, bound, nblk)
    iq[0] = bound - 1
    iq[1] = -(bound - 1)
    return iq


@pytest.mark.parametrize("table", [COS_ENC, COS_DEC], ids=["enc", "dec"])
def test_ac_part_plus_dc_eighth_is_the_float_path(table):
    m = tables.idct_matrix(tables.table_key(table), "float32")
    assert np.all(m[:, 0] == np.float32(0.125))
    m64 = m.astype(np.float64)
    rng = np.random.default_rng(7)
    iq = _sparse_dequantized(rng, 400, 2 ** 15)
    # the plain version on the card: the dense double product, rounded once
    plain = (iq.astype(np.float64) @ m64.T).astype(np.float32)
    split = np.empty_like(plain)
    for b in range(iq.shape[0]):
        ac = np.zeros(64)
        nz = np.flatnonzero(iq[b, 1:]) + 1
        for p in rng.permutation(nz):      # any order, one fused step a value
            ac = ac + m64[:, p] * float(iq[b, p])
        split[b] = (ac + float(iq[b, 0]) * 0.125).astype(np.float32)
    assert np.array_equal(split.view(np.uint32), plain.view(np.uint32))


@pytest.mark.parametrize("table", [COS_ENC, COS_DEC], ids=["enc", "dec"])
def test_kernel_c_float_table_is_the_matrix_in_scan_order(table):
    key = tables.table_key(table)
    tab = intra_decode_fused.kernel_table(key, torch.float32)
    m = tables.idct_matrix(key, "float32")
    assert tab.dtype == np.float32 and tab.shape == (64, 64) and tab.flags.c_contiguous
    for k in range(64):   # row k: the weights of scan symbol k in all 64 outputs
        assert np.array_equal(tab[k], m[:, ZIGZAG[k]])
    assert np.all(tab[0] == np.float32(0.125))
    exact = intra_decode_fused.kernel_table(key, torch.float64)
    assert exact.dtype == np.float64 and exact.shape == (65,)


@pytest.mark.parametrize("chroma", [False, True], ids=["luma", "chroma"])
def test_dc_chain_plain_versions_equal_jax_on_a_tall_plane(chroma):
    gh, gw = 800, 4
    kind = (tables.chroma_dc_kind if chroma else tables.luma_dc_kind)(gh, gw)
    rng = np.random.default_rng(800 + chroma)
    iq = rng.integers(-3000, 3000, (2, gh, gw)).astype(np.int32)
    want = np.asarray(jwf.idc_dpcm_scan(jnp.asarray(iq), kind))
    got = dc_fused.idc_dpcm_plain(torch.from_numpy(iq), chroma)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    dc = rng.normal(1024, 400, (2, gh, gw))
    qj, dqj = jwf.dc_dpcm_scan(jnp.asarray(dc), kind, 7, chroma=chroma)
    qt, dqt = dc_fused.dc_dpcm_plain(torch.from_numpy(dc), 7, chroma)
    assert np.array_equal(qt.numpy(), np.asarray(qj)) and np.array_equal(dqt.numpy(), np.asarray(dqj))
