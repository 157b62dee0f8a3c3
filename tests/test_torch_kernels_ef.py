"""Claims behind the H100 designs of kernels E (csrc/mc_gather.cu) and F
(csrc/xform_fwd.cu), checked on the CPU at tiny sizes (frames of 64x96):

* mc_gather_yc, the decoder's luma and chroma motion compensation in one
  call, equals the JAX package's me="xla" decode (gather_pred at the luma
  MVs and at sign(mv) * (|mv| // 2)), for MVs from the union offsets,
  negative odd ones and ones outside the padded frame;
* every product of a float32 transform-matrix entry and an integer of
  magnitude below 2^15 is exact in double, and the 64-term double sums of
  such products do not depend on their order: what lets kernel F's float
  path run its dense products on the FP64 tensor cores and still equal the
  plain version bit for bit, and kernel A's (residuals |e| <= 255 forward,
  dequantized values |iq| < 2^15 inverse) likewise;
* the DC term of a block is its integer sum, exactly: S / 8 in float32,
  ((S * IRT2) * IRT2) * 0.25 in float64 (kernel F's first launch);
* kernel F's device arguments (tables in fragment order, zig-zag order,
  kind grid), cached per (table, precision, grid, device), equal the ones
  built afresh;
* a kernel F call of more blocks than one launch takes is split over its
  planes; planes of every height the header carries are taken, and only a
  plane of more blocks than one launch takes is refused.
"""
import pathlib
import re
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icspcodec_tpu.engine import inter as jinter
from icspcodec_tpu.engine.intra import from_blocks as jfrom_blocks
from icspcodec_tpu.ops import me as jme
from icspcodec_tpu.ops import pad as jpad
from icspcodec_torch import tables
from icspcodec_torch.constants import COS_DEC, COS_ENC, IRT2, ZIGZAG
from icspcodec_torch.ops import xform_fused
from icspcodec_torch.ops.mc_fused import chroma_mv, mc_gather_yc
from icspcodec_torch.ops.transforms import fdct


def _jax_decode_predictors(pad_y, pad_c, mv):
    """The JAX package's decode_inter_frame predictors (me="xla")."""
    mvj = jnp.asarray(mv)
    predf = jfrom_blocks(jinter.mb_to_grid8(jme.gather_pred(
        jnp.asarray(pad_y).astype(jnp.int32), mvj, 16)))
    mvc = jnp.sign(mvj) * (jnp.abs(mvj) // 2)
    predcf = jfrom_blocks(jme.gather_pred(jnp.asarray(pad_c).astype(jnp.int32),
                                          jnp.concatenate([mvc, mvc]), 8))
    return np.asarray(predf), np.asarray(predcf)


@pytest.mark.parametrize("far", [0.0, 0.3])
def test_mc_gather_yc_equals_the_jax_decode(far):
    rng = np.random.default_rng(int(far * 10))
    b, h, w = 2, 64, 96
    y = rng.integers(0, 256, (b, h, w), dtype=np.uint8)
    c = rng.integers(0, 256, (2 * b, h // 2, w // 2), dtype=np.uint8)
    pad_y, pad_c = np.array(jpad.pad_image(jnp.asarray(y), 16)), np.array(
        jpad.pad_image(jnp.asarray(c), 8))
    shape = (b, h // 16, w // 16)
    mv = tables.NEG_UNION[rng.integers(0, len(tables.NEG_UNION), shape)]
    mv = np.where((rng.random(shape) < far)[..., None], rng.integers(-150, 151, shape + (2,)), mv)
    mv[0, 0, 0] = (-7, -3)    # negative odd: C truncation rounds toward zero
    mv = mv.astype(np.int32)
    want_y, want_c = _jax_decode_predictors(pad_y, pad_c, mv)
    got_y, got_c = mc_gather_yc(torch.from_numpy(pad_y), torch.from_numpy(pad_c),
                                torch.from_numpy(mv))
    assert got_y.dtype == got_c.dtype == torch.uint8
    assert np.array_equal(got_y.numpy(), want_y) and np.array_equal(got_c.numpy(), want_c)
    want_mvc = np.trunc(mv / 2).astype(np.int32)
    assert np.array_equal(chroma_mv(torch.from_numpy(mv)).numpy(), want_mvc)


def _matrices(table):
    key = tables.table_key(table)
    return [tables.fdct_matrix(key, "float32"), tables.idct_matrix(key, "float32")]


@pytest.mark.parametrize("matrix, bound", [(0, 255), (1, 2 ** 15 - 1)],
                         ids=["forward-residuals", "inverse-dequantized"])
@pytest.mark.parametrize("table", [COS_ENC, COS_DEC], ids=["enc", "dec"])
def test_float_matrix_products_and_sums_are_exact_in_double(table, matrix, bound):
    """The input ranges of kernels A and F: the forward product takes
    residuals |e| <= 255, the inverse dequantized values |iq| < 2^15."""
    rng = np.random.default_rng(matrix)
    ints = [bound, -bound, 255, -255, 1, -1] + rng.integers(-bound, bound + 1, 8).tolist()
    m = _matrices(table)[matrix]
    for e in np.unique(m):   # every entry, once per distinct value
        for v in ints:
            assert Fraction(float(np.float64(e) * v)) == Fraction(float(e)) * v
    # each entry a multiple of 2^-29 and each row's absolute sum below 9:
    # every partial sum of 64 such products is a multiple of 2^-29 below
    # 9 * 2^15 < 2^19, 48 bits, so exact in double in any order
    m64 = m.astype(np.float64)
    assert np.all(np.floor(m64 * 2.0 ** 29) == m64 * 2.0 ** 29)
    assert np.abs(m64).sum(axis=1).max() < 9
    v = rng.integers(-bound, bound + 1, (64, 256)).astype(np.float64)
    v[:, 0] = bound   # the largest sums
    seq = m64[:, 0, None] * v[0]
    for k in range(1, 64):         # index order, as dense_f64 summed
        seq = seq + m64[:, k, None] * v[k]
    blocked = sum(m64[:, k::4] @ v[k::4] for k in range(4))   # an mma-like order
    assert np.array_equal(seq, m64 @ v) and np.array_equal(seq, blocked)
    exact = [sum(Fraction(float(m64[o, k])) * int(v[k, 0]) for k in range(64)) for o in (0, 9, 63)]
    assert [Fraction(float(seq[o, 0])) for o in (0, 9, 63)] == exact


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_dc_term_is_the_integer_block_sum(dtype):
    rng = np.random.default_rng(3)
    blocks = rng.integers(-255, 256, (40, 8, 8)).astype(np.int32)
    blocks[0] = 255
    blocks[1] = -255
    s = blocks.sum(axis=(1, 2)).astype(np.float64)
    dc = fdct(torch.from_numpy(blocks), dtype=dtype)[:, 0, 0].numpy()
    want = s / 8 if dtype == torch.float32 else ((s * IRT2) * IRT2) * 0.25
    assert np.array_equal(dc, want.astype(dc.dtype))
    for table in (COS_ENC, COS_DEC):
        assert np.all(np.asarray(table)[0] == 1.0)
        assert np.all(_matrices(table)[0][0] == 0.125)


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("chroma", [False, True])
def test_cached_device_args_equal_fresh_ones(exact, chroma):
    gh, gw = (4, 6) if chroma else (8, 12)
    cpu = torch.device("cpu")
    tab, zz, kind = xform_fused._device_args("enc", exact, chroma, gh, gw, cpu)
    assert xform_fused._device_args("enc", exact, chroma, gh, gw, cpu)[0] is tab
    if exact:
        want = np.concatenate([np.asarray(COS_ENC, np.float64).ravel(), [IRT2]])
    else:
        lane = np.arange(32)
        want = np.concatenate([np.stack([m[mt * 8 + lane // 4, ks * 4 + lane % 4]
                                         for mt in range(8) for ks in range(16)]).ravel()
                               for m in _matrices(COS_ENC)])
    assert tab.dtype == (torch.float64 if exact else torch.float32)
    assert np.array_equal(tab.numpy(), want)
    assert np.array_equal(zz.numpy(), ZIGZAG)
    fresh_kind = (tables.chroma_dc_kind if chroma else tables.luma_dc_kind)(gh, gw)
    assert np.array_equal(kind.numpy(), fresh_kind)


def test_kernel_blocks_keeps_aligned_views_and_copies_the_rest():
    planes = torch.zeros((2, 16, 24), dtype=torch.int32)
    view = planes.reshape(2, 2, 8, 3, 8).movedim(-3, -2)   # engine/intra.to_blocks
    assert xform_fused._kernel_blocks(view) is view
    odd = torch.zeros((2, 16, 26), dtype=torch.int32)[..., 1:25]   # 4-byte offset, stride 26
    out = xform_fused._kernel_blocks(odd.reshape(2, 2, 8, 3, 8).movedim(-3, -2))
    assert out.is_contiguous() and out.dtype == torch.int32
    assert xform_fused._kernel_blocks(view.to(torch.int16)).dtype == torch.int32


@pytest.mark.parametrize("nplanes, gh, gw", [(30, 36, 44), (1100, 135, 240), (3, 512, 4)])
def test_large_calls_are_split_over_planes(nplanes, gh, gw):
    batches = xform_fused._plane_batches(nplanes, gh, gw)
    assert batches[0][0] == 0 and batches[-1][1] == nplanes
    assert all(a[1] == b[0] for a, b in zip(batches, batches[1:]))
    assert all(0 < (p1 - p0) * gh * gw <= xform_fused.MAX_CELLS for p0, p1 in batches)
    assert len(batches) == -(-nplanes * gh * gw // xform_fused.MAX_CELLS)


def test_plane_limits_match_the_kernel_and_refuse_taller_planes():
    """The kernel's only plane limit is MAX_CELLS blocks: the DC walk takes
    every height the header carries (8,190 block rows, 65,520 lines) in
    bands of 32 * CHAIN_MAX_ROWS rows, so only a plane of more blocks than
    one launch takes is refused."""
    src = (pathlib.Path(xform_fused.__file__).parent.parent / "csrc" / "xform_fwd.cu").read_text()
    assert re.search(r"MAX_CELLS = 1LL << (\d+);", src).group(1) == "25"
    assert 1 << 25 == xform_fused.MAX_CELLS
    assert "gh > 32 * CHAIN_MAX_ROWS)" not in src    # no refusal of tall planes
    max_rows = tables.parse_header(tables.pack_header(65520, 32, 16, 16, 1))[0] // 8
    assert max_rows == 8190
    widest = xform_fused.MAX_CELLS // max_rows
    for gh, gw, want in ((540, 960, [(0, 2)]), (max_rows, 4, [(0, 2)]),
                         (max_rows, widest, [(0, 1), (1, 2)])):
        assert xform_fused._plane_batches(2, gh, gw) == want
    with pytest.raises(ValueError, match="blocks"):
        xform_fused._plane_batches(1, max_rows, widest + 1)
    with pytest.raises(ValueError, match="blocks"):
        xform_fused._plane_batches(1, 2, xform_fused.MAX_CELLS)
