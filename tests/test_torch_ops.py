"""Block ops and device entropy coding of the PyTorch port against the JAX
package, on the same numpy-seeded inputs.

Tolerances: float64 paths and every integer op are exact; the float32
transforms are held within 1e-4 absolute (both sides sum the 64 products
of one matrix row, in orders that may differ).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icspcodec_tpu import bitstream_device as jbd
from icspcodec_tpu.constants import COS_DEC, COS_ENC
from icspcodec_tpu.ops import medians as jmed
from icspcodec_tpu.ops import quant as jq
from icspcodec_tpu.ops import scanorder as jzz
from icspcodec_tpu.ops import transforms as jtr
from icspcodec_torch import bitstream_device as tbd
from icspcodec_torch.ops import medians as tmed
from icspcodec_torch.ops import quant as tq
from icspcodec_torch.ops import scanorder as tzz
from icspcodec_torch.ops import transforms as ttr

DTYPES = {"float64": (jnp.float64, torch.float64), "float32": (jnp.float32, torch.float32)}


def _j(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("prec", ["float64", "float32"])
@pytest.mark.parametrize("table", ["enc", "dec"])
def test_fdct_idct_match_jax(prec, table):
    jdt, tdt = DTYPES[prec]
    ct = COS_ENC if table == "enc" else COS_DEC
    rng = np.random.default_rng(1)
    err = rng.integers(-255, 256, (3, 5, 8, 8)).astype(np.int32)
    iq = rng.integers(-2000, 2001, (3, 5, 8, 8)).astype(np.int32)
    fj = _j(jtr.fdct(jnp.asarray(err), table=ct, dtype=jdt))
    ft = ttr.fdct(_t(err), table=ct, dtype=tdt).numpy()
    ij = _j(jtr.idct(jnp.asarray(iq), table=ct, dtype=jdt))
    it = ttr.idct(_t(iq), table=ct, dtype=tdt).numpy()
    assert ft.dtype == fj.dtype and it.dtype == ij.dtype
    if prec == "float64":
        assert np.array_equal(fj, ft) and np.array_equal(ij, it)
    else:
        np.testing.assert_allclose(ft, fj, rtol=0, atol=1e-4)
        np.testing.assert_allclose(it, ij, rtol=0, atol=1e-4)


@pytest.mark.parametrize("prec", ["float64", "float32"])
@pytest.mark.parametrize("chroma", [False, True])
@pytest.mark.parametrize("qdc,qac", [(16, 16), (1, 1), (10, 12)])
def test_quant_dequant_acflag_match_jax(prec, chroma, qdc, qac):
    jdt, tdt = DTYPES[prec]
    rng = np.random.default_rng(2)
    # half-integers, negatives and values near the rounding boundaries
    v = (rng.integers(-4000, 4000, (4, 3, 8, 8)) / 2.0).astype(np.dtype(prec))
    v[0, 0] = 0.0
    qj = _j(jq.quant_block(jnp.asarray(v, jdt), qdc, qac, chroma))
    qt = tq.quant_block(_t(v), qdc, qac, chroma).numpy()
    assert np.array_equal(qj, qt)
    assert np.array_equal(_j(jq.dequant_block(jnp.asarray(qj), qdc, qac)),
                          tq.dequant_block(_t(qt), qdc, qac).numpy())
    assert np.array_equal(_j(jq.ac_flag(jnp.asarray(qj))), tq.ac_flag(_t(qt)).numpy())
    a = rng.integers(-5000, 5000, 257).astype(np.int32)
    assert np.array_equal(_j(jq.c_div(jnp.asarray(a), qac)), tq.c_div(_t(a), qac).numpy())
    assert np.array_equal(_j(jq.c_trunc(jnp.asarray(v, jdt))), tq.c_trunc(_t(v)).numpy())


def test_zigzag_and_median_match_jax():
    rng = np.random.default_rng(3)
    q = rng.integers(-99, 99, (2, 3, 8, 8)).astype(np.int32)
    sc = _j(jzz.zigzag(jnp.asarray(q)))
    assert np.array_equal(sc, tzz.zigzag(_t(q)).numpy())
    assert np.array_equal(_j(jzz.izigzag(jnp.asarray(sc))), tzz.izigzag(_t(sc)).numpy())
    abc = rng.integers(-3, 4, (3, 500)).astype(np.int32)  # many ties
    assert np.array_equal(_j(jmed.median3(*map(jnp.asarray, abc))),
                          tmed.median3(*map(_t, abc)).numpy())


def test_vlc_encode_matches_jax():
    v = np.concatenate([np.arange(-4500, 4501), [2**15 - 1, -(2**15 - 1), 2**14, -(2**14)],
                        np.arange(-70000, 70000, 997) % 32767]).astype(np.int32)
    cj, lj = jbd.vlc_encode_dev(jnp.asarray(v))
    ct, lt = tbd.vlc_encode_dev(_t(v))
    assert np.array_equal(_j(cj).astype(np.int64), ct.numpy())
    assert np.array_equal(_j(lj), lt.numpy())


def _symbols(rng, f, gh, gw):
    """Seeded intra symbols of the engine's shapes and dtypes."""
    def scan(n):
        s = np.where(rng.random((f, n, 64)) < 0.7, 0,
                     rng.integers(-300, 300, (f, n, 64))).astype(np.int16)
        s[:, ::3, 1:] = 0  # some AC-empty blocks
        return s
    y = scan(gh * gw).reshape(f, gh, gw, 64)
    c = gh * gw // 4
    syms = dict(y_scan=y, mpm=rng.integers(0, 2, (f, gh, gw)).astype(np.int8),
                mode_bit=rng.integers(0, 2, (f, gh, gw)).astype(np.int8),
                cb_scan=scan(c).reshape(f, gh // 2, gw // 2, 64),
                cr_scan=scan(c).reshape(f, gh // 2, gw // 2, 64))
    for k in ("y", "cb", "cr"):
        s = syms[f"{k}_scan"]
        syms[f"{k}_acflag"] = (np.count_nonzero(s[..., 1:], -1) == 0).astype(np.int8)
    return syms


def test_frame_items_and_pack_match_jax():
    rng = np.random.default_rng(4)
    syms = _symbols(rng, 3, 4, 6)
    items = jax.jit(jbd.frame_items_dev, static_argnums=1)
    cj, lj = items({k: jnp.asarray(v) for k, v in syms.items()}, True)
    ct, lt = tbd.frame_items_dev({k: _t(v) for k, v in syms.items()}, True)
    assert np.array_equal(_j(cj).astype(np.int64), ct.numpy())
    assert np.array_equal(_j(lj), lt.numpy())
    maxbytes = int(-(-int(_j(lj).sum(1).max()) // 8)) + 5
    pj, nj = jbd.pack_frames_dev(cj, lj, maxbytes)
    pt, nt = tbd.pack_frames_dev(ct, lt, maxbytes)
    assert np.array_equal(_j(pj), pt.numpy()) and np.array_equal(_j(nj), nt.numpy())
    rows, bits = list(pt.numpy()), [int(b) for b in nt]
    assert tbd.assemble_frames(rows, bits) == jbd.assemble_frames(list(_j(pj)), list(_j(nj)))


@pytest.mark.parametrize("nbits", [[8, 16], [13, 7, 1], [9]])
def test_assemble_frames_tail_convention_matches_jax(nbits):
    rng = np.random.default_rng(5)
    rows = [rng.integers(0, 256, 4).astype(np.uint8) for _ in nbits]
    # bits past each frame's end are zero, as pack_frames_dev leaves them
    rows = [np.unpackbits(r)[:n].tolist() + [0] * (32 - n) for r, n in zip(rows, nbits)]
    rows = [np.packbits(np.asarray(r, np.uint8)) for r in rows]
    assert tbd.assemble_frames(rows, nbits) == jbd.assemble_frames(rows, nbits)
