"""Wavefronts and the intra engine of the PyTorch port against the JAX
package, on the same numpy-seeded inputs (grids of at most 6x8 blocks).

On the CPU the kernel wrappers (dc_dpcm_fused, intra_luma_scan_fused) run
their plain versions, so these tests pin the formulation each CUDA kernel
is held against on the card (chip_smoke.py).  Tolerances: float64 is
bit-exact; so is the DC chain in float32 (everything after the subtraction
and the +0.5 is integer).  The float32 luma wavefront may flip a quantizer
tie where the two frameworks sum the 64x64 transform in another order: at
most 0.1% of symbols may differ and PSNR-Y by 0.05 dB.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icspcodec_tpu.engine import intra as jintra
from icspcodec_tpu.engine import wavefront as jwf
from icspcodec_torch.engine import intra as tintra
from icspcodec_torch.engine import wavefront as twf
from icspcodec_torch.ops.dc_fused import dc_dpcm_fused
from icspcodec_torch.ops.intra_fused import intra_luma_scan_fused

DTYPES = {"float64": (jnp.float64, torch.float64), "float32": (jnp.float32, torch.float32)}


def _psnr(rec, orig):
    mse = ((rec.astype(np.float64) - orig.astype(np.float64)) ** 2).mean()
    return 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))


def _luma(seed, f=3, gh=6, gw=8):
    """Seeded pixel blocks (F, gh, gw, 8, 8): smooth content plus noise, so
    all three intra modes win somewhere."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:gh * 8, 0:gw * 8]
    base = 128 + 60 * np.sin(xx / 9.0) * np.cos(yy / 7.0)
    y = np.clip(base[None] + rng.normal(0, 12, (f, gh * 8, gw * 8)), 0, 255).astype(np.uint8)
    return np.asarray(jintra.to_blocks(jnp.asarray(y))).astype(np.int32)


@pytest.mark.parametrize("prec", ["float64", "float32"])
@pytest.mark.parametrize("chroma", [True, False])
@pytest.mark.parametrize("qstep", [16, 1, 7])
def test_dc_dpcm_matches_jax(prec, chroma, qstep):
    jdt, tdt = DTYPES[prec]
    rng = np.random.default_rng(qstep)
    gh, gw = 6, 8
    # spread around the predictors so every rounding branch fires
    dc = (rng.normal(1024, 400, (4, gh, gw)).round(1) + 0.5).astype(np.dtype(prec))
    kind = (jwf.chroma_dc_kind if chroma else jwf.luma_dc_kind)(gh, gw)
    qj, dqj = jwf.dc_dpcm_scan(jnp.asarray(dc, jdt), kind, qstep, chroma)
    qt, dqt = twf.dc_dpcm_scan(torch.from_numpy(dc), kind, qstep, chroma)
    assert np.array_equal(np.asarray(qj), qt.numpy())
    assert np.array_equal(np.asarray(dqj), dqt.numpy())
    qf, dqf = dc_dpcm_fused(torch.from_numpy(dc), qstep, chroma)
    assert torch.equal(qf, qt) and torch.equal(dqf, dqt)


@pytest.mark.parametrize("qdc,qac", [(16, 16), (1, 1), (10, 12)])
def test_intra_luma_scan_exact_matches_jax(qdc, qac):
    orig = _luma(qdc)
    j = jwf.intra_luma_scan_packed(jnp.asarray(orig), qdc, qac, dtype=jnp.float64)
    t = twf.intra_luma_scan_packed(torch.from_numpy(orig), qdc, qac, dtype=torch.float64)
    for k in ("recon", "scan", "mpm", "mode_bit"):
        assert np.array_equal(np.asarray(j[k]), t[k].numpy()), k
    # the kernel wrapper on a CPU tensor: same bits, in the kernel's dtypes
    f = intra_luma_scan_fused(torch.from_numpy(orig), qdc, qac, dtype=torch.float64)
    assert torch.equal(f["scan"], t["scan"].to(torch.int16))
    assert torch.equal(f["recon"], t["recon"].to(torch.uint8))
    assert torch.equal(f["mpm"], t["mpm"].to(torch.int8))
    acf = (np.count_nonzero(np.asarray(j["scan"])[..., 1:], -1) == 0)
    assert np.array_equal(f["acflag"].numpy(), acf.astype(np.int8))


@pytest.mark.parametrize("qdc,qac", [(16, 16), (4, 6)])
def test_intra_luma_scan_fast_within_tolerance(qdc, qac):
    orig = _luma(100 + qdc)
    j = jwf.intra_luma_scan_packed(jnp.asarray(orig), qdc, qac, dtype=jnp.float32)
    t = intra_luma_scan_fused(torch.from_numpy(orig), qdc, qac, dtype=torch.float32,
                              recon_plane=True)
    sj = np.asarray(j["scan"])
    ndiff = int((sj != t["scan"].numpy()).sum())
    print(f"float32 luma wavefront: {ndiff} of {sj.size} symbols differ from JAX")
    assert ndiff <= 0.001 * sj.size
    plane = np.asarray(jintra.from_blocks(jnp.asarray(orig)))
    rj = np.asarray(jintra.from_blocks(j["recon"]))
    assert abs(_psnr(t["recon_plane"].numpy(), plane) - _psnr(rj, plane)) <= 0.05


def test_intra_luma_refuses_odd_grid_width():
    orig = torch.zeros((1, 2, 3, 8, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        intra_luma_scan_fused(orig, 16, 16)
    with pytest.raises(ValueError):
        twf.intra_luma_scan_packed(orig, 16, 16)


@pytest.mark.parametrize("return_recon", [True, False])
def test_encode_intra_frames_exact_matches_jax(return_recon):
    rng = np.random.default_rng(7)
    y = rng.integers(0, 256, (2, 48, 64), dtype=np.uint8)
    cb = rng.integers(0, 256, (2, 24, 32), dtype=np.uint8)
    cr = rng.integers(0, 256, (2, 24, 32), dtype=np.uint8)
    enc = jax.jit(jintra.encode_intra_frames,
                  static_argnames=("qdc", "qac", "dtype", "return_recon"))
    j = enc(jnp.asarray(y), jnp.asarray(cb), jnp.asarray(cr), qdc=10, qac=12,
            dtype=jnp.float64, return_recon=return_recon)
    t = tintra.encode_intra_frames(*map(torch.from_numpy, (y, cb, cr)), 10, 12,
                                   dtype=torch.float64, return_recon=return_recon)
    assert sorted(j) == sorted(t)
    for k in j:
        a, b = np.asarray(j[k]), t[k].numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), k
