"""The grid forms of the intra luma wavefronts (engine/wavefront.py:
wavefront_schedule, intra_luma_scan, intra_luma_decode_scan) against the
JAX package's, on the same numpy-seeded inputs (grids of at most 6x8
blocks, 2 frames), and against the port's packed forms.

Tolerances: float64 is bit-exact on every output.  The float32 encoder may
flip a quantizer tie where the two frameworks sum the transform in another
order: at most 0.1% of symbols may differ and PSNR-Y by 0.05 dB (the
tolerance of test_torch_wavefront.py).  Within the port, the packed forms
run the grid forms' loop (the encoder's drops `modes` and refuses odd
widths), so they are bit-identical in both precisions.  Each JAX scan is
jitted once, with the quantizer steps traced, so the file compiles four
of them.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icspcodec_tpu.engine import intra as jintra
from icspcodec_tpu.engine import wavefront as jwf
from icspcodec_torch.engine import wavefront as twf

DTYPES = {"float64": (jnp.float64, torch.float64), "float32": (jnp.float32, torch.float32)}
ENC_KEYS = ("recon", "modes", "scan", "mpm", "mode_bit")


@functools.lru_cache(maxsize=None)
def _jax_encode(prec: str):
    jdt = DTYPES[prec][0]
    return jax.jit(lambda o, qdc, qac: jwf.intra_luma_scan(o, qdc, qac, dtype=jdt))


@functools.lru_cache(maxsize=None)
def _jax_decode():
    return jax.jit(lambda r, f, b: jwf.intra_luma_decode_scan(r, f, b, dtype=jnp.float64))


def _luma(seed, f=2, gh=6, gw=8):
    """Seeded pixel blocks (F, gh, gw, 8, 8) int32: smooth content plus
    noise, so all three intra modes win somewhere."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:gh * 8, 0:gw * 8]
    base = 128 + 60 * np.sin(xx / 9.0) * np.cos(yy / 7.0)
    y = np.clip(base[None] + rng.normal(0, 12, (f, gh * 8, gw * 8)), 0, 255).astype(np.uint8)
    return y.reshape(f, gh, 8, gw, 8).transpose(0, 1, 3, 2, 4).astype(np.int32)


def _decode_inputs(seed, f=2, gh=6, gw=8):
    """Seeded inverse-DCT blocks and mode bits, as JAX's own grid test
    draws them."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(-80, 300, (f, gh, gw, 8, 8))
    mpm, bit = rng.integers(0, 2, (2, f, gh, gw)).astype(np.int32)
    return r, mpm, bit


def _psnr(rec, orig):
    mse = ((rec.astype(np.float64) - orig.astype(np.float64)) ** 2).mean()
    return 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))


@pytest.mark.parametrize("gh,gw", [(1, 1), (3, 5), (6, 8)])
def test_wavefront_schedule_matches_jax(gh, gw):
    for a, b in zip(twf.wavefront_schedule(gh, gw), jwf.wavefront_schedule(gh, gw)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_kind_grids_importable_from_the_wavefront_module():
    for gh, gw in ((6, 8), (3, 5)):
        assert np.array_equal(twf.chroma_dc_kind(gh, gw), jwf.chroma_dc_kind(gh, gw))
        assert np.array_equal(twf.luma_dc_kind(gh, gw), jwf.luma_dc_kind(gh, gw))


@pytest.mark.parametrize("qdc,qac", [(16, 16), (1, 1), (10, 12)])
def test_intra_luma_scan_exact_matches_jax(qdc, qac):
    orig = _luma(qdc)
    j = _jax_encode("float64")(jnp.asarray(orig), qdc, qac)
    t = twf.intra_luma_scan(torch.from_numpy(orig), qdc, qac, dtype=torch.float64)
    assert sorted(t) == sorted(j)
    for k in ENC_KEYS:
        a, b = np.asarray(j[k]), t[k].numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), k


def test_intra_luma_scan_odd_width_matches_jax():
    """An odd grid width, which the packed forms and kernel A refuse: the
    right-edge kind-4 cells read the upper neighbour as the upper-right
    one, in both grid forms."""
    orig = _luma(5, gw=7)
    j = _jax_encode("float64")(jnp.asarray(orig), 8, 12)
    t = twf.intra_luma_scan(torch.from_numpy(orig), 8, 12, dtype=torch.float64)
    for k in ENC_KEYS:
        assert np.array_equal(np.asarray(j[k]), t[k].numpy()), k


@pytest.mark.parametrize("qdc,qac", [(16, 16), (4, 6)])
def test_intra_luma_scan_fast_within_tolerance(qdc, qac):
    orig = _luma(100 + qdc)
    j = _jax_encode("float32")(jnp.asarray(orig), qdc, qac)
    t = twf.intra_luma_scan(torch.from_numpy(orig), qdc, qac, dtype=torch.float32)
    sj = np.asarray(j["scan"])
    ndiff = int((sj != t["scan"].numpy()).sum())
    print(f"float32 grid wavefront: {ndiff} of {sj.size} symbols differ from JAX")
    assert ndiff <= 0.001 * sj.size
    plane = np.asarray(jintra.from_blocks(jnp.asarray(orig)))
    rj = np.asarray(jintra.from_blocks(j["recon"]))
    rt = np.asarray(jintra.from_blocks(jnp.asarray(t["recon"].numpy())))
    assert abs(_psnr(rt, plane) - _psnr(rj, plane)) <= 0.05


@pytest.mark.parametrize("seed", [10, 11])
def test_intra_luma_decode_scan_exact_matches_jax(seed):
    r, mpm, bit = _decode_inputs(seed)
    j = np.asarray(_jax_decode()(r, mpm, bit))
    t = twf.intra_luma_decode_scan(*map(torch.from_numpy, (r, mpm, bit)), dtype=torch.float64)
    assert j.dtype == t.numpy().dtype and np.array_equal(j, t.numpy())


@pytest.mark.parametrize("prec", ["float64", "float32"])
def test_grid_forms_equal_packed_forms(prec):
    tdt = DTYPES[prec][1]
    orig = torch.from_numpy(_luma(21))
    for qdc, qac in ((16, 16), (1, 1)):
        g = twf.intra_luma_scan(orig, qdc, qac, dtype=tdt)
        p = twf.intra_luma_scan_packed(orig, qdc, qac, dtype=tdt)
        assert sorted(p) == sorted(set(g) - {"modes"})
        for k in p:
            assert torch.equal(g[k], p[k]), (qdc, k)
    r, mpm, bit = _decode_inputs(22)
    args = (torch.from_numpy(r).to(tdt), torch.from_numpy(mpm), torch.from_numpy(bit))
    assert torch.equal(twf.intra_luma_decode_scan(*args, dtype=tdt),
                       twf.intra_luma_decode_scan_packed(*args, dtype=tdt))
