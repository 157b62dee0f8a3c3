"""Kernel B's plain version against the Pallas kernel it replaces.

dc_fused.dc_dpcm_plain, the reference that chip_smoke.py holds the CUDA
kernel B (csrc/dc_dpcm.cu) to bit for bit, and dc_fused.dc_dpcm_fused on a
CPU tensor, which runs it, against icspcodec_tpu.ops.pallas_dc.dc_dpcm_fused
in interpret mode: edge shapes (gh = 1, gw = 1, odd gw, a plane of 40 block
rows), DCs with exact half-integers and residuals far below zero (floor
against trunc, C division of negatives), qstep 1, 7 and 16, luma and chroma
kinds, float32 and float64; bit-identical.  The Pallas kernel computes in
float32 (its wrapper casts the DCs), so the float64 case takes the planes
whose DCs are multiples of 1/4 below 2^13: float32 holds them, and every
residual and half of theirs, exactly.

Luma planes are an even number of blocks wide (a frame's width is a
multiple of 16), so luma kinds are held on even widths and gw = 1 only: at
an odd width above 1 the luma kind grid gives the last column kind 4,
med(l, u, ur), whose upper-right neighbour lies outside the plane, and
there the JAX package's XLA scan and its Pallas kernel disagree with each
other (the port takes ur = u, as its plain version's clamped index does).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icspcodec_tpu.ops import pallas_dc
from icspcodec_torch.ops import dc_fused

# (shape, chroma): chroma planes may be an odd number of blocks wide (QCIF's
# are 11), luma planes not
CASES = [
    pytest.param((3, 1, 9), False, id="gh1-luma"), pytest.param((3, 1, 9), True, id="gh1-chroma"),
    pytest.param((3, 7, 1), False, id="gw1-luma"), pytest.param((3, 7, 1), True, id="gw1-chroma"),
    pytest.param((3, 5, 7), True, id="odd_gw-chroma"),
    pytest.param((2, 40, 4), False, id="tall-luma"),
    pytest.param((2, 40, 3), True, id="tall-chroma"),
]


def _dcs(shape) -> np.ndarray:
    """(2F, gh, gw) float32 DCs: F planes of any float32 values, then F of
    multiples of 1/4."""
    f, gh, gw = shape
    rng = np.random.default_rng(100 * gh + gw)
    a = rng.normal(1024, 400, (2 * f, gh, gw))
    a[..., ::3] = np.round(a[..., ::3]) + 0.5
    a[..., 1::4] = -rng.uniform(0, 3000, a[..., 1::4].shape)
    a[f:] = np.round(a[f:] * 4) / 4
    return a.astype(np.float32)


# one XLA program a case, the packing around the kernel in it
_pallas_fwd = jax.jit(pallas_dc.dc_dpcm_fused, static_argnames=("qstep", "chroma", "interpret"))


@functools.lru_cache(maxsize=None)
def _pallas(shape, qstep: int, chroma: bool):
    q, dq = _pallas_fwd(jnp.asarray(_dcs(shape)), qstep=qstep, chroma=chroma, interpret=True)
    return np.asarray(q), np.asarray(dq)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("qstep", [1, 7, 16])
@pytest.mark.parametrize("shape,chroma", CASES)
def test_dc_chain_plain_equals_pallas_kernel(shape, chroma, qstep, dtype):
    x = _dcs(shape)
    want_q, want_dq = _pallas(shape, qstep, chroma)
    if dtype == torch.float64:
        f = shape[0]
        x, want_q, want_dq = x[f:], want_q[f:], want_dq[f:]
    dc = torch.from_numpy(x).to(dtype)
    for fn in (dc_fused.dc_dpcm_plain, dc_fused.dc_dpcm_fused):
        q, dq = fn(dc, qstep, chroma)
        assert q.dtype == dq.dtype == torch.int32
        assert np.array_equal(q.numpy(), want_q) and np.array_equal(dq.numpy(), want_dq)
