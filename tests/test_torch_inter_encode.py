"""The PyTorch port's inter GOP encode against the JAX package (period 3, 5
frames of 64x96: one full GOP and a GOP of 2; the plain versions of the
kernels on the CPU).

* exact mode: byte-identical streams and identical recon planes, on a
  textured pan and on static-trigger content, whose stream carries MVs off
  the canonical spiral (the stateful branch ran); the sha256 that
  chip_smoke.py checks on the card is the JAX package's stream;
* fast mode: within 0.5% of the JAX fast stream's size, PSNR-Y within
  0.05 dB in every frame, and the JAX decoder reads the port's stream
  (its final byte realigned, as the JAX parser needs);
* on break-free content the stateful selection over kernel D's and G's
  SADs picks the fixed branch's MVs.
"""
import hashlib

import numpy as np
import pytest
import torch

import chip_smoke
from icspcodec_tpu import codec as jcodec
from icspcodec_tpu.config import CodecConfig as JConfig
from icspcodec_torch import codec as tcodec
from icspcodec_torch import tables
from icspcodec_torch.config import CodecConfig as TConfig
from icspcodec_torch.engine.inter import mv_reconstruct_scan
from icspcodec_torch.ops.me import stateful_select
from icspcodec_torch.ops.me_fused import sad_mc_best, sad_union_extra
from icspcodec_torch.ops.pad import pad_image
from icspcodec_torch.runtime import parse_body
from test_torch_decode import F, H, W, _content, _static_content
from tests.torch_tail import jax_realigned

PERIOD = 3


def _cfg(precision):
    return dict(width=W, height=H, qp_dc=16, qp_ac=16, intra_period=PERIOD, precision=precision)


def _psnr(rec, orig):
    mse = ((rec.astype(np.float64) - orig.astype(np.float64)) ** 2).mean(axis=(-2, -1))
    return 10 * np.log10(255.0 ** 2 / np.maximum(mse, 1e-12))


def _mvs(data: bytes) -> np.ndarray:
    """The reconstructed MVs of the stream's P-frames, (n, 2)."""
    syms = parse_body(data[14:], F, H, W, PERIOD)
    pframes = [n for n in range(F) if n % PERIOD]
    return mv_reconstruct_scan(torch.from_numpy(syms["mv_diff"][pframes])).numpy().reshape(-1, 2)


@pytest.mark.parametrize("content", ["pan", "static"])
def test_exact_inter_encode_identical_to_jax(content):
    frames = _static_content() if content == "static" else _content(7)
    bj, rj = jcodec.encode(*frames, JConfig(**_cfg("exact")))
    bt, rt = tcodec.encode(*frames, TConfig(**_cfg("exact")), device="cpu")
    assert bt == bj
    for k in ("y", "cb", "cr"):
        assert rt[k].dtype == np.uint8 and np.array_equal(rt[k], rj[k]), k
    canon = {tuple(v) for v in tables.NEG_SPIRAL.tolist()}
    union = {tuple(v) for v in tables.NEG_UNION.tolist()}
    mvs = [tuple(v) for v in _mvs(bt).tolist()]
    assert all(v in union for v in mvs)
    if content == "static":
        assert any(v not in canon for v in mvs), "no non-canonical MV: the stateful branch did not run"


def test_pinned_inter_sha256_is_the_jax_stream():
    frames = chip_smoke.static_trigger_input()
    cfg = chip_smoke.INTER_ENC_CFG
    bj, _ = jcodec.encode(*frames, JConfig(**cfg), return_recon=False)
    bt, rec = tcodec.encode(*frames, TConfig(**cfg), return_recon=False, device="cpu")
    assert rec is None
    assert hashlib.sha256(bj).hexdigest() == chip_smoke.INTER_ENC_SHA256
    assert hashlib.sha256(bt).hexdigest() == chip_smoke.INTER_ENC_SHA256


def test_fast_inter_encode_within_tolerance_of_jax():
    y, cb, cr = _content(7)
    bj, rj = jcodec.encode(y, cb, cr, JConfig(**_cfg("fast")))
    bt, rt = tcodec.encode(y, cb, cr, TConfig(**_cfg("fast")), device="cpu")
    assert abs(len(bt) - len(bj)) <= 0.005 * len(bj)
    assert np.abs(_psnr(rt["y"], y) - _psnr(rj["y"], y)).max() <= 0.05
    dt = jcodec.decode(jax_realigned(bt, F), F, precision="fast")
    assert dt["y"].shape == y.shape
    assert np.abs(_psnr(dt["y"], y) - _psnr(rt["y"], y)).max() <= 0.05


def test_stateful_selection_on_break_free_content_is_the_fixed_branch():
    """Frame 1 of the pan against frame 0: no MB has two zero SADs, so the
    stateful selection over the 129 union SADs (kernel D's canonical rows
    and kernel G's extra rows) must pick D's MVs."""
    y = torch.from_numpy(_content(7, f=2)[0])
    cur, pad = y[1:], pad_image(y[:1], 16)
    best, zc, sads_c, _ = sad_mc_best(cur, pad)
    assert int(zc.max()) < 2
    best_u = stateful_select(torch.cat([sads_c, sad_union_extra(cur, pad)], dim=1))
    assert np.array_equal(tables.NEG_UNION[best_u.numpy()], tables.NEG_SPIRAL[best.numpy()])
