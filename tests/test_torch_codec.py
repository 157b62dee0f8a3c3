"""The PyTorch port's encode, as a whole, against the JAX package (frames of
64x96, the plain versions of the kernels on the CPU).

* exact mode: byte-identical bitstreams and identical recon planes;
* the sha256 that chip_smoke.py checks on the card is the JAX package's;
* fast mode: the JAX decoder reads the port's stream (its final byte
  realigned, as the JAX parser needs), and its PSNR-Y is within 0.05 dB of
  the JAX fast encode's;
* the entry point: no silent CPU fallback, sharding refused (with either
  writer), and at intra periods 2 and 10 the parser reads back every
  symbol the encoder emitted.
"""
import ast
import hashlib
import pathlib

import numpy as np
import pytest
import torch

import chip_smoke
from icspcodec_tpu import codec as jcodec
from icspcodec_tpu.config import CodecConfig as JConfig
from icspcodec_torch import codec as tcodec
from icspcodec_torch.bitstream_device import frame_items_dev
from icspcodec_torch.config import CodecConfig as TConfig
from icspcodec_torch.runtime import parse_body
from tests.torch_tail import jax_realigned

REPO = pathlib.Path(__file__).resolve().parents[1]


def _frames(seed=0, f=2, h=64, w=96):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 120 + 50 * np.sin(xx / 11.0) + 30 * np.cos(yy / 5.0)
    y = np.clip(base[None] + rng.normal(0, 20, (f, h, w)), 0, 255).astype(np.uint8)
    cb = rng.integers(0, 256, (f, h // 2, w // 2), dtype=np.uint8)
    cr = rng.integers(0, 256, (f, h // 2, w // 2), dtype=np.uint8)
    return y, cb, cr


def _psnr(rec, orig):
    mse = ((rec.astype(np.float64) - orig.astype(np.float64)) ** 2).mean(axis=(-2, -1))
    return float((10 * np.log10(255.0 ** 2 / np.maximum(mse, 1e-12))).mean())


@pytest.mark.parametrize("qdc,qac", [(16, 16), (8, 16), (10, 12), (1, 1)])
def test_exact_encode_byte_identical_to_jax(qdc, qac):
    y, cb, cr = _frames(qdc)
    kw = dict(width=96, height=64, qp_dc=qdc, qp_ac=qac, precision="exact")
    bj, rj = jcodec.encode(y, cb, cr, JConfig(**kw))
    bt, rt = tcodec.encode(y, cb, cr, TConfig(**kw), device="cpu")
    assert bt == bj
    for k in ("y", "cb", "cr"):
        assert np.array_equal(rt[k], rj[k]), k


def test_pinned_sha256_is_the_jax_stream():
    cfg = chip_smoke.XCHECK_CFG
    bj, _ = jcodec.encode(*chip_smoke.xcheck_input(), JConfig(**cfg))
    bt, rec = tcodec.encode(*chip_smoke.xcheck_input(), TConfig(**cfg), return_recon=False,
                            device="cpu")
    assert rec is None
    assert hashlib.sha256(bj).hexdigest() == chip_smoke.XCHECK_SHA256
    assert hashlib.sha256(bt).hexdigest() == chip_smoke.XCHECK_SHA256


def test_fast_encode_decodes_with_jax():
    y, cb, cr = _frames(3)
    kw = dict(width=96, height=64, qp_dc=16, qp_ac=16, precision="fast", intra_period=1)
    bt, rt = tcodec.encode(y, cb, cr, TConfig(**kw), device="cpu")
    bj, _ = jcodec.encode(y, cb, cr, JConfig(**kw))
    dt = jcodec.decode(jax_realigned(bt, 2), 2, precision="exact")
    dj = jcodec.decode(jax_realigned(bj, 2), 2, precision="exact")
    assert dt["y"].shape == y.shape
    assert abs(_psnr(dt["y"], y) - _psnr(dj["y"], y)) <= 0.05
    assert abs(_psnr(rt["y"], y) - _psnr(dj["y"], y)) <= 0.05


def test_encode_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    y, cb, cr = _frames(f=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcodec.encode(y, cb, cr, TConfig(width=96, height=64))


@pytest.mark.parametrize("bad", [dict(gop_shards=2), dict(tile_shards=2),
                                 dict(entropy="host", gop_shards=2)])
def test_configs_outside_the_slice_are_refused(bad):
    """A sharded config runs over a list of devices: a single device is
    refused, pointing at the list form (tests/test_torch_gop_sharding.py
    runs the lists)."""
    y, cb, cr = _frames(f=1)
    with pytest.raises(ValueError, match="list of devices"):
        tcodec.encode(y, cb, cr, TConfig(width=96, height=64, **bad), device="cpu")


@pytest.mark.parametrize("period", [2, 10])
def test_inter_encode_symbols_read_back(period):
    """11 frames: five full GOPs and a one-frame intra GOP at period 2, one
    full GOP and a one-frame intra GOP at period 10.  The port's parser
    reads back exactly the symbols the encoder emitted, frame by frame,
    from the stream's raw bytes: it reads the final partial byte, whose
    bits the writer keeps LOW (the reference's tail convention), as the
    writer wrote it."""
    y, cb, cr = _frames(period, f=11)
    cfg = TConfig(width=96, height=64, intra_period=period, precision="fast")
    bits, rec = tcodec.encode(y, cb, cr, cfg, device="cpu")
    assert rec["y"].shape == y.shape and len(bits) > 14
    (isyms, iidx), (psyms, pidx), _ = tcodec.encode_symbols(
        *(torch.from_numpy(a) for a in (y, cb, cr)), cfg, return_recon=False)
    assert sorted(iidx.tolist()) == list(range(0, 11, period))
    assert sorted(np.concatenate([iidx, pidx]).tolist()) == list(range(11))
    nbits = sum(int(frame_items_dev(s, intra)[1].sum()) for s, intra in ((isyms, True),
                                                                         (psyms, False)))
    assert len(bits) - 14 == nbits // 8 + 1
    parsed = parse_body(bits[14:], 11, 64, 96, period)
    for syms, idx in ((isyms, iidx), (psyms, pidx)):
        for k, v in syms.items():
            assert np.array_equal(parsed[k][idx], v.numpy()), k


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "icspcodec_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "icspcodec_tpu"), f"{path}: {name}"
