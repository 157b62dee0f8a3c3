"""Device entropy on the sharded encode routes of the port, on the CPU:
frames of 64x96, the device list naming "cpu" once per shard.

The sharded engines gather their symbols on the list's first device, and
codec.encode entropy-codes them there through codec.write_stream, as it
does unsharded; entropy="host" sends them to the numpy writer
(codec.write_bitstream_grouped) on every route.

* GOP shards (2 and 3) and MB-column tiles (2) with entropy "auto" and
  "device", all-intra and at period 3 (8 frames: GOPs of 3, 3 and 2), in
  both precisions, give the unsharded bytes and recon, with the numpy
  writer made to raise;
* entropy="host" with GOP shards gives the same bytes through the numpy
  writer, with the device writer made to raise.
"""
import functools

import numpy as np
import pytest
import torch

from icspcodec_torch import codec
from icspcodec_torch.config import CodecConfig

F, H, W = 8, 64, 96

ROUTES = {"gop2": dict(gop_shards=2), "gop3": dict(gop_shards=3), "tile2": dict(tile_shards=2)}


@functools.lru_cache(maxsize=None)
def _frames():
    """A textured pan with noise and a static black block, seeded."""
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:H, 0:W]
    base = 118 + 48 * np.sin(xx / 9.0) + 28 * np.cos(yy / 6.0)
    y = np.stack([np.roll(base, 3 * t, axis=1) for t in range(F)])
    y = np.clip(y + rng.normal(0, 5, (F, H, W)), 0, 255).astype(np.uint8)
    y[:, 16:32, 48:64] = 0
    cb = rng.integers(90, 166, (F, H // 2, W // 2), dtype=np.uint8)
    cr = rng.integers(90, 166, (F, H // 2, W // 2), dtype=np.uint8)
    return y, cb, cr


def _cfg(precision, period, **kw):
    return CodecConfig(width=W, height=H, qp_dc=8, qp_ac=16, intra_period=period,
                       precision=precision, **kw)


@functools.lru_cache(maxsize=None)
def _unsharded(precision, period):
    return codec.encode(*_frames(), _cfg(precision, period), device="cpu")


def _refuse(name):
    def refuse(*args, **kwargs):
        raise AssertionError(f"codec.{name} was called")
    return refuse


def _spy(fn, calls):
    """fn, noting each call's intra y_scan symbols."""
    def spy(*args, **kwargs):
        calls.append(args[0]["y_scan"])
        return fn(*args, **kwargs)
    return spy


def _sharded(route, precision, period, entropy):
    shards = ROUTES[route]
    n = max(shards.values())
    return codec.encode(*_frames(), _cfg(precision, period, entropy=entropy, **shards),
                        device=["cpu"] * n)


def _assert_unsharded(bits, rec, precision, period):
    bits1, rec1 = _unsharded(precision, period)
    assert bits == bits1
    assert rec.keys() == rec1.keys()
    for n in rec1:
        assert np.array_equal(rec[n], rec1[n]), n


@pytest.mark.parametrize("precision", ["exact", "fast"])
@pytest.mark.parametrize("period", [0, 3])
@pytest.mark.parametrize("entropy", ["auto", "device"])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_sharded_device_entropy_equals_unsharded(monkeypatch, route, entropy, period,
                                                 precision):
    _unsharded(precision, period)
    calls = []
    monkeypatch.setattr(codec, "write_bitstream_grouped", _refuse("write_bitstream_grouped"))
    monkeypatch.setattr(codec, "write_stream", _spy(codec.write_stream, calls))
    bits, rec = _sharded(route, precision, period, entropy)
    assert [(type(c), c.device.type) for c in calls] == [(torch.Tensor, "cpu")]
    _assert_unsharded(bits, rec, precision, period)


@pytest.mark.parametrize("route", ["gop2", "tile2"])
@pytest.mark.parametrize("period", [0, 3])
def test_sharded_host_entropy_takes_the_numpy_writer(monkeypatch, route, period):
    _unsharded("exact", period)
    calls = []
    monkeypatch.setattr(codec, "write_stream", _refuse("write_stream"))
    monkeypatch.setattr(codec, "write_bitstream_grouped",
                        _spy(codec.write_bitstream_grouped, calls))
    bits, rec = _sharded(route, "exact", period, "host")
    assert [type(c) for c in calls] == [np.ndarray]
    _assert_unsharded(bits, rec, "exact", period)
