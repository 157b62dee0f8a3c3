"""GOP sharding of the port over a device list (icspcodec_torch/parallel/gop.py),
on the CPU: frames of 64x96, the list naming "cpu" once per shard, the
plain versions of the kernels in every shard.

* encode_gops_sharded / encode_gops_padded / encode_intra_padded equal the
  single-device engines;
* codec.encode and codec.decode at gop_shards 2 and 3 give the unsharded
  bytes, recon and planes, at period 0 and 3, with GOP counts the shard
  count does not divide (8 frames: 2 full GOPs of 3 and one of 2), in both
  precisions; encode_streaming at gop_shards 2 likewise, with a resume;
* the refusals: fewer devices than shards, a single device with shards;
* the CLI with --gopShards 2 and a device list;
* slow: the JAX package's own sharded encode (gop_shards=3 on its virtual
  CPU devices) gives the same bytes.
"""
import functools

import numpy as np
import pytest
import torch

from icspcodec_torch import cli, codec, streaming
from icspcodec_torch.config import CodecConfig
from icspcodec_torch.engine.inter import encode_gop
from icspcodec_torch.engine.intra import encode_intra_frames
from icspcodec_torch.io import save_yuv420
from icspcodec_torch.metrics import MetricsLog
from icspcodec_torch.parallel import gop

F, H, W = 8, 64, 96


@functools.lru_cache(maxsize=None)
def _frames(f: int = F):
    """A textured pan with noise and a static block, seeded."""
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:H, 0:W]
    base = 120 + 50 * np.sin(xx / 11.0) + 30 * np.cos(yy / 5.0)
    y = np.stack([np.roll(base, 2 * t, axis=1) for t in range(f)])
    y = np.clip(y + rng.normal(0, 6, (f, H, W)), 0, 255).astype(np.uint8)
    y[:, :16, :32] = 0
    cb = rng.integers(90, 166, (f, H // 2, W // 2), dtype=np.uint8)
    cr = rng.integers(90, 166, (f, H // 2, W // 2), dtype=np.uint8)
    return y, cb, cr


def _cfg(precision, period, **kw):
    return CodecConfig(width=W, height=H, qp_dc=8, qp_ac=16, intra_period=period,
                       precision=precision, **kw)


@functools.lru_cache(maxsize=None)
def _unsharded(precision, period):
    bits, rec = codec.encode(*_frames(), _cfg(precision, period), device="cpu")
    return bits, rec, codec.decode(bits, F, precision, device="cpu")


@pytest.mark.parametrize("k", [2, 3])
def test_sharded_engines_equal_the_single_device_ones(k):
    y, cb, cr = (a[:6].reshape((3, 2) + a.shape[1:]) for a in _frames())
    want_i, want_p = encode_gop(*(torch.from_numpy(a) for a in (y, cb, cr)), 8, 16,
                                dtype=torch.float32)
    gi, gp = gop.encode_gops_padded(y, cb, cr, 8, 16, ["cpu"] * k)
    for want, got in ((want_i, gi), (want_p, gp)):
        assert want.keys() == got.keys()
        for n in want:
            assert torch.equal(want[n], got[n]), n
    if 3 % k == 0:
        si, sp = gop.encode_gops_sharded(y, cb, cr, 8, 16, [torch.device("cpu")] * k)
        assert all(torch.equal(want_p[n], sp[n]) for n in want_p)
    else:
        with pytest.raises(ValueError, match="encode_gops_padded"):
            gop.encode_gops_sharded(y, cb, cr, 8, 16, ["cpu"] * k)
    fy, fcb, fcr = (a[:5] for a in _frames())
    want = encode_intra_frames(*(torch.from_numpy(a) for a in (fy, fcb, fcr)), 8, 16,
                               dtype=torch.float32)
    got = gop.encode_intra_padded(fy, fcb, fcr, 8, 16, ["cpu"] * k)
    assert all(torch.equal(want[n], got[n]) for n in want)


@pytest.mark.parametrize("shards", [2, 3])
@pytest.mark.parametrize("period", [0, 3])
@pytest.mark.parametrize("precision", ["exact", "fast"])
def test_sharded_encode_and_decode_equal_unsharded(precision, period, shards):
    bits1, rec1, dec1 = _unsharded(precision, period)
    bits, rec = codec.encode(*_frames(), _cfg(precision, period, gop_shards=shards),
                             device=["cpu"] * shards)
    assert bits == bits1
    for n in rec1:
        assert np.array_equal(rec[n], rec1[n]), n
    dec = codec.decode(bits1, F, precision, device=["cpu"] * shards, gop_shards=shards)
    for n in dec1:
        assert np.array_equal(dec[n], dec1[n]), n


@pytest.mark.parametrize("precision", ["exact", "fast"])
def test_sharded_streaming_equals_unsharded(tmp_path, precision):
    bits1 = _unsharded(precision, 3)[0]
    cfg = _cfg(precision, 3, gop_shards=2)
    log = MetricsLog()
    got = streaming.encode_streaming(*_frames(), cfg, str(tmp_path), metrics=log,
                                     device=["cpu"] * 2)
    assert got == bits1
    assert [r.gop_index for r in log.records] == [0, 1, 2]
    assert set(np.load(tmp_path / "gop_00000.npz").files) == {"codes", "lengths", "fingerprint"}
    (tmp_path / "gop_00001.npz").unlink()
    log = MetricsLog()
    assert streaming.encode_streaming(*_frames(), cfg, str(tmp_path), metrics=log,
                                      device=["cpu"] * 2) == bits1
    assert [r.gop_index for r in log.records] == [1]


def test_sharding_refusals(tmp_path):
    frames = [a[:3] for a in _frames()]
    cfg = _cfg("fast", 3, gop_shards=2)
    with pytest.raises(ValueError, match="gop_shards=2 but only 1 devices"):
        codec.encode(*frames, cfg, device=["cpu"])
    if torch.cuda.device_count() < 2:  # None means every CUDA device
        with pytest.raises(ValueError, match="devices are available"):
            codec.encode(*frames, cfg)
        with pytest.raises(ValueError, match="devices are available"):
            codec.decode(b"", 1, gop_shards=2)
    with pytest.raises(ValueError, match=r"list of devices.*\['cpu'\] \* 2"):
        codec.encode(*frames, cfg, device="cpu")
    with pytest.raises(ValueError, match="list of devices"):
        codec.decode(b"", 1, device="cpu", gop_shards=2)
    with pytest.raises(ValueError, match="list of devices"):
        streaming.encode_streaming(*frames, cfg, str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        codec.decode(b"", 1, device=["cpu"] * 2, gop_shards=2, tile_shards=2)


def test_cli_gop_shards(tmp_path, capsys):
    bits1, _, dec1 = _unsharded("fast", 3)
    yuv, out = tmp_path / "seq_cif.yuv", tmp_path / "seq.bin"
    save_yuv420(yuv, *_frames())
    cli.main(["encode", "-i", str(yuv), "-n", str(F), "--width", str(W), "--height", str(H),
              "--qpdc", "8", "--qpac", "16", "--intraPeriod", "3", "--precision", "fast",
              "--gopShards", "2", "-o", str(out)], device=["cpu"] * 2)
    assert out.read_bytes() == bits1
    dec = tmp_path / "dec.yuv"
    cli.main(["decode", "-i", str(out), "-n", str(F), "--precision", "fast", "--gopShards",
              "3", "-o", str(dec)], device=["cpu"] * 3)
    want = np.concatenate([np.concatenate([dec1[k][f].ravel() for k in ("y", "cb", "cr")])
                           for f in range(F)])
    assert np.array_equal(np.fromfile(dec, np.uint8), want)
    assert "encoded 8 frames" in capsys.readouterr().out


@pytest.mark.slow
def test_equals_the_jax_sharded_encode():
    import jax

    from icspcodec_tpu import codec as jcodec
    from icspcodec_tpu.config import CodecConfig as JConfig

    if len(jax.devices("cpu")) < 3:
        pytest.skip("needs 3 virtual CPU devices")
    jbits, jrec = jcodec.encode(*_frames(), JConfig(width=W, height=H, qp_dc=8, qp_ac=16,
                                                    intra_period=3, precision="exact",
                                                    gop_shards=3))
    bits, rec = codec.encode(*_frames(), _cfg("exact", 3, gop_shards=3), device=["cpu"] * 3)
    assert bits == jbits
    for n in rec:
        assert np.array_equal(rec[n], jrec[n]), n
