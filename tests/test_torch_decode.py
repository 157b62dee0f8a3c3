"""The PyTorch port's decoder against the JAX package's (frames of 64x96,
at most 6 frames; the plain versions of the kernels on the CPU).

* the decode wavefronts (inverse DC chain, intra luma pixel recon) and the
  kernel wrappers' plain versions: bit-exact in float64;
* exact mode: codec.decode gives the JAX package's planes byte for byte,
  for all-intra streams at three QP pairs and for inter streams at period
  3 with a shorter last GOP, one of them from static-trigger content whose
  MVs leave the canonical spiral.  The JAX package decodes each stream as
  written: with its final byte realigned (tests/torch_tail.py), since its
  parser reads that byte MSB-first where the writer keeps the bits low;
* the digests chip_smoke.py checks on the card are the JAX decode's;
* fast mode: PSNR-Y within 0.05 dB of the JAX fast decode (float32 sums
  in another order can move a pixel on a truncation boundary by one);
* the entry point: no silent CPU fallback; sharding takes a device list.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from icspcodec_tpu import codec as jcodec
from icspcodec_tpu.config import CodecConfig as JConfig
from icspcodec_tpu.engine import wavefront as jwf
from icspcodec_tpu.runtime import parse_body as jparse_body
from icspcodec_torch import codec as tcodec
from icspcodec_torch import tables
from icspcodec_torch.config import CodecConfig as TConfig
from icspcodec_torch.constants import COS_DEC
from icspcodec_torch.engine import inter as tinter
from icspcodec_torch.engine import wavefront as twf
from icspcodec_torch.ops.dc_fused import idc_dpcm_fused
from icspcodec_torch.ops.intra_decode_fused import intra_luma_decode_fused
from icspcodec_torch.runtime import parse_body
from tests.torch_tail import jax_readings, jax_realigned

F, H, W = 5, 64, 96


def _psnr(rec, orig):
    mse = ((rec.astype(np.float64) - orig.astype(np.float64)) ** 2).mean()
    return 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))


def _content(seed, f=F):
    """A textured pan with noise (all intra modes and real motion)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    base = 120 + 50 * np.sin(xx / 11.0) + 30 * np.cos(yy / 5.0)
    y = np.stack([np.roll(base, 2 * t, axis=1) for t in range(f)])
    y = np.clip(y + rng.normal(0, 6, (f, H, W)), 0, 255).astype(np.uint8)
    cb = rng.integers(90, 166, (f, H // 2, W // 2), dtype=np.uint8)
    cr = rng.integers(90, 166, (f, H // 2, W // 2), dtype=np.uint8)
    return y, cb, cr


def _static_content(f=F):
    """Static-trigger content: saturated black and white blocks repeated
    across frames beside a moving texture (chip_smoke.static_trigger_input).
    The black MB's zero SAD fires the encoder's early break, which mirrors
    the spiral for the MBs after it."""
    return chip_smoke.static_trigger_input(f, H, W)


@functools.lru_cache(maxsize=None)
def _inter_stream(content: str) -> bytes:
    """The JAX package's exact encode at period 3, QP 16/16, of F frames:
    one full GOP and a GOP of 2.  One configuration, so the JAX encoder
    compiles once for both contents."""
    frames = _static_content() if content == "static" else _content(7)
    cfg = JConfig(width=W, height=H, qp_dc=16, qp_ac=16, intra_period=3, precision="exact")
    return jcodec.encode(*frames, cfg, return_recon=False)[0]


def _intra_stream(qdc, qac, precision="exact", f=2):
    """An all-intra stream by the port's encoder (on the CPU; its exact
    bytes equal the JAX package's, tests/test_torch_codec.py)."""
    cfg = TConfig(width=W, height=H, qp_dc=qdc, qp_ac=qac, precision=precision)
    return tcodec.encode(*_content(qdc, f=f), cfg, return_recon=False, device="cpu")[0]


# ---------------------------------------------------------------------------
# the wavefronts and the kernel wrappers' plain versions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chroma,gh,gw", [(True, 4, 6), (False, 6, 8), (True, 3, 5)])
def test_idc_dpcm_matches_jax(chroma, gh, gw):
    iq = np.random.default_rng(gh * gw).integers(-900, 900, (3, gh, gw)).astype(np.int32)
    kind = (tables.chroma_dc_kind if chroma else tables.luma_dc_kind)(gh, gw)
    dj = np.asarray(jwf.idc_dpcm_scan(jnp.asarray(iq), kind))
    dt = twf.idc_dpcm_scan(torch.from_numpy(iq), kind)
    assert dt.dtype == torch.int32 and np.array_equal(dj, dt.numpy())
    assert torch.equal(idc_dpcm_fused(torch.from_numpy(iq), chroma), dt)


def _decode_syms(seed, f=3, gh=6, gw=8):
    rng = np.random.default_rng(seed)
    sc = np.where(rng.random((f, gh, gw, 64)) < 0.15, rng.integers(-6, 7, (f, gh, gw, 64)), 0)
    sc[..., 0] = rng.integers(-3, 4, (f, gh, gw))
    bits = rng.integers(0, 2, (2, f, gh, gw))
    return sc.astype(np.int16), bits[0].astype(np.int8), bits[1].astype(np.int8)


@pytest.mark.parametrize("prec", ["float64", "float32"])
def test_intra_luma_decode_matches_jax(prec):
    """intra_luma_decode_scan_packed, and the kernel C wrapper's plain
    version, against the JAX XLA branch at QP 16/16 (the codec tests below
    cover 8/16 and 1/1); float32 within one level."""
    jdt, tdt = (jnp.float64, torch.float64) if prec == "float64" else (jnp.float32, torch.float32)
    sc, mpm, bit = _decode_syms(1)
    rng = np.random.default_rng(2)
    r = rng.normal(0, 40, sc.shape[:3] + (8, 8)).astype(np.dtype(prec))
    rj = np.asarray(jwf.intra_luma_decode_scan_packed(jnp.asarray(r), jnp.asarray(mpm),
                                                      jnp.asarray(bit), dtype=jdt))
    rt = twf.intra_luma_decode_scan_packed(torch.from_numpy(r), torch.from_numpy(mpm),
                                           torch.from_numpy(bit), dtype=tdt)
    assert np.array_equal(rj, rt.numpy())
    dj = jcodec._decode_intra_jit(sc, mpm, bit, sc[:, ::2, ::2], sc[:, 1::2, ::2], 16, 16,
                                  prec == "float64")
    yt = intra_luma_decode_fused(torch.from_numpy(sc), torch.from_numpy(mpm),
                                 torch.from_numpy(bit), 16, 16, table=COS_DEC, dtype=tdt)
    diff = np.abs(np.asarray(dj["y"]).astype(int) - yt.numpy())
    assert diff.max() <= (0 if prec == "float64" else 1)


def test_intra_luma_decode_clamps_and_refuses_odd_width():
    sc, mpm, bit = _decode_syms(3, f=1)
    wide = sc.astype(np.int32)
    wide[0, 1, 2, :4] = [70000, -70000, 32767, -32768]
    narrow = np.clip(wide, -32768, 32767).astype(np.int16)
    args = (torch.from_numpy(mpm), torch.from_numpy(bit), 8, 16)
    assert torch.equal(intra_luma_decode_fused(torch.from_numpy(wide), *args),
                       intra_luma_decode_fused(torch.from_numpy(narrow), *args))
    with pytest.raises(ValueError, match="even"):
        intra_luma_decode_fused(torch.from_numpy(sc[:, :, :7]), torch.from_numpy(mpm[:, :, :7]),
                                torch.from_numpy(bit[:, :, :7]), 8, 16)


# ---------------------------------------------------------------------------
# codec.decode against the JAX package's decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("qdc,qac", [(16, 16), (8, 16), (1, 1)])
def test_exact_intra_decode_identical_to_jax(qdc, qac):
    data = _intra_stream(qdc, qac)
    dj = jcodec.decode(jax_realigned(data, 2), 2, precision="exact")
    dt = tcodec.decode(data, 2, precision="exact", device="cpu")
    for k in ("y", "cb", "cr"):
        assert dt[k].dtype == np.uint8 and np.array_equal(dt[k], dj[k]), k


@pytest.mark.parametrize("content", ["static", "pan"])
def test_exact_inter_decode_identical_to_jax(content):
    """Period 3, 5 frames: one full GOP and a GOP of 2."""
    data = _inter_stream(content)
    dj = jcodec.decode(jax_realigned(data, F), F, precision="exact")
    dt = tcodec.decode(data, F, precision="exact", device="cpu")
    for k in ("y", "cb", "cr"):
        assert np.array_equal(dt[k], dj[k]), k
    syms = parse_body(data[14:], F, H, W, 3)
    jsyms = jparse_body(jax_realigned(data, F)[14:], F, H, W, 3)
    assert all(np.array_equal(syms[k], jsyms[k]) for k in syms)
    mv = tinter.mv_reconstruct_scan(torch.from_numpy(syms["mv_diff"][[1, 2, 4]])).numpy()
    canon = {tuple(v) for v in tables.NEG_SPIRAL.tolist()}
    noncanon = [v for v in mv.reshape(-1, 2).tolist() if tuple(v) not in canon]
    if content == "static":
        assert noncanon, "the static-trigger stream carries no non-canonical MV"
    assert all(tuple(v) in {tuple(u) for u in tables.NEG_UNION.tolist()}
               for v in mv.reshape(-1, 2).tolist())


def test_pinned_decode_digests_are_the_jax_decode():
    """The two digests chip_smoke.py checks on the card: the exact decode of
    the XCHECK stream and of the seeded inter stream (MVs outside the
    padded frame included) by the JAX package (of the stream realigned)
    and by the port."""
    xb = tcodec.encode(*chip_smoke.xcheck_input(), TConfig(**chip_smoke.XCHECK_CFG),
                       return_recon=False, device="cpu")[0]   # = the JAX stream (sha256 pinned)
    ib = chip_smoke.inter_xcheck_stream()
    nf = chip_smoke.INTER_XCHECK["nframes"]
    assert sorted(jax_readings(xb, 2)) == [chip_smoke.XCHECK_TAIL_BITS]
    for data, n, pinned in ((xb, 2, chip_smoke.XCHECK_DECODE_SHA256),
                            (ib, nf, chip_smoke.INTER_XCHECK_DECODE_SHA256)):
        assert chip_smoke.planes_digest(jcodec.decode(jax_realigned(data, n), n,
                                                      precision="exact")) == pinned
        assert chip_smoke.planes_digest(tcodec.decode(data, n, device="cpu")) == pinned


@pytest.mark.parametrize("period", [0, 3])
def test_fast_decode_within_tolerance_of_jax(period):
    if period:
        y, data = _content(7)[0], _inter_stream("pan")
    else:
        y, data = _content(16, f=F)[0], _intra_stream(16, 16, "fast", f=F)
    dj = jcodec.decode(jax_realigned(data, F), F, precision="fast")
    dt = tcodec.decode(data, F, precision="fast", device="cpu")
    for k in ("y", "cb", "cr"):
        assert dt[k].shape == dj[k].shape and dt[k].dtype == np.uint8
    for i in range(F):
        assert abs(_psnr(dt["y"][i], y[i]) - _psnr(dj["y"][i], y[i])) <= 0.05, i


def test_decode_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = tcodec.encode(*_content(1, f=1), TConfig(width=W, height=H), device="cpu")[0]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcodec.decode(data, 1)


@pytest.mark.parametrize("shards", [dict(gop_shards=2), dict(tile_shards=2)])
def test_decode_refuses_sharding(shards):
    """A sharded decode runs over a list of devices: a single device is
    refused, pointing at the list form."""
    data = tcodec.encode(*_content(1, f=1), TConfig(width=W, height=H), device="cpu")[0]
    with pytest.raises(ValueError, match="list of devices"):
        tcodec.decode(data, 1, device="cpu", **shards)
