"""MB-column tiles of the port (icspcodec_torch/parallel/tiles.py) on the CPU:
frames of 64x96 (6 MB columns), the tile list naming "cpu" once per tile,
against the untiled port.

* tiled_schedule equals the JAX package's (numpy only: the JAX tiled
  engines are not compiled here);
* codec.encode and codec.decode with tile_shards 2, 3 and 6 give the
  untiled bytes, recon and planes, all-intra and at period 3 (a GOP of 3
  and one of 2), in both precisions.  The content is static-trigger: a
  black MB's zero SAD breaks the encoder's spiral walk, and the mirrored
  walk state crosses the tile seams, so MBs of later tiles take
  non-canonical MVs (checked);
* the drivers codec.encode does not call (the luma wavefront alone, a
  batch of P-frames) equal the single-device engines;
* the tiled entry points refuse a tile count that does not divide the MB
  columns, and streaming refuses tiles with the JAX message;
* slow: CIF over 11 tiles, as the JAX package's tests/test_tiles.py splits it.
"""
import functools

import numpy as np
import pytest
import torch

import chip_smoke
from icspcodec_tpu.parallel.tiles import tiled_schedule as jax_tiled_schedule
from icspcodec_torch import codec, streaming, tables
from icspcodec_torch.config import CodecConfig
from icspcodec_torch.engine import wavefront as twf
from icspcodec_torch.engine.inter import encode_inter_frame, mv_reconstruct_scan
from icspcodec_torch.engine.intra import encode_intra_frames, from_blocks, to_blocks
from icspcodec_torch.parallel import tiles
from icspcodec_torch.runtime import parse_body

F, H, W, PERIOD = 5, 64, 96, 3


@functools.lru_cache(maxsize=None)
def _frames():
    return chip_smoke.static_trigger_input(F, H, W)


def _cfg(precision, period, **kw):
    return CodecConfig(width=W, height=H, qp_dc=16, qp_ac=16, intra_period=period,
                       precision=precision, **kw)


@functools.lru_cache(maxsize=None)
def _untiled(precision, period):
    bits, rec = codec.encode(*_frames(), _cfg(precision, period, entropy="host"), device="cpu")
    return bits, rec, codec.decode(bits, F, precision, device="cpu")


@pytest.mark.parametrize("gh, gw, ntiles", [(8, 12, 2), (8, 12, 3), (8, 12, 6), (36, 44, 2),
                                            (36, 44, 11), (5, 8, 4)])
def test_tiled_schedule_equals_jax(gh, gw, ntiles):
    tiles.tiled_schedule.cache_clear()
    for got, want in zip(tiles.tiled_schedule(gh, gw, ntiles),
                         jax_tiled_schedule(gh, gw, ntiles)):
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("ntiles", [2, 3, 6])
@pytest.mark.parametrize("period", [0, PERIOD])
@pytest.mark.parametrize("precision", ["exact", "fast"])
def test_tiled_encode_and_decode_equal_untiled(precision, period, ntiles):
    bits1, rec1, dec1 = _untiled(precision, period)
    mesh = ["cpu"] * ntiles
    bits, rec = codec.encode(*_frames(), _cfg(precision, period, tile_shards=ntiles),
                             device=mesh)
    assert bits == bits1
    for k in rec1:
        assert np.array_equal(rec[k], rec1[k]), k
    dec = codec.decode(bits1, F, precision, device=mesh, tile_shards=ntiles)
    for k in dec1:
        assert np.array_equal(dec[k], dec1[k]), k


@pytest.mark.parametrize("precision", ["exact", "fast"])
def test_the_zero_sad_break_crosses_the_seams(precision):
    """The static block is in the first tile; the walk state it leaves
    mirrors the spiral of MBs in every later tile, so those MBs' union
    offsets lie outside the canonical spiral."""
    syms = parse_body(_untiled(precision, PERIOD)[0][14:], F, H, W, PERIOD)
    pframes = [n for n in range(F) if n % PERIOD]
    mv = mv_reconstruct_scan(torch.from_numpy(syms["mv_diff"][pframes])).numpy()
    canon = {tuple(v) for v in tables.NEG_SPIRAL.tolist()}
    off = np.array([[[tuple(v) not in canon for v in row] for row in f] for f in mv])
    assert off[:, :, 2:].any(), "no non-canonical MV right of the first seam of 3 tiles"


def test_tiled_refusals(tmp_path):
    with pytest.raises(ValueError, match="must divide"):
        tiles.encode_intra_frames_tiled(*(a[:1] for a in _frames()), 16, 16, ["cpu"] * 4)
    with pytest.raises(ValueError, match="tile_shards=2 but only 1 devices"):
        codec.encode(*_frames(), _cfg("fast", 0, tile_shards=2), device=["cpu"])
    with pytest.raises(ValueError, match="list of devices"):
        codec.decode(_untiled("fast", 0)[0], F, "fast", device="cpu", tile_shards=2)
    with pytest.raises(ValueError, match="does not support tile_shards > 1"):
        streaming.encode_streaming(*_frames(), _cfg("fast", PERIOD, tile_shards=2),
                                   str(tmp_path), device=["cpu"] * 2)


@pytest.mark.slow
@pytest.mark.parametrize("precision", ["exact", "fast"])
def test_tiled_cif_at_eleven_tiles_equals_untiled(precision):
    """CIF's 22 MB columns over 11 tiles of two, as the JAX package's
    tests/test_tiles.py splits them: 3 frames of the static-trigger
    content at period 2."""
    frames = chip_smoke.static_trigger_input(3, 288, 352)
    cfg = dict(width=352, height=288, qp_dc=16, qp_ac=16, intra_period=2, precision=precision)
    bits1, rec1 = codec.encode(*frames, CodecConfig(**cfg, entropy="host"), device="cpu")
    bits, rec = codec.encode(*frames, CodecConfig(**cfg, tile_shards=11), device=["cpu"] * 11)
    assert bits == bits1
    for k in rec1:
        assert np.array_equal(rec[k], rec1[k]), k
    dec1 = codec.decode(bits1, 3, precision, device="cpu")
    dec = codec.decode(bits1, 3, precision, device=["cpu"] * 11, tile_shards=11)
    for k in dec1:
        assert np.array_equal(dec[k], dec1[k]), k


def test_tiled_entry_points_equal_the_engines():
    """The drivers codec.encode does not call: the tiled luma wavefront
    alone (3 tiles) and a batch of P-frames (2 tiles) whose zero-SAD break
    crosses the seam."""
    y, cb, cr = (torch.from_numpy(a) for a in _frames())
    want = twf.intra_luma_scan_packed(to_blocks(y[:2]).to(torch.int32), 8, 16,
                                      dtype=torch.float32)
    got = tiles.encode_intra_luma_tiled(y[:2], 8, 16, ["cpu"] * 3)
    assert torch.equal(got["recon_y"], from_blocks(want["recon"].to(torch.uint8)))
    for k, n in (("y_scan", "scan"), ("mpm", "mpm"), ("mode_bit", "mode_bit")):
        assert torch.equal(got[k], want[n]), k
    prev = encode_intra_frames(y[:1], cb[:1], cr[:1], 16, 16, dtype=torch.float64)
    prev = {c: prev[f"recon_{c}"] for c in ("y", "cb", "cr")}
    cur = {"y": y[1:2], "cb": cb[1:2], "cr": cr[1:2]}
    want = encode_inter_frame(cur["y"], cur["cb"], cur["cr"], prev["y"], prev["cb"], prev["cr"],
                              16, 16, dtype=torch.float64)
    got = tiles.encode_inter_frames_tiled(cur, prev, 16, 16, ["cpu"] * 2, dtype=torch.float64)
    assert want.keys() == got.keys()
    for k in want:
        assert torch.equal(got[k].to(torch.int64), want[k].to(torch.int64)), k
