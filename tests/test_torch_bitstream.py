"""The PyTorch port's host bitstream writer (entropy="host") against the JAX
package's (numpy, no JAX compile):

* vlc_encode, frame_items (intra and inter) and write_bitstream_grouped
  equal icspcodec_tpu.bitstream's on seeded symbols up to +-(2^15 - 1);
* pack_items_native equals the JAX packer, a byte-aligned stream included;
* codec.encode(entropy="host") gives the device route's bytes, and the
  pinned JAX sha256s of chip_smoke.py (all-intra and period 3).
"""
import hashlib

import numpy as np
import pytest
import torch

import chip_smoke
from icspcodec_tpu import bitstream as jbs
from icspcodec_tpu.runtime import pack_items_native as j_pack
from icspcodec_torch import bitstream as tbs
from icspcodec_torch import codec as tcodec
from icspcodec_torch.config import CodecConfig as TConfig
from icspcodec_torch.runtime import pack_items_native as t_pack

VMAX = 2 ** 15 - 1


def _scan(rng, shape):
    """int16 coefficient symbols: small values, some AC-empty blocks and
    the VLC domain's extremes."""
    s = rng.integers(-40, 41, shape + (64,))
    s[rng.random(shape + (64,)) < 0.02] = VMAX
    s[rng.random(shape + (64,)) < 0.02] = -VMAX
    s[rng.random(shape) < 0.3, 1:] = 0
    return s.astype(np.int16), (np.count_nonzero(s[..., 1:], -1) == 0).astype(np.int32)


def _symbols(seed, f=3, mbh=2, mbw=3):
    """Seeded (intra, inter) symbol dicts of f frames of mbh x mbw MBs."""
    rng = np.random.default_rng(seed)
    out = []
    for intra in (True, False):
        syms = {}
        for k, shape in (("y", (f, 2 * mbh, 2 * mbw)), ("cb", (f, mbh, mbw)),
                         ("cr", (f, mbh, mbw))):
            syms[f"{k}_scan"], syms[f"{k}_acflag"] = _scan(rng, shape)
        if intra:
            for k in ("mpm", "mode_bit"):
                syms[k] = rng.integers(0, 2, (f, 2 * mbh, 2 * mbw)).astype(np.int32)
        else:
            mv = rng.integers(-16, 17, (f, mbh, mbw, 2))
            mv[0, 0, 0] = (VMAX, -VMAX)
            syms["mv_diff"] = mv.astype(np.int16)
        out.append(syms)
    return out


def test_vlc_encode_matches_jax():
    v = np.concatenate([np.arange(-VMAX, VMAX + 1, 97), [-VMAX, -1, 0, 1, VMAX]])
    tc, tl = tbs.vlc_encode(v)
    jc, jl = jbs.vlc_encode(v)
    assert tc.dtype == np.uint64 and np.array_equal(tc, jc) and np.array_equal(tl, jl)


@pytest.mark.parametrize("intra", [True, False])
def test_frame_items_match_jax(intra):
    syms = _symbols(1)[0 if intra else 1]
    tc, tl = tbs.frame_items(syms, intra)
    jc, jl = jbs.frame_items(syms, intra)
    assert np.array_equal(tc, jc) and np.array_equal(tl, jl)
    assert int(tl.max()) == 2 * 14      # an item of the largest exponent is there


def test_write_bitstream_grouped_matches_jax():
    """Frames 0 and 3 intra, the other four inter, interleaved by index."""
    si, sp = _symbols(2, f=3)
    sp = {k: np.concatenate([v, v[:1]]) for k, v in sp.items()}
    iidx, pidx = np.array([0, 3, 5]), np.array([1, 2, 4, 6])
    args = (si, iidx, sp, pidx, 7, 32, 48, 8, 16, 3)
    assert tbs.write_bitstream_grouped(*args) == jbs.write_bitstream_grouped(*args)


@pytest.mark.parametrize("aligned", [False, True])
def test_pack_items_matches_jax(aligned):
    rng = np.random.default_rng(3)
    lengths = rng.integers(1, 57, 999)
    last = 8 - int(lengths.sum()) % 8 + (0 if aligned else 3)   # total = 0 or 3 mod 8
    lengths = np.append(lengths, last).astype(np.int64)
    codes = rng.integers(0, 2 ** 62, 1000, dtype=np.uint64)    # bits above a length ignored
    total = int(lengths.sum())
    assert (total % 8 == 0) == aligned
    got = t_pack(codes, lengths)
    assert got == j_pack(codes, lengths)
    assert len(got) == total // 8 + 1
    if aligned:
        assert got[-1] == 0          # the reference appends a zero byte


@pytest.mark.parametrize("which", ["intra", "inter"])
def test_host_entropy_encode_gives_the_pinned_stream(which):
    """codec.encode(entropy="host") on the CPU: the device route's bytes,
    which chip_smoke.py pins to the JAX package's streams."""
    if which == "intra":
        frames, cfg, pinned = (chip_smoke.xcheck_input(), chip_smoke.XCHECK_CFG,
                               chip_smoke.XCHECK_SHA256)
    else:
        frames, cfg, pinned = (chip_smoke.static_trigger_input(), chip_smoke.INTER_ENC_CFG,
                               chip_smoke.INTER_ENC_SHA256)
    bh, rh = tcodec.encode(*frames, TConfig(**cfg, entropy="host"), device="cpu")
    bd, rd = tcodec.encode(*frames, TConfig(**cfg), device="cpu")
    assert bh == bd and hashlib.sha256(bh).hexdigest() == pinned
    assert all(np.array_equal(rh[k], rd[k]) for k in rd)


def test_host_symbols_recompute_the_luma_acflag():
    scan = torch.zeros((1, 2, 2, 64), dtype=torch.int16)
    scan[0, 0, 1, 5] = 3
    scan[0, 1, 0, 0] = 7      # DC only: AC-empty
    syms = tcodec.host_symbols({"y_scan": scan, "y_acflag": torch.zeros((1, 2, 2))})
    assert syms["y_scan"].dtype == np.int16
    assert syms["y_acflag"].tolist() == [[[1, 0], [1, 1]]]
