"""The PyTorch port's bitstream reading and writing against the JAX package:
the header and body parser copies, the device writer's inter items, and the
parser's repair (a VLC exponent beyond the encoder's domain is an error,
not undefined behaviour).  Streams are seeded symbols of 64x96 frames,
written by the JAX package's host writer.  Everything here is integer:
equality is exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from icspcodec_tpu import bitstream as jbs
from icspcodec_tpu import bitstream_device as jbd
from icspcodec_tpu import oracle as joracle
from icspcodec_tpu.runtime import parse_body as jparse_body
from icspcodec_torch import bitstream_device as tbd
from icspcodec_torch import tables
from icspcodec_torch.codec import write_stream
from icspcodec_torch.ops import _build
from icspcodec_torch.runtime import parse_body

H, W = 64, 96


def _groups(seed, nframes, period):
    """Seeded intra and inter symbol groups of a closed-GOP stream (numpy),
    with each group's display indices."""
    rng = np.random.default_rng(seed)
    idx = np.arange(nframes)
    eff = 1 if period == 0 else period
    ii, pi = idx[idx % eff == 0], idx[idx % eff != 0]
    si, _ = chip_smoke.seeded_symbols(rng, len(ii), H, W, intra=True)
    sp = None
    if len(pi):
        sp, mv = chip_smoke.seeded_symbols(rng, len(pi), H, W, intra=False, oob_share=0.2)
        sp["mv_diff"] = (mv - 7).astype(np.int16)   # any differences: the parser's domain
    return si, ii, sp, pi


def _jax_stream(seed, nframes, period, qdc=8, qac=16):
    si, ii, sp, pi = _groups(seed, nframes, period)
    return jbs.write_bitstream_grouped(si, ii, sp, pi if sp is not None else None, nframes,
                                       H, W, qdc, qac, period)


@pytest.mark.parametrize("nframes,period", [(3, 0), (5, 3), (4, 2)])
def test_parse_body_equals_jax(nframes, period):
    data = _jax_stream(nframes + period, nframes, period)
    hj = joracle.parse_header(data[:14])
    assert tables.parse_header(data[:14]) == hj == (H, W, 8, 16, period)
    sj = jparse_body(data[14:], nframes, H, W, period)
    st = parse_body(data[14:], nframes, H, W, period)
    assert sorted(sj) == sorted(st)
    for k in sj:
        assert st[k].dtype == (np.int16 if k.endswith("scan") or k == "mv_diff" else np.int8)
        assert np.array_equal(sj[k], st[k]), k


@pytest.mark.parametrize("nframes,period", [(3, 1), (5, 3)])
def test_device_writer_equals_jax_writer(nframes, period):
    """write_stream (frame_items_dev, pack_frames_dev, assemble_frames and
    the header) writes the JAX host writer's bytes, inter frames included."""
    si, ii, sp, pi = _groups(50 + period, nframes, period)
    to_t = lambda d: None if d is None else {k: torch.from_numpy(v) for k, v in d.items()}  # noqa: E731
    bt = write_stream(to_t(si), ii, to_t(sp), pi, nframes, H, W, 8, 16, period)
    assert bt == _jax_stream(50 + period, nframes, period)


def test_frame_items_inter_match_jax():
    _, _, sp, _ = _groups(4, 5, 3)
    items = jax.jit(jbd.frame_items_dev, static_argnums=1)
    cj, lj = items({k: jnp.asarray(v) for k, v in sp.items()}, False)
    ct, lt = tbd.frame_items_dev({k: torch.from_numpy(v) for k, v in sp.items()}, False)
    assert np.array_equal(np.asarray(cj).astype(np.int64), ct.numpy())
    assert np.array_equal(np.asarray(lj), lt.numpy())


def test_largest_legal_symbols_round_trip():
    """|v| = 2^15 - 1 (VLC exponent 14, the domain's edge) parses back."""
    si, ii, sp, pi = _groups(9, 2, 2)
    si["y_scan"][0, 0, 0, :3] = [32767, -32767, 16384]
    si["y_acflag"][0, 0, 0] = 0
    sp["mv_diff"][0, 0, 0] = [-32767, 32767]
    data = jbs.write_bitstream_grouped(si, ii, sp, pi, 2, H, W, 8, 16, 2)
    st = parse_body(data[14:], 2, H, W, 2)
    assert st["y_scan"][0, 0, 0, :3].tolist() == [32767, -32767, 16384]
    assert st["mv_diff"][1, 0, 0].tolist() == [-32767, 32767]


def test_parser_rejects_an_exponent_beyond_the_domain():
    """A run of 40 one-bits where a VLC starts would make the JAX parser
    shift 1 by 42; the port's parser raises."""
    bits = "00" + "1" * 40 + "0" * 86                 # mpm=0, bit=0, then the run
    body = int(bits, 2).to_bytes(len(bits) // 8, "big")
    with pytest.raises(ValueError, match="exponent"):
        parse_body(body, 1, H, W, 0)
    with pytest.raises(ValueError, match="truncated"):
        parse_body(_jax_stream(1, 2, 0)[14:-40], 2, H, W, 0)


@pytest.mark.parametrize("bad", [b"\x00ICSQ" + bytes(9), bytes(10),
                                 tables.pack_header(60, 96, 8, 16, 0),
                                 tables.pack_header(64, 96, 0, 16, 0)])
def test_parse_header_refuses_what_jax_refuses(bad):
    with pytest.raises(ValueError):
        joracle.parse_header(bad)
    with pytest.raises(ValueError):
        tables.parse_header(bad)


def test_parser_builds_into_the_build_directory():
    parse_body(_jax_stream(2, 1, 0)[14:], 1, H, W, 0)
    lib = _build._target("vlcparse")
    assert lib.exists() and lib.parent == _build.BUILD_DIR
    assert not list(_build.RUNTIME.glob("*.so"))
