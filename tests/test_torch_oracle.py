"""The port's numpy oracle (icspcodec_torch/oracle.py) against the JAX
package's oracle and against the port's own codec.

* encode bytes and recon, decode planes and parse_bitstream symbols equal
  the JAX oracle's on seeded 64x96 input at period 3, QP 8/16 and 1/1;
* the oracle's bytes equal the port's exact codec.encode on the CPU, at
  period 0 and 3;
* the hashes chip_smoke.py's phase 19 checks (the XCHECK stream and its
  decoded planes, the static-trigger stream) are the oracle's;
* slow: the oracle against all 61 hashes of tests/golden/MANIFEST.sha256
  (the C++ reference's streams, encoder recons and decoder outputs).
"""
import hashlib

import numpy as np
import pytest

import chip_smoke
from icspcodec_tpu import oracle as joracle
from icspcodec_torch import codec, oracle
from icspcodec_torch.config import CodecConfig
from test_torch_golden_hashes import NFRAMES, _configs, _manifest, _planes, _yuv_sha256

F, H, W = 5, 64, 96
QPS = [(8, 16), (1, 1)]


def _frames(seed: int, f: int = F):
    """A textured pan with noise, seeded."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    base = 120 + 50 * np.sin(xx / 11.0) + 30 * np.cos(yy / 5.0)
    y = np.stack([np.roll(base, 2 * t, axis=1) for t in range(f)])
    y = np.clip(y + rng.normal(0, 6, (f, H, W)), 0, 255).astype(np.uint8)
    cb = rng.integers(90, 166, (f, H // 2, W // 2), dtype=np.uint8)
    cr = rng.integers(90, 166, (f, H // 2, W // 2), dtype=np.uint8)
    return y, cb, cr


def _seq(frames):
    return list(zip(*frames))


def _stack(recons):
    return {k: np.stack([getattr(r, k) for r in recons]) for k in ("y", "cb", "cr")}


@pytest.mark.parametrize("qdc, qac", QPS)
def test_oracle_encode_equals_jax(qdc, qac):
    seq = _seq(_frames(qdc))
    bits, rec = oracle.encode(seq, qdc, qac, 3)
    jbits, jrec = joracle.encode(seq, qdc, qac, 3)
    assert bits == jbits
    for k, v in _stack(rec).items():
        assert np.array_equal(v, _stack(jrec)[k]), k


@pytest.mark.parametrize("qdc, qac", QPS)
def test_oracle_decode_and_parse_equal_jax(qdc, qac):
    bits = joracle.encode(_seq(_frames(qdc)), qdc, qac, 3)[0]
    got, want = _stack(oracle.decode(bits, F)), _stack(joracle.decode(bits, F))
    for k in got:
        assert np.array_equal(got[k], want[k]), k
    (hdr, syms), (jhdr, jsyms) = oracle.parse_bitstream(bits, F), joracle.parse_bitstream(bits, F)
    assert hdr == jhdr and len(syms) == len(jsyms) == F
    for s, js in zip(syms, jsyms):
        assert s.is_intra == js.is_intra
        for name in ("mpm_flag", "mode_bit", "y_scan", "y_acflag", "cb_scan", "cb_acflag",
                     "cr_scan", "cr_acflag", "mv_diff"):
            assert np.array_equal(getattr(s, name), getattr(js, name)), name


@pytest.mark.parametrize("period", [0, 3])
@pytest.mark.parametrize("qdc, qac", QPS)
def test_oracle_bytes_equal_the_port_encode(qdc, qac, period):
    frames = _frames(10 + qdc)
    cfg = CodecConfig(width=W, height=H, qp_dc=qdc, qp_ac=qac, intra_period=period,
                      precision="exact")
    bits, rec = codec.encode(*frames, cfg, device="cpu")
    obits, orec = oracle.encode(_seq(frames), qdc, qac, period)
    assert bits == obits
    for k, v in _stack(orec).items():
        assert np.array_equal(rec[k], v), k


def test_oracle_gives_the_pinned_hashes():
    """What chip_smoke.py's phase 19 checks, on the CPU."""
    bits = oracle.encode(_seq(chip_smoke.xcheck_input()), chip_smoke.XCHECK_CFG["qp_dc"],
                         chip_smoke.XCHECK_CFG["qp_ac"], 0)[0]
    assert hashlib.sha256(bits).hexdigest() == chip_smoke.XCHECK_SHA256
    assert chip_smoke.planes_digest(_stack(oracle.decode(bits, 2))) == \
        chip_smoke.XCHECK_DECODE_SHA256
    cfg = chip_smoke.INTER_ENC_CFG
    bits = oracle.encode(_seq(chip_smoke.static_trigger_input()), cfg["qp_dc"], cfg["qp_ac"],
                         cfg["intra_period"])[0]
    assert hashlib.sha256(bits).hexdigest() == chip_smoke.INTER_ENC_SHA256


@pytest.mark.slow
@pytest.mark.parametrize("seq, qdc, qac, period",
                         [pytest.param(*c, id="%s_%d_%d_%d" % c) for c in _configs()])
def test_oracle_matches_the_cpp_hashes(seq, qdc, qac, period):
    want = _manifest()
    bits, rec = oracle.encode(_seq(_planes(seq)), qdc, qac, period)
    stem = f"{seq}_{qdc}_{qac}_{period}"
    assert hashlib.sha256(bits).hexdigest() == want[f"{seq}_compCIF_{qdc}_{qac}_{period}.bin"]
    assert _yuv_sha256(_stack(rec)) == want[f"{stem}.encrecon.yuv"]
    if period != 0:
        assert _yuv_sha256(_stack(oracle.decode(bits, NFRAMES))) == \
            want[f"{stem}.decrecon.yuv"]
