"""The port against the C++ reference's own outputs, by their sha256.

tests/golden/MANIFEST.sha256 holds the hashes of the C++ reference's
bitstreams (<seq>_compCIF_<qdc>_<qac>_<period>.bin), its encoder
reconstructions (<seq>_<qdc>_<qac>_<period>.encrecon.yuv) and its decoder
outputs (.decrecon.yuv) for 32 CIF frames of tools/make_content.synth_sequence
(tools/gen_golden.sh).  Each case regenerates the sequence, encodes it with
icspcodec_torch.codec.encode in exact mode on the CPU and decodes the
stream with codec.decode, and compares all three hashes with the manifest,
which it reads and never writes.  One all-intra and one period-10
configuration run in tier-1; the other 19 are marked slow.  A hash that
breaks is the port's fault, not the hash's.
"""
import hashlib
import pathlib

import numpy as np
import pytest

from icspcodec_torch import codec
from icspcodec_torch.config import CodecConfig
from tools.make_content import CH, CW, H, W, synth_sequence

MANIFEST = pathlib.Path(__file__).parent / "golden" / "MANIFEST.sha256"
NFRAMES = 32
TIER1 = {("synthA", 16, 16, 1), ("synthB", 8, 8, 10)}


def _manifest() -> dict:
    out = {}
    for line in MANIFEST.read_text().splitlines():
        digest, name = line.split()
        out[name] = digest
    return out


def _configs():
    """(seq, qdc, qac, period) of every bitstream in the manifest."""
    cfgs = []
    for name in sorted(_manifest()):
        if name.endswith(".bin"):
            seq, _, qdc, qac, period = name[:-4].split("_")
            cfgs.append((seq, int(qdc), int(qac), int(period)))
    return cfgs


def _params():
    return [pytest.param(*c, id="%s_%d_%d_%d" % c,
                         marks=() if c in TIER1 else pytest.mark.slow) for c in _configs()]


def _planes(seq: str):
    raw = synth_sequence(seq, NFRAMES).reshape(NFRAMES, -1)
    y = raw[:, :W * H].reshape(NFRAMES, H, W)
    cb = raw[:, W * H:W * H + CW * CH].reshape(NFRAMES, CH, CW)
    cr = raw[:, W * H + CW * CH:].reshape(NFRAMES, CH, CW)
    return y, cb, cr


def _yuv_sha256(planes: dict) -> str:
    """sha256 of the planes written frame by frame, Y then Cb then Cr: the
    reference's .yuv layout."""
    h = hashlib.sha256()
    for f in range(planes["y"].shape[0]):
        for k in ("y", "cb", "cr"):
            h.update(np.ascontiguousarray(planes[k][f], np.uint8).tobytes())
    return h.hexdigest()


def test_manifest_covers_the_generated_configurations():
    cfgs = _configs()
    assert len(cfgs) == 21 and TIER1 <= set(cfgs)
    names = _manifest()
    for seq, qdc, qac, period in cfgs:
        stem = f"{seq}_{qdc}_{qac}_{period}"
        assert f"{stem}.encrecon.yuv" in names
        # period 0 (the header-only all-intra mode) has no decoder output
        assert (f"{stem}.decrecon.yuv" in names) == (period != 0)


@pytest.mark.parametrize("seq, qdc, qac, period", _params())
def test_exact_encode_and_decode_match_the_cpp_hashes(seq, qdc, qac, period):
    want = _manifest()
    y, cb, cr = _planes(seq)
    cfg = CodecConfig(width=W, height=H, qp_dc=qdc, qp_ac=qac, intra_period=period,
                      precision="exact")
    bits, rec = codec.encode(y, cb, cr, cfg, device="cpu")
    stem = f"{seq}_{qdc}_{qac}_{period}"
    assert hashlib.sha256(bits).hexdigest() == want[f"{seq}_compCIF_{qdc}_{qac}_{period}.bin"]
    assert _yuv_sha256(rec) == want[f"{stem}.encrecon.yuv"]
    if period != 0:
        dec = codec.decode(bits, NFRAMES, precision="exact", device="cpu")
        assert _yuv_sha256(dec) == want[f"{stem}.decrecon.yuv"]
