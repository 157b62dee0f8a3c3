"""The frozen plain reference against the program on the CPU (the plain
versions of its kernels) at 112x80: the same stream bytes, recon planes and
decoded planes, all-intra and at period 3; the reference's pool and
stream ending against the oracle's own single-process writer; and no
process left behind by the pool or by a run."""
import subprocess
import sys

import numpy as np
import pytest

from benchlib import children, content
from benchref import clip as ref_clip
from benchref import oracle

H, W, NF = 80, 112, 7


@pytest.fixture(scope="module")
def frames():
    return content.clip("benchA", 2 ** 31 + 3, NF, W, H)


@pytest.mark.parametrize("period", [0, 3])
def test_reference_equals_program(frames, period):
    from icspcodec_torch import codec
    from icspcodec_torch.config import CodecConfig

    ref = ref_clip.encode_clip(*frames, 8, 16, period, decode=True, workers=1)
    bits, rec = codec.encode(*frames, CodecConfig(width=W, height=H, qp_dc=8, qp_ac=16,
                                                  intra_period=period), device="cpu")
    assert bits == ref["stream"]
    for k in ("y", "cb", "cr"):
        np.testing.assert_array_equal(rec[k], ref["recon"][k])
    dec = codec.decode(bits, NF, device="cpu")
    for k in ("y", "cb", "cr"):
        np.testing.assert_array_equal(dec[k], ref["decoded"][k])


@pytest.mark.parametrize("period", [0, 3])
def test_pool_equals_the_oracle_in_one_piece(frames, period):
    seq = [(frames[0][i], frames[1][i], frames[2][i]) for i in range(NF)]
    want_bits, want_rec = oracle.encode(seq, 8, 16, period)
    got = ref_clip.encode_clip(*frames, 8, 16, period, workers=2)
    assert got["stream"] == want_bits
    for k in ("y", "cb", "cr"):
        np.testing.assert_array_equal(got["recon"][k], np.stack([getattr(r, k) for r in want_rec]))


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 63, 64, 1001])
def test_stream_ending_is_the_oracle_writer(n):
    bits = np.random.default_rng(n).integers(0, 2, n).astype(np.uint8)
    bw = oracle.BitWriter()
    bw.extend([int(b) for b in bits])
    cut = n // 3
    parts = [(np.packbits(bits[:cut]), cut), (np.packbits(bits[cut:]), n - cut)]
    assert ref_clip.stream_bytes(parts) == bw.tobytes()


def test_pool_leaves_no_process(frames):
    """The pool's workers and multiprocessing's resource tracker have ended
    when encode_clip returns: the tracker would otherwise outlive a run."""
    ref_clip.encode_clip(*(p[:2] for p in frames), 8, 16, 0, workers=2)
    assert children.children() == []


def test_end_all_ends_a_child_left_behind():
    proc = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(120)"])
    logged = []
    found = children.end_all(logged.append)
    assert len(found) == 1 and "time.sleep(120)" in found[0] and len(logged) == 1
    assert children.children() == [] and proc.poll() is not None
