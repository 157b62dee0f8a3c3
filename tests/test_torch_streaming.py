"""The PyTorch port's streaming encode and CLI (frames of 64x96, the plain
versions of the kernels on the CPU), against the streams that chip_smoke.py
pins to the JAX package's:

* encode_streaming gives the pinned bytes with device chunks and with host
  chunks, all-intra (xcheck_input) and at period 3 with a shorter last GOP
  (static_trigger_input);
* resume re-encodes exactly the missing GOP; a workdir of one host chunk and
  one device chunk resumes with no record; stale chunks are refused;
* _gop_fingerprint and _pack_row equal the JAX package's, so a chunk of
  either package resumes under the other;
* the CLI encodes a .yuv file to the pinned bytes and decodes it to the
  planes of codec.decode, printing the --orig PSNR line;
* no GPU and no device: streaming and the CLI raise.
"""
import hashlib
import shutil

import numpy as np
import pytest
import torch

import chip_smoke
from icspcodec_tpu import streaming as jstreaming
from icspcodec_tpu.config import CodecConfig as JConfig
from icspcodec_torch import cli, codec, streaming
from icspcodec_torch.config import CodecConfig as TConfig
from icspcodec_torch.io import load_yuv420, save_yuv420
from icspcodec_torch.metrics import MetricsLog

CASES = {
    "intra": (chip_smoke.xcheck_input, chip_smoke.XCHECK_CFG, chip_smoke.XCHECK_SHA256),
    "inter": (chip_smoke.static_trigger_input, chip_smoke.INTER_ENC_CFG,
              chip_smoke.INTER_ENC_SHA256),
}


def _run(case, wd, metrics=None, **cfg):
    make, base, _ = CASES[case]
    return streaming.encode_streaming(*make(), TConfig(**{**base, **cfg}), str(wd),
                                      metrics=metrics or MetricsLog(), device="cpu")


@pytest.mark.parametrize("entropy", ["auto", "host"])
@pytest.mark.parametrize("case", ["intra", "inter"])
def test_streaming_gives_the_pinned_stream(tmp_path, case, entropy):
    log = MetricsLog(str(tmp_path / "m.jsonl"))
    got = _run(case, tmp_path / "wd", log, entropy=entropy)
    assert hashlib.sha256(got).hexdigest() == CASES[case][2]
    assert log.summary()["gops"] == 2 and log.summary()["frames"] == len(CASES[case][0]()[0])
    assert all(r.psnr_y_db > 10 and r.bits > 0 for r in log.records)
    assert len((tmp_path / "m.jsonl").read_text().splitlines()) == 2
    chunk = np.load(tmp_path / "wd" / "gop_00000.npz")
    assert set(chunk.files) == ({"codes", "lengths", "fingerprint"} if entropy == "host"
                                else {"packed", "nbits", "fingerprint"})


def test_resume_reencodes_only_the_missing_gop(tmp_path):
    want = _run("inter", tmp_path)
    (tmp_path / "gop_00001.npz").unlink()      # the shorter last GOP
    log = MetricsLog()
    assert _run("inter", tmp_path, log) == want
    assert [(r.gop_index, r.frames) for r in log.records] == [(1, 2)]
    log = MetricsLog()
    assert _run("inter", tmp_path, log) == want and not log.records


def test_mixed_workdir_resumes_with_no_records(tmp_path):
    _run("inter", tmp_path / "wh", entropy="host")
    _run("inter", tmp_path / "wd")
    (tmp_path / "wm").mkdir()
    shutil.copy(tmp_path / "wh" / "gop_00000.npz", tmp_path / "wm" / "gop_00000.npz")
    shutil.copy(tmp_path / "wd" / "gop_00001.npz", tmp_path / "wm" / "gop_00001.npz")
    log = MetricsLog()
    got = _run("inter", tmp_path / "wm", log)
    assert hashlib.sha256(got).hexdigest() == chip_smoke.INTER_ENC_SHA256 and not log.records


def test_stale_chunks_are_refused(tmp_path):
    _run("inter", tmp_path)
    with pytest.raises(ValueError, match="fingerprint"):
        _run("inter", tmp_path, qp_dc=8)
    y, cb, cr = chip_smoke.static_trigger_input()
    y[0, 0, 0] ^= 255
    with pytest.raises(ValueError, match="fingerprint"):
        streaming.encode_streaming(y, cb, cr, TConfig(**chip_smoke.INTER_ENC_CFG),
                                   str(tmp_path), device="cpu")
    old = dict(np.load(tmp_path / "gop_00000.npz"))
    old.pop("fingerprint")
    np.savez(tmp_path / "gop_00000.npz", **old)
    with pytest.raises(ValueError, match="fingerprint"):
        _run("inter", tmp_path)


def test_fingerprint_and_pack_row_match_jax():
    y, cb, cr = chip_smoke.static_trigger_input()
    for kw in (chip_smoke.INTER_ENC_CFG, dict(chip_smoke.INTER_ENC_CFG, precision="fast")):
        assert (streaming._gop_fingerprint(y[:3], cb[:3], cr[:3], TConfig(**kw))
                == jstreaming._gop_fingerprint(y[:3], cb[:3], cr[:3], JConfig(**kw)))
    assert streaming.FORMAT_VERSION == jstreaming.FORMAT_VERSION
    rng = np.random.default_rng(4)
    lengths = rng.integers(1, 57, 300)
    codes = rng.integers(0, 2 ** 62, 300, dtype=np.uint64)
    (tr, tn), (jr, jn) = streaming._pack_row(codes, lengths), jstreaming._pack_row(codes, lengths)
    assert tn == jn == int(lengths.sum()) and np.array_equal(tr, jr)


def test_sharding_and_missing_gpu_are_refused(tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="tile_shards"):
        _run("inter", tmp_path / "a", tile_shards=2)
    with pytest.raises(ValueError, match="list of devices"):   # a single device
        _run("inter", tmp_path / "b", gop_shards=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    make, base, _ = CASES["inter"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        streaming.encode_streaming(*make(), TConfig(**base), str(tmp_path / "c"))
    assert not (tmp_path / "c").exists()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["decode", "-i", str(tmp_path / "none.bin"), "-n", "1"])


@pytest.mark.parametrize("case", ["intra", "inter"])
def test_cli_encodes_and_decodes(tmp_path, monkeypatch, capsys, case):
    make, cfg, pinned = CASES[case]
    y, cb, cr = make()
    save_yuv420(tmp_path / "clip_in.yuv", y, cb, cr)
    monkeypatch.chdir(tmp_path)
    period = cfg.get("intra_period", 0)
    cli.main(["encode", "-i", "clip_in.yuv", "-n", str(len(y)), "--width", "96", "--height",
              "64", "--qpdc", str(cfg["qp_dc"]), "--qpac", str(cfg["qp_ac"]), "--intraPeriod",
              str(period)], device="cpu")
    name = f"clip_compCIF_{cfg['qp_dc']}_{cfg['qp_ac']}_{period}.bin"
    data = (tmp_path / name).read_bytes()
    assert hashlib.sha256(data).hexdigest() == pinned
    assert f"encoded {len(y)} frames -> {name} ({len(data)} bytes)" in capsys.readouterr().out
    cli.main(["decode", "-i", name, "-n", str(len(y)), "-o", "out.yuv", "--orig", "clip_in.yuv"],
             device="cpu")
    out = capsys.readouterr().out
    want = codec.decode(data, len(y), device="cpu")
    got = load_yuv420(str(tmp_path / "out.yuv"), 96, 64, len(y))
    assert all(np.array_equal(a, want[k]) for a, k in zip(got, ("y", "cb", "cr")))
    mse = ((want["y"].astype(np.float64) - y) ** 2).mean(axis=(1, 2))
    assert f"mean Y-PSNR: {(20 * np.log10(255.0 / np.sqrt(mse))).mean():.4f} dB" in out
