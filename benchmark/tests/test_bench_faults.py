"""The harness's check catches a broken timed path.

Each test drives a whole run of a cell on the CPU (the harness's look for
a card skipped, the program's plain versions in place of its kernels, a
few frames in place of 300) with the program broken underneath, and sees
`correct` come out false, once for each fault the cell can have: a P-step
that returns its state unchanged, half of the batch left out, the
exchange between shards left out, and an answer altered where it is
produced.  The unbroken run is correct, and the control (the program in
float32) is not.
"""
import numpy as np
import pytest
import torch

from benchlib import cell

SMALL = {"cif_ai.encode": 4, "cif_ai.decode": 4, "cif_p10.encode": 4,
         "cif_p10_gop4.encode": 20}


def _run(workload):
    result, _ = cell.run_cell(workload, 2 ** 31 + 17, 0.05, False, device_kind="cpu",
                              overrides={"frames": SMALL[workload]}, workers=1)
    return result


def _failing(result):
    return [k for k, c in result["checks"].items() if c["value"] > c["limit"]]


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_sound_run_is_correct(workload):
    result = _run(workload)
    assert result["correct"] and result["failed"] == 0 and not _failing(result)


def _wrap(monkeypatch, module, name, after):
    fn = getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a, **k: after(fn(*a, **k)))


def test_state_left_unchanged(monkeypatch):
    """Each P-step hands back the previous recon as its own."""
    from icspcodec_torch.engine import inter

    step = inter.encode_inter_frame

    def stuck(cur_y, cur_cb, cur_cr, prev_y, prev_cb, prev_cr, *a, **k):
        out = step(cur_y, cur_cb, cur_cr, prev_y, prev_cb, prev_cr, *a, **k)
        return {**out, "recon_y": prev_y, "recon_cb": prev_cb, "recon_cr": prev_cr}

    monkeypatch.setattr(inter, "encode_inter_frame", stuck)
    result = _run("cif_p10.encode")
    assert not result["correct"] and "recon_px_differing" in _failing(result)


def _halve(tree):
    """The second half of a batch left out, its slots filled from the first."""
    out = {}
    for k, v in tree.items():
        h = v.shape[0] // 2
        v = v.clone()
        v[h:2 * h] = v[:h]
        out[k] = v
    return out


def test_half_the_batch_left_out_encode(monkeypatch):
    from icspcodec_torch import codec

    _wrap(monkeypatch, codec, "encode_symbols",
          lambda r: ((_halve(r[0][0]), r[0][1]), r[1], _halve(r[2])))
    result = _run("cif_ai.encode")
    assert not result["correct"] and set(_failing(result)) == {"stream_bytes_differing",
                                                              "recon_px_differing"}


def test_half_the_batch_left_out_decode(monkeypatch):
    from icspcodec_torch import codec

    _wrap(monkeypatch, codec, "decode_intra_frames", _halve)
    result = _run("cif_ai.decode")
    assert not result["correct"] and _failing(result) == ["decoded_px_differing"]


def test_exchange_between_shards_left_out(monkeypatch):
    """The gather keeps shard 0's results and never receives the others'."""
    from icspcodec_torch.parallel import gop

    gather = gop.gather

    def lossy(parts, device, keep=None):
        if parts[0] is None:
            return None
        return gather([parts[0]] + [{k: torch.zeros_like(v) for k, v in p.items()}
                                    for p in parts[1:]], device, keep)

    monkeypatch.setattr(gop, "gather", lossy)
    result = _run("cif_p10_gop4.encode")
    assert not result["correct"] and "stream_bytes_differing" in _failing(result)


@pytest.mark.parametrize("workload", ["cif_ai.encode", "cif_p10.encode"])
def test_symbol_altered_where_produced(monkeypatch, workload):
    from icspcodec_torch import codec

    def alter(r):
        (isyms, iidx), inter, rec = r
        isyms = dict(isyms)
        isyms["y_scan"] = isyms["y_scan"].clone()
        isyms["y_scan"][0, 3, 5, 0] += 1   # a DC: written whatever the AC flag says
        return (isyms, iidx), inter, rec

    _wrap(monkeypatch, codec, "encode_symbols", alter)
    result = _run(workload)
    assert not result["correct"] and _failing(result) == ["stream_bytes_differing"]


def test_pixel_altered_where_produced(monkeypatch):
    from icspcodec_torch import codec

    def alter(planes):
        planes = dict(planes)
        planes["cb"] = planes["cb"].clone()
        planes["cb"][1, 7, 9] ^= np.uint8(1)
        return planes

    _wrap(monkeypatch, codec, "decode_intra_frames", alter)
    result = _run("cif_ai.decode")
    assert not result["correct"] and _failing(result) == ["decoded_px_differing"]


@pytest.mark.parametrize("workload", ["cif_ai.encode", "cif_ai.decode"])
def test_control_in_lower_precision_fails(workload):
    from control import readings

    for _, sound, control in readings(workload, [2 ** 31 + 17], device_kind="cpu",
                                      overrides={"frames": SMALL[workload]}, workers=1):
        assert all(c["value"] == 0 for c in sound.values()), sound
        assert all(c["value"] > c["limit"] for c in control.values()), control
