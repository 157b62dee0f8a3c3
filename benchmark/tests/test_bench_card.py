"""On the card, at each one-card cell's own size: the program as the
configuration states it matches the plain reference, and the control, the
program in its lower precision (float32), does not.  Skips without a card.

    python3 -m pytest benchmark/tests -m card
"""
import pytest

CELLS = ["cif_ai.encode", "cif_p10.encode", "cif_ai.decode"]


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_and_program_passes(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from control import readings

    for _, sound, control in readings(workload, [2 ** 31 + 101]):
        assert all(c["value"] == 0 for c in sound.values()), sound
        assert any(c["value"] > c["limit"] for c in control.values()), control
