"""Host-side claims behind the H100 designs of kernels A (csrc/intra_luma.cu)
and D/G/H (csrc/sad_mc.cu), checked on the CPU:

* kernel A's float tables are the forward and inverse float32 matrices in
  the order of the mma.m16n8k8.f64 A fragments, and its float64 table is
  the cosine table then IRT2;
* the wrappers hand the kernels aligned views and copy the rest;
* the SAD kernels' strip stride spreads the offsets that 32 lanes read at
  once over the banks: at most 2 distinct words a bank.
"""
import pathlib
import re

import numpy as np
import pytest
import torch

from icspcodec_torch.constants import COS_DEC, COS_ENC, IRT2, SPIRAL, SPIRAL_UNION, ZIGZAG
from icspcodec_torch.engine.intra import to_blocks
from icspcodec_torch.ops import intra_fused, me_fused
from icspcodec_torch.tables import N_CANON, fdct_matrix, idct_matrix, luma_dc_kind

CSRC = pathlib.Path(intra_fused.__file__).parent.parent / "csrc"


def _const(src: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


@pytest.mark.parametrize("table, key", [(COS_ENC, "enc"), (COS_DEC, "dec")])
def test_kernel_a_tables(table, key):
    mats, zz, kind = intra_fused._tables(key, torch.float32, 4, 6, torch.device("cpu"))
    assert mats.dtype == torch.float32 and mats.numel() == 2 * 4096
    for half, m in zip(mats.numpy().reshape(2, -1), (fdct_matrix(key, "float32"),
                                                     idct_matrix(key, "float32"))):
        # rebuild the matrix from the fragments: lane 4 g + t holds, of 16-row
        # tile q and k-step ks, A[g + 8 (i & 1)][t + 4 (i >> 1)] in a[i]
        frag = half.reshape(4, 8, 32, 4)
        back = np.zeros((64, 64), np.float32)
        for q in range(4):
            for ks in range(8):
                for lane in range(32):
                    g, t = divmod(lane, 4)
                    for i in range(4):
                        back[16 * q + g + 8 * (i & 1), 8 * ks + t + 4 * (i >> 1)] = \
                            frag[q, ks, lane, i]
        assert np.array_equal(back, m)
    assert np.array_equal(zz.numpy(), ZIGZAG) and np.array_equal(kind.numpy(), luma_dc_kind(4, 6))
    exact = intra_fused._tables(key, torch.float64, 4, 6, torch.device("cpu"))[0]
    assert np.array_equal(exact.numpy(), np.concatenate([np.ravel(table), [IRT2]]))


def test_wrappers_pass_aligned_views_and_copy_the_rest():
    planes = torch.zeros((2, 16, 32), dtype=torch.uint8)
    view = to_blocks(planes)
    assert intra_fused._kernel_pixels(view) is view
    odd = torch.zeros((2, 16, 36), dtype=torch.uint8)[..., 2:34]   # 2-byte offset, stride 36
    out = intra_fused._kernel_pixels(to_blocks(odd))
    assert out.is_contiguous() and out.dtype == torch.uint8
    assert intra_fused._kernel_pixels(view.to(torch.int32)).dtype == torch.uint8
    frames = torch.zeros((3, 32, 48), dtype=torch.uint8)
    assert me_fused._aligned(frames) is frames
    assert me_fused._aligned(frames[1:]).data_ptr() == frames[1:].data_ptr()   # 1536-byte offset
    flat = torch.zeros(32 * 48 + 8, dtype=torch.uint8)
    shifted = flat[8:].reshape(1, 32, 48)   # 8-byte offset
    moved = me_fused._aligned(shifted)
    assert moved.data_ptr() % 16 == 0 and torch.equal(moved, shifted)


@pytest.mark.parametrize("offsets", [SPIRAL, SPIRAL_UNION[N_CANON:], SPIRAL_UNION],
                         ids=["steps", "non-canonical", "union"])
def test_strip_stride_spreads_the_lanes_over_the_banks(offsets):
    src = (CSRC / "sad_mc.cu").read_text()
    stride, run = _const(src, "STRIP_STRIDE"), _const(src, "RUN")
    assert stride >= run * 4 + 8   # a strip row: the run's MBs and 32 px of window
    worst = 0
    for k0 in range(0, len(offsets), 32):   # the offsets a warp's lanes take at once
        lanes = offsets[k0:k0 + 32]
        for j in range(5):                  # each of the 5 words of a candidate row
            words = {int(oy) * stride + (int(ox) >> 2) + j for ox, oy in lanes}
            per_bank = np.bincount([w % 32 for w in words], minlength=32)
            worst = max(worst, int(per_bank.max()))
    assert worst <= 2
