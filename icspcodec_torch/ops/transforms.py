"""Batched 8x8 DCT/IDCT on torch tensors.

Two paths, chosen by dtype:

* float64 ("exact"): the separable transform of the reference's C loops
  (DCT_block enc src:2685-2749, IDCT_block :2825-2893), every product
  rounded on its own and the sums taken in index order.  Only eager `*`
  and `+` are used: each runs as its own kernel, so nothing can fuse a
  multiply-add (never addcmul, addmm, alpha= or matmul here).
* float32 ("fast"): one 64x64 matrix product per block with the float32
  matrices of tables.py.  On a CUDA tensor the products and sums are taken
  in float64 and rounded once to float32: a float64 product never goes
  through TF32, so the result does not depend on the TF32 settings
  (torch.backends.cuda.matmul), which a caller may have turned on.  On the
  CPU it is a float32 product.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..constants import COS_ENC, IRT2
from ..tables import fdct_matrix, idct_matrix, table_key


@functools.lru_cache(maxsize=None)
def _device_const(data: bytes, shape: tuple, device: torch.device,
                  dtype: torch.dtype) -> torch.Tensor:
    """A float64 numpy constant (given as its bytes) on the device, copied
    there once."""
    arr = np.frombuffer(data, np.float64).reshape(shape)
    return torch.from_numpy(arr.copy()).to(device=device, dtype=dtype)


def _const(arr: np.ndarray, device, dtype=torch.float64) -> torch.Tensor:
    arr = np.ascontiguousarray(arr, np.float64)
    return _device_const(arr.tobytes(), arr.shape, torch.device(device), dtype)


def _mm_exact(a: torch.Tensor, rowsel, ct_cols) -> torch.Tensor:
    """sum_k a[..., sel(k)] * ct_cols[k] in k order, each product rounded."""
    acc = None
    for k in range(8):
        p = rowsel(a, k) * ct_cols(k)
        acc = p if acc is None else acc + p
    return acc


def _matmul_fast(a: torch.Tensor, m: np.ndarray) -> torch.Tensor:
    """(..., 8, 8) float32 blocks times the float32 64x64 matrix m; on the
    card summed in float64 and rounded once, whatever the TF32 setting."""
    wide = torch.float64 if a.is_cuda else torch.float32
    mt = _const(m, a.device, wide)
    flat = a.reshape(a.shape[:-2] + (64,)).to(wide)
    return torch.matmul(flat, mt.T).to(torch.float32).reshape(a.shape)


def fdct(err: torch.Tensor, table: np.ndarray = COS_ENC,
         dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """Forward DCT of (..., 8, 8) integer residuals.

    out[v,u] = irt2^([v==0]+[u==0]) / 4 * sum_y ct[v,y] * (sum_x e[v,x]*ct[u,x])
    """
    e = err.to(dtype)
    if dtype == torch.float64:
        ct = _const(table, e.device)
        # t1[..., v, u] = sum_x e[..., v, x] * ct[u, x]
        t1 = _mm_exact(e, lambda a, x: a[..., :, x, None], lambda x: ct[:, x])
        # out[..., v, u] = sum_y t1[..., y, u] * ct[v, y]
        out = _mm_exact(t1, lambda a, y: a[..., y, None, :], lambda y: ct[:, y][:, None])
        out = out.clone()
        out[..., 0, :] = out[..., 0, :] * IRT2
        out[..., :, 0] = out[..., :, 0] * IRT2
        return out * 0.25
    return _matmul_fast(e, fdct_matrix(table_key(table), "float32"))


def idct(iq: torch.Tensor, table: np.ndarray,
         dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """Inverse DCT of (..., 8, 8) dequantized integers.  Per-term order of
    the C code: Cu[u]*(double)iq[y][u] is rounded first, then multiplied by
    the cosine and accumulated (IDCT_block enc src:2857-2878)."""
    q = iq.to(dtype)
    if dtype == torch.float64:
        ct = _const(table, q.device)
        cu = _const(np.array([IRT2] + [1.0] * 7), q.device)
        m = q * cu[None, :]
        t1 = _mm_exact(m, lambda a, u: a[..., :, u, None], lambda u: ct[u, :])
        n = t1 * cu[:, None]
        out = _mm_exact(n, lambda a, v: a[..., v, None, :], lambda v: ct[v, :][:, None])
        return out * 0.25
    return _matmul_fast(q, idct_matrix(table_key(table), "float32"))
