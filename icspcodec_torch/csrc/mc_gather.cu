// Kernel E: motion compensation as a direct per-block gather, for sm_90a.
//
// Replaces: icspcodec_tpu/ops/pallas_me.py::_mc_select (the Pallas TPU
// kernel behind mc_select_luma / _chroma / _luma_union / _chroma_union).
// It computes what the plain PyTorch version computes (ops/me.py::
// gather_pred, then the blocks laid out as a plane): each (block x block)
// predictor block of frame b is the window of the padded previous frame at
// origin - mv + p, p = block, with each window start taken as
// jax.lax.dynamic_slice takes it in the JAX package's gather_pred: a
// negative start counts from the end of the axis, then it is clamped to
// [0, PH-block] x [0, PW-block] (ops/me.py::window_start).  So the kernel
// equals the JAX package's XLA decode for any MV, a corrupt one included;
// the MVs of a compliant stream reach neither rule.  Integer copies only:
// bit-identical.
//
// Bound on this card.  Per inter step of 30 CIF GOPs it reads 3.0 MB of
// luma and 1.5 MB of chroma predictor windows (each output byte reads one
// byte), plus the MVs, and writes as much: ~9 MB, ~2.7 us at 3.35 TB/s.  No
// arithmetic to speak of.
//
// Design.  The TPU kernel rolled the whole padded frame once per offset of
// the table and selected per pixel by the block's offset id, because Mosaic
// could not slice per block.  Here each CTA takes one block row of one
// frame; its threads walk the row's pixels in raster order, each looks up
// its block's MV and copies one byte, so the stores of a warp are
// contiguous and the loads fall within a block's window row.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ int window_start(int s, int dim, int block) {
  return min(max(s < 0 ? s + dim : s, 0), dim - block);
}

__global__ void mc_gather_kernel(const uint8_t* __restrict__ pad, const int* __restrict__ mv,
                                 int nby, int nbx, int block, uint8_t* __restrict__ pred) {
  const int b = blockIdx.x / nby, by = blockIdx.x % nby;
  const int W = nbx * block, PW = W + 2 * block, PH = (nby + 2) * block;
  const uint8_t* src = pad + (long long)b * PH * PW;
  const int* mvrow = mv + ((long long)b * nby + by) * nbx * 2;
  uint8_t* dst = pred + ((long long)b * nby * block + (long long)by * block) * W;
  for (int i = threadIdx.x; i < block * W; i += blockDim.x) {
    const int r = i / W, x = i - r * W;
    const int bx = x / block;
    const int oy = window_start(by * block - mvrow[bx * 2 + 1] + block, PH, block);
    const int ox = window_start(bx * block - mvrow[bx * 2] + block, PW, block);
    dst[(long long)r * W + x] = src[(long long)(oy + r) * PW + ox + (x - bx * block)];
  }
}

}  // namespace

// Plain C entry point, bound with ctypes by ops/mc_fused.py.  pad is
// (nframes, (nby+2)*block, (nbx+2)*block) u8, mv (nframes, nby, nbx, 2) i32
// in (x, y) order, pred (nframes, nby*block, nbx*block) u8; all contiguous.
// Returns cudaGetLastError() after the launch.
extern "C" int icsp_mc_gather(const void* pad, const int* mv, int nframes, int nby, int nbx,
                              int block, void* pred, void* stream) {
  mc_gather_kernel<<<nframes * nby, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(pad), mv, nby, nbx, block, static_cast<uint8_t*>(pred));
  return (int)cudaGetLastError();
}
