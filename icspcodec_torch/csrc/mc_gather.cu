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
// Two entry points: icsp_mc_gather builds one set of planes (16-px luma or
// 8-px chroma blocks) from per-block MVs, for the encoder's mc_select;
// icsp_mc_gather_yc builds the decoder's luma predictor and both chroma
// predictors in one launch, deriving each chroma MV in the kernel as the
// decoder does: mv / 2 with C truncation (CmotionCompensation enc
// src:2538).
//
// Bound on this card.  One decode P-step of 30 CIF frames reads 3.0 MB of
// luma and 1.5 MB of chroma predictor windows (each output byte reads one
// byte), plus the MVs, and writes as much: ~9 MB, ~2.7 us at 3.35 TB/s.  No
// arithmetic to speak of, so the bound is bytes; what kept the first
// design (one byte a thread, two runtime divisions and an MV reload per
// pixel) 8x from it was instructions.  This one moves 16 or 8 bytes per
// thread and comes within 2x of the bound (PERF.md).
//
// Design.  Each CTA takes one block row of one plane.  Its first threads
// compute each block's two window starts once, into shared memory; then one
// thread copies each (block, row) run: 16 bytes for luma, 8 for chroma.  It
// reads the unaligned source run with aligned 4-byte loads and aligns it
// with funnel shifts, and writes it with one uint4 (luma) or uint2 (chroma)
// store; consecutive threads take consecutive blocks of one row, so a
// warp's stores are contiguous.  The only division is one per run (its row
// and block), none per pixel.  The TPU kernel rolled the whole padded frame
// once per offset and selected per pixel, because Mosaic could not slice
// per block; none of that is needed here.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ int window_start(int s, int dim, int block) {
  return min(max(s < 0 ? s + dim : s, 0), dim - block);
}

// The BLOCK bytes at src (any alignment) as BLOCK / 4 words: aligned 4-byte
// loads of the words that hold them, shifted into place.  The last word is
// read only when the run is unaligned, so no word is read that holds none
// of the run's bytes.
template <int BLOCK>
__device__ __forceinline__ void load_run(const uint8_t* src, uint32_t (&out)[BLOCK / 4]) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(a & ~uintptr_t(3));
  const unsigned sh = (unsigned)(a & 3) * 8;
  uint32_t v[BLOCK / 4 + 1];
#pragma unroll
  for (int i = 0; i < BLOCK / 4; ++i) v[i] = __ldg(w + i);
  v[BLOCK / 4] = sh ? __ldg(w + BLOCK / 4) : 0u;
#pragma unroll
  for (int i = 0; i < BLOCK / 4; ++i) out[i] = __funnelshift_r(v[i], v[i + 1], sh);
}

template <int BLOCK>
__device__ __forceinline__ void store_run(uint8_t* dst, const uint32_t (&w)[BLOCK / 4]) {
  if constexpr (BLOCK == 16) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
  }
}

// Block row `by` of one plane: pad is the plane's padded frame, mv its
// (nby, nbx, 2) MVs in (x, y) order (halved, C truncation, when HALF_MV),
// pred the predictor plane.  win: nbx window origins in shared memory.
template <int BLOCK, bool HALF_MV>
__device__ __forceinline__ void gather_row(const uint8_t* __restrict__ pad,
                                           const int* __restrict__ mv, int by, int nby, int nbx,
                                           uint8_t* __restrict__ pred, int2* win) {
  const int W = nbx * BLOCK, PW = W + 2 * BLOCK, PH = (nby + 2) * BLOCK;
  const int* mvrow = mv + (long long)by * nbx * 2;
  for (int bx = threadIdx.x; bx < nbx; bx += blockDim.x) {
    int mx = mvrow[2 * bx], my = mvrow[2 * bx + 1];
    if (HALF_MV) {
      mx /= 2;
      my /= 2;
    }
    win[bx] = make_int2(window_start(bx * BLOCK - mx + BLOCK, PW, BLOCK),
                        window_start(by * BLOCK - my + BLOCK, PH, BLOCK));
  }
  __syncthreads();
  uint8_t* dst = pred + (long long)by * BLOCK * W;
  for (int i = threadIdx.x; i < nbx * BLOCK; i += blockDim.x) {
    const int r = i / nbx, bx = i - r * nbx;
    const int2 o = win[bx];
    uint32_t w[BLOCK / 4];
    load_run<BLOCK>(pad + (long long)(o.y + r) * PW + o.x, w);
    store_run<BLOCK>(dst + (long long)r * W + bx * BLOCK, w);
  }
}

// One CTA per (plane, block row).
template <int BLOCK>
__global__ void __launch_bounds__(THREADS)
mc_gather_kernel(const uint8_t* __restrict__ pad, const int* __restrict__ mv, int nby, int nbx,
                 uint8_t* __restrict__ pred) {
  extern __shared__ int2 win[];
  const int b = blockIdx.x / nby, by = blockIdx.x - b * nby;
  const long long W = (long long)nbx * BLOCK;
  gather_row<BLOCK, false>(pad + (long long)b * (nby + 2) * BLOCK * (W + 2 * BLOCK),
                           mv + (long long)b * nby * nbx * 2, by, nby, nbx,
                           pred + (long long)b * nby * BLOCK * W, win);
}

// The decoder's three predictors: blockIdx.y 0 takes luma frame b, 1 and 2
// chroma plane b and nframes + b (Cb, Cr) at frame b's halved MVs.
__global__ void __launch_bounds__(THREADS)
mc_gather_yc_kernel(const uint8_t* __restrict__ pad_y, const uint8_t* __restrict__ pad_c,
                    const int* __restrict__ mv, int nframes, int nby, int nbx,
                    uint8_t* __restrict__ pred_y, uint8_t* __restrict__ pred_c) {
  extern __shared__ int2 win[];
  const int b = blockIdx.x / nby, by = blockIdx.x - b * nby;
  const int* mvb = mv + (long long)b * nby * nbx * 2;
  if (blockIdx.y == 0) {
    const long long W = (long long)nbx * 16;
    gather_row<16, false>(pad_y + (long long)b * (nby + 2) * 16 * (W + 32), mvb, by, nby, nbx,
                          pred_y + (long long)b * nby * 16 * W, win);
  } else {
    const long long W = (long long)nbx * 8;
    const long long plane = (long long)(blockIdx.y - 1) * nframes + b;
    gather_row<8, true>(pad_c + plane * (nby + 2) * 8 * (W + 16), mvb, by, nby, nbx,
                        pred_c + plane * nby * 8 * W, win);
  }
}

}  // namespace

// Plain C entry points, bound with ctypes by ops/mc_fused.py; all arrays
// contiguous, pred planes 16-byte aligned (fresh allocations).  Each returns
// cudaGetLastError() after its launch (cudaErrorInvalidValue for a block
// size other than 8 or 16).
//
// icsp_mc_gather: pad (nframes, (nby+2)*block, (nbx+2)*block) u8, mv
// (nframes, nby, nbx, 2) i32 in (x, y) order, pred (nframes, nby*block,
// nbx*block) u8.
extern "C" int icsp_mc_gather(const void* pad, const int* mv, int nframes, int nby, int nbx,
                              int block, void* pred, void* stream) {
  const auto* p = static_cast<const uint8_t*>(pad);
  auto* out = static_cast<uint8_t*>(pred);
  auto st = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(int2) * nbx;
  if (block == 16) {
    mc_gather_kernel<16><<<nframes * nby, THREADS, smem, st>>>(p, mv, nby, nbx, out);
  } else if (block == 8) {
    mc_gather_kernel<8><<<nframes * nby, THREADS, smem, st>>>(p, mv, nby, nbx, out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// icsp_mc_gather_yc: pad_y (nframes, (nby+2)*16, (nbx+2)*16) u8, pad_c
// (2*nframes, (nby+2)*8, (nbx+2)*8) u8 (Cb planes, then Cr), mv (nframes,
// nby, nbx, 2) i32, the luma MVs; pred_y (nframes, nby*16, nbx*16) u8,
// pred_c (2*nframes, nby*8, nbx*8) u8.
extern "C" int icsp_mc_gather_yc(const void* pad_y, const void* pad_c, const int* mv,
                                 int nframes, int nby, int nbx, void* pred_y, void* pred_c,
                                 void* stream) {
  mc_gather_yc_kernel<<<dim3(nframes * nby, 3), THREADS, sizeof(int2) * nbx,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(pad_y), static_cast<const uint8_t*>(pad_c), mv, nframes, nby,
      nbx, static_cast<uint8_t*>(pred_y), static_cast<uint8_t*>(pred_c));
  return (int)cudaGetLastError();
}
