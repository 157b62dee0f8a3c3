// Kernels D and G, and the unfused search: the motion search, for sm_90a.
//
// Replaces: icspcodec_tpu/ops/pallas_me.py::sad_mc_best (D, the fused
// search behind the encoder's fixed branch), ::_sad_dense_rolls as
// sad_union_extra calls it (G, the SADs the stateful branch adds) and as
// sad_union calls it (all 129 union offsets, the same entry point), and
// ::sad_best (the unfused search with the reference's whole selection
// rule).  Each computes what its plain PyTorch version computes
// (ops/me_fused.py: sad_mc_best_plain, sad_union_extra_plain,
// sad_union_plain, sad_best_plain), in integers: bit-identical.
//
// D, per 16x16 macroblock against the previous reconstruction padded by 16
// px: the SAD of each of the 64 canonical spiral *steps* (steps 0 and 1 are
// both offset (0, 0), so a static MB counts two zero SADs: zc = 2 routes the
// frame to the stateful branch, as in the reference's walk); the rank with
// the smallest key s*64 + rank, i.e. the first strict minimum in spiral
// order, without the second-zero override (the fixed branch consumes it
// only when no MB has zc >= 2); zc, the number of zero-SAD steps; the SAD
// rows of the 63 distinct canonical offsets in union order (row
// SPIRAL_STATE_IDX[0][rank]); and the 16x16 predictor at the winning
// offset.  G: the SADs at the 66 non-canonical union offsets, in union
// order.  sad_best: D's 64 step SADs and key reduction, then the
// reference's second-zero override (the walk breaks at its second zero-SAD
// step, which wins), and only (best, zc) out.
//
// Bound on this card.  D, one P-step of 30 CIF frames: it reads 3.0 MB of
// current frames and 3.7 MB of padded previous frames and writes 3.0 MB of
// SAD rows, 3.0 MB of predictors and 0.1 MB of keys: ~12.8 MB, 3.8 us at
// 3.35 TB/s.  Its work is 195 M byte absolute differences, accumulated:
// at one 32-bit lane operation each (33.5e12 a second, chip_smoke.py's
// PEAK_LANE_OP_S) that is 5.8 us, so operations bound it.  G does the same
// for 66 offsets with no predictor, sad_union for 129 (11.7 us), sad_best
// for D's 64 steps with only the keys out.
//
// Design.  One CTA of 8 warps per MB (11,880 CTAs per CIF P-step): the MB's
// 48x48 window of the padded previous frame (2.3 KB) goes to shared memory
// once, the MB's 16x16 block to registers (8 pixels a lane).  Each warp
// takes every 8th offset; each lane sums |cur - win| over its 8 pixels with
// __usad and the warp reduces by shuffles.  For D, one warp then reduces
// the 64 keys and counts the zeros with a ballot, and the CTA copies the
// winning window from shared memory to the predictor.  The TPU kernel's
// rolls of the whole padded frame, its lane extension, its 0/1 block-sum
// matmuls and its bf16 nibble split are not needed here.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MB = 16;             // macroblock side
constexpr int RANGE = 16;          // offsets lie in [-RANGE, RANGE]^2
constexpr int WIN = MB + 2 * RANGE;
constexpr int THREADS = 256;       // 8 warps
constexpr int MAX_OFFSETS = 160;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ unsigned warp_sum(unsigned v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// The SADs of MB (mby, mbx) of frame g at offsets offs[0..n) ((x, y)
// pairs) into sads[0..n), shared.  win is the CTA's 48x48 window buffer.
// Ends with a block barrier, so every thread may read sads and win.
__device__ __forceinline__ void mb_sads(const uint8_t* __restrict__ cur,
                                        const uint8_t* __restrict__ pad, int H, int W, int g,
                                        int mby, int mbx, const int* __restrict__ offs, int n,
                                        uint8_t* win, int* sads) {
  const int PW = W + 2 * RANGE, PH = H + 2 * RANGE;
  // the window's top-left corner is the MB's origin in the padded frame
  // shifted by (-RANGE, -RANGE), i.e. (mby * 16, mbx * 16)
  const uint8_t* src = pad + (long long)g * PH * PW + (long long)(mby * MB) * PW + mbx * MB;
  for (int i = threadIdx.x; i < WIN * WIN; i += blockDim.x)
    win[i] = src[(long long)(i / WIN) * PW + i % WIN];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int r = lane >> 1, c0 = (lane & 1) * 8;  // this lane's 8 pixels: row r, cols c0..c0+7
  const uint8_t* cb = cur + (long long)g * H * W + (long long)(mby * MB + r) * W + mbx * MB + c0;
  unsigned cv[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) cv[j] = cb[j];
  __syncthreads();
  for (int k = warp; k < n; k += nwarps) {
    const int ox = offs[2 * k], oy = offs[2 * k + 1];
    const uint8_t* wp = win + (RANGE + oy + r) * WIN + RANGE + ox + c0;
    unsigned s = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) s = __usad(cv[j], wp[j], s);
    s = warp_sum(s);
    if (lane == 0) sads[k] = (int)s;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS)
sad_mc_best_kernel(const uint8_t* __restrict__ cur, const uint8_t* __restrict__ pad, int H, int W,
                   const int* __restrict__ offs, const int* __restrict__ rows, int nrows,
                   int* __restrict__ best, int* __restrict__ zc, int* __restrict__ sads_c,
                   uint8_t* __restrict__ pred) {
  __shared__ uint8_t win[WIN * WIN];
  __shared__ int sads[64];
  __shared__ int best_s;
  const int mbw = W / MB, nmb = (H / MB) * mbw;
  const int g = blockIdx.x / nmb, m = blockIdx.x % nmb, mby = m / mbw, mbx = m % mbw;
  mb_sads(cur, pad, H, W, g, mby, mbx, offs, 64, win, sads);

  const int lane = threadIdx.x & 31;
  if (threadIdx.x < 32) {
    const int s0 = sads[lane], s1 = sads[lane + 32];
    int key = min(s0 * 64 + lane, s1 * 64 + lane + 32);  // first strict minimum
    for (int o = 16; o > 0; o >>= 1) key = min(key, __shfl_xor_sync(FULL, key, o));
    const int z = __popc(__ballot_sync(FULL, s0 == 0)) + __popc(__ballot_sync(FULL, s1 == 0));
    // ranks 0 and 1 share offset (0, 0) and so row 0: both write the same value
    sads_c[((long long)g * nrows + rows[lane]) * nmb + m] = s0;
    sads_c[((long long)g * nrows + rows[lane + 32]) * nmb + m] = s1;
    if (lane == 0) {
      best[(long long)g * nmb + m] = key & 63;
      zc[(long long)g * nmb + m] = z;
      best_s = key & 63;
    }
  }
  __syncthreads();
  const int ox = offs[2 * best_s], oy = offs[2 * best_s + 1];
  uint8_t* dst = pred + (long long)g * H * W + (long long)(mby * MB) * W + mbx * MB;
  for (int i = threadIdx.x; i < MB * MB; i += blockDim.x) {
    const int r = i / MB, c = i % MB;
    dst[(long long)r * W + c] = win[(RANGE + oy + r) * WIN + RANGE + ox + c];
  }
}

__global__ void __launch_bounds__(THREADS)
sad_best_kernel(const uint8_t* __restrict__ cur, const uint8_t* __restrict__ pad, int H, int W,
                const int* __restrict__ offs, int* __restrict__ best, int* __restrict__ zc) {
  __shared__ uint8_t win[WIN * WIN];
  __shared__ int sads[64];
  const int mbw = W / MB, nmb = (H / MB) * mbw;
  const int g = blockIdx.x / nmb, m = blockIdx.x % nmb;
  mb_sads(cur, pad, H, W, g, m / mbw, m % mbw, offs, 64, win, sads);
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  const int s0 = sads[lane], s1 = sads[lane + 32];
  int key = min(s0 * 64 + lane, s1 * 64 + lane + 32);  // first strict minimum
  for (int o = 16; o > 0; o >>= 1) key = min(key, __shfl_xor_sync(FULL, key, o));
  // bit k of zeros: step k's SAD is 0, steps in walk order
  const unsigned long long zeros = (unsigned long long)__ballot_sync(FULL, s0 == 0) |
                                   ((unsigned long long)__ballot_sync(FULL, s1 == 0) << 32);
  if (lane == 0) {
    const int z = __popcll(zeros);
    // two or more zeros: the walk breaks at the second, which wins
    best[(long long)g * nmb + m] = z >= 2 ? __ffsll(zeros & (zeros - 1)) - 1 : key & 63;
    zc[(long long)g * nmb + m] = z;
  }
}

__global__ void __launch_bounds__(THREADS)
sad_offsets_kernel(const uint8_t* __restrict__ cur, const uint8_t* __restrict__ pad, int H, int W,
                   const int* __restrict__ offs, int n, int* __restrict__ out) {
  __shared__ uint8_t win[WIN * WIN];
  __shared__ int sads[MAX_OFFSETS];
  const int mbw = W / MB, nmb = (H / MB) * mbw;
  const int g = blockIdx.x / nmb, m = blockIdx.x % nmb;
  mb_sads(cur, pad, H, W, g, m / mbw, m % mbw, offs, n, win, sads);
  for (int k = threadIdx.x; k < n; k += blockDim.x)
    out[((long long)g * n + k) * nmb + m] = sads[k];
}

}  // namespace

// Plain C entry points, bound with ctypes by ops/me_fused.py.  cur is
// (nframes, H, W) u8 and pad (nframes, H+32, W+32) u8, contiguous, H and W
// multiples of 16; offs an int32 (n, 2) table of (x, y) offsets in
// [-16, 16].  Each returns cudaGetLastError() after its launch.

// D: offs holds the 64 canonical steps, rows (64) each step's SAD row;
// best, zc (nframes, H/16, W/16) i32, sads_c (nframes, nrows, H/16, W/16)
// i32, pred (nframes, H, W) u8.
extern "C" int icsp_sad_mc_best(const void* cur, const void* pad, int nframes, int H, int W,
                                const int* offs, const int* rows, int nrows, int* best, int* zc,
                                int* sads_c, void* pred, void* stream) {
  const long long nblk = (long long)nframes * (H / MB) * (W / MB);
  sad_mc_best_kernel<<<(unsigned)nblk, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(cur), static_cast<const uint8_t*>(pad), H, W, offs, rows,
      nrows, best, zc, sads_c, static_cast<uint8_t*>(pred));
  return (int)cudaGetLastError();
}

// sad_best: offs holds the 64 canonical steps; best, zc (nframes, H/16,
// W/16) i32.
extern "C" int icsp_sad_best(const void* cur, const void* pad, int nframes, int H, int W,
                             const int* offs, int* best, int* zc, void* stream) {
  const long long nblk = (long long)nframes * (H / MB) * (W / MB);
  sad_best_kernel<<<(unsigned)nblk, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(cur), static_cast<const uint8_t*>(pad), H, W, offs, best, zc);
  return (int)cudaGetLastError();
}

// G and sad_union: the SADs at n <= 160 offsets into out (nframes, n,
// H/16, W/16) i32.
extern "C" int icsp_sad_offsets(const void* cur, const void* pad, int nframes, int H, int W,
                                const int* offs, int n, int* out, void* stream) {
  if (n > MAX_OFFSETS) return (int)cudaErrorInvalidValue;
  const long long nblk = (long long)nframes * (H / MB) * (W / MB);
  sad_offsets_kernel<<<(unsigned)nblk, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(cur), static_cast<const uint8_t*>(pad), H, W, offs, n, out);
  return (int)cudaGetLastError();
}
