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
// 3.35 TB/s.  Its work is 195 M byte absolute differences, accumulated; the
// body below does four in one 32-bit lane instruction (vabsdiff4, SASS
// VABSDIFF4.U8.ACC), so 49 M operations, 1.5 us at 33.5e12 a second
// (chip_smoke.py's PEAK_LANE_OP_S), and bytes bound it.  G does the same
// for 66 offsets with no predictor, sad_union for 129, sad_best for D's 64
// steps with only the keys out.
//
// Design.  One CTA of 8 warps takes a run of up to 8 macroblocks of one MB
// row of one frame (CIF: 3 runs a row, 1,620 CTAs a P-step), a warp an MB.
// The CTA brings the run's 48-row strip of the padded previous frame (the
// MBs' windows overlap, so the strip is ~1.7x the MBs' bytes where a window
// each would be 9x) and the MBs' current pixels into shared memory with
// coalesced 16-byte loads, 4 pixels a 32-bit word.  Each lane owns whole
// SADs: spiral steps k = lane + 32 i (2 a lane for the 64 steps, up to 5
// for the union offsets), summed over the MB's 16 rows of 4 words, so no
// step needs a warp reduction.  A candidate row at an unaligned x offset is
// aligned from 5 words by __funnelshift_r, and each word pair goes through
// one vabsdiff4 (four byte absolute differences, accumulated).  The strip's
// row stride, 42 words, spreads the 32 lanes' offsets over the banks (at
// most 2 lanes of distinct words a bank for the canonical steps and the
// union).  D then reduces the 64 keys once per MB (a shuffle min) and counts
// the zeros with a ballot, and 16 lanes copy the winning rows from the
// strip to the predictor in 16-byte stores.  The TPU kernel's rolls of the
// whole padded frame, its lane extension, its 0/1 block-sum matmuls and its
// bf16 nibble split are not needed here.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MB = 16;             // macroblock side
constexpr int RANGE = 16;          // offsets lie in [-RANGE, RANGE]^2
constexpr int RUN = 8;             // MBs a CTA, a warp each
constexpr int THREADS = RUN * 32;
constexpr int STRIP_ROWS = MB + 2 * RANGE;
constexpr int STRIP_STRIDE = 42;   // words a strip row: >= RUN * 4 + 8, and 42 = 10 mod 32
constexpr int CUR_STRIDE = RUN * 4;
constexpr int MAX_OFFSETS = 160;
constexpr int MAX_PER_LANE = MAX_OFFSETS / 32;
constexpr unsigned FULL = 0xffffffffu;

// acc + the sum of the four byte absolute differences of a and b
__device__ __forceinline__ unsigned sad4(unsigned a, unsigned b, unsigned acc) {
  unsigned r;
  asm("vabsdiff4.u32.u32.u32.add %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(acc));
  return r;
}

// The CTA's run: frame g, MB row mby, MBs mb0 .. mb0 + nm - 1 of the row.
struct Run {
  int g, mby, mb0, nm, mbw, nmb;
  __device__ __forceinline__ Run(int H, int W) {
    mbw = W / MB;
    const int nruns = (mbw + RUN - 1) / RUN, mbh = H / MB;
    int b = blockIdx.x;
    const int run = b % nruns;
    b /= nruns;
    mby = b % mbh;
    g = b / mbh;
    mb0 = run * RUN;
    nm = min(RUN, mbw - mb0);
    nmb = mbh * mbw;
  }
  __device__ __forceinline__ int mb_index(int m) const { return mby * mbw + mb0 + m; }
};

// The run's strip of the padded frame (rows mby*16 .. +47, columns mb0*16 ..
// + nm*16 + 31) and its MBs' current pixels into shared memory, 16 bytes a
// load.  Ends with a block barrier.
__device__ __forceinline__ void load_run(const uint8_t* __restrict__ cur,
                                         const uint8_t* __restrict__ pad, int H, int W,
                                         const Run& run, unsigned* strip, unsigned* curw) {
  const int PW = W + 2 * RANGE, PH = H + 2 * RANGE;
  const int q_row = run.nm + 2;      // 16-byte chunks a strip row
  const uint8_t* src = pad + ((long long)run.g * PH + run.mby * MB) * PW + run.mb0 * MB;
  for (int i = threadIdx.x; i < STRIP_ROWS * q_row; i += blockDim.x) {
    const int r = i / q_row, q = i - r * q_row;
    const uint4 v = *reinterpret_cast<const uint4*>(src + (long long)r * PW + q * 16);
    unsigned* dst = strip + r * STRIP_STRIDE + q * 4;
    dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
  }
  const uint8_t* cs = cur + ((long long)run.g * H + run.mby * MB) * W + run.mb0 * MB;
  for (int i = threadIdx.x; i < MB * run.nm; i += blockDim.x) {
    const int r = i / run.nm, q = i - r * run.nm;
    *reinterpret_cast<uint4*>(curw + r * CUR_STRIDE + q * 4) =
        *reinterpret_cast<const uint4*>(cs + (long long)r * W + q * 16);
  }
  __syncthreads();
}

// Word j (0..3) of row r of the candidate of MB m at byte column b of the
// strip (b = m * 16 + RANGE + ox), from the strip's aligned words
__device__ __forceinline__ void cand_row(const unsigned* strip, int row, int b, unsigned (&w)[4]) {
  const unsigned* p = strip + row * STRIP_STRIDE + (b >> 2);
  const unsigned sh = (b & 3) * 8;
  const unsigned a0 = p[0], a1 = p[1], a2 = p[2], a3 = p[3], a4 = p[4];
  w[0] = __funnelshift_r(a0, a1, sh);
  w[1] = __funnelshift_r(a1, a2, sh);
  w[2] = __funnelshift_r(a2, a3, sh);
  w[3] = __funnelshift_r(a3, a4, sh);
}

// The SADs of this warp's MB m at offsets k = lane + 32 i (i < K, k < n)
// into s[i]; the offsets (x, y) pairs of offs.
template <int K>
__device__ __forceinline__ void mb_sads(const unsigned* strip, const unsigned* curw, int m,
                                        const int* __restrict__ offs, int n, unsigned (&s)[K]) {
  const int lane = threadIdx.x & 31;
  int b[K], oy[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int k = min(lane + 32 * i, n - 1);
    b[i] = m * MB + RANGE + offs[2 * k];
    oy[i] = RANGE + offs[2 * k + 1];
    s[i] = 0;
  }
#pragma unroll 4
  for (int r = 0; r < MB; ++r) {
    const uint4 c = *reinterpret_cast<const uint4*>(curw + r * CUR_STRIDE + m * 4);
#pragma unroll
    for (int i = 0; i < K; ++i) {
      unsigned w[4];
      cand_row(strip, oy[i] + r, b[i], w);
      s[i] = sad4(c.x, w[0], sad4(c.y, w[1], sad4(c.z, w[2], sad4(c.w, w[3], s[i]))));
    }
  }
}

__global__ void __launch_bounds__(THREADS)
sad_mc_best_kernel(const uint8_t* __restrict__ cur, const uint8_t* __restrict__ pad, int H, int W,
                   const int* __restrict__ offs, const int* __restrict__ rows, int nrows,
                   int* __restrict__ best, int* __restrict__ zc, int* __restrict__ sads_c,
                   uint8_t* __restrict__ pred) {
  __shared__ __align__(16) unsigned strip[STRIP_ROWS * STRIP_STRIDE + 4];
  __shared__ __align__(16) unsigned curw[MB * CUR_STRIDE];
  const Run run(H, W);
  load_run(cur, pad, H, W, run, strip, curw);
  const int m = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (m >= run.nm) return;
  unsigned s[2];
  mb_sads<2>(strip, curw, m, offs, 64, s);
  const int s0 = (int)s[0], s1 = (int)s[1], mi = run.mb_index(m);
  int key = min(s0 * 64 + lane, s1 * 64 + lane + 32);  // first strict minimum
  for (int o = 16; o > 0; o >>= 1) key = min(key, __shfl_xor_sync(FULL, key, o));
  const int z = __popc(__ballot_sync(FULL, s0 == 0)) + __popc(__ballot_sync(FULL, s1 == 0));
  // ranks 0 and 1 share offset (0, 0) and so row 0: both write the same value
  sads_c[((long long)run.g * nrows + rows[lane]) * run.nmb + mi] = s0;
  sads_c[((long long)run.g * nrows + rows[lane + 32]) * run.nmb + mi] = s1;
  const int bk = key & 63;
  if (lane == 0) {
    best[(long long)run.g * run.nmb + mi] = bk;
    zc[(long long)run.g * run.nmb + mi] = z;
  }
  if (lane < MB) {   // the predictor: row `lane` of the winning candidate
    unsigned w[4];
    cand_row(strip, RANGE + offs[2 * bk + 1] + lane, m * MB + RANGE + offs[2 * bk], w);
    *reinterpret_cast<uint4*>(pred + ((long long)run.g * H + run.mby * MB + lane) * W +
                              (run.mb0 + m) * MB) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

__global__ void __launch_bounds__(THREADS)
sad_best_kernel(const uint8_t* __restrict__ cur, const uint8_t* __restrict__ pad, int H, int W,
                const int* __restrict__ offs, int* __restrict__ best, int* __restrict__ zc) {
  __shared__ __align__(16) unsigned strip[STRIP_ROWS * STRIP_STRIDE + 4];
  __shared__ __align__(16) unsigned curw[MB * CUR_STRIDE];
  const Run run(H, W);
  load_run(cur, pad, H, W, run, strip, curw);
  const int m = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (m >= run.nm) return;
  unsigned s[2];
  mb_sads<2>(strip, curw, m, offs, 64, s);
  const int s0 = (int)s[0], s1 = (int)s[1], mi = run.mb_index(m);
  int key = min(s0 * 64 + lane, s1 * 64 + lane + 32);  // first strict minimum
  for (int o = 16; o > 0; o >>= 1) key = min(key, __shfl_xor_sync(FULL, key, o));
  // bit k of zeros: step k's SAD is 0, steps in walk order
  const unsigned long long zeros = (unsigned long long)__ballot_sync(FULL, s0 == 0) |
                                   ((unsigned long long)__ballot_sync(FULL, s1 == 0) << 32);
  if (lane == 0) {
    const int z = __popcll(zeros);
    // two or more zeros: the walk breaks at the second, which wins
    best[(long long)run.g * run.nmb + mi] = z >= 2 ? __ffsll(zeros & (zeros - 1)) - 1 : key & 63;
    zc[(long long)run.g * run.nmb + mi] = z;
  }
}

// K offsets a lane: n <= 32 K
template <int K>
__global__ void __launch_bounds__(THREADS)
sad_offsets_kernel(const uint8_t* __restrict__ cur, const uint8_t* __restrict__ pad, int H, int W,
                   const int* __restrict__ offs, int n, int* __restrict__ out) {
  __shared__ __align__(16) unsigned strip[STRIP_ROWS * STRIP_STRIDE + 4];
  __shared__ __align__(16) unsigned curw[MB * CUR_STRIDE];
  const Run run(H, W);
  load_run(cur, pad, H, W, run, strip, curw);
  const int m = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (m >= run.nm) return;
  unsigned s[K];
  mb_sads<K>(strip, curw, m, offs, n, s);
  const int mi = run.mb_index(m);
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int k = lane + 32 * i;
    if (k < n) out[((long long)run.g * n + k) * run.nmb + mi] = (int)s[i];
  }
}

unsigned grid(int nframes, int H, int W) {
  const long long mbw = W / MB;
  return (unsigned)((long long)nframes * (H / MB) * ((mbw + RUN - 1) / RUN));
}

template <int K>
void launch_offsets(const void* cur, const void* pad, int nframes, int H, int W, const int* offs,
                    int n, int* out, cudaStream_t stream) {
  sad_offsets_kernel<K><<<grid(nframes, H, W), THREADS, 0, stream>>>(
      static_cast<const uint8_t*>(cur), static_cast<const uint8_t*>(pad), H, W, offs, n, out);
}

}  // namespace

// Plain C entry points, bound with ctypes by ops/me_fused.py.  cur is
// (nframes, H, W) u8 and pad (nframes, H+32, W+32) u8, contiguous and
// 16-byte aligned, H and W multiples of 16; offs an int32 (n, 2) table of
// (x, y) offsets in [-16, 16].  Each returns cudaGetLastError() after its launch.

// D: offs holds the 64 canonical steps, rows (64) each step's SAD row;
// best, zc (nframes, H/16, W/16) i32, sads_c (nframes, nrows, H/16, W/16)
// i32, pred (nframes, H, W) u8.
extern "C" int icsp_sad_mc_best(const void* cur, const void* pad, int nframes, int H, int W,
                                const int* offs, const int* rows, int nrows, int* best, int* zc,
                                int* sads_c, void* pred, void* stream) {
  sad_mc_best_kernel<<<grid(nframes, H, W), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(cur), static_cast<const uint8_t*>(pad), H, W, offs, rows,
      nrows, best, zc, sads_c, static_cast<uint8_t*>(pred));
  return (int)cudaGetLastError();
}

// sad_best: offs holds the 64 canonical steps; best, zc (nframes, H/16,
// W/16) i32.
extern "C" int icsp_sad_best(const void* cur, const void* pad, int nframes, int H, int W,
                             const int* offs, int* best, int* zc, void* stream) {
  sad_best_kernel<<<grid(nframes, H, W), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(cur), static_cast<const uint8_t*>(pad), H, W, offs, best, zc);
  return (int)cudaGetLastError();
}

// G and sad_union: the SADs at 1 <= n <= 160 offsets into out (nframes,
// n, H/16, W/16) i32.
extern "C" int icsp_sad_offsets(const void* cur, const void* pad, int nframes, int H, int W,
                                const int* offs, int n, int* out, void* stream) {
  if (n < 1 || n > MAX_OFFSETS) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  switch ((n + 31) / 32) {
    case 1: launch_offsets<1>(cur, pad, nframes, H, W, offs, n, out, st); break;
    case 2: launch_offsets<2>(cur, pad, nframes, H, W, offs, n, out, st); break;
    case 3: launch_offsets<3>(cur, pad, nframes, H, W, offs, n, out, st); break;
    case 4: launch_offsets<4>(cur, pad, nframes, H, W, offs, n, out, st); break;
    default: launch_offsets<MAX_PER_LANE>(cur, pad, nframes, H, W, offs, n, out, st);
  }
  return (int)cudaGetLastError();
}
