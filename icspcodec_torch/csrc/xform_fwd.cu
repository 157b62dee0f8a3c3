// Kernel F: the forward residual chain of the inter encoder, for sm_90a.
//
// Replaces: icspcodec_tpu/ops/pallas_xform.py::_xform_rows_fused (the Pallas
// TPU kernel behind xform_fwd_fused).  It computes what the plain PyTorch
// version computes (ops/xform_fused.py::xform_fwd_plain, the unfused chain
// of the JAX package's engine/inter.py:140-152) for (F, gh, gw, 8, 8)
// integer blocks (inter luma residuals, or inter chroma residuals):
//   d   = fdct(block)
//   dc  : the DC DPCM chain along the 2*gy+gx anti-diagonals of each plane,
//         resid = d[0] - pred(kind), t = floor (chroma) or trunc (luma) of
//         resid + 0.5, q = t / qdc (C division), dq = q * qdc + pred, with
//         pred the kind-coded predictor over the neighbours' dq
//   ac  : q = floor / trunc (d + 0.5) / qac, iq = q * qac
//   the zig-zag symbols, the AC-empty flag, and r = idct(iq with dq at DC):
//   luma writes (int) r (truncation, mergeBlock INTER enc src:4812), chroma
//   the raw float r, because the engine adds the predictor in float before
//   its (int) cast.
//
// Precision.  Each type runs the transform of its plain path
// (ops/transforms.py).  double: the separable transform, every product and
// sum rounded on its own in the plain version's order (__dmul_rn /
// __dadd_rn; nvcc would otherwise contract a multiply-add into an FMA), so
// it is bit-identical to the plain version.  float: the plain version on the
// card multiplies by the float32 64x64 matrices (tables.fdct_matrix /
// idct_matrix) in double and rounds once to float.  Every entry of those
// matrices is a multiple of 2^-29 and each row's absolute sum is below 9,
// so with integer inputs below 2^15 every product and every partial sum is
// a multiple of 2^-29 below 2^19 in magnitude: 48 bits, exact in double.
// The double sum is therefore the exact one in any order, and the kernel's
// tensor-core products (below) equal the plain version's bit for bit
// (tests/test_torch_kernels_ef.py checks the claim on the tables).  That
// matters beyond the symbols: the decoder's inverse transform is the plain
// one, and an AC-empty block's IDCT lands on whole numbers (at QP 16: dq /
// 8), so a float path of other rounding (a separable float32 body, say)
// truncates such blocks one lower than the decoder does and the encoder's
// reference frames drift from the decoder's over a GOP.
//
// Bound on this card.  One luma call of a CIF P-step (30 frames, 47,520
// blocks) reads 12.2 MB of int32 residuals and writes 6.1 MB of int16
// symbols, 12.2 MB of int32 r and 0.05 MB of flags: ~30 MB, 9 us at
// 3.35 TB/s.  The float path's function is the two 64x64 products in
// double: the forward dense, 4,096 FP64 multiply-adds a block (0.39 GFLOP
// for the luma call, 5.8 us at the 67 TFLOP/s of the FP64 tensor cores),
// the inverse 64 for each nonzero dequantized value, which the data
// decides (chip_smoke.py counts them, and takes the larger of the two
// bounds).  The kernel runs the inverse dense all the same.  The exact path's separable
// transforms are 4,096 flops a block and bytes bound it.  Beside the bound, the DC chain's 114 dependent
// diagonals (CIF luma) take one warp's instruction latency each, about
// 0.3 us on an H100 (PERF.md), so the design keeps every step short.
//
// Design.  Two launches on the caller's stream.  (1) One CTA per plane: all
// its threads sum each block of the plane (its DC term is a function of the
// sum, see dc_slot) into shared memory beside the kind grid; then one warp
// walks the DC chain along the diagonals, each lane holding block rows and
// their last three dequantized DCs in registers, the upper row's read by a
// shuffle, with a branch-free step and the division by the quantizer as a
// multiply.  A plane too large for shared memory keeps its sums in a
// global scratch array.  (2) The block chain.  float: each warp takes
// tiles of 8 blocks, the residual tile brought into shared memory with
// cp.async one tile ahead, and runs both dense products as FP64
// tensor-core products (mma.m8n8k4.f64: the matrix, widened to double in
// shared memory in fragment order, is the A operand, the 8 blocks' 64
// values the B operand), with quantization, the chain's DC, zig-zag, the
// AC flag and dequantization between them; one CTA of 16 warps per SM,
// which loads the 64 KB of matrices once.  double: one warp per block, two
// coefficients a lane, the separable body.  The TPU kernel's shear layout,
// rolls, 0/1 extraction and split permutation matmuls are not needed here.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

template <typename T> struct Rn;
template <> struct Rn<double> {
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
};

constexpr unsigned FULL = 0xffffffffu;
constexpr int CHAIN_MAX_ROWS = 16;  // sets of 32 block rows a lane of the walk holds at
                                    // once; taller planes are walked in bands of 512 rows
constexpr int BLOCK_WARPS = 8;      // warps per CTA of launch 2
constexpr int MMA_WARPS = 16;       // warps per CTA of launch 2, float (one CTA per SM)
constexpr int TILE = 8;             // blocks per warp tile of the float path (the mma's n)
constexpr int TS = 68;              // int32 stride of a block in a tile buffer: 64 + 4,
                                    // so the mma operand reads hit 32 distinct banks
constexpr int NFRAG = 4096;         // one 64x64 matrix in mma fragment order
constexpr int EXACT_TAB = 65;       // the double path's table: 8x8 cosines, then IRT2
constexpr int MAX_DEV = 64;
constexpr long long MAX_CELLS = 1LL << 25;  // blocks a call: cell indices stay in int
                                            // (ops/xform_fused.py splits larger calls)

__device__ __forceinline__ int median3(int a, int b, int c) {
  const int m1 = max(b, c), m2 = max(a, c), m3 = max(a, b);
  return (a > b && a > c) ? m1 : ((b > a && b > c) ? m2 : m3);
}

// (int) of v + 0.5 after the chain's rounding: floor for chroma, truncation
// toward zero for luma
template <typename T, bool CHROMA>
__device__ __forceinline__ int round_q(T half) {
  return CHROMA ? (int)floor(half) : (int)half;
}

// int32 blocks (F, gh, gw, 8, 8) with element strides; the wrapper makes
// s_x = 1, the other strides multiples of 4 and the base 16-byte aligned,
// so each 8-value block row is two aligned int4
struct Blocks {
  const int* p;
  long long s_f, s_gy, s_gx, s_y, s_x;
  __device__ __forceinline__ const int* at(int f, int gy, int gx) const {
    return p + f * s_f + gy * s_gy + gx * s_gx;
  }
};

__device__ __forceinline__ void load_row(const int* p, int (&v)[8]) {
  const int4 a = *reinterpret_cast<const int4*>(p), b = *reinterpret_cast<const int4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// ---------------------------------------------------------------------------
// Launch 1: DC terms and the DC chain, one CTA per plane
// ---------------------------------------------------------------------------

// C division t / d (truncation toward zero) for d >= 1, without a branch:
// m = ceil(2^64 / d) (d >= 2), so |t| * m / 2^64 = |t| / d + |t| e / (d
// 2^64) with e = m d - 2^64 < d, and |t| e < 2^63 keeps the floor exact
__device__ __forceinline__ unsigned long long div_multiplier(int d) {
  return d > 1 ? ~0ULL / (unsigned)d + 1 : 0;
}
__device__ __forceinline__ int div_trunc(int t, int d, unsigned long long m) {
  const int q = (int)__umul64hi((unsigned long long)(unsigned)abs(t), m);
  return d == 1 ? t : t < 0 ? -q : q;
}

// What launch 1 keeps of each block for the walk.  The DC term follows
// today's arithmetic, which row 0 of the cosine tables (all ones;
// ops/xform_fused.py checks it) reduces to the block's integer sum S
// exactly.  double: the separable order, ((sum_y t1[y][0] * ct[0][y]) *
// irt2) * irt2 * 0.25 with t1[y][0] = sum_x e[y][x] * ct[0][x]: products by
// 1 and sums of integers are exact, so the DC term is ((S * irt2) * irt2) *
// 0.25, kept as a double.  float: row 0 of the dense matrix is 64 entries of
// 1/8, so the double sum is S / 8 and so is the float; then dc - pred + 0.5
// = (S + 4 - 8 pred) / 8 is exact in float, and the chain's floor (chroma)
// or truncation (luma) of it is that of the integer quotient.  The walk
// keeps A = S + 4, an int.
template <typename T>
using DcSlot = typename std::conditional<std::is_same<T, double>::value, double, int>::type;

template <typename T>
__device__ __forceinline__ DcSlot<T> dc_slot(const int* e, long long s_y, double irt2) {
  int s = 0;
#pragma unroll
  for (int y = 0; y < 8; ++y) {
    int v[8];
    load_row(e + y * s_y, v);
#pragma unroll
    for (int x = 0; x < 8; ++x) s += v[x];
  }
  if constexpr (std::is_same<T, double>::value) {
    return __dmul_rn(__dmul_rn(__dmul_rn((double)s, irt2), irt2), 0.25);
  } else {
    return s + 4;
  }
}

// t of the DC chain for a cell: round_q(dc - pred + 0.5), in the plain
// version's arithmetic
template <typename T, bool CHROMA>
__device__ __forceinline__ int chain_t(DcSlot<T> v, int pred) {
  if constexpr (std::is_same<T, double>::value) {
    return round_q<double, CHROMA>(__dadd_rn(__dsub_rn(v, (double)pred), 0.5));
  } else {
    const int n = v - 8 * pred;
    return CHROMA ? n >> 3 : n / 8;   // floor / truncation of n / 8
  }
}

// Shared memory of launch 1, when it fits: the plane's DC slots and kinds.
template <typename T>
inline size_t chain_smem(int gh, int gw) {
  return (sizeof(DcSlot<T>) + sizeof(int)) * (size_t)gh * gw;
}

// Threads of launch 1: as many as the registers of the walk's rows allow.
constexpr int chain_threads(int rows) { return rows <= 4 ? 1024 : 512; }

// One CTA per plane.  All threads compute the DC slots of the plane's blocks
// and copy the kind grid into shared memory (in_smem), or into the global
// scratch dc_g beside the kind grid kind_g (planes too large); then warp 0
// walks the diagonals.  Its lane holds block rows lane + 32 r (r < ROWS) of
// the current band of 32 ROWS rows, each with its last three dq in
// registers: at step d, row gy takes cell gx = d - 2 gy, whose left
// neighbour is its own last dq and whose upper neighbours (gx + 1, gx, gx -
// 1) row gy - 1 took at steps d - 1, d - 2 and d - 3 (at gx = gw - 1 that
// row ended a step early: ur = u, ul its second last), read from lane gy -
// 1 by a shuffle.  A step touches memory only to store its result,
// qdq[cell] = (q, dq), and to load the next step's slot and kind.  One warp
// walks, so the walk's time is the latency of its instructions: the step
// has no branch, the quotient by qdc is a multiply, and ROWS is the least
// power of two >= gh / 32 (at most CHAIN_MAX_ROWS), so that no lane steps
// through many rows that do not exist.  A plane of more than 32 ROWS rows is
// walked band after band: the top row of a band reads the dq of the row
// above it, which the band before finished, from a copy of that row in
// shared memory (upper), at the clamped columns the plain version reads.
// tab: the double path's 65 values (IRT2 last).
template <typename T, bool CHROMA, int ROWS>
__global__ void __launch_bounds__(chain_threads(ROWS))
chain_kernel(Blocks blk, const double* __restrict__ tab, const int* __restrict__ kind_g, int gh,
             int gw, int qdc, int in_smem, DcSlot<T>* __restrict__ dc_g,
             int2* __restrict__ qdq) {
  using S = DcSlot<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int plane = blockIdx.x, ncp = gh * gw;
  S* slot = in_smem ? reinterpret_cast<S*>(smem) : dc_g + (long long)plane * ncp;
  int* kind_s = reinterpret_cast<int*>(smem + sizeof(S) * ncp);
  const int* kind = in_smem ? kind_s : kind_g;
  int* upper = in_smem ? kind_s + ncp : reinterpret_cast<int*>(smem);
  const double irt2 = std::is_same<T, double>::value ? tab[64] : 0.0;
  for (int c = threadIdx.x; c < ncp; c += blockDim.x) {
    const int gy = c / gw, gx = c - gy * gw;
    slot[c] = dc_slot<T>(blk.at(plane, gy, gx), blk.s_y, irt2);
    if (in_smem) kind_s[c] = kind_g[c];
  }
  __syncthreads();  // the last block barrier: warp 0 walks the chain below
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  const unsigned long long mdc = div_multiplier(qdc);
  int2* out = qdq + (long long)plane * ncp;
  // only the walk of CHAIN_MAX_ROWS sets takes planes of more than one band
  constexpr bool BANDS = ROWS == CHAIN_MAX_ROWS;
  for (int gy0 = 0; gy0 < gh; gy0 += 32 * ROWS) {
    const bool band = BANDS && gy0 > 0;   // a band below another: its top row reads upper
    if (band) {
      __syncwarp();   // the band above stored its results
      for (int x = lane; x < gw; x += 32) upper[x] = out[(long long)(gy0 - 1) * gw + x].y;
      __syncwarp();
    }
    int h1[ROWS], h2[ROWS], h3[ROWS], kn[ROWS];
    S vn[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {   // the band's first step takes its cell (gy0, 0) alone
      h1[r] = h2[r] = h3[r] = 0;
      vn[r] = slot[gy0 * gw];
      kn[r] = kind[gy0 * gw];
    }
    // the top row's upper neighbours (ur, u, ul) for the next step
    int p1 = band ? upper[min(1, gw - 1)] : 0, p2 = band ? upper[0] : 0, p3 = p2;
    const int d_end = 2 * min(gh - 1, gy0 + 32 * ROWS - 1) + gw;
    for (int d = 2 * gy0; d < d_end; ++d) {
      const int t1 = p1, t2 = p2, t3 = p3;
      if (band) {
        const int gxn = min(max(d + 1 - 2 * gy0, 0), gw - 1);
        p1 = upper[min(gxn + 1, gw - 1)];
        p2 = upper[gxn];
        p3 = upper[max(gxn - 1, 0)];
      }
      // sets from the last down: set r's shuffle reads set r - 1 (lane 31)
      // before that set takes its step; the body has no branch
#pragma unroll
      for (int r = ROWS - 1; r >= 0; --r) {
        const int gy = gy0 + lane + 32 * r, gx = d - 2 * gy;
        const bool on = gy < gh && gx >= 0 && gx < gw;
        const S v = vn[r];
        const int kk = kn[r];
        // the cell of step d + 1, loaded while this one is worked
        const bool on1 = gy < gh && gx + 1 >= 0 && gx + 1 < gw;
        const int c1 = on1 ? gy * gw + gx + 1 : 0;
        vn[r] = slot[c1];
        kn[r] = kind[c1];
        // lane L reads row gy - 1: lane L - 1's set r, or for lane 0 lane
        // 31's set r - 1; the band's top row reads upper
        const bool wrap = lane == 31 && r > 0;
        const int src = (lane + 31) & 31;
        const int u1 = __shfl_sync(FULL, wrap ? h1[r > 0 ? r - 1 : 0] : h1[r], src);
        const int u2 = __shfl_sync(FULL, wrap ? h2[r > 0 ? r - 1 : 0] : h2[r], src);
        const int u3 = __shfl_sync(FULL, wrap ? h3[r > 0 ? r - 1 : 0] : h3[r], src);
        const bool last = gx == gw - 1, top = band && r == 0 && lane == 0;
        const int l = h1[r];
        const int ur = top ? t1 : u1, u = top ? t2 : last ? u1 : u2;
        const int ul = top ? t3 : last ? u2 : u3;
        const int pred = kk == 0 ? 1024 : kk == 1 ? l : kk == 2 ? u
                       : kk == 3 ? median3(l, ul, u) : median3(l, u, ur);
        const int qv = div_trunc(chain_t<T, CHROMA>(v, pred), qdc, mdc);
        const int dqv = qv * qdc + pred;
        if (on) out[gy * gw + gx] = make_int2(qv, dqv);
        h3[r] = on ? h2[r] : h3[r];
        h2[r] = on ? h1[r] : h2[r];
        h1[r] = on ? dqv : h1[r];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Launch 2, float: the dense products on the FP64 tensor cores
// ---------------------------------------------------------------------------

// D (8x8) += A (8x4, row) * B (4x8, col), one double each of A and B and two
// of D a lane: lane = 4 g + t holds A[g][t], B[t][g], D[g][2t], D[g][2t+1]
__device__ __forceinline__ void dmma(double& d0, double& d1, double a, double b) {
  asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};\n"
      : "+d"(d0), "+d"(d1)
      : "d"(a), "d"(b));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct Cell {
  int f, gy, gx;
};
__device__ __forceinline__ Cell cell_at(int c, int gh, int gw) {
  const int f = c / (gh * gw), rem = c - f * gh * gw, gy = rem / gw;
  return Cell{f, gy, rem - gy * gw};
}

// The residuals of cells c0 .. c0+TILE-1 into buf (block n at n * TS,
// row-major): 16-byte chunks, TILE / 2 a lane; cells past the end are zeros
__device__ __forceinline__ void load_tile(const Blocks& blk, int c0, int ncell, int gh, int gw,
                                          int* buf, int lane) {
#pragma unroll
  for (int j = 0; j < TILE / 2; ++j) {
    const int ch = lane + 32 * j;
    const int n = ch >> 4, y = (ch >> 1) & 7, h = ch & 1;
    int* dst = buf + n * TS + y * 8 + h * 4;
    if (c0 + n < ncell) {
      const Cell c = cell_at(c0 + n, gh, gw);
      cp_async16(dst, blk.at(c.f, c.gy, c.gx) + y * blk.s_y + h * 4);
    } else {
      *reinterpret_cast<int4*>(dst) = make_int4(0, 0, 0, 0);
    }
  }
}

// Shared memory of the float path: both matrices as double in fragment
// order, the zig-zag order, then per warp two tile buffers and TILE DC dqs.
constexpr size_t WARP_INTS = 2 * TILE * TS + TILE;
constexpr size_t MMA_SMEM =
    sizeof(double) * 2 * NFRAG + sizeof(int) * (64 + MMA_WARPS * WARP_INTS);

// frag: the forward then the inverse float32 matrix in fragment order,
// frag[(mt * 16 + ks) * 32 + lane] = M[mt * 8 + lane / 4][ks * 4 + lane % 4].
// Lane 4 g + t of a warp holds, of its tile's block 2t + i, coefficient (or
// pixel) mt * 8 + g in acc[mt][i].
template <bool CHROMA>
__global__ void __launch_bounds__(MMA_WARPS * 32, 1)
block_mma_kernel(Blocks blk, const float* __restrict__ frag, const int* __restrict__ zz_g,
                 const int2* __restrict__ qdq, int nplanes, int gh, int gw, int qac,
                 int16_t* __restrict__ scan, int8_t* __restrict__ acf, void* __restrict__ r_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* af = reinterpret_cast<double*>(smem);
  int* zz = reinterpret_cast<int*>(af + 2 * NFRAG);
  for (int i = threadIdx.x; i < 2 * NFRAG; i += blockDim.x) af[i] = (double)frag[i];
  for (int i = threadIdx.x; i < 64; i += blockDim.x) zz[i] = zz_g[i];
  __syncthreads();  // the last block barrier: warps run on their own below
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  int* bufs = zz + 64 + warp * WARP_INTS;
  int* dqs = bufs + 2 * TILE * TS;
  const int ncell = nplanes * gh * gw;
  const int ntile = (ncell + TILE - 1) / TILE;
  const int stride = gridDim.x * MMA_WARPS;
  const long long W = (long long)gw * 8;

  int tile = blockIdx.x * MMA_WARPS + warp;
  int cur = 0;
  if (tile < ntile) load_tile(blk, tile * TILE, ncell, gh, gw, bufs, lane);
  cp_async_commit();
  for (; tile < ntile; tile += stride, cur ^= 1) {
    int* eb = bufs + cur * TILE * TS;
    if (tile + stride < ntile)
      load_tile(blk, (tile + stride) * TILE, ncell, gh, gw, bufs + (cur ^ 1) * TILE * TS, lane);
    cp_async_commit();
    cp_async_wait<1>();  // this tile's copies are done, the next tile's in flight
    __syncwarp();

    // --- forward product: acc[mt][i] = d[mt * 8 + g] of block 2t + i ---
    double acc[8][2];
#pragma unroll
    for (int mt = 0; mt < 8; ++mt) acc[mt][0] = acc[mt][1] = 0.0;
#pragma unroll
    for (int ks = 0; ks < 16; ++ks) {
      const double b = (double)eb[g * TS + ks * 4 + t];
#pragma unroll
      for (int mt = 0; mt < 8; ++mt)
        dmma(acc[mt][0], acc[mt][1], af[(mt * 16 + ks) * 32 + lane], b);
    }

    // --- quantization (the DC from the chain), into the tile buffer ---
    const int c0 = tile * TILE, ca = c0 + 2 * t;
    int2 dc2[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) dc2[i] = g == 0 && ca + i < ncell ? qdq[ca + i] : make_int2(0, 0);
    __syncwarp();  // every lane is done reading the residuals
    int nz[2] = {0, 0};
#pragma unroll
    for (int mt = 0; mt < 8; ++mt) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int o = mt * 8 + g;
        int q;
        if (o == 0) {
          q = dc2[i].x;
        } else {
          q = round_q<float, CHROMA>(__fadd_rn((float)acc[mt][i], 0.5f)) / qac;
          nz[i] |= q != 0;
        }
        eb[(2 * t + i) * TS + o] = q;
      }
    }
    if (g == 0) {
      dqs[2 * t] = dc2[0].y;
      dqs[2 * t + 1] = dc2[1].y;
    }
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      nz[0] |= __shfl_xor_sync(FULL, nz[0], off);
      nz[1] |= __shfl_xor_sync(FULL, nz[1], off);
    }
    __syncwarp();

    // --- zig-zag symbols (the tile's 512 are contiguous) and AC flags ---
    uint32_t* sw = reinterpret_cast<uint32_t*>(scan + (long long)c0 * 64);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int w = lane + 32 * j, n = w >> 5, p = (2 * w) & 63;
      if (c0 + n < ncell)
        sw[w] = (uint32_t)(uint16_t)eb[n * TS + zz[p]] |
                ((uint32_t)(uint16_t)eb[n * TS + zz[p + 1]] << 16);
    }
    if (g == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (ca + i < ncell) acf[ca + i] = (int8_t)!nz[i];
    }

    // --- inverse product over iq (dq at DC): acc[mt][i] = r[y = mt][x = g]
    // of block 2t + i ---
#pragma unroll
    for (int mt = 0; mt < 8; ++mt) acc[mt][0] = acc[mt][1] = 0.0;
#pragma unroll
    for (int ks = 0; ks < 16; ++ks) {
      const int k = ks * 4 + t;
      const double b = (double)(k == 0 ? dqs[g] : eb[g * TS + k] * qac);
#pragma unroll
      for (int mt = 0; mt < 8; ++mt)
        dmma(acc[mt][0], acc[mt][1], af[NFRAG + (mt * 16 + ks) * 32 + lane], b);
    }

    // r as planes (F, gh*8, gw*8)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (ca + i >= ncell) continue;
      const Cell c = cell_at(ca + i, gh, gw);
      const long long o = ((long long)c.f * gh * 8 + c.gy * 8) * W + c.gx * 8 + g;
#pragma unroll
      for (int mt = 0; mt < 8; ++mt) {
        const float v = (float)acc[mt][i];
        if (CHROMA) {
          static_cast<float*>(r_out)[o + mt * W] = v;
        } else {
          static_cast<int*>(r_out)[o + mt * W] = (int)v;   // (int) truncates toward zero
        }
      }
    }
    __syncwarp();  // the buffer is free for the copy of the tile after next
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// Launch 2, double: one warp per block, the separable body
// ---------------------------------------------------------------------------

// Two coefficients a lane (i0 = lane, i1 = lane + 32; row y0 / y0 + 4,
// column xx): the forward DCT, the quantizer with the chain's DC, zig-zag,
// the AC-empty flag, dequantization and the inverse DCT.  The CTA's warps
// stride over the blocks.
template <bool CHROMA>
__global__ void __launch_bounds__(BLOCK_WARPS * 32)
block_exact_kernel(Blocks blk, const double* __restrict__ tab_g, const int* __restrict__ zz_g,
                   const int2* __restrict__ qdq, int nplanes, int gh, int gw, int qac,
                   int16_t* __restrict__ scan, int8_t* __restrict__ acf, void* __restrict__ r_out) {
  using T = double;
  using R = Rn<T>;
  __shared__ T ct[EXACT_TAB];
  __shared__ int zz[64];
  __shared__ T ebuf_all[BLOCK_WARPS][64];
  __shared__ T tbuf_all[BLOCK_WARPS][64];
  __shared__ int qbuf_all[BLOCK_WARPS][64];
  for (int i = threadIdx.x; i < EXACT_TAB; i += blockDim.x) ct[i] = tab_g[i];
  for (int i = threadIdx.x; i < 64; i += blockDim.x) zz[i] = zz_g[i];
  __syncthreads();  // the last block barrier: warps run on their own below
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T* ebuf = ebuf_all[warp];
  T* tbuf = tbuf_all[warp];
  int* qbuf = qbuf_all[warp];
  const int i0 = lane, i1 = lane + 32, y0 = i0 >> 3, y1 = y0 + 4, xx = i0 & 7;
  const int ncell = nplanes * gh * gw;
  const long long W = (long long)gw * 8;
  const T irt2 = ct[64];

  for (int cell = blockIdx.x * BLOCK_WARPS + warp; cell < ncell;
       cell += gridDim.x * BLOCK_WARPS) {
    const Cell c = cell_at(cell, gh, gw);
    const int* e = blk.at(c.f, c.gy, c.gx);
    __syncwarp();  // the warp's buffers are free again
    ebuf[i0] = (T)e[y0 * blk.s_y + xx];
    ebuf[i1] = (T)e[y1 * blk.s_y + xx];
    __syncwarp();

    // --- forward DCT: t1[v][u] = sum_x e[v][x] * ct[u][x]; out[v][u] =
    // sum_y t1[y][u] * ct[v][y]; then the irt2 weights and 1/4 ---
    T ta = R::mul(ebuf[y0 * 8], ct[xx * 8]), tb = R::mul(ebuf[y1 * 8], ct[xx * 8]);
#pragma unroll
    for (int x = 1; x < 8; ++x) {
      ta = R::add(ta, R::mul(ebuf[y0 * 8 + x], ct[xx * 8 + x]));
      tb = R::add(tb, R::mul(ebuf[y1 * 8 + x], ct[xx * 8 + x]));
    }
    tbuf[i0] = ta;
    tbuf[i1] = tb;
    __syncwarp();
    T da = R::mul(tbuf[xx], ct[y0 * 8]);
    T db = R::mul(tbuf[xx], ct[y1 * 8]);
#pragma unroll
    for (int y = 1; y < 8; ++y) {
      da = R::add(da, R::mul(tbuf[y * 8 + xx], ct[y0 * 8 + y]));
      db = R::add(db, R::mul(tbuf[y * 8 + xx], ct[y1 * 8 + y]));
    }
    if (y0 == 0) da = R::mul(da, irt2);
    if (xx == 0) { da = R::mul(da, irt2); db = R::mul(db, irt2); }
    da = R::mul(da, (T)0.25);
    db = R::mul(db, (T)0.25);

    // --- quantization (the DC from the chain), dequantization ---
    const int2 dcq = qdq[cell];
    int qa, iqa;
    if (i0 == 0) {
      qa = dcq.x;
      iqa = dcq.y;
    } else {
      qa = round_q<T, CHROMA>(R::add(da, (T)0.5)) / qac;
      iqa = qa * qac;
    }
    const int qb = round_q<T, CHROMA>(R::add(db, (T)0.5)) / qac;
    const int iqb = qb * qac;
    const int empty = !__any_sync(FULL, (i0 != 0 && qa != 0) || qb != 0);
    __syncwarp();  // every lane is done reading ebuf / tbuf
    qbuf[i0] = qa;
    qbuf[i1] = qb;
    ebuf[i0] = (T)iqa;
    ebuf[i1] = (T)iqb;
    __syncwarp();
    scan[(long long)cell * 64 + i0] = (int16_t)qbuf[zz[i0]];
    scan[(long long)cell * 64 + i1] = (int16_t)qbuf[zz[i1]];
    if (lane == 0) acf[cell] = (int8_t)empty;

    // --- inverse DCT: t1[v][x] = sum_u (iq[v][u] * cu[u]) * ct[u][x]; n =
    // t1 * cu[v]; out[y][x] = sum_v n[v][x] * ct[v][y]; then 1/4 ---
    ta = R::mul(R::mul(ebuf[y0 * 8], irt2), ct[xx]);
    tb = R::mul(R::mul(ebuf[y1 * 8], irt2), ct[xx]);
#pragma unroll
    for (int u = 1; u < 8; ++u) {
      ta = R::add(ta, R::mul(ebuf[y0 * 8 + u], ct[u * 8 + xx]));   // cu[u] = 1 is exact
      tb = R::add(tb, R::mul(ebuf[y1 * 8 + u], ct[u * 8 + xx]));
    }
    if (y0 == 0) ta = R::mul(ta, irt2);
    tbuf[i0] = ta;   // tbuf was last read before the barrier above
    tbuf[i1] = tb;
    __syncwarp();
    T ra = R::mul(tbuf[xx], ct[y0]);
    T rb = R::mul(tbuf[xx], ct[y1]);
#pragma unroll
    for (int v = 1; v < 8; ++v) {
      ra = R::add(ra, R::mul(tbuf[v * 8 + xx], ct[v * 8 + y0]));
      rb = R::add(rb, R::mul(tbuf[v * 8 + xx], ct[v * 8 + y1]));
    }
    ra = R::mul(ra, (T)0.25);
    rb = R::mul(rb, (T)0.25);

    // r as planes (F, gh*8, gw*8)
    const long long o = ((long long)c.f * gh * 8 + c.gy * 8) * W + c.gx * 8;
    if (CHROMA) {
      T* r = static_cast<T*>(r_out);
      r[o + y0 * W + xx] = ra;
      r[o + y1 * W + xx] = rb;
    } else {
      int* r = static_cast<int*>(r_out);
      r[o + y0 * W + xx] = (int)ra;   // (int) truncates toward zero
      r[o + y1 * W + xx] = (int)rb;
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

struct DeviceInfo {
  int nsm, smem_optin;
};

// The SM count and the opt-in shared memory of the current device, read
// once per device; the float block kernel is opted in to its shared memory
// at the same time.
cudaError_t device_info(DeviceInfo* out) {
  static DeviceInfo cache[MAX_DEV];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEV && cache[dev].nsm > 0) {
    *out = cache[dev];
    return cudaSuccess;
  }
  DeviceInfo d{};
  err = cudaDeviceGetAttribute(&d.nsm, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&d.smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const auto opt = cudaFuncAttributeMaxDynamicSharedMemorySize;
  if (err == cudaSuccess) err = cudaFuncSetAttribute(block_mma_kernel<false>, opt, (int)MMA_SMEM);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(block_mma_kernel<true>, opt, (int)MMA_SMEM);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEV) cache[dev] = d;
  *out = d;
  return cudaSuccess;
}

struct ChainArgs {
  Blocks blk;
  const double* tab;
  const int* kind;
  int nplanes, gh, gw, qdc;
  void* dc;
  int2* qdq;
  int in_smem;  // 0: the DC slots go to dc (planes too large for shared memory)
  size_t smem;
  cudaStream_t stream;
};

// Launch 1: one band of up to 32 * ROWS block rows at a time
template <typename T, bool CHROMA, int ROWS>
cudaError_t launch_chain(const ChainArgs& a) {
  if (a.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        chain_kernel<T, CHROMA, ROWS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)a.smem);
    if (err != cudaSuccess) return err;
  }
  chain_kernel<T, CHROMA, ROWS><<<a.nplanes, chain_threads(ROWS), a.smem, a.stream>>>(
      a.blk, a.tab, a.kind, a.gh, a.gw, a.qdc, a.in_smem, static_cast<DcSlot<T>*>(a.dc), a.qdq);
  return cudaGetLastError();
}

template <typename T, bool CHROMA>
int launch(const Blocks& blk, const void* tab, const int* zz, const int* kind, int nplanes,
           int gh, int gw, int qdc, int qac, void* dc, int2* qdq, int16_t* scan, int8_t* acf,
           void* r, cudaStream_t stream) {
  constexpr bool EXACT = std::is_same<T, double>::value;
  DeviceInfo info;
  cudaError_t err = device_info(&info);
  if (err != cudaSuccess) return (int)err;
  // a plane walked in bands keeps a copy of the row above the band in shared memory
  const size_t upper = gh > 32 * CHAIN_MAX_ROWS ? sizeof(int) * (size_t)gw : 0;
  const size_t all = chain_smem<T>(gh, gw) + upper;
  const int in_smem = all <= (size_t)info.smem_optin;
  const ChainArgs ca{blk, static_cast<const double*>(tab), kind, nplanes, gh, gw, qdc, dc, qdq,
                     in_smem, in_smem ? all : upper, stream};
  const int rows = (gh + 31) / 32;
  err = rows <= 1   ? launch_chain<T, CHROMA, 1>(ca)
        : rows <= 2 ? launch_chain<T, CHROMA, 2>(ca)
        : rows <= 4 ? launch_chain<T, CHROMA, 4>(ca)
        : rows <= 8 ? launch_chain<T, CHROMA, 8>(ca)
                    : launch_chain<T, CHROMA, CHAIN_MAX_ROWS>(ca);
  if (err != cudaSuccess) return (int)err;
  const long long ncell = (long long)nplanes * gh * gw;
  if constexpr (EXACT) {
    const long long nblk = (ncell + BLOCK_WARPS - 1) / BLOCK_WARPS;
    const unsigned grid = (unsigned)(nblk < 4LL * info.nsm ? nblk : 4LL * info.nsm);
    block_exact_kernel<CHROMA><<<grid, BLOCK_WARPS * 32, 0, stream>>>(
        blk, static_cast<const double*>(tab), zz, qdq, nplanes, gh, gw, qac, scan, acf, r);
  } else {
    const long long nblk = ((ncell + TILE - 1) / TILE + MMA_WARPS - 1) / MMA_WARPS;
    const unsigned grid = (unsigned)(nblk < info.nsm ? nblk : info.nsm);
    block_mma_kernel<CHROMA><<<grid, MMA_WARPS * 32, MMA_SMEM, stream>>>(
        blk, static_cast<const float*>(tab), zz, qdq, nplanes, gh, gw, qac, scan, acf, r);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes by ops/xform_fused.py.  blocks:
// int32 (nplanes, gh, gw, 8, 8) with the given element strides (s_x = 1,
// the others multiples of 4, the base 16-byte aligned); tab: double, the 8x8
// cosine table then IRT2 (is_f64), or float32, the forward then the inverse
// 64x64 matrix in mma fragment order; zz: the zig-zag order (64 int32);
// kind: the DC kind grid (gh, gw) int32; dc (nplanes*gh*gw, int32 for
// float, double for is_f64): scratch for planes whose DC slots do not fit in
// shared memory;
// qdq (nplanes*gh*gw*2 int32): scratch; scan (nplanes, gh, gw, 64) i16; acf
// (nplanes, gh, gw) i8; r (nplanes, gh*8, gw*8): int32 for luma, float or
// double for chroma; at most MAX_CELLS blocks, planes of any height (the
// wrapper splits a larger call over its planes).  Returns cudaGetLastError()
// after the second launch (cudaErrorInvalidValue for a layout or size it
// does not take).
extern "C" int icsp_xform_fwd(const void* blocks, long long s_f, long long s_gy, long long s_gx,
                              long long s_y, long long s_x, int is_f64, int chroma,
                              const void* tab, const int* zz, const int* kind, int nplanes,
                              int gh, int gw, int qdc, int qac, void* dc, void* qdq, void* scan,
                              void* acf, void* r, void* stream) {
  if (s_x != 1 || (s_f | s_gy | s_gx | s_y) % 4 != 0 || reinterpret_cast<uintptr_t>(blocks) % 16 ||
      (long long)nplanes * gh * gw > MAX_CELLS)
    return (int)cudaErrorInvalidValue;
  const Blocks blk{static_cast<const int*>(blocks), s_f, s_gy, s_gx, s_y, s_x};
  auto st = static_cast<cudaStream_t>(stream);
  auto* q2 = static_cast<int2*>(qdq);
  auto* sc = static_cast<int16_t*>(scan);
  auto* af = static_cast<int8_t*>(acf);
  if (is_f64) {
    return chroma ? launch<double, true>(blk, tab, zz, kind, nplanes, gh, gw, qdc, qac, dc, q2,
                                         sc, af, r, st)
                  : launch<double, false>(blk, tab, zz, kind, nplanes, gh, gw, qdc, qac, dc, q2,
                                          sc, af, r, st);
  }
  return chroma ? launch<float, true>(blk, tab, zz, kind, nplanes, gh, gw, qdc, qac, dc, q2, sc,
                                      af, r, st)
                : launch<float, false>(blk, tab, zz, kind, nplanes, gh, gw, qdc, qac, dc, q2, sc,
                                       af, r, st);
}
