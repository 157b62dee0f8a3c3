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
// idct_matrix) with products and sums in double, rounded once to float; the
// kernel does the same, summing the 64 exact products in index order, so it
// differs from the plain version only where the two double sums round to
// different floats.  That matters beyond the symbols: the decoder's inverse
// transform is the plain one, and an AC-empty block's IDCT lands on whole
// numbers (at QP 16: dq / 8), so a float path of other rounding (the
// separable one, say) truncates such blocks one lower than the decoder does
// and the encoder's reference frames drift from the decoder's over a GOP.
//
// Bound on this card.  One luma call of a CIF P-step (30 frames, 47,520
// blocks) reads 12.2 MB of int32 residuals and writes 6.1 MB of int16
// symbols, 12.2 MB of int32 r and 0.05 MB of flags: ~30 MB, 9 us at
// 3.35 TB/s.  Its transforms in separable form are 4,096 flops a block,
// 0.19 GFLOP, 3 us at 67 TFLOP/s float32.  So bytes bound it.  The float
// path spends 4x those operations on the dense products, in double.  The
// DC chain of 114 dependent diagonals (CIF luma) paces the middle phase.
//
// Design.  Three launches on the caller's stream: (1) one thread per
// block computes only the DCT's DC term into a scratch array; (2) one warp
// per plane walks the DC chain as kernel B does (csrc/dc_dpcm.cu: a ring of
// 4 slots per block row in shared memory), writing each block's q and dq
// to scratch; (3) one warp per block runs the whole transform chain with
// two coefficients a lane, taking its DC symbols from the scratch; its CTAs
// stride over the blocks, so each loads the transform tables once.  Only
// phase 2 is serial, and it handles one number a block.  The TPU kernel's
// shear layout, rolls, 0/1 extraction and split permutation matmuls are
// not needed here.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

template <typename T> struct Rn;
template <> struct Rn<float> {
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
};
template <> struct Rn<double> {
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
};

constexpr unsigned FULL = 0xffffffffu;
constexpr int CHAIN_WARPS = 4;   // planes per CTA of phase 2
constexpr int BLOCK_WARPS = 8;   // blocks per CTA of phase 3
constexpr int DC_THREADS = 256;

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

struct Blocks {  // int32 blocks (F, gh, gw, 8, 8) with element strides
  const int* p;
  long long s_f, s_gy, s_gx, s_y, s_x;
  __device__ __forceinline__ const int* at(int f, int gy, int gx) const {
    return p + f * s_f + gy * s_gy + gx * s_gx;
  }
};

// The transform tables: double -> the 8x8 cosine table ct[u * 8 + x], then
// IRT2 (65 values); float -> the float32 64x64 forward and inverse matrices,
// transposed (m_t[k * 64 + o] = M[o][k]; 8,192 values).
template <typename T> struct Tables {
  static constexpr int size = std::is_same<T, double>::value ? 65 : 8192;
};

// (float) of sum_k m_t[k * 64 + o] * v[k] in double, k in index order: each
// product of a float32 matrix entry and an integer-valued v is exact in
// double, so only the sum rounds
__device__ __forceinline__ float dense_f64(const float* m_t, const float* v, int o) {
  double s = 0.0;
#pragma unroll 8
  for (int k = 0; k < 64; ++k) s = __dadd_rn(s, __dmul_rn((double)m_t[k * 64 + o], (double)v[k]));
  return (float)s;
}

// Phase 1: the DC term of each block's forward DCT.  double:
//   ((sum_y t1[y][0] * ct[0][y]) * irt2) * irt2 * 0.25,
//   t1[y][0] = sum_x e[y][x] * ct[0][x],
// in the order of the full separable transform below; float: row 0 of the
// dense product, as dense_f64.
template <typename T>
__global__ void dc_kernel(Blocks blk, const T* __restrict__ tab, int nplanes, int gh, int gw,
                          T* __restrict__ dc) {
  using R = Rn<T>;
  const long long cell = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= (long long)nplanes * gh * gw) return;
  const int f = (int)(cell / (gh * gw)), gy = (int)(cell / gw % gh), gx = (int)(cell % gw);
  const int* e = blk.at(f, gy, gx);
  if constexpr (std::is_same<T, double>::value) {
    const T* ct = tab;
    T acc = 0;
#pragma unroll
    for (int y = 0; y < 8; ++y) {
      T t = R::mul((T)e[y * blk.s_y], ct[0]);
#pragma unroll
      for (int x = 1; x < 8; ++x) t = R::add(t, R::mul((T)e[y * blk.s_y + x * blk.s_x], ct[x]));
      const T p = R::mul(t, ct[y]);
      acc = y == 0 ? p : R::add(acc, p);
    }
    const T irt2 = ct[64];
    dc[cell] = R::mul(R::mul(R::mul(acc, irt2), irt2), (T)0.25);
  } else {
    double s = 0.0;
#pragma unroll 8
    for (int k = 0; k < 64; ++k)
      s = __dadd_rn(s, __dmul_rn((double)tab[k * 64], (double)e[(k >> 3) * blk.s_y + (k & 7) * blk.s_x]));
    dc[cell] = (float)s;
  }
}

// Phase 2: the DC chain, one warp per plane along the diagonals, with the
// dequantized DCs that later cells read in a ring of 4 slots per block row
// (slot gx & 3), as kernel B.  Writes qdq[cell] = (q, dq).
template <typename T, bool CHROMA>
__global__ void chain_kernel(const T* __restrict__ dc, const int* __restrict__ kind,
                             int nplanes, int gh, int gw, int qdc, int2* __restrict__ qdq) {
  using R = Rn<T>;
  extern __shared__ int ring_all[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int plane = blockIdx.x * CHAIN_WARPS + warp;
  if (plane >= nplanes) return;  // whole warps only: no block barrier follows
  int* ring = ring_all + warp * gh * 4;
  for (int i = lane; i < gh * 4; i += 32) ring[i] = 0;
  __syncwarp();
  const long long base = (long long)plane * gh * gw;
  const int nsteps = 2 * (gh - 1) + gw;
  for (int d = 0; d < nsteps; ++d) {
    const int lo = d - gw + 1 > 0 ? (d - gw + 2) / 2 : 0;
    const int hi = min(gh - 1, d / 2);
    for (int gy = lo + lane; gy <= hi; gy += 32) {
      const int gx = d - 2 * gy;
      const int gyu = gy > 0 ? gy - 1 : 0;
      const int sl = (gx - 1) & 3, sc = gx & 3, sr = (gx + 1 < gw ? gx + 1 : gw - 1) & 3;
      const int l = ring[gy * 4 + sl], u = ring[gyu * 4 + sc];
      const int ul = ring[gyu * 4 + sl], ur = ring[gyu * 4 + sr];
      const int k = kind[gy * gw + gx];
      const int pred = k == 0 ? 1024 : k == 1 ? l : k == 2 ? u
                     : k == 3 ? median3(l, ul, u) : median3(l, u, ur);
      const long long c = base + gy * gw + gx;
      const int qv = round_q<T, CHROMA>(R::add(R::sub(dc[c], (T)pred), (T)0.5)) / qdc;
      const int dqv = qv * qdc + pred;
      qdq[c] = make_int2(qv, dqv);
      ring[gy * 4 + sc] = dqv;
    }
    __syncwarp();
  }
}

// Phase 3: one warp per block, two coefficients a lane (i0 = lane, i1 =
// lane + 32; row y0 / y0 + 4, column xx): the forward DCT, the quantizer
// with the chain's DC, zig-zag, the AC-empty flag, dequantization and the
// inverse DCT.  The CTA's warps stride over the blocks.
template <typename T, bool CHROMA>
__global__ void __launch_bounds__(BLOCK_WARPS * 32)
block_kernel(Blocks blk, const T* __restrict__ tab_g, const int* __restrict__ zz_g,
             const int2* __restrict__ qdq, int nplanes, int gh, int gw, int qac,
             int16_t* __restrict__ scan, int8_t* __restrict__ acf, void* __restrict__ r_out) {
  using R = Rn<T>;
  constexpr bool EXACT = std::is_same<T, double>::value;
  constexpr int NT = Tables<T>::size;
  extern __shared__ __align__(16) unsigned char smem[];
  T* tab = reinterpret_cast<T*>(smem);
  __shared__ int zz[64];
  __shared__ T ebuf_all[BLOCK_WARPS][64];
  __shared__ T tbuf_all[BLOCK_WARPS][64];
  __shared__ int qbuf_all[BLOCK_WARPS][64];
  for (int i = threadIdx.x; i < NT; i += blockDim.x) tab[i] = tab_g[i];
  for (int i = threadIdx.x; i < 64; i += blockDim.x) zz[i] = zz_g[i];
  __syncthreads();  // the last block barrier: warps run on their own below
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T* ebuf = ebuf_all[warp];
  T* tbuf = tbuf_all[warp];
  int* qbuf = qbuf_all[warp];
  const int i0 = lane, i1 = lane + 32, y0 = i0 >> 3, y1 = y0 + 4, xx = i0 & 7;
  const long long ncell = (long long)nplanes * gh * gw;
  const long long W = (long long)gw * 8;

  for (long long cell = (long long)blockIdx.x * BLOCK_WARPS + warp; cell < ncell;
       cell += (long long)gridDim.x * BLOCK_WARPS) {
    const int f = (int)(cell / (gh * gw)), gy = (int)(cell / gw % gh), gx = (int)(cell % gw);
    const int* e = blk.at(f, gy, gx);
    __syncwarp();  // the warp's buffers are free again
    ebuf[i0] = (T)e[y0 * blk.s_y + xx * blk.s_x];
    ebuf[i1] = (T)e[y1 * blk.s_y + xx * blk.s_x];
    __syncwarp();

    // --- forward DCT ---
    T da, db;
    if constexpr (EXACT) {
      // t1[v][u] = sum_x e[v][x] * ct[u][x]; out[v][u] = sum_y t1[y][u] *
      // ct[v][y]; then the irt2 weights and 1/4
      const T* ct = tab;
      const T irt2 = ct[64];
      T ta = R::mul(ebuf[y0 * 8], ct[xx * 8]), tb = R::mul(ebuf[y1 * 8], ct[xx * 8]);
#pragma unroll
      for (int x = 1; x < 8; ++x) {
        ta = R::add(ta, R::mul(ebuf[y0 * 8 + x], ct[xx * 8 + x]));
        tb = R::add(tb, R::mul(ebuf[y1 * 8 + x], ct[xx * 8 + x]));
      }
      tbuf[i0] = ta;
      tbuf[i1] = tb;
      __syncwarp();
      da = R::mul(tbuf[xx], ct[y0 * 8]);
      db = R::mul(tbuf[xx], ct[y1 * 8]);
#pragma unroll
      for (int y = 1; y < 8; ++y) {
        da = R::add(da, R::mul(tbuf[y * 8 + xx], ct[y0 * 8 + y]));
        db = R::add(db, R::mul(tbuf[y * 8 + xx], ct[y1 * 8 + y]));
      }
      if (y0 == 0) da = R::mul(da, irt2);
      if (xx == 0) { da = R::mul(da, irt2); db = R::mul(db, irt2); }
      da = R::mul(da, (T)0.25);
      db = R::mul(db, (T)0.25);
    } else {
      da = dense_f64(tab, ebuf, i0);
      db = dense_f64(tab, ebuf, i1);
    }

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
    scan[cell * 64 + i0] = (int16_t)qbuf[zz[i0]];
    scan[cell * 64 + i1] = (int16_t)qbuf[zz[i1]];
    if (lane == 0) acf[cell] = (int8_t)empty;

    // --- inverse DCT ---
    T ra, rb;
    if constexpr (EXACT) {
      // t1[v][x] = sum_u (iq[v][u] * cu[u]) * ct[u][x]; n = t1 * cu[v];
      // out[y][x] = sum_v n[v][x] * ct[v][y]; then 1/4
      const T* ct = tab;
      const T irt2 = ct[64];
      T ta = R::mul(R::mul(ebuf[y0 * 8], irt2), ct[xx]);
      T tb = R::mul(R::mul(ebuf[y1 * 8], irt2), ct[xx]);
#pragma unroll
      for (int u = 1; u < 8; ++u) {
        ta = R::add(ta, R::mul(ebuf[y0 * 8 + u], ct[u * 8 + xx]));   // cu[u] = 1 is exact
        tb = R::add(tb, R::mul(ebuf[y1 * 8 + u], ct[u * 8 + xx]));
      }
      if (y0 == 0) ta = R::mul(ta, irt2);
      tbuf[i0] = ta;   // tbuf was last read before the barrier above
      tbuf[i1] = tb;
      __syncwarp();
      ra = R::mul(tbuf[xx], ct[y0]);
      rb = R::mul(tbuf[xx], ct[y1]);
#pragma unroll
      for (int v = 1; v < 8; ++v) {
        ra = R::add(ra, R::mul(tbuf[v * 8 + xx], ct[v * 8 + y0]));
        rb = R::add(rb, R::mul(tbuf[v * 8 + xx], ct[v * 8 + y1]));
      }
      ra = R::mul(ra, (T)0.25);
      rb = R::mul(rb, (T)0.25);
    } else {
      ra = dense_f64(tab + 4096, ebuf, i0);
      rb = dense_f64(tab + 4096, ebuf, i1);
    }

    // r as planes (F, gh*8, gw*8)
    const long long o = ((long long)f * gh * 8 + gy * 8) * W + gx * 8;
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

template <typename T, bool CHROMA>
int launch(const Blocks& blk, const T* tab, const int* zz, const int* kind, int nplanes, int gh,
           int gw, int qdc, int qac, T* dc, int2* qdq, int16_t* scan, int8_t* acf, void* r,
           cudaStream_t stream) {
  const long long ncell = (long long)nplanes * gh * gw;
  dc_kernel<T><<<(unsigned)((ncell + DC_THREADS - 1) / DC_THREADS), DC_THREADS, 0, stream>>>(
      blk, tab, nplanes, gh, gw, dc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  chain_kernel<T, CHROMA><<<(nplanes + CHAIN_WARPS - 1) / CHAIN_WARPS, CHAIN_WARPS * 32,
                            sizeof(int) * CHAIN_WARPS * gh * 4, stream>>>(
      dc, kind, nplanes, gh, gw, qdc, qdq);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  int dev = 0, nsm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long nblk = (ncell + BLOCK_WARPS - 1) / BLOCK_WARPS;
  const unsigned grid = (unsigned)(nblk < 4LL * nsm ? nblk : 4LL * nsm);
  block_kernel<T, CHROMA><<<grid, BLOCK_WARPS * 32, sizeof(T) * Tables<T>::size, stream>>>(
      blk, tab, zz, qdq, nplanes, gh, gw, qac, scan, acf, r);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes by ops/xform_fused.py.  blocks:
// int32 (nplanes, gh, gw, 8, 8) with the given element strides; tab: the
// transform tables (struct Tables above), double or float as is_f64 says;
// zz: the zig-zag order (64 int32); kind: the DC kind grid (gh, gw) int32; dc
// (nplanes*gh*gw, float or double) and qdq (nplanes*gh*gw*2 int32): scratch;
// scan (nplanes, gh, gw, 64) i16; acf (nplanes, gh, gw) i8; r (nplanes,
// gh*8, gw*8): int32 for luma, float or double for chroma.  Returns
// cudaGetLastError() after the last of the three launches.
extern "C" int icsp_xform_fwd(const void* blocks, long long s_f, long long s_gy, long long s_gx,
                              long long s_y, long long s_x, int is_f64, int chroma,
                              const void* tab, const int* zz, const int* kind, int nplanes,
                              int gh, int gw, int qdc, int qac, void* dc, void* qdq, void* scan,
                              void* acf, void* r, void* stream) {
  const Blocks blk{static_cast<const int*>(blocks), s_f, s_gy, s_gx, s_y, s_x};
  auto st = static_cast<cudaStream_t>(stream);
  auto* q2 = static_cast<int2*>(qdq);
  auto* sc = static_cast<int16_t*>(scan);
  auto* af = static_cast<int8_t*>(acf);
  if (is_f64) {
    auto* c = static_cast<const double*>(tab);
    auto* d = static_cast<double*>(dc);
    return chroma ? launch<double, true>(blk, c, zz, kind, nplanes, gh, gw, qdc, qac, d, q2, sc,
                                         af, r, st)
                  : launch<double, false>(blk, c, zz, kind, nplanes, gh, gw, qdc, qac, d, q2,
                                          sc, af, r, st);
  }
  auto* c = static_cast<const float*>(tab);
  auto* d = static_cast<float*>(dc);
  return chroma ? launch<float, true>(blk, c, zz, kind, nplanes, gh, gw, qdc, qac, d, q2, sc, af,
                                      r, st)
                : launch<float, false>(blk, c, zz, kind, nplanes, gh, gw, qdc, qac, d, q2, sc,
                                       af, r, st);
}
