// Kernel A: the intra luma wavefront of the encoder, for sm_90a.
//
// Replaces: icspcodec_tpu/ops/pallas_intra.py::_intra_rows_fused (the
// Pallas TPU kernel behind intra_luma_scan_fused).  It computes exactly what
// the plain PyTorch version computes (engine/wavefront.py::
// intra_luma_scan_packed): per 8x8 luma block along the 2*gy+gx
// anti-diagonals, the 3-mode intra prediction chosen by SAE, the MPM flag and
// remainder bit, the forward DCT, the DC DPCM against the kind-coded
// neighbour predictor, luma quantization (truncation, C division), zig-zag,
// the AC-empty flag, dequantization, the inverse DCT and the clipped
// reconstruction.
//
// Precision.  float: the fast path, one 64x64 matrix product per transform
// (tables.fdct_matrix / idct_matrix), as the plain version; the kernel sums
// in float32 where the plain version on the card sums in float64, so
// quantizer ties may flip.  double: the exact path, the separable transform
// with every product rounded on its own and the sums in index order
// (__dmul_rn / __dadd_rn: nvcc would otherwise contract a multiply-add into
// an FMA), bit-identical to the plain version.
//
// Bound on this card.  For CIF300 (475,200 blocks) the kernel reads 30 MB of
// u8 pixels and writes 61 MB of i16 symbols, 1.4 MB of flags and 30 MB of
// recon: ~123 MB, 37 us at 3.35 TB/s.  The two transforms need, in their
// separable form, 2 passes x 64 outputs x 8 multiply-adds each: 4,096 flops
// a block, 1.9 GFLOP, 29 us at 67 TFLOP/s float32.  So the kernel is bound
// by bytes, at ~37 us.  The float path below spends four times those flops
// on the dense 64x64 products.  What paces it in practice is the chain of
// 114 dependent diagonals per frame.
//
// Design.  One CTA per frame walks the diagonals in a loop with a
// __syncthreads() between them; frames are independent, so 300 CTAs cover
// the card.  Each warp takes one block of the diagonal at a time, two
// coefficients per lane; SAEs and the AC flag are warp reductions, the
// transforms go through a per-warp 64-entry buffer in shared memory.  The
// only state a block leaves for later blocks is its right pixel column,
// bottom row, mode and dequantized DC, read by the blocks at most 3
// diagonals later: it lives in a ring of 4 slots per block row in shared
// memory (slot gx & 3), so the state is a few KB whatever the frame size.
// Within a diagonal a block writes slot gx & 3 of its row while the blocks
// of the row below read slots gx-3 .. gx-1 of it, so no two touch the same
// slot.  The TPU kernel's lane shear, rolls, 0/1 extraction matmuls,
// split-bf16 permutations and reciprocal division are not needed here.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

template <typename T> struct Rn;
template <> struct Rn<float> {
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
  static __device__ __forceinline__ int trunc_int(float a) { return __float2int_rz(a); }
};
template <> struct Rn<double> {
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
  static __device__ __forceinline__ int trunc_int(double a) { return __double2int_rz(a); }
};

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ int median3(int a, int b, int c) {
  const int m1 = max(b, c), m2 = max(a, c), m3 = max(a, b);
  return (a > b && a > c) ? m1 : ((b > a && b > c) ? m2 : m3);
}

__device__ __forceinline__ int dc_pred(int kind, int l, int ul, int u, int ur) {
  if (kind == 0) return 1024;
  if (kind == 1) return l;
  if (kind == 2) return u;
  if (kind == 3) return median3(l, ul, u);
  return median3(l, u, ur);
}

__device__ __forceinline__ int isign(int v) { return (v > 0) - (v < 0); }

// The mats table: float -> [fdct^T (64x64), idct^T (64x64)], each stored as
// m_t[k * 64 + o] = M[o][k] so that the lanes of a warp read consecutive
// words.  double -> the 8x8 cosine table ct[u * 8 + x], then IRT2.
template <typename T> struct Tables {
  static constexpr int size = std::is_same<T, double>::value ? 65 : 8192;
};

template <typename T>
__global__ void intra_luma_kernel(
    const uint8_t* __restrict__ orig, long long s_f, long long s_gy, long long s_gx,
    long long s_y, long long s_x, const int* __restrict__ kind,
    const T* __restrict__ mats, const int* __restrict__ zz, int gh, int gw, int qdc,
    int qac, int16_t* __restrict__ scan, int8_t* __restrict__ mpm,
    int8_t* __restrict__ mbit, int8_t* __restrict__ acf, uint8_t* __restrict__ recon) {
  using R = Rn<T>;
  constexpr bool EXACT = std::is_same<T, double>::value;
  constexpr int NM = Tables<T>::size;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int f = blockIdx.x;

  extern __shared__ __align__(16) unsigned char smem[];
  T* mat_s = reinterpret_cast<T*>(smem);
  T* ebuf = mat_s + NM + warp * 128;   // per warp: 64 coefficients ...
  T* tbuf = ebuf + 64;                 // ... and 64 for the separable stage
  int* zz_s = reinterpret_cast<int*>(mat_s + NM + nwarps * 128);
  int* qbuf = zz_s + 64 + warp * 64;
  int* md_ring = zz_s + 64 + nwarps * 64;        // (gh, 4) modes
  int* dq_ring = md_ring + gh * 4;               // (gh, 4) dequantized DCs
  uint8_t* rc_ring = reinterpret_cast<uint8_t*>(dq_ring + gh * 4);  // (gh, 4, 8)
  uint8_t* br_ring = rc_ring + gh * 32;                             // (gh, 4, 8)

  for (int i = threadIdx.x; i < NM; i += blockDim.x) mat_s[i] = mats[i];
  for (int i = threadIdx.x; i < 64; i += blockDim.x) zz_s[i] = zz[i];
  for (int i = threadIdx.x; i < gh * 4; i += blockDim.x) md_ring[i] = dq_ring[i] = 0;
  for (int i = threadIdx.x; i < gh * 32; i += blockDim.x) rc_ring[i] = br_ring[i] = 0;
  __syncthreads();

  const int W = gw * 8;
  const int i0 = lane, i1 = lane + 32;           // this lane's two coefficients
  const int y0 = i0 >> 3, y1 = y0 + 4, xx = i0 & 7;
  const int nsteps = 2 * (gh - 1) + gw;

  for (int d = 0; d < nsteps; ++d) {
    const int lo = d - gw + 1 > 0 ? (d - gw + 2) / 2 : 0;
    const int hi = min(gh - 1, d / 2);
    for (int gy = lo + warp; gy <= hi; gy += nwarps) {
      const int gx = d - 2 * gy;
      __syncwarp();  // the warp's buffers are free again
      const bool hu = gy > 0, hl = gx > 0, first = !hu && !hl;
      const int gyu = hu ? gy - 1 : 0;
      const int sl = (gx - 1) & 3, sc = gx & 3, sr = (gx + 1 < gw ? gx + 1 : gw - 1) & 3;
      const uint8_t* lcol = rc_ring + (gy * 4 + sl) * 8;
      const uint8_t* urow = br_ring + (gyu * 4 + sc) * 8;
      int lsum = 0, usum = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) { lsum += lcol[k]; usum += urow[k]; }
      if (!hl) lsum = 1024;
      if (!hu) usum = 1024;
      const int up_x = urow[xx], lf_0 = lcol[y0], lf_1 = lcol[y1];

      const uint8_t* ob = orig + f * s_f + gy * s_gy + gx * s_gx;
      const int cur0 = ob[y0 * s_y + xx * s_x], cur1 = ob[y1 * s_y + xx * s_x];

      // --- candidate residuals and SAEs ---
      const int e0a = cur0 - up_x, e0b = cur1 - up_x;
      const int e1a = cur0 - lf_0, e1b = cur1 - lf_1;
      const int d16a = 16 * cur0 - (lsum + usum), d16b = 16 * cur1 - (lsum + usum);
      const int e2a = isign(d16a) * (abs(d16a) / 16), e2b = isign(d16b) * (abs(d16b) / 16);
      const int sae0 = warp_sum(abs(e0a) + abs(e0b));
      const int sae1 = warp_sum(abs(e1a) + abs(e1b));
      const int sae2 = warp_sum(abs(e2a) + abs(e2b));
      int mode;
      if (first) mode = 2;
      else if (hu && hl) mode = (sae0 <= sae1 && sae0 <= sae2) ? 0 : (sae1 <= sae2 ? 1 : 2);
      else if (hl) mode = sae2 > sae1 ? 1 : 2;
      else mode = sae2 > sae0 ? 0 : 2;
      const int erra = mode == 0 ? e0a : (mode == 1 ? e1a : e2a);
      const int errb = mode == 0 ? e0b : (mode == 1 ? e1b : e2b);

      // --- MPM flag / remainder bit ---
      const int l_md = md_ring[gy * 4 + sl], u_md = md_ring[gyu * 4 + sc];
      const int ul_md = md_ring[gyu * 4 + sl];
      const int pred_mode = (hu && hl) ? median3(l_md, ul_md, u_md) : (hl ? l_md : u_md);
      const int flag = (mode == pred_mode) && !first;
      const int bit = (flag || first) ? 0 : (pred_mode == 2 ? mode == 1 : mode == 2);

      // --- forward DCT ---
      ebuf[i0] = (T)erra;
      ebuf[i1] = (T)errb;
      __syncwarp();
      T da, db;
      if constexpr (EXACT) {
        const T* ct = mat_s;
        // t1[v][u] = sum_x e[v][x] * ct[u][x]
        T ta = R::mul(ebuf[y0 * 8], ct[xx * 8]), tb = R::mul(ebuf[y1 * 8], ct[xx * 8]);
#pragma unroll
        for (int x = 1; x < 8; ++x) {
          ta = R::add(ta, R::mul(ebuf[y0 * 8 + x], ct[xx * 8 + x]));
          tb = R::add(tb, R::mul(ebuf[y1 * 8 + x], ct[xx * 8 + x]));
        }
        tbuf[i0] = ta;
        tbuf[i1] = tb;
        __syncwarp();
        // out[v][u] = sum_y t1[y][u] * ct[v][y], then the irt2 and 1/4 weights
        da = R::mul(tbuf[xx], ct[y0 * 8]);
        db = R::mul(tbuf[xx], ct[y1 * 8]);
#pragma unroll
        for (int y = 1; y < 8; ++y) {
          da = R::add(da, R::mul(tbuf[y * 8 + xx], ct[y0 * 8 + y]));
          db = R::add(db, R::mul(tbuf[y * 8 + xx], ct[y1 * 8 + y]));
        }
        const T irt2 = ct[64];
        if (y0 == 0) da = R::mul(da, irt2);
        if (xx == 0) { da = R::mul(da, irt2); db = R::mul(db, irt2); }
        da = R::mul(da, (T)0.25);
        db = R::mul(db, (T)0.25);
      } else {
        const T* mf = mat_s;
        da = 0; db = 0;
#pragma unroll 8
        for (int k = 0; k < 64; ++k) {
          const T e = ebuf[k];
          da += mf[k * 64 + i0] * e;
          db += mf[k * 64 + i1] * e;
        }
      }

      // --- DC DPCM, quantization, dequantization ---
      const int l_dq = dq_ring[gy * 4 + sl], u_dq = dq_ring[gyu * 4 + sc];
      const int ul_dq = dq_ring[gyu * 4 + sl], ur_dq = dq_ring[gyu * 4 + sr];
      const int pred = dc_pred(kind[gy * gw + gx], l_dq, ul_dq, u_dq, ur_dq);
      if (i0 == 0) da = R::sub(da, (T)pred);   // (d - pred) + 0.5, the C order
      const int qa = R::trunc_int(R::add(da, (T)0.5)) / (i0 == 0 ? qdc : qac);
      const int qb = R::trunc_int(R::add(db, (T)0.5)) / qac;
      const int iqa = i0 == 0 ? qa * qdc + pred : qa * qac;
      const int iqb = qb * qac;
      const int new_dq = __shfl_sync(FULL, iqa, 0);
      const int empty = !__any_sync(FULL, (i0 != 0 && qa != 0) || qb != 0);
      __syncwarp();  // every lane is done reading ebuf / tbuf
      qbuf[i0] = qa;
      qbuf[i1] = qb;
      ebuf[i0] = (T)iqa;
      ebuf[i1] = (T)iqb;
      __syncwarp();

      const long long blk = ((long long)f * gh + gy) * gw + gx;
      scan[blk * 64 + i0] = (int16_t)qbuf[zz_s[i0]];
      scan[blk * 64 + i1] = (int16_t)qbuf[zz_s[i1]];

      // --- inverse DCT ---
      T ra, rb;
      if constexpr (EXACT) {
        const T* ct = mat_s;
        const T irt2 = ct[64];
        // t1[r][x] = sum_u (iq[r][u] * cu[u]) * ct[u][x];  n = t1 * cu[r]
        T ta = R::mul(R::mul(ebuf[y0 * 8], irt2), ct[xx]);
        T tb = R::mul(R::mul(ebuf[y1 * 8], irt2), ct[xx]);
#pragma unroll
        for (int u = 1; u < 8; ++u) {
          ta = R::add(ta, R::mul(R::mul(ebuf[y0 * 8 + u], (T)1.0), ct[u * 8 + xx]));
          tb = R::add(tb, R::mul(R::mul(ebuf[y1 * 8 + u], (T)1.0), ct[u * 8 + xx]));
        }
        if (y0 == 0) ta = R::mul(ta, irt2);
        tbuf[i0] = ta;
        tbuf[i1] = tb;
        __syncwarp();
        // out[y][x] = sum_v n[v][x] * ct[v][y], then 1/4
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
        const T* mi = mat_s + 4096;
        ra = 0; rb = 0;
#pragma unroll 8
        for (int k = 0; k < 64; ++k) {
          const T e = ebuf[k];
          ra += mi[k * 64 + i0] * e;
          rb += mi[k * 64 + i1] * e;
        }
      }

      // --- pixel reconstruction ---
      T pa, pb;
      if (mode == 0) {
        pa = pb = (T)(hu ? up_x : 128);
      } else if (mode == 1) {
        pa = (T)(hl ? lf_0 : 128);
        pb = (T)(hl ? lf_1 : 128);
      } else {
        pa = pb = R::div((T)(lsum + usum), (T)16.0);
      }
      const int reca = min(max(R::trunc_int(R::add(ra, pa)), 0), 255);
      const int recb = min(max(R::trunc_int(R::add(rb, pb)), 0), 255);
      if (recon != nullptr) {
        uint8_t* rp = recon + (long long)f * (gh * 8) * W + (long long)(gy * 8) * W + gx * 8;
        rp[y0 * W + xx] = (uint8_t)reca;
        rp[y1 * W + xx] = (uint8_t)recb;
      }

      // --- boundary state for the later diagonals, and the flags ---
      uint8_t* rcs = rc_ring + (gy * 4 + sc) * 8;
      uint8_t* brs = br_ring + (gy * 4 + sc) * 8;
      if (xx == 7) { rcs[y0] = (uint8_t)reca; rcs[y1] = (uint8_t)recb; }
      if (y1 == 7) brs[xx] = (uint8_t)recb;
      if (lane == 0) {
        md_ring[gy * 4 + sc] = mode;
        dq_ring[gy * 4 + sc] = new_dq;
        mpm[blk] = (int8_t)flag;
        mbit[blk] = (int8_t)bit;
        acf[blk] = (int8_t)empty;
      }
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const void* orig, long long s_f, long long s_gy, long long s_gx, long long s_y,
           long long s_x, const int* kind, const void* mats, const int* zz, int nframes,
           int gh, int gw, int qdc, int qac, int16_t* scan, int8_t* mpm, int8_t* mbit,
           int8_t* acf, uint8_t* recon, cudaStream_t stream) {
  const int nmax = min(gh, (gw + 1) / 2);      // longest diagonal
  const int nwarps = max(1, min(16, (nmax + 1) / 2));
  const size_t smem = sizeof(T) * (Tables<T>::size + nwarps * 128) +
                      sizeof(int) * (64 + nwarps * 64 + gh * 8) + gh * 64;
  cudaError_t err = cudaFuncSetAttribute(
      intra_luma_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  intra_luma_kernel<T><<<nframes, nwarps * 32, smem, stream>>>(
      static_cast<const uint8_t*>(orig), s_f, s_gy, s_gx, s_y, s_x, kind,
      static_cast<const T*>(mats), zz, gh, gw, qdc, qac, scan, mpm, mbit, acf, recon);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes by ops/intra_fused.py.  orig is u8
// blocks (F, gh, gw, 8, 8) with the given element strides; scan (F, gh, gw,
// 64) i16; mpm / mbit / acf (F, gh, gw) i8; recon (F, gh*8, gw*8) u8 or
// null.  Returns cudaGetLastError() after the launch.
extern "C" int icsp_intra_luma(const void* orig, long long s_f, long long s_gy,
                               long long s_gx, long long s_y, long long s_x, int is_f64,
                               const int* kind, const void* mats, const int* zz,
                               int nframes, int gh, int gw, int qdc, int qac, void* scan,
                               void* mpm, void* mbit, void* acf, void* recon,
                               void* stream) {
  auto* sc = static_cast<int16_t*>(scan);
  auto* mp = static_cast<int8_t*>(mpm);
  auto* mb = static_cast<int8_t*>(mbit);
  auto* af = static_cast<int8_t*>(acf);
  auto* rc = static_cast<uint8_t*>(recon);
  auto st = static_cast<cudaStream_t>(stream);
  if (is_f64)
    return launch<double>(orig, s_f, s_gy, s_gx, s_y, s_x, kind, mats, zz, nframes, gh, gw,
                          qdc, qac, sc, mp, mb, af, rc, st);
  return launch<float>(orig, s_f, s_gy, s_gx, s_y, s_x, kind, mats, zz, nframes, gh, gw, qdc,
                       qac, sc, mp, mb, af, rc, st);
}
