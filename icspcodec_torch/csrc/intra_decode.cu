// Kernel C: the intra luma decode wavefront, for sm_90a.
//
// Replaces: icspcodec_tpu/ops/pallas_intra.py::_intra_decode_rows_fused (the
// Pallas TPU kernel behind intra_luma_decode_fused).  It computes exactly
// what the plain PyTorch version computes (ops/intra_decode_fused.py::
// intra_luma_decode_plain: inverse zig-zag, dequantization,
// engine/wavefront.py::idc_dpcm_scan, the inverse DCT and
// intra_luma_decode_scan_packed): per 8x8 luma block along the 2*gy+gx
// anti-diagonals, the inverse zig-zag of the int16 symbols, dequantization
// with the DC predicted from the kind-coded neighbour DCs, the separable
// inverse DCT, the mode from the MPM flag and remainder bit, and the
// clipped pixel reconstruction from the reconstructed neighbours.
//
// Precision.  Both paths run the separable transform of the reference's C
// loops with every product rounded on its own and the sums in index order
// (__dmul_rn / __dadd_rn, __fmul_rn / __fadd_rn: nvcc would otherwise
// contract a multiply-add into an FMA).  double: the exact path,
// bit-identical to the plain version.  float: the fast path; the plain
// version on the card takes the 64x64 matrix product summed in float64 and
// rounded once, so a pixel on a truncation boundary may differ by one.
//
// Bound on this card.  For CIF300 (475,200 blocks) the kernel reads 60.8 MB
// of i16 symbols and 0.95 MB of flags and writes 30.4 MB of recon: ~92 MB,
// 28 us at 3.35 TB/s.  The separable inverse DCT is 2 passes x 64 outputs x
// 8 multiply-adds: 2,048 flops a block, 0.97 GFLOP, 15 us at 67 TFLOP/s
// float32.  So it is bound by bytes.  What paces it in practice is the
// chain of 114 dependent diagonals per frame.
//
// Design.  Kernel A's frame: one CTA per frame walks the diagonals with a
// __syncthreads() between them; each warp takes one block of the diagonal at
// a time, two coefficients per lane, the transform passes through a per-warp
// buffer in shared memory.  A block leaves its right pixel column, bottom
// row, mode and dequantized DC for the blocks at most 3 diagonals later, in
// a ring of 4 slots per block row in shared memory (slot gx & 3): within a
// diagonal a block writes slot gx & 3 of its row while the blocks of the row
// below read slots gx-1 .. gx+1 of it, so no two touch the same slot.  The
// TPU kernel's lane shear, rolls, 0/1 extraction and split permutation
// matmuls are not needed here.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T> struct Rn;
template <> struct Rn<float> {
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
  static __device__ __forceinline__ int trunc_int(float a) { return __float2int_rz(a); }
};
template <> struct Rn<double> {
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
  static __device__ __forceinline__ int trunc_int(double a) { return __double2int_rz(a); }
};

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_WARPS = 24;

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

// tabs: the 8x8 cosine table ct[u * 8 + x], then IRT2, in T.
template <typename T>
__global__ void __launch_bounds__(MAX_WARPS * 32) intra_decode_kernel(
    const int16_t* __restrict__ scan, const int8_t* __restrict__ mpm,
    const int8_t* __restrict__ mbit, const int* __restrict__ kind,
    const T* __restrict__ tabs, const int* __restrict__ izz, int gh, int gw, int qdc, int qac,
    uint8_t* __restrict__ recon) {
  using R = Rn<T>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int f = blockIdx.x;

  extern __shared__ __align__(16) unsigned char smem[];
  T* ct = reinterpret_cast<T*>(smem);            // 65 entries
  T* ebuf = ct + 72 + warp * 128;                // per warp: 64 coefficients ...
  T* tbuf = ebuf + 64;                           // ... and 64 for the second pass
  int* izz_s = reinterpret_cast<int*>(ct + 72 + nwarps * 128);
  int* md_ring = izz_s + 64;                     // (gh, 4) modes
  int* dq_ring = md_ring + gh * 4;               // (gh, 4) dequantized DCs
  uint8_t* rc_ring = reinterpret_cast<uint8_t*>(dq_ring + gh * 4);  // (gh, 4, 8)
  uint8_t* br_ring = rc_ring + gh * 32;                             // (gh, 4, 8)

  for (int i = threadIdx.x; i < 65; i += blockDim.x) ct[i] = tabs[i];
  for (int i = threadIdx.x; i < 64; i += blockDim.x) izz_s[i] = izz[i];
  for (int i = threadIdx.x; i < gh * 4; i += blockDim.x) md_ring[i] = dq_ring[i] = 0;
  for (int i = threadIdx.x; i < gh * 32; i += blockDim.x) rc_ring[i] = br_ring[i] = 0;
  __syncthreads();

  const int W = gw * 8;
  const int i0 = lane, i1 = lane + 32;           // this lane's two coefficients
  const int y0 = i0 >> 3, y1 = y0 + 4, xx = i0 & 7;
  const int nsteps = 2 * (gh - 1) + gw;
  const T irt2 = ct[64];

  for (int d = 0; d < nsteps; ++d) {
    const int lo = d - gw + 1 > 0 ? (d - gw + 2) / 2 : 0;
    const int hi = min(gh - 1, d / 2);
    for (int gy = lo + warp; gy <= hi; gy += nwarps) {
      const int gx = d - 2 * gy;
      __syncwarp();  // the warp's buffers are free again
      const long long blk = ((long long)f * gh + gy) * gw + gx;
      const int qa = scan[blk * 64 + izz_s[i0]];
      const int qb = scan[blk * 64 + izz_s[i1]];
      const bool hu = gy > 0, hl = gx > 0, first = !hu && !hl;
      const int gyu = hu ? gy - 1 : 0;
      const int sl = (gx - 1) & 3, sc = gx & 3, sr = (gx + 1 < gw ? gx + 1 : gw - 1) & 3;

      // --- dequantization with the DC chain ---
      const int l_dq = dq_ring[gy * 4 + sl], u_dq = dq_ring[gyu * 4 + sc];
      const int ul_dq = dq_ring[gyu * 4 + sl], ur_dq = dq_ring[gyu * 4 + sr];
      const int pred = dc_pred(kind[gy * gw + gx], l_dq, ul_dq, u_dq, ur_dq);
      const int iqa = i0 == 0 ? qa * qdc + pred : qa * qac;
      const int iqb = qb * qac;
      ebuf[i0] = (T)iqa;
      ebuf[i1] = (T)iqb;
      __syncwarp();

      // --- inverse DCT: t1[r][x] = sum_u (iq[r][u] * cu[u]) * ct[u][x];
      //     n = t1 * cu[r]; out[y][x] = sum_v n[v][x] * ct[v][y] / 4 ---
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
      T ra = R::mul(tbuf[xx], ct[y0]);
      T rb = R::mul(tbuf[xx], ct[y1]);
#pragma unroll
      for (int v = 1; v < 8; ++v) {
        ra = R::add(ra, R::mul(tbuf[v * 8 + xx], ct[v * 8 + y0]));
        rb = R::add(rb, R::mul(tbuf[v * 8 + xx], ct[v * 8 + y1]));
      }
      ra = R::mul(ra, (T)0.25);
      rb = R::mul(rb, (T)0.25);

      // --- mode from the MPM flag and the remainder bit ---
      const int l_md = md_ring[gy * 4 + sl], u_md = md_ring[gyu * 4 + sc];
      const int ul_md = md_ring[gyu * 4 + sl];
      const int pred_mode = (hu && hl) ? median3(l_md, ul_md, u_md) : (hl ? l_md : u_md);
      const int fl = mpm[blk], bt = mbit[blk];
      int mode;
      if (first) mode = 2;
      else if (fl == 1) mode = pred_mode;
      else if (bt == 0) mode = pred_mode == 0 ? 1 : 0;
      else mode = pred_mode == 2 ? 1 : 2;

      // --- pixel reconstruction ---
      const uint8_t* lcol = rc_ring + (gy * 4 + sl) * 8;
      const uint8_t* urow = br_ring + (gyu * 4 + sc) * 8;
      T pa, pb;
      if (mode == 0) {
        pa = pb = (T)(hu ? urow[xx] : 128);
      } else if (mode == 1) {
        pa = (T)(hl ? lcol[y0] : 128);
        pb = (T)(hl ? lcol[y1] : 128);
      } else {
        int lsum = 0, usum = 0;
#pragma unroll
        for (int k = 0; k < 8; ++k) { lsum += lcol[k]; usum += urow[k]; }
        if (!hl) lsum = 1024;
        if (!hu) usum = 1024;
        pa = pb = R::div((T)(lsum + usum), (T)16.0);
      }
      const int reca = min(max(R::trunc_int(R::add(ra, pa)), 0), 255);
      const int recb = min(max(R::trunc_int(R::add(rb, pb)), 0), 255);
      uint8_t* rp = recon + (long long)f * (gh * 8) * W + (long long)(gy * 8) * W + gx * 8;
      rp[y0 * W + xx] = (uint8_t)reca;
      rp[y1 * W + xx] = (uint8_t)recb;

      // --- boundary state for the later diagonals ---
      const int new_dq = __shfl_sync(FULL, iqa, 0);
      uint8_t* rcs = rc_ring + (gy * 4 + sc) * 8;
      uint8_t* brs = br_ring + (gy * 4 + sc) * 8;
      if (xx == 7) { rcs[y0] = (uint8_t)reca; rcs[y1] = (uint8_t)recb; }
      if (y1 == 7) brs[xx] = (uint8_t)recb;
      if (lane == 0) {
        md_ring[gy * 4 + sc] = mode;
        dq_ring[gy * 4 + sc] = new_dq;
      }
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const int16_t* scan, const int8_t* mpm, const int8_t* mbit, const int* kind,
           const void* tabs, const int* izz, int nframes, int gh, int gw, int qdc, int qac,
           uint8_t* recon, cudaStream_t stream) {
  const int nmax = min(gh, (gw + 1) / 2);      // longest diagonal
  const int nwarps = max(1, min(MAX_WARPS, nmax));
  const size_t smem = sizeof(T) * (72 + nwarps * 128) + sizeof(int) * (64 + gh * 8) + gh * 64;
  cudaError_t err = cudaFuncSetAttribute(
      intra_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  intra_decode_kernel<T><<<nframes, nwarps * 32, smem, stream>>>(
      scan, mpm, mbit, kind, static_cast<const T*>(tabs), izz, gh, gw, qdc, qac, recon);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes by ops/intra_decode_fused.py.  scan
// is (F, gh, gw, 64) i16 in zig-zag order, mpm / mbit (F, gh, gw) i8, kind
// (gh, gw) i32, tabs the cosine table and IRT2 (65 floats or doubles), izz
// the 64 scan positions of the block-order coefficients, recon (F, gh*8,
// gw*8) u8; all contiguous.  Returns cudaGetLastError() after the launch.
extern "C" int icsp_intra_decode(const void* scan, const void* mpm, const void* mbit,
                                 int is_f64, const int* kind, const void* tabs,
                                 const int* izz, int nframes, int gh, int gw, int qdc,
                                 int qac, void* recon, void* stream) {
  auto* sc = static_cast<const int16_t*>(scan);
  auto* mp = static_cast<const int8_t*>(mpm);
  auto* mb = static_cast<const int8_t*>(mbit);
  auto* rc = static_cast<uint8_t*>(recon);
  auto st = static_cast<cudaStream_t>(stream);
  if (is_f64)
    return launch<double>(sc, mp, mb, kind, tabs, izz, nframes, gh, gw, qdc, qac, rc, st);
  return launch<float>(sc, mp, mb, kind, tabs, izz, nframes, gh, gw, qdc, qac, rc, st);
}
