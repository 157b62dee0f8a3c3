// Kernels B and B': the forward and inverse DC DPCM chains, for sm_90a.
//
// Replaces: icspcodec_tpu/ops/pallas_dc.py::_dc_rows_fused, in forward
// mode (B, behind dc_dpcm_fused) and with inverse=True (B', behind
// idc_dpcm_fused).  Each computes what its plain PyTorch version computes
// (engine/wavefront.py::dc_dpcm_scan / idc_dpcm_scan), expression for
// expression.  B, along the 2*gy+gx anti-diagonals of each plane,
//   resid = dc - pred(kind);  t = floor (chroma) or trunc (luma) of
//   resid + 0.5;  q = t / qstep (C division);  dq = q * qstep + pred,
// with pred the kind-coded predictor over the already dequantized
// neighbour DCs (0 -> 1024, 1 -> left, 2 -> up, 3 -> med(l, ul, u),
// 4 -> med(l, u, ur)).  Every step after the subtraction and the +0.5 is
// integer, and those two are rounded as IEEE operations (__fsub_rn, ...),
// so the kernel is bit-identical to the plain version in float and double.
// B' (the decoder) reads integer residuals iq and writes dq = iq + pred: all
// integer, bit-identical.
//
// Bound on this card.  For the CIF300 chroma batch (600 planes of 18x22) it
// reads 0.95 MB of float DCs and writes 1.9 MB of int32 q and dq: 2.85 MB,
// under 1 us at 3.35 TB/s.  The arithmetic is a few integer operations a
// cell.  What paces it is the chain of 56 dependent diagonals.  B' moves
// 8 bytes a cell (int32 in and out): 1.9 MB for the CIF300 intra chroma
// batch, 0.6 us; per inter step of 30 GOPs, 0.38 MB of luma and 0.19 MB of
// chroma.  It too is paced by its chain (114 diagonals for CIF luma).
//
// Design.  One warp per plane walks the diagonals, one cell per lane (lanes
// loop when a diagonal holds more than 32 cells), with a __syncwarp()
// between diagonals.  The dequantized DCs that later cells read sit in a
// ring of 4 slots per block row in shared memory (slot gx & 3): a cell reads
// slots gx-1 .. gx+1 of the row above and gx-1 of its own row, while the
// cell of the row above on the same diagonal writes slot gx+2, so no two
// touch the same slot.  The TPU kernel's shear layout and rolls are not
// needed here.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

__device__ __forceinline__ int median3(int a, int b, int c) {
  const int m1 = max(b, c), m2 = max(a, c), m3 = max(a, b);
  return (a > b && a > c) ? m1 : ((b > a && b > c) ? m2 : m3);
}

constexpr int WARPS = 4;  // planes per CTA

// The kind-coded predictor of cell (gy, gx) from the ring of dequantized
// DCs (slot gx & 3 of each block row).
__device__ __forceinline__ int ring_pred(const int* ring, int k, int gy, int gx, int gw) {
  const int gyu = gy > 0 ? gy - 1 : 0;
  const int sl = (gx - 1) & 3, sc = gx & 3, sr = (gx + 1 < gw ? gx + 1 : gw - 1) & 3;
  const int l = ring[gy * 4 + sl], u = ring[gyu * 4 + sc];
  const int ul = ring[gyu * 4 + sl], ur = ring[gyu * 4 + sr];
  return k == 0 ? 1024
       : k == 1 ? l
       : k == 2 ? u
       : k == 3 ? median3(l, ul, u)
                : median3(l, u, ur);
}

template <typename T, bool CHROMA>
__global__ void dc_dpcm_kernel(const T* __restrict__ dc, const int* __restrict__ kind,
                               int nplanes, int gh, int gw, int qstep, int* __restrict__ q,
                               int* __restrict__ dq) {
  extern __shared__ int ring_all[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int plane = blockIdx.x * WARPS + warp;
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
      const int pred = ring_pred(ring, kind[gy * gw + gx], gy, gx, gw);
      const long long c = base + gy * gw + gx;
      const T half = add_rn(sub_rn(dc[c], (T)pred), (T)0.5);
      const int t = CHROMA ? (int)floor(half) : (int)half;  // (int) truncates
      const int qv = t / qstep;                             // C division
      const int dqv = qv * qstep + pred;
      q[c] = qv;
      dq[c] = dqv;
      ring[gy * 4 + (gx & 3)] = dqv;
    }
    __syncwarp();
  }
}

// B': the same walk, dq = iq + pred.
__global__ void idc_dpcm_kernel(const int* __restrict__ iq, const int* __restrict__ kind,
                                int nplanes, int gh, int gw, int* __restrict__ dq) {
  extern __shared__ int ring_all[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int plane = blockIdx.x * WARPS + warp;
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
      const long long c = base + gy * gw + gx;
      const int dqv = iq[c] + ring_pred(ring, kind[gy * gw + gx], gy, gx, gw);
      dq[c] = dqv;
      ring[gy * 4 + (gx & 3)] = dqv;
    }
    __syncwarp();
  }
}

template <typename T>
int launch(const void* dc, const int* kind, int nplanes, int gh, int gw, int qstep,
           int chroma, int* q, int* dq, cudaStream_t stream) {
  const dim3 grid((nplanes + WARPS - 1) / WARPS);
  const size_t smem = sizeof(int) * WARPS * gh * 4;
  const T* x = static_cast<const T*>(dc);
  if (chroma)
    dc_dpcm_kernel<T, true><<<grid, WARPS * 32, smem, stream>>>(x, kind, nplanes, gh, gw,
                                                                 qstep, q, dq);
  else
    dc_dpcm_kernel<T, false><<<grid, WARPS * 32, smem, stream>>>(x, kind, nplanes, gh, gw,
                                                                  qstep, q, dq);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes by ops/dc_fused.py.  dc is
// (nplanes, gh, gw) float or double, contiguous; kind (gh, gw) int32; q and
// dq (nplanes, gh, gw) int32.  Returns cudaGetLastError() after the launch.
extern "C" int icsp_dc_dpcm_fwd(const void* dc, int is_f64, const int* kind, int nplanes,
                                int gh, int gw, int qstep, int chroma, int* q, int* dq,
                                void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (is_f64) return launch<double>(dc, kind, nplanes, gh, gw, qstep, chroma, q, dq, st);
  return launch<float>(dc, kind, nplanes, gh, gw, qstep, chroma, q, dq, st);
}

// Plain C entry point of B', bound with ctypes by ops/dc_fused.py.  iq and dq
// are (nplanes, gh, gw) int32, contiguous; kind (gh, gw) int32.  Returns
// cudaGetLastError() after the launch.
extern "C" int icsp_dc_dpcm_inv(const int* iq, const int* kind, int nplanes, int gh, int gw,
                                int* dq, void* stream) {
  const dim3 grid((nplanes + WARPS - 1) / WARPS);
  const size_t smem = sizeof(int) * WARPS * gh * 4;
  idc_dpcm_kernel<<<grid, WARPS * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      iq, kind, nplanes, gh, gw, dq);
  return (int)cudaGetLastError();
}
