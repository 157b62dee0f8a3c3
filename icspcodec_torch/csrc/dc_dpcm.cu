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
// Bound on this card.  For the CIF300 chroma batch (600 planes of 18x22) B
// reads 0.95 MB of float DCs and writes 1.9 MB of int32 q and dq: 2.85 MB,
// under 1 us at 3.35 TB/s.  The arithmetic is a few integer operations a
// cell.  B' moves 8 bytes a cell (int32 in and out): 1.9 MB for the CIF300
// intra chroma batch, 0.6 us; per inter step of 30 GOPs, 0.38 MB of luma
// and 0.19 MB of chroma.  What paces both is the chain of dependent
// diagonals (56 for CIF chroma, 114 for CIF luma).
//
// Design.  The ring walk (B, and B' for planes too large to stage): one
// warp per plane walks the diagonals, one cell per lane (lanes loop when a
// diagonal holds more than 32 cells), with a __syncwarp() between
// diagonals.  The dequantized DCs that later cells read sit in a ring of 4
// slots per block row in shared memory (slot gx & 3): a cell reads slots
// gx-1 .. gx+1 of the row above and gx-1 of its own row, while the cell of
// the row above on the same diagonal writes slot gx+2, so no two touch the
// same slot.  The ring takes 16 bytes a block row; the launcher puts as
// many planes in a CTA as the card's opt-in shared memory holds, at least
// one, so one plane of the header's 8,190 block rows takes 131 KB.  Each
// step of this walk loads its cell from global memory, so a diagonal costs
// about one memory latency.
//   B' stages instead, when the kind grid and a plane fit in shared memory
// (up to 720p luma and 1080p chroma, a plane a CTA): all threads copy the kind
// grid and the CTA's planes of residuals into shared memory, four loads a
// thread in flight, coalesced; then one warp per plane walks it in bands of
// up to 128 block rows with the walk's state in registers and shuffles
// (walk, below), no global access and no branch in a step; then all
// threads store the planes, coalesced.  The launcher puts up to 4 planes in
// a CTA, fewer when the planes would not otherwise fill the SMs.  A first
// version walked the staged plane in shared memory and chose the predictor
// by branches with the neighbour loads inside them, which serialised the
// loads and made the divergent lanes take turns: it was slower than the
// ring walk (PERF.md).  The TPU kernel's shear layout and rolls are not
// needed here.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// The median of three in four min/max operations (the plain version's
// median3 is the true median too).
__device__ __forceinline__ int median3(int a, int b, int c) {
  return max(min(a, b), min(max(a, b), c));
}

__device__ __forceinline__ int dc_pred(int k, int l, int ul, int u, int ur) {
  return k == 0 ? 1024 : k == 1 ? l : k == 2 ? u : k == 3 ? median3(l, ul, u) : median3(l, u, ur);
}

constexpr unsigned FULL = 0xffffffffu;
constexpr int RING_WARPS = 4;     // planes a CTA of the ring walk, at most
constexpr int RING_ROW_BYTES = 16;
constexpr int STAGE_WARPS = 4;    // threads of a staged CTA / 32, and its planes at most

// The kind-coded predictor of cell (gy, gx) from the ring of dequantized
// DCs (slot gx & 3 of each block row).
__device__ __forceinline__ int ring_pred(const int* ring, int k, int gy, int gx, int gw) {
  const int gyu = gy > 0 ? gy - 1 : 0;
  const int sl = (gx - 1) & 3, sc = gx & 3, sr = (gx + 1 < gw ? gx + 1 : gw - 1) & 3;
  return dc_pred(k, ring[gy * 4 + sl], ring[gyu * 4 + sl], ring[gyu * 4 + sc], ring[gyu * 4 + sr]);
}

// The ring walk of B: a plane per warp, blockDim.x / 32 planes a CTA.
template <typename T, bool CHROMA>
__global__ void dc_dpcm_kernel(const T* __restrict__ dc, const int* __restrict__ kind,
                               int nplanes, int gh, int gw, int qstep, int* __restrict__ q,
                               int* __restrict__ dq) {
  extern __shared__ int ring_all[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int plane = blockIdx.x * (blockDim.x >> 5) + warp;
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

// B' by the ring walk: the same walk, dq = iq + pred.
__global__ void idc_dpcm_ring_kernel(const int* __restrict__ iq, const int* __restrict__ kind,
                                     int nplanes, int gh, int gw, int* __restrict__ dq) {
  extern __shared__ int ring_all[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int plane = blockIdx.x * (blockDim.x >> 5) + warp;
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

// Copies `total` ints from src into rows of stride S in dst: element i goes
// to row i / gw, column i % gw.  Four loads a thread are in flight before
// any store; m = ceil(2^32 / gw) divides (gw >= 2, i * gw < 2^32).
__device__ __forceinline__ void stage(const int* __restrict__ src, int total, int gw, int S,
                                      unsigned m, int* dst) {
  for (int i0 = threadIdx.x; i0 < total; i0 += 4 * blockDim.x) {
    int v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = i0 + j * blockDim.x;
      v[j] = i < total ? src[i] : 0;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = i0 + j * blockDim.x;
      const int row = gw == 1 ? i : (int)__umulhi((unsigned)i, m);
      if (i < total) dst[row * S + i - row * gw] = v[j];
    }
  }
}

// B' staged: ppc planes a CTA of STAGE_WARPS warps.  Shared memory: the
// kind grid, then the planes, each (gh, S) int32 with S = gw | 1.  A warp
// walks its plane in bands of 32 * ROWS block rows, lane L holding rows
// ROWS L .. ROWS L + ROWS - 1 of the band with the last three dequantized
// DCs of each in registers, as kernel F's DC walk does: at step d, row gy
// takes cell gx = d - 2 gy, whose left neighbour is its own last dq and
// whose upper neighbours (gx + 1, gx, gx - 1) row gy - 1 took at steps d -
// 1, d - 2 and d - 3 (at gx = gw - 1 that row ended a step early: ur = u,
// ul its second last), read from the lane's row above, from lane L - 1 by
// a shuffle, or, for the top row of a band below another, from the plane,
// where the band above left its results.  The step's residual and kind are
// loaded one step ahead; the step has no branch and no other load, and
// writes its dq over its residual.
template <int ROWS>
__device__ __forceinline__ void walk(int* v, const int* kd, int gh, int gw, int S, int lane) {
  for (int gy0 = 0; gy0 < gh; gy0 += 32 * ROWS) {
    int h1[ROWS], h2[ROWS], h3[ROWS], vn[ROWS], kn[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int gy = gy0 + lane * ROWS + r, c = gy < gh ? gy * S : 0;
      h1[r] = h2[r] = h3[r] = 0;
      vn[r] = v[c];
      kn[r] = kd[c];
    }
    const int* up = v + (gy0 > 0 ? gy0 - 1 : 0) * S;   // the row above the band
    const int d_end = 2 * (min(gh, gy0 + 32 * ROWS) - 1) + gw;
    for (int d = 2 * gy0; d < d_end; ++d) {
      // the row above this lane's first row, as its last three results
      int a1 = __shfl_up_sync(FULL, h1[ROWS - 1], 1);
      int a2 = __shfl_up_sync(FULL, h2[ROWS - 1], 1);
      int a3 = __shfl_up_sync(FULL, h3[ROWS - 1], 1);
      if (gy0 > 0 && lane == 0) {
        const int m = min(d - 2 * gy0 + 1, gw - 1);   // its last cell by step d - 1
        a1 = up[max(m, 0)];
        a2 = up[max(m - 1, 0)];
        a3 = up[max(m - 2, 0)];
      }
#pragma unroll
      for (int r = ROWS - 1; r >= 0; --r) {
        const int gy = gy0 + lane * ROWS + r, gx = d - 2 * gy;
        const bool on = gy < gh && gx >= 0 && gx < gw;
        const int iqv = vn[r], k = kn[r];
        const bool on1 = gy < gh && gx + 1 >= 0 && gx + 1 < gw;
        const int c1 = on1 ? gy * S + gx + 1 : 0;
        vn[r] = v[c1];
        kn[r] = kd[c1];
        const int b1 = r > 0 ? h1[r > 0 ? r - 1 : 0] : a1;
        const int b2 = r > 0 ? h2[r > 0 ? r - 1 : 0] : a2;
        const int b3 = r > 0 ? h3[r > 0 ? r - 1 : 0] : a3;
        const bool last = gx == gw - 1;
        const int l = h1[r], ur = b1, u = last ? b1 : b2, ul = last ? b2 : b3;
        int pred = k == 3 ? median3(l, ul, u) : median3(l, u, ur);
        pred = k == 2 ? u : pred;
        pred = k == 1 ? l : pred;
        pred = k == 0 ? 1024 : pred;
        const int dqv = iqv + pred;
        if (on) v[gy * S + gx] = dqv;
        h3[r] = on ? h2[r] : h3[r];
        h2[r] = on ? h1[r] : h2[r];
        h1[r] = on ? dqv : h1[r];
      }
    }
    __syncwarp();   // the band's results are in the plane before the next band reads them
  }
}

// One plane a warp, ppc planes a CTA: all threads stage the kind grid and
// the planes in shared memory (coalesced loads), each warp walks its plane,
// all threads store the planes (coalesced).
template <int ROWS>
__global__ void __launch_bounds__(STAGE_WARPS * 32)
idc_dpcm_staged_kernel(const int* __restrict__ iq, const int* __restrict__ kind, int nplanes,
                       int gh, int gw, int ppc, int* __restrict__ dq) {
  extern __shared__ __align__(16) int sm[];
  const int S = gw | 1, cells = gh * S, n = gh * gw;
  const unsigned m = gw > 1 ? 0xffffffffu / (unsigned)gw + 1 : 0;
  const long long p0 = (long long)blockIdx.x * ppc;
  const int np = (int)min((long long)ppc, nplanes - p0);
  const long long base = p0 * n;
  stage(kind, n, gw, S, m, sm);
  stage(iq + base, np * n, gw, S, m, sm + cells);
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp < np) walk<ROWS>(sm + cells * (warp + 1), sm, gh, gw, S, lane);
  __syncthreads();
  for (int i = threadIdx.x; i < np * n; i += blockDim.x) {
    const int row = gw == 1 ? i : (int)__umulhi((unsigned)i, m);
    dq[base + i] = sm[cells + row * S + i - row * gw];
  }
}

struct Card {
  int nsm, optin;
};

cudaError_t card(Card* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&out->nsm, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&out->optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return err;
}

// Planes a CTA of the ring walk: as many as the opt-in holds, at most
// RING_WARPS; 0 when not even one plane's ring fits.
int ring_warps(int gh, const Card& c) {
  const long long per = (long long)gh * RING_ROW_BYTES;
  const long long fit = per > 0 ? c.optin / per : 0;
  return (int)(fit < RING_WARPS ? fit : RING_WARPS);
}

// Launches a kernel with `smem` bytes of dynamic shared memory, opting in
// above the default 48 KB.
template <typename K, typename... Args>
int launch_smem(K kernel, unsigned grid, int threads, size_t smem, cudaStream_t stream,
                Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fwd(const void* dc, const int* kind, int nplanes, int gh, int gw, int qstep,
               int chroma, int* q, int* dq, cudaStream_t stream) {
  Card c{};
  cudaError_t err = card(&c);
  if (err != cudaSuccess) return (int)err;
  const int warps = ring_warps(gh, c);
  if (warps < 1) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((nplanes + warps - 1) / warps);
  const size_t smem = (size_t)warps * gh * RING_ROW_BYTES;
  const T* x = static_cast<const T*>(dc);
  return chroma ? launch_smem(dc_dpcm_kernel<T, true>, grid, warps * 32, smem, stream, x, kind,
                              nplanes, gh, gw, qstep, q, dq)
                : launch_smem(dc_dpcm_kernel<T, false>, grid, warps * 32, smem, stream, x, kind,
                              nplanes, gh, gw, qstep, q, dq);
}

}  // namespace

// Plain C entry point, bound with ctypes by ops/dc_fused.py.  dc is
// (nplanes, gh, gw) float or double, contiguous; kind (gh, gw) int32; q and
// dq (nplanes, gh, gw) int32.  Planes of every height the header carries
// are taken (up to the opt-in shared memory / 16 block rows, 14,528 on an
// H100).  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a taller plane).
extern "C" int icsp_dc_dpcm_fwd(const void* dc, int is_f64, const int* kind, int nplanes,
                                int gh, int gw, int qstep, int chroma, int* q, int* dq,
                                void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (is_f64) return launch_fwd<double>(dc, kind, nplanes, gh, gw, qstep, chroma, q, dq, st);
  return launch_fwd<float>(dc, kind, nplanes, gh, gw, qstep, chroma, q, dq, st);
}

// Plain C entry point of B', bound with ctypes by ops/dc_fused.py.  iq and dq
// are (nplanes, gh, gw) int32, contiguous; kind (gh, gw) int32.  Staged when
// the kind grid and one plane fit in the opt-in shared memory, else the ring
// walk, which takes planes of every height the header carries.  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a plane
// taller than the ring walk takes).
extern "C" int icsp_dc_dpcm_inv(const int* iq, const int* kind, int nplanes, int gh, int gw,
                                int* dq, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  Card c{};
  cudaError_t err = card(&c);
  if (err != cudaSuccess) return (int)err;
  const size_t plane = sizeof(int) * (size_t)gh * (gw | 1);   // the kind grid takes as much
  // enough CTAs to fill the SMs, at most STAGE_WARPS planes each
  int ppc = (nplanes + c.nsm - 1) / c.nsm;
  ppc = ppc < STAGE_WARPS ? ppc : STAGE_WARPS;
  while (ppc > 0 && (ppc + 1) * plane > (size_t)c.optin) --ppc;
  if (ppc > 0) {
    // rows a lane of the walk holds: enough for one band at CIF luma and below
    const unsigned grid = (unsigned)((nplanes + ppc - 1) / ppc);
    const size_t smem = (ppc + 1) * plane;
    return gh <= 32 ? launch_smem(idc_dpcm_staged_kernel<1>, grid, STAGE_WARPS * 32, smem, st,
                                  iq, kind, nplanes, gh, gw, ppc, dq)
         : gh <= 64 ? launch_smem(idc_dpcm_staged_kernel<2>, grid, STAGE_WARPS * 32, smem, st,
                                  iq, kind, nplanes, gh, gw, ppc, dq)
                    : launch_smem(idc_dpcm_staged_kernel<4>, grid, STAGE_WARPS * 32, smem, st,
                                  iq, kind, nplanes, gh, gw, ppc, dq);
  }
  const int warps = ring_warps(gh, c);
  if (warps < 1) return (int)cudaErrorInvalidValue;
  return launch_smem(idc_dpcm_ring_kernel, (unsigned)((nplanes + warps - 1) / warps), warps * 32,
                     (size_t)warps * gh * RING_ROW_BYTES, st, iq, kind, nplanes, gh, gw, dq);
}
