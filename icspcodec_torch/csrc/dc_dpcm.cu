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
// integer, bit-identical.  The two differ only in that cell (Quantize and
// Reconstruct below); both walks take the cell as a template parameter.
//
// Bound on this card.  For the CIF300 chroma batch (600 planes of 18x22) B
// reads 0.95 MB of float DCs and writes 1.9 MB of int32 q and dq: 2.85 MB,
// under 1 us at 3.35 TB/s.  The arithmetic is a few integer operations a
// cell.  B' moves 8 bytes a cell (int32 in and out): 1.9 MB for the CIF300
// intra chroma batch, 0.6 us; per inter step of 30 GOPs, 0.38 MB of luma
// and 0.19 MB of chroma.  What paces both is the chain of dependent
// diagonals (56 for CIF chroma, 114 for CIF luma).
//
// Design.  Both stage a plane in shared memory where the kind grid and one
// plane fit (B' up to 720p luma and 1080p chroma; B less, its planes holding
// a float or double input and an int q a cell: float32 planes 4 blocks wide
// up to 3,874 block rows on an H100, float64 2,905): all threads copy the
// kind grid and the CTA's planes into shared memory by cp.async, every copy
// in flight at once, coalesced; then one warp per plane walks it in bands
// of up to 128 block rows with the walk's state in registers and shuffles
// (walk, below), no global access and no branch in a step, each cell's dq
// written over its input; then all threads store the planes, coalesced.
// The launcher puts up to 4 planes in a CTA, fewer when the planes would
// not otherwise fill the SMs.  B's step is longer than B''s (int to float,
// two rounded adds, floor or trunc, the division, a multiply-add), and the
// division is on its chain, so B divides by a 32-bit multiply-high
// (Divider): on the card it beat both `/` and kernel F's 64-bit one at
// every shape tried, as staging by cp.async beat four register loads a
// thread in flight for B (for B' it was faster on a P-step's luma, even
// at the CIF300 chroma batch, slower on a P-step's 60 chroma planes).  Taller
// planes take the ring walk: one warp
// per plane walks the diagonals, one cell per lane (lanes loop when a
// diagonal holds more than 32 cells), with a __syncwarp() between
// diagonals, each step loading its cell from global memory, so a diagonal
// costs about one memory latency.  The dequantized DCs that later cells
// read sit in a ring of 4 slots per block row in shared memory (slot
// gx & 3): a cell reads slots gx-1 .. gx+1 of the row above and gx-1 of its
// own row, while the cell of the row above on the same diagonal writes slot
// gx+2, so no two touch the same slot.  The ring takes 16 bytes a block
// row; the launcher puts as many planes in a CTA as the card's opt-in
// shared memory holds, at least one, so one plane of the header's 8,190
// block rows takes 131 KB.  A first staged version of B' walked the plane
// in shared memory and chose the predictor by branches with the neighbour
// loads inside them, which serialised the loads and made the divergent
// lanes take turns: it was slower than the ring walk (PERF.md).  The TPU
// kernel's shear layout and rolls are not needed here.
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

// C division by a positive qstep as a multiply-high with a sign correction
// (Granlund and Montgomery's round-up method, exact for every 32-bit
// magnitude): a few dependent integer operations, on the chain of every
// step, where `/` by a value known only at run time is a longer emulated
// sequence.
// chip_smoke.py holds it equal to `/` for every qstep the header carries
// (1 .. 255) and every int32 dividend (icsp_dc_dpcm_cdiv_check).
struct Divider {
  int d;
  unsigned mag;
  int s1, s2;
  static Divider of(int d) {
    int l = 0;   // ceil(log2 d)
    while ((1ull << l) < (unsigned long long)d) ++l;
    const unsigned mag = (unsigned)(((1ull << 32) * ((1ull << l) - d)) / d + 1);
    return {d, mag, l < 1 ? l : 1, l > 1 ? l - 1 : 0};
  }
  __device__ __forceinline__ int div(int t) const {
    const unsigned n = t < 0 ? 0u - (unsigned)t : (unsigned)t;
    const unsigned hi = __umulhi(n, mag);
    const unsigned q = (hi + ((n - hi) >> s1)) >> s2;   // floor(n / d)
    return (int)(t < 0 ? 0u - q : q);
  }
};

// B's cell: from the cell's DC and its predictor, q and dq.
template <typename T, bool CHROMA>
struct Quantize {
  using In = T;
  static constexpr bool kQ = true;   // writes q beside dq
  Divider qstep;
  __device__ __forceinline__ int operator()(T dc, int pred, int& q) const {
    const T half = add_rn(sub_rn(dc, (T)pred), (T)0.5);
    const int t = CHROMA ? (int)floor(half) : (int)half;  // (int) truncates
    q = qstep.div(t);                                      // C division
    return q * qstep.d + pred;
  }
};

// B''s cell: dq = iq + pred.
struct Reconstruct {
  using In = int;
  static constexpr bool kQ = false;
  __device__ __forceinline__ int operator()(int iq, int pred, int&) const { return iq + pred; }
};

// Shared memory a cell of a staged plane: its input, and B's q.
template <typename Cell>
constexpr size_t cell_bytes() {
  return sizeof(typename Cell::In) + (Cell::kQ ? sizeof(int) : 0);
}

// The kind-coded predictor of cell (gy, gx) from the ring of dequantized
// DCs (slot gx & 3 of each block row).
__device__ __forceinline__ int ring_pred(const int* ring, int k, int gy, int gx, int gw) {
  const int gyu = gy > 0 ? gy - 1 : 0;
  const int sl = (gx - 1) & 3, sc = gx & 3, sr = (gx + 1 < gw ? gx + 1 : gw - 1) & 3;
  return dc_pred(k, ring[gy * 4 + sl], ring[gyu * 4 + sl], ring[gyu * 4 + sc], ring[gyu * 4 + sr]);
}

// The ring walk: a plane per warp, blockDim.x / 32 planes a CTA.  q is
// written by B only.
template <typename Cell>
__global__ void ring_kernel(const typename Cell::In* __restrict__ x, const int* __restrict__ kind,
                            int nplanes, int gh, int gw, Cell cell, int* __restrict__ q,
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
      const long long c = base + gy * gw + gx;
      int qv;
      const int dqv = cell(x[c], ring_pred(ring, kind[gy * gw + gx], gy, gx, gw), qv);
      if constexpr (Cell::kQ) q[c] = qv;
      dq[c] = dqv;
      ring[gy * 4 + (gx & 3)] = dqv;
    }
    __syncwarp();
  }
}

// Copies `total` elements from src into rows of stride S in dst: element i
// goes to row i / gw, column i % gw; m = ceil(2^32 / gw) divides (gw >= 2,
// i * gw < 2^32).  By cp.async, through no register: every copy of the CTA
// is in flight at once, and the CTA waits once for all of them (wait_staged).
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ src, int total, int gw, int S,
                                      unsigned m, T* dst) {
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int row = gw == 1 ? i : (int)__umulhi((unsigned)i, m);
    const unsigned to = (unsigned)__cvta_generic_to_shared(dst + row * S + i - row * gw);
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(to), "l"(src + i),
                 "n"(sizeof(T)));
  }
}

// Waits for this thread's cp.async copies, then for the CTA's.
__device__ __forceinline__ void wait_staged() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// The dq of cell c of a staged plane, written over the cell's input (in the
// low word of a double's slot).
template <typename T>
__device__ __forceinline__ int& dq_at(T* v, int c) {
  return *reinterpret_cast<int*>(v + c);
}

// A warp walks its staged plane v (row stride S; B's q plane qs beside it)
// in bands of 32 * ROWS block rows, lane L holding rows ROWS L .. ROWS L +
// ROWS - 1 of the band with the last three dequantized DCs of each in
// registers, as kernel F's DC walk does: at step d, row gy takes cell gx =
// d - 2 gy, whose left neighbour is its own last dq and whose upper
// neighbours (gx + 1, gx, gx - 1) row gy - 1 took at steps d - 1, d - 2 and
// d - 3 (at gx = gw - 1 that row ended a step early: ur = u, ul its second
// last), read from the lane's row above, from lane L - 1 by a shuffle, or,
// for the top row of a band below another, from the plane, where the band
// above left its dq.  The step's input and kind are loaded one step ahead;
// the step has no branch and no other load, and writes its dq over its
// input.
template <int ROWS, typename Cell>
__device__ __forceinline__ void walk(typename Cell::In* v, int* qs, const int* kd, int gh, int gw,
                                     int S, int lane, Cell cell) {
  using T = typename Cell::In;
  for (int gy0 = 0; gy0 < gh; gy0 += 32 * ROWS) {
    int h1[ROWS], h2[ROWS], h3[ROWS], kn[ROWS];
    T vn[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int gy = gy0 + lane * ROWS + r, c = gy < gh ? gy * S : 0;
      h1[r] = h2[r] = h3[r] = 0;
      vn[r] = v[c];
      kn[r] = kd[c];
    }
    const int up = (gy0 > 0 ? gy0 - 1 : 0) * S;   // the row above the band
    const int d_end = 2 * (min(gh, gy0 + 32 * ROWS) - 1) + gw;
    for (int d = 2 * gy0; d < d_end; ++d) {
      // the row above this lane's first row, as its last three results
      int a1 = __shfl_up_sync(FULL, h1[ROWS - 1], 1);
      int a2 = __shfl_up_sync(FULL, h2[ROWS - 1], 1);
      int a3 = __shfl_up_sync(FULL, h3[ROWS - 1], 1);
      if (gy0 > 0 && lane == 0) {
        const int m = min(d - 2 * gy0 + 1, gw - 1);   // its last cell by step d - 1
        a1 = dq_at(v, up + max(m, 0));
        a2 = dq_at(v, up + max(m - 1, 0));
        a3 = dq_at(v, up + max(m - 2, 0));
      }
#pragma unroll
      for (int r = ROWS - 1; r >= 0; --r) {
        const int gy = gy0 + lane * ROWS + r, gx = d - 2 * gy;
        const bool on = gy < gh && gx >= 0 && gx < gw;
        const T xv = vn[r];
        const int k = kn[r];
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
        int qv;
        const int dqv = cell(xv, pred, qv);
        if (on) {
          dq_at(v, gy * S + gx) = dqv;
          if constexpr (Cell::kQ) qs[gy * S + gx] = qv;
        }
        h3[r] = on ? h2[r] : h3[r];
        h2[r] = on ? h1[r] : h2[r];
        h1[r] = on ? dqv : h1[r];
      }
    }
    __syncwarp();   // the band's results are in the plane before the next band reads them
  }
}

// Bytes of the kind grid at the head of a staged CTA's shared memory,
// rounded up to 8 so that planes of doubles follow it aligned.
__host__ __device__ __forceinline__ size_t kind_bytes(size_t cells) {
  return (cells * sizeof(int) + 7) & ~(size_t)7;
}

// One plane a warp, ppc planes a CTA.  Shared memory: the kind grid, the
// ppc input planes, then (B) the ppc q planes, each (gh, S) with S = gw | 1.
// All threads stage the kind grid and the input planes (coalesced loads),
// each warp walks its plane, all threads store dq (and q; coalesced).
template <int ROWS, typename Cell>
__global__ void __launch_bounds__(STAGE_WARPS * 32)
staged_kernel(const typename Cell::In* __restrict__ x, const int* __restrict__ kind, int nplanes,
              int gh, int gw, int ppc, Cell cell, int* __restrict__ q, int* __restrict__ dq) {
  using T = typename Cell::In;
  extern __shared__ __align__(16) unsigned char sm[];
  const int S = gw | 1, cells = gh * S, n = gh * gw;
  const unsigned m = gw > 1 ? 0xffffffffu / (unsigned)gw + 1 : 0;
  int* kd = reinterpret_cast<int*>(sm);
  T* v = reinterpret_cast<T*>(sm + kind_bytes(cells));
  int* qs = reinterpret_cast<int*>(v + (size_t)ppc * cells);
  const long long p0 = (long long)blockIdx.x * ppc;
  const int np = (int)min((long long)ppc, nplanes - p0);
  const long long base = p0 * n;
  stage(kind, n, gw, S, m, kd);
  stage(x + base, np * n, gw, S, m, v);
  wait_staged();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp < np) walk<ROWS>(v + cells * warp, qs + cells * warp, kd, gh, gw, S, lane, cell);
  __syncthreads();
  for (int i = threadIdx.x; i < np * n; i += blockDim.x) {
    const int row = gw == 1 ? i : (int)__umulhi((unsigned)i, m);
    const int c = row * S + i - row * gw;
    dq[base + i] = dq_at(v, c);
    if constexpr (Cell::kQ) q[base + i] = qs[c];
  }
}

// Counts the int32 dividends whose Divider quotient differs from C division:
// 2^22 threads, 1,024 dividends each, all 2^32 in all.
__global__ void cdiv_check_kernel(Divider dv, unsigned long long* bad) {
  const unsigned t0 = (blockIdx.x * blockDim.x + threadIdx.x) << 10;
  unsigned long long n = 0;
  for (unsigned j = 0; j < 1024; ++j) {
    const int t = (int)(t0 | j);
    n += dv.div(t) != t / dv.d;
  }
  if (n) atomicAdd(bad, n);
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

// Planes a CTA of the staged walk: enough CTAs to fill the SMs, at most
// STAGE_WARPS planes each, as many as the opt-in shared memory holds beside
// the kind grid; 0 when not even one plane fits (the ring walk then).
template <typename Cell>
int staged_ppc(int nplanes, int gh, int gw, const Card& c) {
  const size_t cells = (size_t)gh * (gw | 1);
  int ppc = (nplanes + c.nsm - 1) / c.nsm;
  ppc = ppc < STAGE_WARPS ? ppc : STAGE_WARPS;
  while (ppc > 0 && kind_bytes(cells) + ppc * cells * cell_bytes<Cell>() > (size_t)c.optin) --ppc;
  return ppc;
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

// Staged where the kind grid and one plane fit in the opt-in shared memory,
// else the ring walk, which takes planes of every height the header carries.
template <typename Cell>
int launch(const typename Cell::In* x, const int* kind, int nplanes, int gh, int gw, Cell cell,
           int* q, int* dq, cudaStream_t st) {
  Card c{};
  const cudaError_t err = card(&c);
  if (err != cudaSuccess) return (int)err;
  const int ppc = staged_ppc<Cell>(nplanes, gh, gw, c);
  if (ppc > 0) {
    const unsigned grid = (unsigned)((nplanes + ppc - 1) / ppc);
    const size_t cells = (size_t)gh * (gw | 1);
    const size_t smem = kind_bytes(cells) + ppc * cells * cell_bytes<Cell>();
    // rows a lane of the walk holds: enough for one band at CIF luma and below
    return gh <= 32 ? launch_smem(staged_kernel<1, Cell>, grid, STAGE_WARPS * 32, smem, st, x,
                                  kind, nplanes, gh, gw, ppc, cell, q, dq)
         : gh <= 64 ? launch_smem(staged_kernel<2, Cell>, grid, STAGE_WARPS * 32, smem, st, x,
                                  kind, nplanes, gh, gw, ppc, cell, q, dq)
                    : launch_smem(staged_kernel<4, Cell>, grid, STAGE_WARPS * 32, smem, st, x,
                                  kind, nplanes, gh, gw, ppc, cell, q, dq);
  }
  const int warps = ring_warps(gh, c);
  if (warps < 1) return (int)cudaErrorInvalidValue;
  return launch_smem(ring_kernel<Cell>, (unsigned)((nplanes + warps - 1) / warps), warps * 32,
                     (size_t)warps * gh * RING_ROW_BYTES, st, x, kind, nplanes, gh, gw, cell, q,
                     dq);
}

template <typename T>
int launch_fwd(const void* dc, const int* kind, int nplanes, int gh, int gw, int qstep,
               int chroma, int* q, int* dq, cudaStream_t st) {
  const T* x = static_cast<const T*>(dc);
  const Divider dv = Divider::of(qstep);
  return chroma ? launch(x, kind, nplanes, gh, gw, Quantize<T, true>{dv}, q, dq, st)
                : launch(x, kind, nplanes, gh, gw, Quantize<T, false>{dv}, q, dq, st);
}

}  // namespace

// Plain C entry point, bound with ctypes by ops/dc_fused.py.  dc is
// (nplanes, gh, gw) float or double, contiguous; kind (gh, gw) int32; q and
// dq (nplanes, gh, gw) int32.  Staged when the kind grid and one plane fit
// in the opt-in shared memory (icsp_dc_dpcm_fwd_ppc), else the ring walk,
// which takes planes of every height the header carries (up to the opt-in
// shared memory / 16 block rows, 14,528 on an H100).  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a taller
// plane).
extern "C" int icsp_dc_dpcm_fwd(const void* dc, int is_f64, const int* kind, int nplanes,
                                int gh, int gw, int qstep, int chroma, int* q, int* dq,
                                void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (is_f64) return launch_fwd<double>(dc, kind, nplanes, gh, gw, qstep, chroma, q, dq, st);
  return launch_fwd<float>(dc, kind, nplanes, gh, gw, qstep, chroma, q, dq, st);
}

// The layout icsp_dc_dpcm_fwd takes for these planes on the current card:
// planes a CTA of the staged walk, 0 for the ring walk; minus the
// cudaError_t when the card cannot be read.
extern "C" int icsp_dc_dpcm_fwd_ppc(int is_f64, int nplanes, int gh, int gw) {
  Card c{};
  const cudaError_t err = card(&c);
  if (err != cudaSuccess) return -(int)err;
  return is_f64 ? staged_ppc<Quantize<double, true>>(nplanes, gh, gw, c)
                : staged_ppc<Quantize<float, true>>(nplanes, gh, gw, c);
}

// Plain C entry point of B', bound with ctypes by ops/dc_fused.py.  iq and dq
// are (nplanes, gh, gw) int32, contiguous; kind (gh, gw) int32.  Staged when
// the kind grid and one plane fit in the opt-in shared memory, else the ring
// walk, which takes planes of every height the header carries.  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a plane
// taller than the ring walk takes).
extern "C" int icsp_dc_dpcm_inv(const int* iq, const int* kind, int nplanes, int gh, int gw,
                                int* dq, void* stream) {
  return launch(iq, kind, nplanes, gh, gw, Reconstruct{}, nullptr, dq,
                static_cast<cudaStream_t>(stream));
}

// The check of B's division: for each qstep 1 .. qmax, adds to bad[qstep -
// 1] (unsigned 64-bit counters, zeroed by the caller) the int32 dividends
// whose Divider quotient differs from C division.  Returns
// cudaGetLastError() after the last launch.
extern "C" int icsp_dc_dpcm_cdiv_check(int qmax, unsigned long long* bad, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  for (int d = 1; d <= qmax; ++d) {
    cdiv_check_kernel<<<1 << 14, 256, 0, st>>>(Divider::of(d), bad + d - 1);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
