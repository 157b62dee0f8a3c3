// Kernel C: the intra luma decode wavefront, for sm_90a.
//
// Replaces: icspcodec_tpu/ops/pallas_intra.py::_intra_decode_rows_fused (the
// Pallas TPU kernel behind intra_luma_decode_fused).  It computes exactly
// what the plain PyTorch version computes (ops/intra_decode_fused.py::
// intra_luma_decode_plain: inverse zig-zag, dequantization,
// engine/wavefront.py::idc_dpcm_scan, the inverse DCT and
// intra_luma_decode_scan_packed): per 8x8 luma block along the 2*gy+gx
// anti-diagonals, the inverse zig-zag of the int16 symbols, dequantization
// with the DC predicted from the kind-coded neighbour DCs, the inverse DCT,
// the mode from the MPM flag and remainder bit, and the clipped pixel
// reconstruction from the reconstructed neighbours.
//
// Precision.  float: the plain version on the card multiplies the
// dequantized block by the float32 64x64 matrix (tables.idct_matrix) in
// double and rounds once to float.  Every entry of that matrix is a
// multiple of 2^-29 with row sums below 9, so with dequantized values below
// 2^15 every product and partial sum is exact in double in any order
// (tests/test_torch_kernels_ef.py), and column 0, the DC's, is 0.125 for
// all 64 outputs (tests/test_torch_kernels_bc.py).  The kernel therefore
// sums the AC part of each output in double over the block's nonzero AC
// values only, in any order, and adds dq * 0.125 once the DC chain has
// given dq: (float)(ac + dq * 0.125) is the plain version's value bit for
// bit, and so is every pixel.  double: the exact path, the separable
// transform of the reference's C loops with every product rounded on its
// own and the sums in index order (__dmul_rn / __dadd_rn: nvcc would
// otherwise contract a multiply-add into an FMA), bit-identical too.
//
// Bound on this card.  For CIF300 (475,200 blocks) the kernel reads 60.8 MB
// of i16 symbols and 0.95 MB of flags and writes 30.4 MB of recon: ~92 MB,
// 28 us at 3.35 TB/s.  The float path's product is 64 multiply-adds in
// double for each nonzero dequantized value (~724,000 at QP 16, 0.09
// GFLOP), so bytes bound it; the exact path's separable transforms are
// 2,048 flops a block on the FP64 pipes, 29 us at 33.5 TFLOP/s.  Beside the
// bound, each frame is a chain of 2*(gh-1)+gw dependent diagonals (114 at
// CIF).
//
// Design.  One CTA per frame walks the diagonals in rounds of up to 4 blocks
// a warp (one round a diagonal at CIF, where a diagonal holds at most 22
// blocks and a CTA has 6 warps).  Eight lanes take a block, a pixel row a
// lane.  A block leaves its right pixel column, bottom row, mode and
// dequantized DC for the blocks at most 3 diagonals later in a ring of 4
// slots per block row (slot gx & 3): within a diagonal a block writes slot
// gx & 3 of its row while the blocks of the row below read slots gx-3 ..
// gx-1 of it, so no two touch the same slot.  The ring takes 96 bytes a
// block row, in shared memory, or in a global scratch ring of the same
// layout when it does not fit there beside the rest (from about 2,000 block
// rows on), so the kernel takes every height the header carries.
//   The chain of a round is only this: the ring values, all loaded before
// any is used; the DC predictor and the mode by selects, without a branch;
// dq; the 64 pixels as (float)(ac + dq * 0.125) (dq / 8 for a warp of
// AC-empty blocks) plus the predictor, truncated and clipped on the float
// pipes alone; the recon row out in one 8-byte store; the ring written.
// Then each thread arrives at the round's mbarrier and, before it waits
// there for the others, prepares the next round, which the chain does not
// reach: its symbols and aux values (a row of 16 bytes and one of the MPM
// flag, the mode bit and the DC kind a lane), loaded into registers a round
// earlier, go to its warp's buffer, and the float path sums each output's
// AC part over the block's nonzero AC symbols (eight ballots find them; the
// matrix sits in shared memory in double, its columns in scan order, laid
// out so that a block's eight lanes read 128 contiguous bytes).  A warp
// with no block in a round only prepares the next.  Four CIF frames fit on
// an SM (79 registers, 39 KB), so the 300 frames run in one wave.  What
// paces a frame is the latency of a round's dependent instructions: a
// first version that chose the DC predictor by branches, with the ring
// loads inside them, and copied a round's symbols into shared memory by
// cp.async three rounds ahead, was slower (PERF.md).  The TPU kernel's lane
// shear, rolls, 0/1 extraction and split permutation matmuls are not needed
// here.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_WARPS = 6;
constexpr int BPW = 4;               // blocks a warp takes at once, 8 lanes each
constexpr int AUX = 4;               // ints of a block's buffer beside its symbols
constexpr int NBS = 66;              // doubles a block's second-pass buffer (exact path): 64 + 2,
                                     // so the 4 blocks of a warp start in other banks
constexpr int RING_ROW_BYTES = 96;   // a block row's ring: 4 modes, 4 DCs, 4 x 8 + 4 x 8 pixels

// Shared memory: the tables (float: the 64x64 matrix, its columns in scan
// order; double: the cosine table and IRT2, each warp's second-pass
// buffers and the inverse zig-zag), then the buffer of a round's symbols
// and aux values, then the ring when it lives there.
template <typename T>
__host__ __device__ constexpr size_t table_bytes(int nwarps) {
  return std::is_same<T, float>::value
             ? sizeof(double) * 4096
             : sizeof(double) * (72 + (size_t)nwarps * BPW * NBS) + sizeof(int) * 64;
}
__host__ __device__ constexpr size_t buf_bytes(int nwarps) {
  return (size_t)nwarps * BPW * (64 * sizeof(int16_t) + AUX * sizeof(int));
}
template <typename T>
__host__ __device__ constexpr size_t fixed_bytes(int nwarps) {
  return table_bytes<T>(nwarps) + buf_bytes(nwarps) + 16;   // the round's mbarrier
}

// The median of three in four min/max operations (the plain version's
// median3 is the true median too).
__device__ __forceinline__ int median3(int a, int b, int c) {
  return max(min(a, b), min(max(a, b), c));
}

// v (0 <= v < 2^23) as float, without a conversion instruction
__device__ __forceinline__ float as_float(int v) {
  return __fsub_rn(__uint_as_float(0x4b000000u | (unsigned)v), 8388608.0f);
}

__device__ __forceinline__ int byte_sum(unsigned long long v) {
  return (int)(__dp4a((unsigned)v, 0x01010101u, 0u) + __dp4a((unsigned)(v >> 32), 0x01010101u, 0u));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}
// arrives (release) and returns the phase's token
__device__ __forceinline__ unsigned long long mbar_arrive(unsigned long long* bar) {
  unsigned long long token;
  asm volatile("mbarrier.arrive.shared.b64 %0, [%1];\n"
               : "=l"(token) : "r"(smem_addr(bar)) : "memory");
  return token;
}
// waits (acquire) until every thread has arrived in the token's phase
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned long long token) {
  unsigned done = 0;
  while (!done) {
    asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.shared.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(smem_addr(bar)), "l"(token) : "memory");
  }
}

// The ring of boundary state, 4 slots a block row: modes and dequantized DCs
// (gh, 4) int, right pixel columns and bottom pixel rows (gh, 4, 8) u8.
struct Ring {
  int* md;
  int* dq;
  uint8_t* rc;
  uint8_t* br;
  __device__ __forceinline__ Ring(unsigned char* base, int gh)
      : md(reinterpret_cast<int*>(base)),
        dq(reinterpret_cast<int*>(base) + gh * 4),
        rc(base + gh * 32),
        br(base + gh * 64) {}
};

__device__ __forceinline__ int lo_row(int d, int gw) { return d - gw + 1 > 0 ? (d - gw + 2) / 2 : 0; }

// A round: up to R blocks of diagonal d, from block row b0 on.
struct Round {
  int d, b0;
  __device__ __forceinline__ void next(int gh, int gw, int R) {
    b0 += R;
    if (b0 > min(gh - 1, d / 2)) {
      ++d;
      b0 = lo_row(d, gw);
    }
  }
  __device__ __forceinline__ int blocks(int gh, int R) const { return min(R, min(gh - 1, d / 2) - b0 + 1); }
};

template <typename T, bool GRING>
__global__ void __launch_bounds__(MAX_WARPS * 32, 3) intra_decode_kernel(
    const int16_t* __restrict__ scan, const int8_t* __restrict__ mpm,
    const int8_t* __restrict__ mbit, const int* __restrict__ kind,
    const T* __restrict__ tabs, const int* __restrict__ izz, int gh, int gw, int qdc, int qac,
    uint8_t* __restrict__ recon, unsigned char* __restrict__ ring_g) {
  constexpr bool EXACT = std::is_same<T, double>::value;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const int R = nwarps * BPW, f = blockIdx.x;
  const int nsteps = 2 * (gh - 1) + gw, W = gw * 8;

  extern __shared__ __align__(16) unsigned char smem[];
  const Ring ring(GRING ? ring_g + (long long)f * gh * RING_ROW_BYTES
                        : smem + fixed_bytes<T>(nwarps), gh);
  // double: ct (65 entries, padded to 72), the second-pass buffers, izz
  double* nbuf = reinterpret_cast<double*>(smem) + 72;
  int* izz_s = reinterpret_cast<int*>(nbuf + nwarps * BPW * NBS);

  if constexpr (EXACT) {
    for (int i = tid; i < 65; i += blockDim.x) reinterpret_cast<double*>(smem)[i] = tabs[i];
    for (int i = tid; i < 64; i += blockDim.x) izz_s[i] = izz[i];
  } else {
    // tabs[k * 64 + yx] -> pairs (x, x + 1) of row y of scan symbol k's
    // weights, the 8 rows of a pair side by side (a group's 8 lanes read 128
    // contiguous bytes)
    for (int j = tid; j < 4096; j += blockDim.x) {
      const int k = j >> 6, yy = (j >> 3) & 7, x = j & 7;
      reinterpret_cast<double*>(smem)[(((k * 4 + (x >> 1)) * 8 + yy) << 1) | (x & 1)] = (double)tabs[j];
    }
  }
  for (int i = tid; i < gh * RING_ROW_BYTES / 4; i += blockDim.x) ring.md[i] = 0;

  // This lane's block of a round and its pixel row.  Each lane loads its
  // part of a block, row y of its symbols (16 bytes) and for y < 3 an aux
  // value (MPM flag, mode bit, DC kind), a round ahead into registers; the
  // round stores them in its warp's buffer, where the block's eight lanes
  // read them after a __syncwarp().
  const int i = warp * BPW + (lane >> 3), y = lane & 7;
  const long long f0 = (long long)f * gh * gw;   // this frame's first block
  const int16_t* scan_f = scan + f0 * 64 + y * 8;
  const int8_t* flag_f = (y == 0 ? mpm : mbit) + f0;
  int4 nsym = make_int4(0, 0, 0, 0);
  int naux = 0;
  auto fetch = [&](const Round& c) {
    if (c.d < nsteps && i < c.blocks(gh, R)) {
      const int gy = c.b0 + i, cell = gy * gw + c.d - 2 * gy;
      nsym = __ldg(reinterpret_cast<const int4*>(scan_f + (long long)cell * 64));
      if (y < 3) naux = y == 2 ? __ldg(kind + cell) : (int)__ldg(flag_f + cell);
    }
  };
  int16_t* sbuf = reinterpret_cast<int16_t*>(smem + table_bytes<T>(nwarps)) + i * 64;
  int* abuf = reinterpret_cast<int*>(smem + table_bytes<T>(nwarps) + R * 128) + i * AUX;

  double ac[8];           // float: the AC part of this lane's outputs in the round prepared
  bool has_ac = false;    // float: any block of the warp has a nonzero AC value
  // prepares round c: this lane's loads of it into the warp's buffer, then
  // (float) the AC part of its outputs, summed in double over the block's
  // nonzero AC symbols
  auto prepare = [&](const Round& c) {
    const int nb = c.blocks(gh, R);
    if (c.d >= nsteps || warp * BPW >= nb) return;
    *reinterpret_cast<int4*>(sbuf + y * 8) = nsym;
    if (y < 3) abuf[y] = naux;
    __syncwarp();
    if constexpr (!EXACT) {
      const unsigned w4[4] = {(unsigned)nsym.x, (unsigned)nsym.y, (unsigned)nsym.z,
                              (unsigned)nsym.w};
      // bit 8 j + y' of nz: symbol 8 y' + j of the block is a nonzero AC value
      unsigned long long nz = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const unsigned b = __ballot_sync(FULL, (w4[j >> 1] >> (16 * (j & 1))) & 0xffffu &&
                                                   (y | j) != 0 && i < nb);
        nz |= (unsigned long long)((b >> (lane & 24)) & 0xffu) << (8 * j);
      }
#pragma unroll
      for (int x = 0; x < 8; ++x) ac[x] = 0.0;
      const double2* mz = reinterpret_cast<const double2*>(smem) + y;
      // one nonzero value of each block a pass, as many passes as the
      // fullest block of the warp needs; a block without one adds zeros
      has_ac = __any_sync(FULL, nz != 0);
      while (__any_sync(FULL, nz != 0)) {
        const bool more = nz != 0;
        const int b = more ? __ffsll((long long)nz) - 1 : 0;
        nz &= nz - 1;
        const int k = ((b & 7) << 3) | (b >> 3);
        const double v = more ? (double)(sbuf[k] * qac) : 0.0;
#pragma unroll
        for (int x = 0; x < 8; x += 2) {
          const double2 m = mz[(k * 4 + (x >> 1)) * 8];
          ac[x] = __fma_rn(m.x, v, ac[x]);
          ac[x + 1] = __fma_rn(m.y, v, ac[x + 1]);
        }
      }
    }
  };

  // Every thread arrives at the round's barrier once, after its ring writes,
  // prepares the next round, and only then waits for the others: the next
  // round's loads and AC sums are off the chain.
  unsigned long long* bar =
      reinterpret_cast<unsigned long long*>(smem + table_bytes<T>(nwarps) + buf_bytes(nwarps));
  if (tid == 0) mbar_init(bar, blockDim.x);
  Round wk{0, 0};
  fetch(wk);
  __syncthreads();   // the tables, the ring and the barrier are ready
  prepare(wk);
  Round nx = wk;
  nx.next(gh, gw, R);
  fetch(nx);
  while (wk.d < nsteps) {
    const int nb = wk.blocks(gh, R);
    if (warp * BPW < nb) {
      const int16_t* sym = sbuf;
      const int* aux = abuf;
      // lanes past the round's blocks work its last block again and store nothing
      const bool on = i < nb;
      const int ib = on ? i : nb - 1;
      if (!on) {
        sym += (ib - i) * 64;
        aux += (ib - i) * AUX;
      }
      const int gy = wk.b0 + ib, gx = wk.d - 2 * gy;

      // --- what the chain reads, all loaded before any of it is used ---
      const bool hu = gy > 0, hl = gx > 0, first = !hu && !hl;
      const int gyu = hu ? gy - 1 : 0;
      const int sl = (gx - 1) & 3, sc = gx & 3, sr = (gx + 1 < gw ? gx + 1 : gw - 1) & 3;
      const unsigned long long lcol =
          *reinterpret_cast<const unsigned long long*>(ring.rc + (gy * 4 + sl) * 8);
      const unsigned long long urow =
          *reinterpret_cast<const unsigned long long*>(ring.br + (gyu * 4 + sc) * 8);
      const int l_dq = ring.dq[gy * 4 + sl], ul_dq = ring.dq[gyu * 4 + sl];
      const int u_dq = ring.dq[gyu * 4 + sc], ur_dq = ring.dq[gyu * 4 + sr];
      const int l_md = ring.md[gy * 4 + sl], u_md = ring.md[gyu * 4 + sc];
      const int ul_md = ring.md[gyu * 4 + sl];
      const int q0 = sym[0], kd = aux[2];
      const int fl = aux[0], bt = aux[1];

      // --- the chain: the dequantized DC and the mode, by selects ---
      const int m3 = median3(l_dq, ul_dq, u_dq), m4 = median3(l_dq, u_dq, ur_dq);
      int pred = kd == 3 ? m3 : m4;
      pred = kd == 2 ? u_dq : pred;
      pred = kd == 1 ? l_dq : pred;
      pred = kd == 0 ? 1024 : pred;
      const int dqv = q0 * qdc + pred;
      const int pred_mode = (hu && hl) ? median3(l_md, ul_md, u_md) : (hl ? l_md : u_md);
      int mode = bt == 0 ? (pred_mode == 0 ? 1 : 0) : (pred_mode == 2 ? 1 : 2);
      mode = fl == 1 ? pred_mode : mode;
      mode = first ? 2 : mode;

      // --- double: the separable inverse DCT in the reference's order ---
      T out[8];
      if constexpr (EXACT) {
        const double* ct = reinterpret_cast<const double*>(smem);
        double* nb8 = nbuf + (warp * BPW + (lane >> 3)) * NBS;
        const double irt2 = ct[64];
        double e[8];
  #pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int p = y * 8 + u, v = sym[izz_s[p]];
          e[u] = (double)(p == 0 ? dqv : v * qac);
        }
        // t1[y][x] = sum_u (iq[y][u] * cu[u]) * ct[u][x]; n = t1 * cu[y]
  #pragma unroll
        for (int x = 0; x < 8; ++x) {
          double t = __dmul_rn(__dmul_rn(e[0], irt2), ct[x]);
  #pragma unroll
          for (int u = 1; u < 8; ++u) t = __dadd_rn(t, __dmul_rn(__dmul_rn(e[u], 1.0), ct[u * 8 + x]));
          nb8[y * 8 + x] = y == 0 ? __dmul_rn(t, irt2) : t;
        }
        __syncwarp();
        // out[y][x] = sum_v n[v][x] * ct[v][y] / 4
  #pragma unroll
        for (int x = 0; x < 8; ++x) {
          double t = __dmul_rn(nb8[x], ct[y]);
  #pragma unroll
          for (int v = 1; v < 8; ++v) t = __dadd_rn(t, __dmul_rn(nb8[v * 8 + x], ct[v * 8 + y]));
          out[x] = __dmul_rn(t, 0.25);
        }
      } else if (has_ac) {
        const double dc8 = __dmul_rn((double)dqv, 0.125);
  #pragma unroll
        for (int x = 0; x < 8; ++x) out[x] = __double2float_rn(__dadd_rn(ac[x], dc8));
      } else {
        // AC-empty blocks: every output is dq / 8, exact in float
        const float r = __fmul_rn(__int2float_rn(dqv), 0.125f);
  #pragma unroll
        for (int x = 0; x < 8; ++x) out[x] = r;
      }

      // --- pixel reconstruction and the boundary state for later diagonals ---
      const int psum = (hl ? byte_sum(lcol) : 1024) + (hu ? byte_sum(urow) : 1024);
      const int pl = hl ? (int)((lcol >> (8 * y)) & 0xff) : 128;
      unsigned long long row = 0;
      if constexpr (EXACT) {
        const double p2 = __ddiv_rn((double)psum, 16.0), p1 = pl;
  #pragma unroll
        for (int x = 0; x < 8; ++x) {
          const double p0 = hu ? (int)((urow >> (8 * x)) & 0xff) : 128;
          const double p = mode == 0 ? p0 : mode == 1 ? p1 : p2;
          const int rec = min(max(__double2int_rz(__dadd_rn(out[x], p)), 0), 255);
          row |= (unsigned long long)rec << (8 * x);
        }
      } else {
        // the same arithmetic on the float pipes alone: a byte or an integer
        // below 2^23 as float is (2^23 + v) - 2^23, and clamp(trunc(v), 0, 255)
        // is the low byte of clamp(v, 0, 255) + 2^23 rounded toward zero
        const float p12 = mode == 1 ? as_float(pl) : __fmul_rn(as_float(psum), 0.0625f);
        const unsigned u_lo = hu ? (unsigned)urow : 0x80808080u;
        const unsigned u_hi = hu ? (unsigned)(urow >> 32) : 0x80808080u;
        unsigned w[8];
  #pragma unroll
        for (int x = 0; x < 8; ++x) {
          const float p0 = __fsub_rn(__uint_as_float(__byte_perm(x < 4 ? u_lo : u_hi, 0x4b000000u,
                                                                 0x7650 + (x & 3))), 8388608.0f);
          const float v = fminf(fmaxf(__fadd_rn(out[x], mode == 0 ? p0 : p12), 0.0f), 255.0f);
          w[x] = __float_as_uint(__fadd_rz(v, 8388608.0f));
        }
        row = (unsigned long long)__byte_perm(__byte_perm(w[0], w[1], 0x0040),
                                              __byte_perm(w[2], w[3], 0x0040), 0x5410) |
              (unsigned long long)__byte_perm(__byte_perm(w[4], w[5], 0x0040),
                                              __byte_perm(w[6], w[7], 0x0040), 0x5410) << 32;
      }
      if (on) {
        *reinterpret_cast<unsigned long long*>(recon + ((long long)f * gh * 8 + gy * 8 + y) * W +
                                               gx * 8) = row;
        ring.rc[(gy * 4 + sc) * 8 + y] = (uint8_t)(row >> 56);
        if (y == 7) *reinterpret_cast<unsigned long long*>(ring.br + (gy * 4 + sc) * 8) = row;
        if (y == 0) {
          ring.md[gy * 4 + sc] = mode;
          ring.dq[gy * 4 + sc] = dqv;
        }
      }
    }
    const unsigned long long token = mbar_arrive(bar);
    Round nn = nx;
    nn.next(gh, gw, R);
    __syncwarp();   // the round's reads of the warp's buffer are done
    prepare(nx);
    fetch(nn);      // in flight during the next round
    mbar_wait(bar, token);   // the round's ring writes, all of them
    wk = nx;
    nx = nn;
  }
}

struct Plan {
  int nwarps;
  size_t smem;
  bool gring;
};

// The CTA's warps, shared memory and ring place for a (gh, gw) frame: the
// ring goes to shared memory when it fits beside the rest within the
// device's opt-in, else to the global scratch ring.
template <typename T>
cudaError_t plan(int gh, int gw, Plan* p) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const int nmax = min(gh, (gw + 1) / 2);      // longest diagonal
  p->nwarps = max(1, min(MAX_WARPS, (nmax + BPW - 1) / BPW));
  const size_t fixed = fixed_bytes<T>(p->nwarps), ring = (size_t)gh * RING_ROW_BYTES;
  p->gring = fixed + ring > (size_t)optin;
  p->smem = p->gring ? fixed : fixed + ring;
  return cudaSuccess;
}

template <typename T, bool GRING>
int launch_ring(const int16_t* scan, const int8_t* mpm, const int8_t* mbit, const int* kind,
                const void* tabs, const int* izz, int nframes, int gh, int gw, int qdc, int qac,
                uint8_t* recon, unsigned char* ring_g, const Plan& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      intra_decode_kernel<T, GRING>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return (int)err;
  intra_decode_kernel<T, GRING><<<nframes, p.nwarps * 32, p.smem, stream>>>(
      scan, mpm, mbit, kind, static_cast<const T*>(tabs), izz, gh, gw, qdc, qac, recon, ring_g);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const int16_t* scan, const int8_t* mpm, const int8_t* mbit, const int* kind,
           const void* tabs, const int* izz, int nframes, int gh, int gw, int qdc, int qac,
           uint8_t* recon, unsigned char* ring_g, cudaStream_t stream) {
  Plan p{};
  const cudaError_t err = plan<T>(gh, gw, &p);
  if (err != cudaSuccess) return (int)err;
  return p.gring ? launch_ring<T, true>(scan, mpm, mbit, kind, tabs, izz, nframes, gh, gw, qdc,
                                        qac, recon, ring_g, p, stream)
                 : launch_ring<T, false>(scan, mpm, mbit, kind, tabs, izz, nframes, gh, gw, qdc,
                                         qac, recon, ring_g, p, stream);
}

template <typename T>
int occupancy(int gh, int gw, int* ctas) {
  Plan p{};
  cudaError_t err = plan<T>(gh, gw, &p);
  const auto opt = cudaFuncAttributeMaxDynamicSharedMemorySize;
  if (err == cudaSuccess) {
    err = p.gring ? cudaFuncSetAttribute(intra_decode_kernel<T, true>, opt, (int)p.smem)
                  : cudaFuncSetAttribute(intra_decode_kernel<T, false>, opt, (int)p.smem);
  }
  if (err == cudaSuccess) {
    err = p.gring ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                        ctas, intra_decode_kernel<T, true>, p.nwarps * 32, p.smem)
                  : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                        ctas, intra_decode_kernel<T, false>, p.nwarps * 32, p.smem);
  }
  return (int)err;
}

}  // namespace

// Plain C entry point, bound with ctypes by ops/intra_decode_fused.py.  scan
// is (F, gh, gw, 64) i16 in zig-zag order, 16-byte aligned; mpm / mbit (F,
// gh, gw) i8; kind (gh, gw) i32; tabs: float, the 64x64 inverse matrix with
// its columns in scan order (tabs[k * 64 + yx] = M[yx][ZIGZAG[k]]), or
// double, the cosine table and IRT2 (65 values); izz the 64 scan positions
// of the block-order coefficients (read by the double path); recon (F,
// gh*8, gw*8) u8; all contiguous.  ring: ring_bytes of global scratch, at
// least nframes * gh * RING_ROW_BYTES, that holds the ring when it does not
// fit in shared memory.  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for too small a ring or a misaligned scan).
extern "C" int icsp_intra_decode(const void* scan, const void* mpm, const void* mbit,
                                 int is_f64, const int* kind, const void* tabs,
                                 const int* izz, int nframes, int gh, int gw, int qdc,
                                 int qac, void* recon, void* ring, long long ring_bytes,
                                 void* stream) {
  if (ring_bytes < (long long)nframes * gh * RING_ROW_BYTES ||
      reinterpret_cast<uintptr_t>(scan) % 16)
    return (int)cudaErrorInvalidValue;
  auto* sc = static_cast<const int16_t*>(scan);
  auto* mp = static_cast<const int8_t*>(mpm);
  auto* mb = static_cast<const int8_t*>(mbit);
  auto* rc = static_cast<uint8_t*>(recon);
  auto st = static_cast<cudaStream_t>(stream);
  auto* rg = static_cast<unsigned char*>(ring);
  if (is_f64)
    return launch<double>(sc, mp, mb, kind, tabs, izz, nframes, gh, gw, qdc, qac, rc, rg, st);
  return launch<float>(sc, mp, mb, kind, tabs, izz, nframes, gh, gw, qdc, qac, rc, rg, st);
}

// The CTAs of a (gh, gw) frame that one SM holds at once, as the launcher
// would launch them, into *ctas.  Returns a cudaError_t.
extern "C" int icsp_intra_decode_occupancy(int is_f64, int gh, int gw, int* ctas) {
  return is_f64 ? occupancy<double>(gh, gw, ctas) : occupancy<float>(gh, gw, ctas);
}
