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
// Precision.  float: the fast path.  The plain version on the card
// multiplies by the float32 64x64 matrices (tables.fdct_matrix /
// idct_matrix) in double and rounds once to float.  Every entry of those
// matrices is a multiple of 2^-29 with row sums below 9, and the inputs are
// integers below 2^15 (residuals |e| <= 255, dequantized values |iq| <
// 2^15), so every partial sum is exact in double in any order
// (tests/test_torch_kernels_ef.py): the kernel's tensor-core sums, rounded
// once to float, equal the plain version's bit for bit, and so do the
// symbols and the recon.  double: the exact path, the separable transform
// with every product rounded on its own and the sums in index order
// (__dmul_rn / __dadd_rn: nvcc would otherwise contract a multiply-add into
// an FMA), bit-identical to the plain version.
//
// Bound on this card.  For CIF300 (475,200 blocks) the kernel reads 30 MB of
// u8 pixels and writes 61 MB of i16 symbols, 1.4 MB of flags and 30 MB of
// recon: ~123 MB, 37 us at 3.35 TB/s.  The float path's function is the two
// 64x64 products in double (what keeps its rounding the decoder's): the
// forward product dense, 4,096 multiply-adds a block (3.9 GFLOP, 58 us at
// the 67 TFLOP/s of the FP64 tensor cores), the inverse 64 for each
// nonzero dequantized value, which the data decides (chip_smoke.py counts
// them from the run's symbols), so operations bound it.  The exact path's
// separable transforms are 4,096 flops a block and bytes bound it.  Beside
// the bound, each frame is a chain of 2*(gh-1)+gw dependent diagonals (114
// at CIF).
//
// Design.  One CTA per frame walks the diagonals with a __syncthreads()
// between them; frames are independent, so 300 CTAs cover the card.  The
// only state a block leaves for later blocks is its right pixel column,
// bottom row, mode and dequantized DC, read by the blocks at most 3
// diagonals later: it lives in a ring of 4 slots per block row (slot gx &
// 3), 96 bytes a row, in shared memory, or in a global scratch ring of the
// same layout when it does not fit there beside the rest (from about 1,700
// block rows on), so the kernel takes every height the header carries.
// Within a diagonal a block writes slot gx & 3 of its row while the blocks
// of the row below read slots gx-3 .. gx-1 of it, so no two touch the same
// slot.
//   float (intra_luma_mma_kernel): the blocks of a diagonal are cut into
// tiles of 8, and a team of two warps takes a tile through the whole chain,
// with named barriers between its stages.  Each warp first works 4 of the
// blocks (8 lanes a block, a pixel row a lane: the SAEs four pixels an
// instruction by vabsdiff4, then three shuffles, the mode, the residuals
// into the tile buffer); then the team runs the forward product on the FP64
// tensor cores, each warp 32 of the 64 output rows (mma.m16n8k8.f64: the
// matrix, widened to double in fragment order in shared memory, is the A
// operand, the tile's 8 blocks the B operand, so every matrix element read
// serves 8 blocks), the quantizer (the DC less its predictor; the quotients
// by a 64-bit multiply), the zig-zag symbols and flags, the inverse product
// over the dequantized values, which skips the k-steps whose 8 blocks hold
// only zeros (adding zeros leaves an exact sum as it is), and the recon of
// its rows.  A warp loads its pixel row of the next diagonal while it works
// the current one.  The kernel keeps to 96 registers, so that three CIF
// frames (CTAs of 6 warps and 76 KB of shared memory) share an SM.  What
// paces it is the chain of dependent steps in each diagonal (PERF.md).
//   double (intra_luma_exact_kernel): one warp per block of the diagonal,
// two coefficients a lane, the separable transforms through a per-warp
// buffer in shared memory.
// The TPU kernel's lane shear, rolls, 0/1 extraction matmuls, split-bf16
// permutations and reciprocal division are not needed here.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int RING_ROW_BYTES = 96;  // a block row's ring: 4 modes, 4 DCs, 4 x 8 + 4 x 8 pixels
constexpr int EXACT_TAB = 65;       // the double path's table: 8x8 cosines, then IRT2
constexpr int EXACT_MAX_WARPS = 16;
constexpr int MMA_MAX_WARPS = 16;
constexpr int TILE = 8;             // blocks a warp tile of the float path (the mma's n)
constexpr int TS = 68;              // int32 stride of a block in a tile buffer: 64 + 4,
                                    // so the mma operand reads hit 32 distinct banks
constexpr int NFRAG = 4096;         // one 64x64 matrix in mma fragment order

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

// acc + the sum of the four byte absolute differences of a and b
__device__ __forceinline__ unsigned sad4(unsigned a, unsigned b, unsigned acc) {
  unsigned r;
  asm("vabsdiff4.u32.u32.u32.add %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(acc));
  return r;
}

// the residual of DC prediction: sign(d16) * (|d16| / 16)
__device__ __forceinline__ int dc_resid(int cur, int sum) {
  const int d16 = 16 * cur - sum;
  return isign(d16) * (abs(d16) / 16);
}

// the intra mode from the SAEs of the three candidates (the plain version's rule)
__device__ __forceinline__ int pick_mode(bool hu, bool hl, int sae0, int sae1, int sae2) {
  if (!hu && !hl) return 2;
  if (hu && hl) return (sae0 <= sae1 && sae0 <= sae2) ? 0 : (sae1 <= sae2 ? 1 : 2);
  if (hl) return sae2 > sae1 ? 1 : 2;
  return sae2 > sae0 ? 0 : 2;
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
  __device__ __forceinline__ void clear(int gh) {
    for (int i = threadIdx.x; i < gh * RING_ROW_BYTES / 4; i += blockDim.x)
      reinterpret_cast<int*>(md)[i] = 0;
  }
};

// What a block of a diagonal reads of its neighbours: position, slots and
// the neighbour modes and DCs
struct Cell {
  int gy, gx, gyu, sl, sc, sr;
  bool hu, hl;
  __device__ __forceinline__ Cell(int gy_, int gx_, int gw)
      : gy(gy_), gx(gx_), gyu(gy_ > 0 ? gy_ - 1 : 0), sl((gx_ - 1) & 3), sc(gx_ & 3),
        sr((gx_ + 1 < gw ? gx_ + 1 : gw - 1) & 3), hu(gy_ > 0), hl(gx_ > 0) {}
  __device__ __forceinline__ int pred_mode(const Ring& r) const {
    const int l = r.md[gy * 4 + sl], u = r.md[gyu * 4 + sc], ul = r.md[gyu * 4 + sl];
    return (hu && hl) ? median3(l, ul, u) : (hl ? l : u);
  }
  __device__ __forceinline__ int dc_predictor(const Ring& r, int kind) const {
    return dc_pred(kind, r.dq[gy * 4 + sl], r.dq[gyu * 4 + sl], r.dq[gyu * 4 + sc],
                   r.dq[gyu * 4 + sr]);
  }
};

// MPM flag and remainder bit of a block's mode against the predicted one
__device__ __forceinline__ void mpm_bits(int mode, int pred_mode, bool first, int* flag,
                                         int* bit) {
  *flag = (mode == pred_mode) && !first;
  *bit = (*flag || first) ? 0 : (pred_mode == 2 ? mode == 1 : mode == 2);
}

__device__ __forceinline__ int lo_row(int d, int gw) { return d - gw + 1 > 0 ? (d - gw + 2) / 2 : 0; }

// C division t / d (truncation toward zero) for d >= 1, without a divide:
// m = ceil(2^64 / d) (d >= 2), so |t| * m / 2^64 = |t| / d + |t| e / (d
// 2^64) with e = m d - 2^64 < d, and |t| e < 2^63 keeps the floor exact
// (kernel F's walk divides so too)
__device__ __forceinline__ unsigned long long div_multiplier(int d) {
  return d > 1 ? ~0ULL / (unsigned)d + 1 : 0;
}
__device__ __forceinline__ int div_trunc(int t, int d, unsigned long long m) {
  const int q = (int)__umul64hi((unsigned long long)(unsigned)abs(t), m);
  return d == 1 ? t : t < 0 ? -q : q;
}

// ---------------------------------------------------------------------------
// float: the blocks of a diagonal in tiles of 8, a team of TEAM warps a tile
// ---------------------------------------------------------------------------

// D (16x8) += A (16x8, row) * B (8x8, col) on the FP64 tensor cores, an
// sm_90 shape: lane = 4 g + t holds A[g + 8 (i & 1)][t + 4 (i >> 1)] in
// a[i], B[t + 4 i][g] in b[i], and D[g][2t], D[g][2t+1], D[g+8][2t],
// D[g+8][2t+1] in d0..d3.  A 64x64 product over 8 blocks is a chain of 8
// k-steps.  (Kernel F's m8n8k4 took the same time here; m16n8k16 needs more
// registers than three CTAs an SM leave.)
constexpr int KMMA = 8;
constexpr int NA = KMMA / 2, NB = KMMA / 4, KSTEPS = 64 / KMMA;
__device__ __forceinline__ void dmma(double& d0, double& d1, double& d2, double& d3,
                                       const double (&a)[NA], const double (&b)[NB]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(d0), "+d"(d1), "+d"(d2), "+d"(d3)
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// The A fragments of 16-row tile q (rows 16 q ..) and k-step ks (columns
// KMMA ks ..) of a matrix in fragment order (ops/intra_fused._fragments)
__device__ __forceinline__ void load_a(const double* af, int q, int ks, int lane,
                                       double (&a)[NA]) {
  const double2* p = reinterpret_cast<const double2*>(af + ((q * KSTEPS + ks) * 32 + lane) * NA);
#pragma unroll
  for (int i = 0; i < NA / 2; ++i) {
    const double2 v = p[i];
    a[2 * i] = v.x;
    a[2 * i + 1] = v.y;
  }
}

// The warps of a team split a tile: member m works blocks m * BPW .. + BPW - 1
// before and after the products (LPB lanes a block, a pixel row a lane) and
// output rows (m-tiles) m * MPW .. + MPW - 1 of both products.
constexpr int TEAM = 2;
constexpr int BPW = TILE / TEAM;    // blocks a warp, outside the products
constexpr int LPB = 32 / BPW;       // lanes a block: one pixel row each
constexpr int MPW = 8 / TEAM;       // m-tiles a warp
static_assert(LPB == 8, "a lane holds one pixel row of a block");

// Per team: the tile buffer (residuals, then quantized values, block-order
// rows of TS ints), each block's mode, predictor sum, DC predictor and MPM
// bits, its dequantized DC, and each member's AC-nonzero bits of the blocks.
struct TileInfo {
  int mode, sum, pred, flags;
};
constexpr size_t TEAM_BYTES = sizeof(int) * TILE * TS + sizeof(TileInfo) * TILE +
                              sizeof(int) * TILE + sizeof(int) * TEAM * TILE;

__device__ __forceinline__ void team_sync(int team) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + team), "r"(TEAM * 32) : "memory");
}

// A lane's pixel row of its block of tile nt of diagonal d (8 bytes: the
// wrapper makes s_x = 1 and the rows 8-byte aligned) and the block's DC
// kind; a block past the diagonal's end reads the diagonal's first.
__device__ __forceinline__ void fetch_row(const uint8_t* __restrict__ orig, long long s_f,
                                          long long s_gy, long long s_gx, long long s_y,
                                          const int* __restrict__ kind, int f, int gh, int gw,
                                          int d, int nt, int j, int y, uint2& px, int& kd) {
  const int lo = lo_row(d, gw), hi = min(gh - 1, d / 2);
  int gy = lo + nt * TILE + j;
  if (gy > hi) gy = lo;
  const int gx = d - 2 * gy;
  px = *reinterpret_cast<const uint2*>(orig + f * s_f + gy * s_gy + gx * s_gx + y * s_y);
  kd = kind[gy * gw + gx];
}

__device__ __forceinline__ int byte_of(uint2 v, int x) {
  return ((x < 4 ? v.x : v.y) >> (8 * (x & 3))) & 0xff;
}

// frag: the forward then the inverse float32 matrix in fragment order,
// frag[((q * KSTEPS + ks) * 32 + lane) * NA + i] = M[16 q + lane / 4 + 8 (i &
// 1)][KMMA ks + lane % 4 + 4 (i >> 1)], widened to double in shared memory.
// At most 96 registers: 5 warps of them fit an SM sub-partition's 16K, so
// three CIF frames' CTAs of 6 warps share an SM.  GRING: the ring lives in
// the global scratch ring_g (else in shared memory, where the compiler
// knows it so).
template <bool GRING>
__global__ void __maxnreg__(96)
intra_luma_mma_kernel(const uint8_t* __restrict__ orig, long long s_f, long long s_gy,
                      long long s_gx, long long s_y, long long s_x, const int* __restrict__ kind,
                      const float* __restrict__ frag, const int* __restrict__ zz_g, int gh,
                      int gw, int qdc, int qac, int16_t* __restrict__ scan,
                      int8_t* __restrict__ mpm, int8_t* __restrict__ mbit,
                      int8_t* __restrict__ acf, uint8_t* __restrict__ recon,
                      unsigned char* __restrict__ ring_g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int team = warp / TEAM, mem = warp % TEAM, nteams = (blockDim.x >> 5) / TEAM;
  const int f = blockIdx.x;
  double* af = reinterpret_cast<double*>(smem);
  int* zz = reinterpret_cast<int*>(af + 2 * NFRAG);
  unsigned char* tbase = reinterpret_cast<unsigned char*>(zz + 64) + team * TEAM_BYTES;
  int* eb = reinterpret_cast<int*>(tbase);
  TileInfo* info = reinterpret_cast<TileInfo*>(eb + TILE * TS);
  int* dqs = reinterpret_cast<int*>(info + TILE);
  int* nzp = dqs + TILE;
  unsigned char* ring_s = reinterpret_cast<unsigned char*>(zz + 64) + nteams * TEAM_BYTES;
  Ring ring(GRING ? ring_g + (long long)f * gh * RING_ROW_BYTES : ring_s, gh);

  for (int i = threadIdx.x; i < 2 * NFRAG; i += blockDim.x) af[i] = (double)frag[i];
  for (int i = threadIdx.x; i < 64; i += blockDim.x) zz[i] = zz_g[i];
  ring.clear(gh);
  __syncthreads();

  const long long W = (long long)gw * 8;
  const int g = lane >> 2, t = lane & 3;             // mma roles
  const int j = mem * BPW + lane / LPB, y = lane % LPB;  // stage roles: block j, row y
  const int mt0 = mem * MPW;                          // this warp's m-tiles
  const int zz0 = zz[2 * lane], zz1 = zz[2 * lane + 1];
  const unsigned long long mdc = div_multiplier(qdc), mac = div_multiplier(qac);
  const int nsteps = 2 * (gh - 1) + gw;
  // the pixel row and DC kind of the team's first tile of the next
  // diagonal, loaded a diagonal ahead
  uint2 px;
  int kd;
  fetch_row(orig, s_f, s_gy, s_gx, s_y, kind, f, gh, gw, 0, team, j, y, px, kd);
  for (int d = 0; d < nsteps; ++d) {
    const int lo = lo_row(d, gw), hi = min(gh - 1, d / 2);
    const int ntiles = (hi - lo + TILE) / TILE;
    uint2 cpx = px;
    int ckd = kd;
    if (d + 1 < nsteps)
      fetch_row(orig, s_f, s_gy, s_gx, s_y, kind, f, gh, gw, d + 1, team, j, y, px, kd);
    for (int nt = team; nt < ntiles; nt += nteams) {
      const int gy0 = lo + nt * TILE;
      if (nt != team) {
        fetch_row(orig, s_f, s_gy, s_gx, s_y, kind, f, gh, gw, d, nt, j, y, cpx, ckd);
        team_sync(team);  // the team is done with the buffers of its last tile
      }

      // --- per block: candidates, SAEs (four pixels an instruction), mode,
      // MPM, DC predictor; the residual row into the tile buffer ---
      {
        const int gy = gy0 + j;
        const bool on = gy <= hi;
        const Cell c(on ? gy : lo, on ? d - 2 * gy : d - 2 * lo, gw);
        const int pmode = c.pred_mode(ring);
        // a block past the diagonal's end: zero residuals, predictor 0, so
        // its dequantized values stay zero
        const int pred = on ? c.dc_predictor(ring, ckd) : 0;
        const uint2 lc = *reinterpret_cast<const uint2*>(ring.rc + (c.gy * 4 + c.sl) * 8);
        const uint2 ur = *reinterpret_cast<const uint2*>(ring.br + (c.gyu * 4 + c.sc) * 8);
        const int lsum = c.hl ? (int)(sad4(lc.x, 0, 0) + sad4(lc.y, 0, 0)) : 1024;
        const int usum = c.hu ? (int)(sad4(ur.x, 0, 0) + sad4(ur.y, 0, 0)) : 1024;
        const int sum = lsum + usum;
        const int lf = byte_of(lc, y);
        const unsigned lf4 = 0x01010101u * (unsigned)lf;
        // |dc_resid(cur, sum)| = min(|cur - a|, |cur - c|) with a = floor(sum /
        // 16) and c = ceil(sum / 16) <= a + 1, and so (|cur - a| + |cur - c| -
        // (c - a)) / 2: a row's sum from two byte SADs
        const int a = sum >> 4, cc = (sum + 15) >> 4;
        const unsigned a4 = 0x01010101u * (unsigned)a, c4 = 0x01010101u * (unsigned)cc;
        int sae0 = (int)sad4(cpx.x, ur.x, sad4(cpx.y, ur.y, 0));
        int sae1 = (int)sad4(cpx.x, lf4, sad4(cpx.y, lf4, 0));
        int sae2 = ((int)sad4(cpx.x, a4, sad4(cpx.y, a4, sad4(cpx.x, c4, sad4(cpx.y, c4, 0)))) -
                    8 * (cc - a)) / 2;
#pragma unroll
        for (int o = 1; o < LPB; o <<= 1) {
          sae0 += __shfl_xor_sync(FULL, sae0, o);
          sae1 += __shfl_xor_sync(FULL, sae1, o);
          sae2 += __shfl_xor_sync(FULL, sae2, o);
        }
        const int mode = pick_mode(c.hu, c.hl, sae0, sae1, sae2);
        int v[8];
#pragma unroll
        for (int x = 0; x < 8; ++x) {
          const int cur = byte_of(cpx, x);
          const int ev = mode == 0 ? cur - byte_of(ur, x) : mode == 1 ? cur - lf
                                                                      : dc_resid(cur, sum);
          v[x] = on ? ev : 0;
        }
        int4* e = reinterpret_cast<int4*>(eb + j * TS + y * 8);
        e[0] = make_int4(v[0], v[1], v[2], v[3]);
        e[1] = make_int4(v[4], v[5], v[6], v[7]);
        if (y == 0) {
          int flag, bit;
          mpm_bits(mode, pmode, !c.hu && !c.hl, &flag, &bit);
          info[j] = TileInfo{mode, sum, pred, flag | bit << 1};
        }
      }
      team_sync(team);

      // --- forward product, this warp's rows: acc[m][i] = d[(mt0 + m) * 8 +
      // g] of block 2t + i ---
      double acc[MPW][2];
#pragma unroll
      for (int m = 0; m < MPW; ++m) acc[m][0] = acc[m][1] = 0.0;
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        double b[NB];
#pragma unroll
        for (int i = 0; i < NB; ++i) b[i] = (double)eb[g * TS + ks * KMMA + t + 4 * i];
#pragma unroll
        for (int m = 0; m < MPW; m += 2) {
          double a[NA];
          load_a(af, (mt0 + m) / 2, ks, lane, a);
          dmma(acc[m][0], acc[m][1], acc[m + 1][0], acc[m + 1][1], a, b);
        }
      }
      team_sync(team);  // the team is done reading the residuals

      // --- quantization ((d - pred) + 0.5 at DC, the C order), into the
      // tile buffer; the dequantized DC; the AC-nonzero bits ---
      int nz[2] = {0, 0};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const TileInfo bi = info[2 * t + i];
#pragma unroll
        for (int m = 0; m < MPW; ++m) {
          const int o = (mt0 + m) * 8 + g;
          const float dv = (float)acc[m][i];
          int q;
          if (o == 0) {
            q = div_trunc(__float2int_rz(__fadd_rn(__fsub_rn(dv, (float)bi.pred), 0.5f)), qdc,
                          mdc);
            dqs[2 * t + i] = q * qdc + bi.pred;
          } else {
            q = div_trunc(__float2int_rz(__fadd_rn(dv, 0.5f)), qac, mac);
            nz[i] |= q != 0;
          }
          eb[(2 * t + i) * TS + o] = q;
        }
      }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        nz[0] |= __shfl_xor_sync(FULL, nz[0], off);
        nz[1] |= __shfl_xor_sync(FULL, nz[1], off);
      }
      if (g == 0) {
        nzp[mem * TILE + 2 * t] = nz[0];
        nzp[mem * TILE + 2 * t + 1] = nz[1];
      }
      team_sync(team);

      // --- this warp's blocks: zig-zag symbols (a block's 64 are
      // contiguous) and flags ---
#pragma unroll
      for (int k = 0; k < BPW; ++k) {
        const int b = mem * BPW + k, gy = gy0 + b;
        if (gy > hi) break;
        const long long blk = ((long long)f * gh + gy) * gw + (d - 2 * gy);
        reinterpret_cast<uint32_t*>(scan + blk * 64)[lane] =
            (uint32_t)(uint16_t)eb[b * TS + zz0] | ((uint32_t)(uint16_t)eb[b * TS + zz1] << 16);
      }
      if (lane < BPW) {
        const int b = mem * BPW + lane, gy = gy0 + b;
        if (gy <= hi) {
          int any = 0;
#pragma unroll
          for (int m = 0; m < TEAM; ++m) any |= nzp[m * TILE + b];
          const long long blk = ((long long)f * gh + gy) * gw + (d - 2 * gy);
          mpm[blk] = (int8_t)(info[b].flags & 1);
          mbit[blk] = (int8_t)(info[b].flags >> 1);
          acf[blk] = (int8_t)!any;
        }
      }

      // --- inverse product over iq (dq at DC), this warp's rows: acc[m][i]
      // = r[y = mt0 + m][x = g] of block 2t + i; k-steps whose 8 blocks are
      // all zero are skipped ---
#pragma unroll
      for (int m = 0; m < MPW; ++m) acc[m][0] = acc[m][1] = 0.0;
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        int v[NB], any = 0;
#pragma unroll
        for (int i = 0; i < NB; ++i) {
          const int k = ks * KMMA + t + 4 * i;
          v[i] = k == 0 ? dqs[g] : eb[g * TS + k] * qac;
          any |= v[i];
        }
        if (!__any_sync(FULL, any != 0)) continue;
        double b[NB];
#pragma unroll
        for (int i = 0; i < NB; ++i) b[i] = (double)v[i];
#pragma unroll
        for (int m = 0; m < MPW; m += 2) {
          double a[NA];
          load_a(af + NFRAG, (mt0 + m) / 2, ks, lane, a);
          dmma(acc[m][0], acc[m][1], acc[m + 1][0], acc[m + 1][1], a, b);
        }
      }

      // --- pixel reconstruction of this warp's rows, the ring, the recon
      // plane ---
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int b = 2 * t + i, gy = gy0 + b;
        if (gy > hi) continue;
        const Cell c(gy, d - 2 * gy, gw);
        const TileInfo bi = info[b];
        const uint2 lc = *reinterpret_cast<const uint2*>(ring.rc + (c.gy * 4 + c.sl) * 8);
        const uint8_t* urow = ring.br + (c.gyu * 4 + c.sc) * 8;
        const float pdc = __fdiv_rn((float)bi.sum, 16.0f);
        const float pup = (float)(c.hu ? urow[g] : 128);
        uint8_t* rcs = ring.rc + (c.gy * 4 + c.sc) * 8;
        uint8_t* brs = ring.br + (c.gy * 4 + c.sc) * 8;
        uint8_t col[MPW];
#pragma unroll
        for (int m = 0; m < MPW; ++m) {
          const float p = bi.mode == 0 ? pup
                        : bi.mode == 1 ? (float)(c.hl ? byte_of(lc, mt0 + m) : 128) : pdc;
          col[m] = (uint8_t)min(max(__float2int_rz(__fadd_rn((float)acc[m][i], p)), 0), 255);
        }
        // lanes of other blocks still read this block's neighbours' slots,
        // never its own: the ring is written in place
        if (recon) {
          uint8_t* rp = recon + (long long)f * (gh * 8) * W + (long long)(c.gy * 8 + mt0) * W +
                        c.gx * 8 + g;
#pragma unroll
          for (int m = 0; m < MPW; ++m) rp[m * W] = col[m];
        }
        if (g == 7) {
#pragma unroll
          for (int m = 0; m < MPW; ++m) rcs[mt0 + m] = col[m];
        }
        if (mt0 + MPW == 8) brs[g] = col[MPW - 1];
        if (mem == 0 && g == 0) {
          ring.md[c.gy * 4 + c.sc] = bi.mode;
          ring.dq[c.gy * 4 + c.sc] = dqs[b];
        }
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// double: one warp per block, the separable body
// ---------------------------------------------------------------------------

struct R {
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
};

// tab: the 8x8 cosine table ct[u * 8 + x], then IRT2
template <bool GRING>
__global__ void intra_luma_exact_kernel(const uint8_t* __restrict__ orig, long long s_f, long long s_gy,
                        long long s_gx, long long s_y, long long s_x,
                        const int* __restrict__ kind, const double* __restrict__ tab,
                        const int* __restrict__ zz, int gh, int gw, int qdc, int qac,
                        int16_t* __restrict__ scan, int8_t* __restrict__ mpm,
                        int8_t* __restrict__ mbit, int8_t* __restrict__ acf,
                        uint8_t* __restrict__ recon, unsigned char* __restrict__ ring_g) {
  using T = double;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int f = blockIdx.x;

  extern __shared__ __align__(16) unsigned char smem[];
  T* ct = reinterpret_cast<T*>(smem);
  T* ebuf = ct + EXACT_TAB + 1 + warp * 128;   // per warp: 64 coefficients ...
  T* tbuf = ebuf + 64;                         // ... and 64 for the separable stage
  int* zz_s = reinterpret_cast<int*>(ct + EXACT_TAB + 1 + nwarps * 128);
  int* qbuf = zz_s + 64 + warp * 64;
  unsigned char* ring_s = reinterpret_cast<unsigned char*>(zz_s + 64 + nwarps * 64);
  Ring ring(GRING ? ring_g + (long long)f * gh * RING_ROW_BYTES : ring_s, gh);

  for (int i = threadIdx.x; i < EXACT_TAB; i += blockDim.x) ct[i] = tab[i];
  for (int i = threadIdx.x; i < 64; i += blockDim.x) zz_s[i] = zz[i];
  ring.clear(gh);
  __syncthreads();

  const int W = gw * 8;
  const int i0 = lane, i1 = lane + 32;           // this lane's two coefficients
  const int y0 = i0 >> 3, y1 = y0 + 4, xx = i0 & 7;
  const int nsteps = 2 * (gh - 1) + gw;
  const T irt2 = ct[64];

  for (int d = 0; d < nsteps; ++d) {
    const int lo = lo_row(d, gw), hi = min(gh - 1, d / 2);
    for (int gy = lo + warp; gy <= hi; gy += nwarps) {
      const Cell c(gy, d - 2 * gy, gw);
      const int gx = c.gx;
      __syncwarp();  // the warp's buffers are free again
      const bool first = !c.hu && !c.hl;
      const uint8_t* lcol = ring.rc + (gy * 4 + c.sl) * 8;
      const uint8_t* urow = ring.br + (c.gyu * 4 + c.sc) * 8;
      int lsum = 0, usum = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) { lsum += lcol[k]; usum += urow[k]; }
      if (!c.hl) lsum = 1024;
      if (!c.hu) usum = 1024;
      const int up_x = urow[xx], lf_0 = lcol[y0], lf_1 = lcol[y1];

      const uint8_t* ob = orig + f * s_f + gy * s_gy + gx * s_gx;
      const int cur0 = ob[y0 * s_y + xx * s_x], cur1 = ob[y1 * s_y + xx * s_x];

      // --- candidate residuals and SAEs ---
      const int e0a = cur0 - up_x, e0b = cur1 - up_x;
      const int e1a = cur0 - lf_0, e1b = cur1 - lf_1;
      const int e2a = dc_resid(cur0, lsum + usum), e2b = dc_resid(cur1, lsum + usum);
      const int sae0 = warp_sum(abs(e0a) + abs(e0b));
      const int sae1 = warp_sum(abs(e1a) + abs(e1b));
      const int sae2 = warp_sum(abs(e2a) + abs(e2b));
      const int mode = pick_mode(c.hu, c.hl, sae0, sae1, sae2);
      const int erra = mode == 0 ? e0a : (mode == 1 ? e1a : e2a);
      const int errb = mode == 0 ? e0b : (mode == 1 ? e1b : e2b);
      int flag, bit;
      mpm_bits(mode, c.pred_mode(ring), first, &flag, &bit);

      // --- forward DCT: t1[v][u] = sum_x e[v][x] * ct[u][x]; out[v][u] =
      // sum_y t1[y][u] * ct[v][y], then the irt2 and 1/4 weights ---
      ebuf[i0] = (T)erra;
      ebuf[i1] = (T)errb;
      __syncwarp();
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

      // --- DC DPCM, quantization, dequantization ---
      const int pred = c.dc_predictor(ring, kind[gy * gw + gx]);
      if (i0 == 0) da = R::sub(da, (T)pred);   // (d - pred) + 0.5, the C order
      const int qa = __double2int_rz(R::add(da, (T)0.5)) / (i0 == 0 ? qdc : qac);
      const int qb = __double2int_rz(R::add(db, (T)0.5)) / qac;
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

      // --- inverse DCT: t1[r][x] = sum_u (iq[r][u] * cu[u]) * ct[u][x]; n =
      // t1 * cu[r]; out[y][x] = sum_v n[v][x] * ct[v][y], then 1/4 ---
      ta = R::mul(R::mul(ebuf[y0 * 8], irt2), ct[xx]);
      tb = R::mul(R::mul(ebuf[y1 * 8], irt2), ct[xx]);
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

      // --- pixel reconstruction ---
      T pa, pb;
      if (mode == 0) {
        pa = pb = (T)(c.hu ? up_x : 128);
      } else if (mode == 1) {
        pa = (T)(c.hl ? lf_0 : 128);
        pb = (T)(c.hl ? lf_1 : 128);
      } else {
        pa = pb = __ddiv_rn((T)(lsum + usum), (T)16.0);
      }
      const int reca = min(max(__double2int_rz(R::add(ra, pa)), 0), 255);
      const int recb = min(max(__double2int_rz(R::add(rb, pb)), 0), 255);
      if (recon != nullptr) {
        uint8_t* rp = recon + (long long)f * (gh * 8) * W + (long long)(gy * 8) * W + gx * 8;
        rp[y0 * W + xx] = (uint8_t)reca;
        rp[y1 * W + xx] = (uint8_t)recb;
      }

      // --- boundary state for the later diagonals, and the flags ---
      uint8_t* rcs = ring.rc + (gy * 4 + c.sc) * 8;
      uint8_t* brs = ring.br + (gy * 4 + c.sc) * 8;
      if (xx == 7) { rcs[y0] = (uint8_t)reca; rcs[y1] = (uint8_t)recb; }
      if (y1 == 7) brs[xx] = (uint8_t)recb;
      if (lane == 0) {
        ring.md[gy * 4 + c.sc] = mode;
        ring.dq[gy * 4 + c.sc] = new_dq;
        mpm[blk] = (int8_t)flag;
        mbit[blk] = (int8_t)bit;
        acf[blk] = (int8_t)empty;
      }
    }
    __syncthreads();
  }
}

struct Args {
  const uint8_t* orig;
  long long s_f, s_gy, s_gx, s_y, s_x;
  const int* kind;
  const void* tab;
  const int* zz;
  int nframes, gh, gw, qdc, qac;
  int16_t* scan;
  int8_t *mpm, *mbit, *acf;
  uint8_t* recon;
  unsigned char* ring;
  cudaStream_t stream;
};

int longest_diagonal(int gh, int gw) { return min(gh, (gw + 1) / 2); }

template <bool GRING>
int launch_mma(const Args& a, int nteams, size_t smem) {
  // the largest shared-memory carveout: three CIF frames' CTAs an SM
  cudaError_t err = cudaFuncSetAttribute(
      intra_luma_mma_kernel<GRING>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(intra_luma_mma_kernel<GRING>,
                               cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (err != cudaSuccess) return (int)err;
  intra_luma_mma_kernel<GRING><<<a.nframes, nteams * TEAM * 32, smem, a.stream>>>(
      a.orig, a.s_f, a.s_gy, a.s_gx, a.s_y, a.s_x, a.kind, static_cast<const float*>(a.tab),
      a.zz, a.gh, a.gw, a.qdc, a.qac, a.scan, a.mpm, a.mbit, a.acf, a.recon, a.ring);
  return (int)cudaGetLastError();
}

template <bool GRING>
int launch_exact(const Args& a, int nwarps, size_t smem) {
  const cudaError_t err = cudaFuncSetAttribute(
      intra_luma_exact_kernel<GRING>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  intra_luma_exact_kernel<GRING><<<a.nframes, nwarps * 32, smem, a.stream>>>(
      a.orig, a.s_f, a.s_gy, a.s_gx, a.s_y, a.s_x, a.kind, static_cast<const double*>(a.tab),
      a.zz, a.gh, a.gw, a.qdc, a.qac, a.scan, a.mpm, a.mbit, a.acf, a.recon, a.ring);
  return (int)cudaGetLastError();
}

// The ring goes to shared memory when it fits beside the rest (the tables,
// the zig-zag order and the warps' buffers) within the device's opt-in,
// else to the global scratch a.ring.
int launch(const Args& a, int is_f64) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const int nmax = longest_diagonal(a.gh, a.gw);
  const size_t ring = (size_t)a.gh * RING_ROW_BYTES;
  if (is_f64) {
    const int nwarps = max(1, min(EXACT_MAX_WARPS, (nmax + 1) / 2));
    const size_t fixed =
        sizeof(double) * (EXACT_TAB + 1 + nwarps * 128) + sizeof(int) * (64 + nwarps * 64);
    return fixed + ring <= (size_t)optin ? launch_exact<false>(a, nwarps, fixed + ring)
                                         : launch_exact<true>(a, nwarps, fixed);
  }
  const int nteams = max(1, min(MMA_MAX_WARPS / TEAM, (nmax + TILE - 1) / TILE));
  const size_t fixed = sizeof(double) * 2 * NFRAG + sizeof(int) * 64 + nteams * TEAM_BYTES;
  return fixed + ring <= (size_t)optin ? launch_mma<false>(a, nteams, fixed + ring)
                                       : launch_mma<true>(a, nteams, fixed);
}

}  // namespace

// Plain C entry point, bound with ctypes by ops/intra_fused.py.  orig is u8
// blocks (F, gh, gw, 8, 8) with the given element strides; tab: double, the
// 8x8 cosine table then IRT2 (is_f64), or float32, the forward then the
// inverse 64x64 matrix in mma fragment order; zz the zig-zag order (64
// int32); kind the DC kind grid (gh, gw) int32; scan (F, gh, gw, 64) i16;
// mpm / mbit / acf (F, gh, gw) i8; recon (F, gh*8, gw*8) u8 or null; ring:
// ring_bytes of global scratch, at least F * gh * RING_ROW_BYTES, that holds
// the ring when it does not fit in shared memory.  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for too small
// a ring).
extern "C" int icsp_intra_luma(const void* orig, long long s_f, long long s_gy,
                               long long s_gx, long long s_y, long long s_x, int is_f64,
                               const int* kind, const void* tab, const int* zz,
                               int nframes, int gh, int gw, int qdc, int qac, void* scan,
                               void* mpm, void* mbit, void* acf, void* recon, void* ring,
                               long long ring_bytes, void* stream) {
  if (ring_bytes < (long long)nframes * gh * RING_ROW_BYTES) return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const uint8_t*>(orig), s_f, s_gy, s_gx, s_y, s_x, kind, tab, zz,
               nframes, gh, gw, qdc, qac, static_cast<int16_t*>(scan),
               static_cast<int8_t*>(mpm), static_cast<int8_t*>(mbit), static_cast<int8_t*>(acf),
               static_cast<uint8_t*>(recon), static_cast<unsigned char*>(ring),
               static_cast<cudaStream_t>(stream)};
  return launch(a, is_f64);
}
