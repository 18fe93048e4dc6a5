// nll_core: the Woodbury NLL tail from the R-sized core, at any R.
//
// From G (R×R), UtZ (R×L), ‖Z‖² and v_n, with B = I + G/v_n = L_B L_Bᵀ:
//   log|B| = 2·Σ log diag(L_B)
//   W      = L_B⁻¹ UtZ,   X = L_B⁻¹
//   nll    = ½[ L·(N·log v_n + log|B|) + (‖Z‖² − ‖W‖²/v_n)/v_n + N·L·log 2π ]
// X and W are emitted as the backward pass's residuals (M = XᵀW, B⁻¹ = XᵀX).
//
// Replaces gppvae_tpu/ops/pallas_chol.py::_nll_core_pallas (the Pallas kernel
// _nll_core_kernel), which padded R and L to multiples of 128 for the TPU's
// lanes and took R ≤ 512; nothing is padded here and R has no upper limit
// but device memory.
//
// What bounds it on the H100: latency, not FLOPs or bytes. The work is
// 2R³/3 + R²L FLOP on G's lower triangle and UtZ in, X and W out (R = 560:
// 0.12 GFLOP, 1.8 µs at the fp32 peak). What takes the time is the chain of
// dependent steps of a Cholesky and the barriers between them: in the
// previous design (one CTA up to R ≈ 232, a cooperative grid above) a panel
// of 32 columns took 25-45 µs, of which the 32×32 diagonal factor took ~7 µs
// and the grid's two barriers 11-13 µs (tools/torch_nll_core_steps.py).
//
// The algorithm: a right-looking blocked Cholesky in panels of 32 columns
// that carries the right-hand side [W | X] = [UtZ | I] along, so that X and W
// come out of the factorization. L_B's columns are dead once their panel is
// done, and X is lower triangular, so one lower triangle M holds both: X in
// the columns of finished panels, B's trailing block in the rest. For panel k
// (columns c0 … c0+31, D = L_kk⁻¹):
//   1. one warp factors the diagonal block and inverts it by substitution
//      (factor_block): D, and X_kk = D over the block;
//   2. each row block i below the panel: L_ik = A_ik Dᵀ, kept in a panel copy
//      Pb, and at once X_ik = −L_ik D over A_ik in M; block row k of [W | X]
//      (W's L columns, X's first c0): Y_k = D·Y_k;
//   3. each row block i below and each column tile: the trailing lower
//      triangle A_ij −= L_ik L_jkᵀ (j ≤ i) and Y_i −= L_ik Y_k, from Pb.
// Steps 2 and 3 are products of 32-row by 32-column tiles, one warp each, on
// the tensor cores: mma.sync.m16n8k8 in TF32 with every operand split as
// x = hi + lo (hi = cvt.rna.tf32(x), lo = cvt.rna.tf32(x − hi)) and the sum
// lo·hi + hi·lo + hi·hi kept in f32 ("3xTF32"), which keeps the products to
// about f32's precision; one plain TF32 pass (three decimal digits) would not
// hold X and W (tests/test_torch_nll_core_plan.py emulates both). wgmma is
// not used: it wants 64-row tiles, and these products are short and
// latency-bound, so mma.sync at a fraction of the tensor-core rate already
// removes the FFMA time. A tile's operands are all loaded before its first
// product, so that one round trip (to another CTA's shared memory, or to L2)
// pays for them.
// Lookahead: the warp that factors panel k+1 first does its diagonal tile's
// step-3 update of panel k, then factors it while the other warps finish
// step 3, so step 1 leaves the critical path where step 3 is longer; the
// other CTAs take D_{k+1} from it after the next barrier.
//
// Three drivers of this device code, chosen by the caller's plan
// (ops/nll_core.py plan_nll_core, from R, L and the device's properties, its
// cut-overs from the card's times), never by a failed launch:
//   * cta (small R): one CTA of 256 threads, everything in its shared memory
//     (packed M with rows padded to 4 floats, W, Pb, D), three __syncthreads
//     per panel;
//   * cluster (the middle band): a thread-block cluster of up to 16 CTAs
//     (above 8 with cudaFuncAttributeNonPortableClusterSizeAllowed), the rows
//     dealt to the CTAs in blocks of 32 in snake order, so that packed M, W
//     and Pb spread over the cluster's shared memory. A CTA updates the rows
//     it holds and reads the others' panel copy, block row and D through
//     distributed shared memory (cluster.map_shared_rank); two cluster
//     barriers (barrier.cluster) per panel, no grid-wide one. G's lower
//     triangle and UtZ are read into shared memory once, at the start, with
//     the bulk asynchronous copy (cp.async.bulk with an mbarrier) where rows
//     are 16-byte aligned (R and L multiples of 4), else with plain loads;
//     X and W are written once, at the end. (Dealing every tile to any CTA,
//     its operands and outputs remote, was slower on the card than dealing
//     by rows held);
//   * grid (large R): one cooperative launch of a CTA per SM, M in the X
//     output buffer (resident in the 50 MB L2), Pb and D in the scratch
//     buffer, the tiles of a step dealt over every warp of the grid, two
//     grid-wide barriers per panel.
// Precision: f32 in and out; the pivots use rsqrtf (2 ulp). Sums run in a
// fixed order (no float atomics), so the same inputs give bit-identical
// outputs on every run. A non-positive pivot gives NaN (rsqrtf of a negative
// number, or 0·∞) and is never clamped: the trainer's spike guard handles
// non-finite values.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>

#include "hopper.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int NB = 32;               // panel width: one warp's lanes
constexpr int DLD = 36;              // D's row stride (16-byte rows, no bank conflicts)
constexpr int PLD = 36;              // the panel copy's row stride, likewise
constexpr int SLD = 36;              // step 1's rows (16-byte rows, conflict-free float4 reads)
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_CLUSTER = 16;
constexpr int MAX_DEVICES = 64;
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2PI = 1.8378770664093453f;
enum Driver { kCta = 0, kCluster = 1, kGrid = 2 };

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// Σ_{i<r} ceil4(i + 1): where packed row r starts when each row is padded to
// a multiple of 4 floats (so that every row is 16-byte aligned).
__host__ __device__ inline long long padded_prefix(int r) {
  const long long K = r >> 2, j = r & 3;
  return 8 * K * (K + 1) + 4 * j * (K + 1);
}

// The CTA of a cluster of C that holds row block b (rows 32b … 32b+31):
// blocks dealt in snake order (0 … C−1, then C−1 … 0, …), so that the large
// blocks at the bottom spread evenly. Each CTA gets one block per C, the
// (b / C)-th of its own.
__host__ __device__ inline int block_owner(int b, int C) {
  const int cyc = b / C;
  const int pos = b - cyc * C;
  return (cyc & 1) ? C - 1 - pos : pos;
}

constexpr int STAMPS = 11;
#ifdef GPPVAE_STEP_CLOCK
// tools/torch_nll_core_steps.py: %globaltimer on thread 0 of each CTA at
// the step boundaries of each panel (0 panel start, 1 D in place, 2 step 2
// starts, 3 step 2 done, 4 step 3 starts, 5 step 3 done; 6 and 7 around the
// lookahead factorization, on the CTA that runs it, and inside it 8 block
// loaded, 9 factored, 10 inverted; panel slot 511 holds the first block's,
// factored before any other work)
__device__ unsigned long long* g_step_clock;
__device__ __forceinline__ void step_clock(int panel, int i) {
  if (threadIdx.x == 0 && g_step_clock != nullptr) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_step_clock[((size_t)blockIdx.x * 512 + panel) * STAMPS + i] = t;
  }
}
#else
__device__ __forceinline__ void step_clock(int, int) {}
#endif

// ---- split-TF32 tensor-core products of 32×32 tiles, one warp

// tf32, split and mma_tf32: hopper.cuh

// A lane's rows of a 32-row tile: rows g + 8i (g = lane / 4), i = 0 … 3,
// as pointers to the tile's column 0 (nullptr: a row of zeros).
struct Rows {
  float* p[4];
};

template <class RowFn>
__device__ __forceinline__ Rows lane_rows(RowFn row, int r0, int R, int col) {
  const int g = (threadIdx.x & 31) >> 2;
  Rows a;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + g + 8 * i;
    a.p[i] = r < R ? row(r) + col : nullptr;
  }
  return a;
}

// acc (rows 0…31 × columns 0…31 of the tile) += A · B over k = 0…31, A's
// rows from `a` (A(r, k) = a.p[·][k]) and B(k, n) = b(kk, h, nt) for
// k = kk + t + 4h, n = 8nt + g (t = lane % 4): each m16n8k8 sums eight
// consecutive k. Every operand is loaded first, so that one round trip (to
// another CTA's shared memory, or to L2) pays for them all, then split into
// TF32 hi + lo, and lo·hi + hi·lo + hi·hi are summed into f32.
// acc[mt][nt][e] holds row 16mt + g + 8(e / 2), column 8nt + 2t + e % 2.
// (Permuting k so that a lane's eight were one 16-byte run gave the same
// times on the card and X, W up to twice as far from the plain version.)
template <class BF>
__device__ __forceinline__ void mma32(float (&acc)[2][4][4], const Rows& a, BF b) {
  const int t = threadIdx.x & 3;
  float av[4][2][4];
  float bv[4][2][4];
#pragma unroll
  for (int kq = 0; kq < 4; ++kq) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // (g, t), (g+8, t), (g, t+4), (g+8, t+4)
        const float* row = a.p[2 * mt + (e & 1)];
        av[kq][mt][e] = row != nullptr ? row[8 * kq + t + 4 * (e >> 1)] : 0.f;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) bv[kq][h][nt] = b(8 * kq, h, nt);
  }
#pragma unroll
  for (int kq = 0; kq < 4; ++kq) {
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) split(av[kq][mt][e], ah[mt][e], al[mt][e]);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      uint32_t bh[2], bl[2];
      split(bv[kq][0][nt], bh[0], bl[0]);
      split(bv[kq][1][nt], bh[1], bl[1]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        mma_tf32(acc[mt][nt], al[mt], bh);
        mma_tf32(acc[mt][nt], ah[mt], bl);
        mma_tf32(acc[mt][nt], ah[mt], bh);
      }
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[2][4][4]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
}

// f(row pointer of out (nullptr: dropped), tile row, tile column, value) for
// each of the lane's outputs.
template <class F>
__device__ __forceinline__ void each_out(const float (&acc)[2][4][4], const Rows& out, F f) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float* row = out.p[2 * mt + (e >> 1)];
        if (row != nullptr) f(row, 16 * mt + g + 8 * (e >> 1), 8 * nt + 2 * t + (e & 1), acc[mt][nt][e]);
      }
}

// ---- where rows live

// The cta and cluster drivers: shared memory, rows dealt to the C CTAs in
// blocks of 32 (block_owner). Per block, where its rows of packed M (padded
// to 4 floats), of W (L floats) and of Pb (PLD floats) start, in whichever
// CTA holds it, as generic pointers (the own CTA's are its plain shared
// addresses); filled once at the start.
struct Dist {
  int R, L;
  float* const* mb;
  float* const* wb;
  float* const* pb;
  __device__ __forceinline__ float* mrow(int r) const {
    const int b = r >> 5;
    return mb[b] + (int)(padded_prefix(r) - padded_prefix(b << 5));
  }
  __device__ __forceinline__ float* wrow(int r) const { return wb[r >> 5] + (r & 31) * L; }
  __device__ __forceinline__ float* prow(int r) const { return pb[r >> 5] + (r & 31) * PLD; }
};

// The grid driver: M is the R×R output X, W the output W, Pb in scratch.
struct Flat {
  int R, L;
  float* X;
  float* W;
  float* P;
  __device__ __forceinline__ float* mrow(int r) const { return X + (size_t)r * R; }
  __device__ __forceinline__ float* wrow(int r) const { return W + (size_t)r * L; }
  __device__ __forceinline__ float* prow(int r) const { return P + (size_t)r * PLD; }
};

// ---- step 1, one warp: factor and invert the diagonal block

// Step 1 of the panel at c0 (nb columns): L_kk, the Cholesky factor of M's
// nb×nb diagonal block padded to 32×32 with the identity, and D = L_kk⁻¹
// (row stride DLD); X_kk = D over the block; lsum += log diag (lanes i < nb).
// The block is held whole (both triangles, so that a row is also a column),
// lane i's row i in registers; column j's multipliers L[i][j] go to row j of
// Lt (zeros at and above the diagonal) for the inversion. A loop over the
// columns whose body loads the pivot row whole (16-byte rows, all its loads
// in flight at once), updates the lane's row in registers and has no
// shuffles: unrolled, with its multipliers passed by shuffles in a branch that
// only one warp takes (so each shuffle became a collective), this step was the
// longest of a panel; as a loop that loaded, updated and stored one piece of
// the row after another, it waited on each load.
template <class S>
__device__ __forceinline__ void factor_block(const S& s, int c0, int nb, float* Ls, float* Lt,
                                             float* inv_diag, float* D, float& lsum, int clock) {
  const int i = threadIdx.x & 31;
  float* row = Ls + i * SLD;
  float* const src = i < nb ? s.mrow(c0 + i) + c0 : nullptr;  // lane i's row of the block in M
  {
    float v[NB];
#pragma unroll
    for (int j = 0; j < NB; ++j) v[j] = (src != nullptr && j <= i) ? src[j] : (i == j ? 1.f : 0.f);
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      row[j] = v[j];
      Lt[j * SLD + i] = 0.f;
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < NB; ++j) v[j] = Ls[j * SLD + i];  // the upper triangle
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      if (j > i) row[j] = v[j];
    }
    __syncwarp();
  }
  step_clock(clock, 8);
  // lane i keeps its row in registers; step j reads the pivot row j from Ls,
  // where lane j put it at the end of step j − 1, and A[i][j] as its column
  // i (the block is kept symmetric), so the only __syncwarp is the one after
  // that store
  float4* a = reinterpret_cast<float4*>(row);
  float4 w[NB / 4];
#pragma unroll
  for (int q = 0; q < NB / 4; ++q) w[q] = a[q];
  float diag = 1.f;
#pragma unroll 1
  for (int j = 0; j < NB; ++j) {
    const float4* pj = reinterpret_cast<const float4*>(Ls + j * SLD);
    float4 p[NB / 4];
#pragma unroll
    for (int q = 0; q < NB / 4; ++q) p[q] = pj[q];
    const float piv = Ls[j * SLD + j];
    const float rs = rsqrtf(piv);
    const float l = Ls[j * SLD + i] * rs;  // L[i][j], i > j
    if (i == j) {
      diag = piv * rs;
      inv_diag[j] = rs;
    }
    if (i > j) Lt[j * SLD + i] = l;
    const float lr = i > j ? l * rs : 0.f;  // row i −= L[i][j] · (row j / L[j][j])
#pragma unroll
    for (int q = 0; q < NB / 4; ++q) {
      w[q].x = fmaf(-lr, p[q].x, w[q].x);
      w[q].y = fmaf(-lr, p[q].y, w[q].y);
      w[q].z = fmaf(-lr, p[q].z, w[q].z);
      w[q].w = fmaf(-lr, p[q].w, w[q].w);
    }
    if (i == j + 1) {  // the next pivot row
#pragma unroll
      for (int q = 0; q < NB / 4; ++q) a[q] = w[q];
    }
    __syncwarp();
  }
  if (i < nb) lsum += logf(diag);
  step_clock(clock, 9);
  // D = L_kk⁻¹: lane c takes column c, by substitution down the rows, L's
  // column m read from Lt's row m as broadcasts (zeros at r ≤ m: exact)
  float x[NB];
#pragma unroll
  for (int r = 0; r < NB; ++r) x[r] = r == i ? 1.f : 0.f;
#pragma unroll
  for (int m = 0; m < NB; ++m) {
    x[m] *= inv_diag[m];
    const float4* lm = reinterpret_cast<const float4*>(Lt + m * SLD);
#pragma unroll
    for (int q = (m + 1) >> 2; q < NB / 4; ++q) {
      const float4 v = lm[q];
      x[4 * q] = fmaf(-v.x, x[m], x[4 * q]);
      x[4 * q + 1] = fmaf(-v.y, x[m], x[4 * q + 1]);
      x[4 * q + 2] = fmaf(-v.z, x[m], x[4 * q + 2]);
      x[4 * q + 3] = fmaf(-v.w, x[m], x[4 * q + 3]);
    }
  }
#pragma unroll
  for (int r = 0; r < NB; ++r) D[r * DLD + i] = x[r];
  __syncwarp();
  step_clock(clock, 10);
  // X_kk = D over the block: lane i writes its row
  if (src != nullptr) {
#pragma unroll
    for (int c = 0; c < NB; ++c) {
      if (c <= i) src[c] = D[i * DLD + c];
    }
  }
  __syncwarp();
}

// ---- steps 2 and 3, one warp per 32×32 tile

// Step 2 for row block ib below the panel at c0: L = A Dᵀ into Pb, then
// X = −L D over A in M.
template <class S>
__device__ __forceinline__ void solve_rows(const S& s, int c0, const float* D, int ib) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = ib * NB;
  float acc[2][4][4];
  zero(acc);
  mma32(acc, lane_rows([&](int r) { return s.mrow(r); }, r0, s.R, c0),
        [&](int kk, int h, int nt) { return D[(8 * nt + g) * DLD + kk + t + 4 * h]; });
  const Rows p = lane_rows([&](int r) { return s.prow(r); }, r0, s.R, 0);
  each_out(acc, p, [](float* row, int, int n, float v) { row[n] = v; });
  __syncwarp();
  zero(acc);
  mma32(acc, p, [&](int kk, int h, int nt) { return D[(kk + t + 4 * h) * DLD + 8 * nt + g]; });
  each_out(acc, lane_rows([&](int r) { return s.mrow(r); }, r0, s.R, c0),
           [](float* row, int, int n, float v) { row[n] = -v; });
  __syncwarp();
}

// Block row k of [W | X] (rows c0 … c0+nb−1), one tile of 32 columns: tiles
// [0, wt) are W's, the rest X's first c0 columns. Where the tile's columns
// end (ncols) and its row pointers.
template <class S>
__device__ __forceinline__ float* rhs_row(const S& s, int r, int tile, int wt) {
  return tile < wt ? s.wrow(r) + NB * tile : s.mrow(r) + NB * (tile - wt);
}

__device__ __forceinline__ int rhs_cols(int L, int c0, int tile, int wt) {
  return tile < wt ? L - NB * tile : c0 - NB * (tile - wt);
}

// Step 2 for one tile of block row k: Y_k = D·Y_k, in place.
template <class S>
__device__ __forceinline__ void solve_block_row(const S& s, int c0, int nb, const float* D,
                                                int tile, int wt) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int ncols = rhs_cols(s.L, c0, tile, wt);
  const float* yr[8];  // rows c0 + 4j + t
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int k = 4 * j + t;
    yr[j] = k < nb ? rhs_row(s, c0 + k, tile, wt) : nullptr;
  }
  Rows a;
#pragma unroll
  for (int i = 0; i < 4; ++i) a.p[i] = const_cast<float*>(D) + (g + 8 * i) * DLD;
  float acc[2][4][4];
  zero(acc);
  mma32(acc, a, [&](int kk, int h, int nt) {
    const float* row = yr[kk / 4 + h];
    const int n = 8 * nt + g;
    return (row != nullptr && n < ncols) ? row[n] : 0.f;
  });
  __syncwarp();
  Rows out;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = g + 8 * i;
    out.p[i] = r < nb ? rhs_row(s, c0 + r, tile, wt) : nullptr;
  }
  each_out(acc, out, [ncols](float* row, int, int n, float v) {
    if (n < ncols) row[n] = v;
  });
  __syncwarp();
}

// Step 3, row block ib × trailing column block jb (k < jb ≤ ib): the lower
// triangle of A_ij −= L_ik L_jkᵀ, both from Pb.
template <class S>
__device__ __forceinline__ void update_trailing(const S& s, int ib, int jb) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const float* lj[4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int j = jb * NB + 8 * nt + g;
    lj[nt] = j < s.R ? s.prow(j) : nullptr;
  }
  float acc[2][4][4];
  zero(acc);
  mma32(acc, lane_rows([&](int r) { return s.prow(r); }, ib * NB, s.R, 0),
        [&](int kk, int h, int nt) {
          return lj[nt] != nullptr ? lj[nt][kk + t + 4 * h] : 0.f;
        });
  const int diag = (ib - jb) * NB;  // write column n of tile row m where n ≤ m + diag
  each_out(acc, lane_rows([&](int r) { return s.mrow(r); }, ib * NB, s.R, jb * NB),
           [diag](float* row, int m, int n, float v) {
             if (n <= m + diag) row[n] -= v;
           });
}

// Step 3, row block ib × one tile of block row k's [W | X] columns:
// Y_i −= L_ik Y_k.
template <class S>
__device__ __forceinline__ void update_rhs(const S& s, int c0, int ib, int tile, int wt) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int ncols = rhs_cols(s.L, c0, tile, wt);
  const float* yr[8];  // rows c0 + 4j + t
#pragma unroll
  for (int j = 0; j < 8; ++j) yr[j] = rhs_row(s, c0 + 4 * j + t, tile, wt);
  float acc[2][4][4];
  zero(acc);
  mma32(acc, lane_rows([&](int r) { return s.prow(r); }, ib * NB, s.R, 0),
        [&](int kk, int h, int nt) {
          const int n = 8 * nt + g;
          return n < ncols ? yr[kk / 4 + h][n] : 0.f;
        });
  Rows out;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ib * NB + g + 8 * i;
    out.p[i] = r < s.R ? rhs_row(s, r, tile, wt) : nullptr;
  }
  each_out(acc, out, [ncols](float* row, int, int n, float v) {
    if (n < ncols) row[n] -= v;
  });
}

// Step 3 of panel k: units (ib, tile) for the row blocks ib > k that `mine`
// accepts, in order, tile < ib − k the trailing column blocks k+1 … ib, then
// the wt + k tiles of [W | X]. Worker `me` of `workers` takes units
// first + me, first + me + workers, … (unit 0 is (k+1, k+1), the
// lookahead's, where its CTA holds block k+1).
template <class S, class Mine>
__device__ __forceinline__ void update_units(const S& s, int k, int nblk, int wt, Mine mine,
                                             int first, int me, int workers) {
  const int c0 = k * NB;
  int u0 = 0;  // units of the accepted blocks before ib
  int u = first + me;
  for (int ib = k + 1; ib < nblk; ++ib) {
    if (!mine(ib)) continue;
    const int n = (ib - k) + wt + k;
    for (; u < u0 + n; u += workers) {
      const int tile = u - u0;
      if (tile < ib - k) {
        update_trailing(s, ib, k + 1 + tile);
      } else {
        update_rhs(s, c0, ib, tile - (ib - k), wt);
      }
    }
    u0 += n;
  }
}

// Fixed-order tree over the block; every thread gets the sum.
__device__ float block_sum(float v, float* red) {
  const int tid = threadIdx.x;
  red[tid] = v;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  const float out = red[0];
  __syncthreads();
  return out;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ float assemble(float lsum, float wsq, float zn, float vn,
                                          float n_rows, float l_dims) {
  const float quad = (zn - wsq / vn) / vn;
  return 0.5f * (l_dims * (n_rows * logf(vn) + 2.f * lsum) + quad + n_rows * l_dims * LOG2PI);
}

// smem_addr, bulk_load and mbar_wait (the bulk asynchronous copy and its
// mbarrier): hopper.cuh

// Shared-memory layout of the cta and cluster drivers, in floats: M (mfl,
// the most any CTA holds), W and Pb (32 rows per block, wbl blocks: the most
// any CTA holds), D, step 1's Ls, Lt and inverse diagonal, the reduction
// buffer, two partial sums, each block's owner, the per-block pointer tables
// (3 × nblk) and the mbarrier.
struct DistLayout {
  long long w, p, d, ls, lt, inv, red, part, own, tab, bar, total;
};

__host__ __device__ inline DistLayout dist_layout(int mfl, int wbl, int L, int nblk) {
  DistLayout o;
  o.w = mfl;
  o.p = o.w + (long long)wbl * NB * L;
  o.d = o.p + (long long)wbl * NB * PLD;
  o.ls = o.d + NB * DLD;
  o.lt = o.ls + NB * SLD;
  o.inv = o.lt + NB * SLD;
  o.red = o.inv + NB;
  o.part = o.red + THREADS;
  o.own = o.part + 4;
  o.tab = o.own + ((nblk + 3) & ~3);
  o.bar = o.tab + 3 * nblk * 2;
  o.total = o.bar + 4;
  return o;
}

// The most floats of packed M that any of C CTAs holds.
int dist_mfl(int R, int C) {
  const int nblk = cdiv(R, NB);
  long long most = 0;
  for (int q = 0; q < C; ++q) {
    long long m = 0;
    for (int b = 0; b < nblk; ++b) {
      if (block_owner(b, C) == q) m += padded_prefix(std::min(NB * (b + 1), R)) - padded_prefix(NB * b);
    }
    most = std::max(most, m);
  }
  return (int)most;
}

template <bool CLUSTER>
__device__ __forceinline__ void csync() {
  if constexpr (CLUSTER) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

// ---- the cta and cluster drivers

template <bool CLUSTER>
__global__ void __launch_bounds__(THREADS, 1) nll_core_dist(
    const float* __restrict__ G, const float* __restrict__ UtZ,
    const float* __restrict__ zn_p, const float* __restrict__ vn_p,
    float* __restrict__ nll, float* __restrict__ X, float* __restrict__ Wout,
    int R, int L, int mfl, int wbl, int bulk, float n_rows, float l_dims) {
  extern __shared__ __align__(16) float smem[];
  const int C = CLUSTER ? (int)cg::this_cluster().num_blocks() : 1;
  const int q = CLUSTER ? (int)cg::this_cluster().block_rank() : 0;
  const int nblk = cdiv(R, NB);
  const DistLayout lay = dist_layout(mfl, wbl, L, nblk);
  float* Mloc = smem;
  float* Wloc = smem + lay.w;
  float* Ploc = smem + lay.p;
  float* D = smem + lay.d;
  float* Ls = smem + lay.ls;
  float* Lt = smem + lay.lt;
  float* inv_diag = smem + lay.inv;
  float* red = smem + lay.red;
  float* part = smem + lay.part;
  int* own = reinterpret_cast<int*>(smem + lay.own);
  float** tab = reinterpret_cast<float**>(smem + lay.tab);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + lay.bar);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  // each block's owner and where its rows start there
  if (tid == 0) {
    int seen[MAX_CLUSTER] = {};
    for (int b = 0; b < nblk; ++b) {
      const int o = block_owner(b, C);
      own[b] = o;
      tab[b] = Mloc + seen[o];  // the owner's offset, rebased below
      seen[o] += (int)(padded_prefix(min(NB * (b + 1), R)) - padded_prefix(NB * b));
    }
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  for (int b = tid; b < nblk; b += THREADS) {
    float* at[3] = {tab[b], Wloc + (b / C) * NB * L, Ploc + (b / C) * NB * PLD};
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      if constexpr (CLUSTER) {
        if (own[b] != q) at[j] = cg::this_cluster().map_shared_rank(at[j], own[b]);
      }
    }
    tab[b] = at[0];
    tab[nblk + b] = at[1];
    tab[2 * nblk + b] = at[2];
  }
  __syncthreads();
  const Dist s{R, L, tab, tab + nblk, tab + 2 * nblk};
  const float vn = *vn_p;

  // this CTA's j-th block: one per C, in snake order (block_owner)
  const auto mine = [C, q](int j) { return j * C + ((j & 1) ? C - 1 - q : q); };
  int n_mine = cdiv(nblk, C);  // mine(j) < nblk for j < n_mine: only the last cycle may not
  if (mine(n_mine - 1) >= nblk) --n_mine;
  // this CTA's rows of B's lower triangle and of UtZ into shared memory
  if (bulk) {
    if (warp == 0) {
      if (lane == 0) {
        uint32_t bytes = 0;
        for (int j = 0; j < n_mine; ++j) {
          const int b = mine(j);
          const int r1 = min(NB * (b + 1), R);
          bytes += (uint32_t)(4 * (padded_prefix(r1) - padded_prefix(NB * b)) +
                              4 * (r1 - NB * b) * L);
        }
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                     ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
      }
      __syncwarp();
      for (int j = 0; j < n_mine; ++j) {
        const int b = mine(j);
        const int r1 = min(NB * (b + 1), R);
        for (int r = NB * b + lane; r < r1; r += 32) {
          bulk_load(s.mrow(r), G + (size_t)r * R, 4 * (uint32_t)(((r + 1) + 3) & ~3), bar);
        }
        if (lane == 0) {
          bulk_load(s.wrow(NB * b), UtZ + (size_t)NB * b * L, 4 * (uint32_t)((r1 - NB * b) * L), bar);
        }
      }
    }
    mbar_wait(bar, 0);
  }
  for (int j = 0; j < n_mine; ++j) {
    const int b = mine(j);
    const int r1 = min(NB * (b + 1), R);
    for (int r = NB * b + warp; r < r1; r += WARPS) {
      float* m = s.mrow(r);
      const float* g = G + (size_t)r * R;
      for (int c = lane; c <= r; c += 32) m[c] = (bulk ? m[c] : g[c]) / vn + (c == r ? 1.f : 0.f);
    }
    if (!bulk) {
      float* w = s.wrow(NB * b);
      const float* u = UtZ + (size_t)NB * b * L;
      for (int e = tid; e < (r1 - NB * b) * L; e += THREADS) w[e] = u[e];
    }
  }
  __syncthreads();
  csync<CLUSTER>();  // every CTA has its rows (and, in a cluster, is running)

  float lsum = 0.f;  // Σ log diag of the blocks this CTA's warp 0 factored (lanes)
  const int wt = cdiv(L, NB);
  int k = -1;  // panel −1: block 0's factorization alone
  for (; k < nblk; ++k) {
    const int c0 = k * NB;
    if (k >= 0) {
      const int nb = min(NB, R - c0);
      const int holder = own[k];
      step_clock(k, 0);
      if constexpr (CLUSTER) {  // D_k from the CTA that factored it
        if (q != holder) {
          const float* src = cg::this_cluster().map_shared_rank(D, holder);
          for (int e = tid; e < NB * DLD / 4; e += THREADS) {
            reinterpret_cast<float4*>(D)[e] = reinterpret_cast<const float4*>(src)[e];
          }
        }
      }
      step_clock(k, 1);
      __syncthreads();
      step_clock(k, 2);
      // step 2: this CTA's row blocks below the panel; block row k's tiles
      // (each CTA writes only the rows it holds: its accesses to the others'
      // shared memory are loads, each unit's all in flight at once)
      int j0 = 0;  // this CTA's first block below the panel
      while (j0 < n_mine && mine(j0) <= k) ++j0;
      const int n_below = n_mine - j0;
      for (int u = warp; u < n_below + (q == holder ? wt + k : 0); u += WARPS) {
        if (u < n_below) {
          solve_rows(s, c0, D, mine(j0 + u));
        } else {
          solve_block_row(s, c0, nb, D, u - n_below, wt);
        }
      }
      step_clock(k, 3);
      csync<CLUSTER>();
      step_clock(k, 4);
    }
    // step 3 of this CTA's rows; warp 0 of the CTA that holds block k+1
    // first updates its diagonal tile and factors it (lookahead)
    if (k + 1 < nblk) {
      const int first = own[k + 1] == q ? 1 : 0;
      if (first && warp == 0) {
        if (k >= 0) {
          update_trailing(s, k + 1, k + 1);
          __syncwarp();
        }
        const int slot = k >= 0 ? k : 511;
        step_clock(slot, 6);
        factor_block(s, c0 + NB, min(NB, R - c0 - NB), Ls, Lt, inv_diag, D, lsum, slot);
        step_clock(slot, 7);
      } else if (k >= 0) {
        update_units(s, k, nblk, wt, [&](int b) { return own[b] == q; }, first, warp - first,
                     WARPS - first);
      }
    }
    if (k >= 0) step_clock(k, 5);
    csync<CLUSTER>();
  }
  step_clock(k, 0);

  // this CTA's rows of X (zeros above the diagonal) and of W; the partial
  // sums, then rank 0 adds them in rank order
  float wsq = 0.f;
  for (int j = 0; j < n_mine; ++j) {
    const int b = mine(j);
    const int r1 = min(NB * (b + 1), R);
    for (int r = NB * b + warp; r < r1; r += WARPS) {
      const float* m = s.mrow(r);
      for (int c = lane; c < R; c += 32) X[(size_t)r * R + c] = c <= r ? m[c] : 0.f;
    }
    const float* w = s.wrow(NB * b);
    for (int e = tid; e < (r1 - NB * b) * L; e += THREADS) {
      Wout[(size_t)NB * b * L + e] = w[e];
      wsq = fmaf(w[e], w[e], wsq);
    }
  }
  wsq = block_sum(wsq, red);
  if (warp == 0) lsum = warp_sum(lsum);
  if (tid == 0) {
    part[0] = wsq;
    part[1] = lsum;
  }
  csync<CLUSTER>();
  if (q == 0 && tid == 0) {
    float wt_sum = 0.f;
    float l_sum = 0.f;
    for (int r = 0; r < C; ++r) {
      const float* p = part;
      if constexpr (CLUSTER) p = cg::this_cluster().map_shared_rank(part, r);
      wt_sum += p[0];
      l_sum += p[1];
    }
    *nll = assemble(l_sum, wt_sum, *zn_p, vn, n_rows, l_dims);
  }
  csync<CLUSTER>();  // no CTA leaves while rank 0 reads its shared memory
}

// ---- the grid driver: one cooperative launch, M in the X output buffer

__global__ void __launch_bounds__(THREADS, 1) nll_core_grid(
    const float* __restrict__ G, const float* __restrict__ UtZ,
    const float* __restrict__ zn_p, const float* __restrict__ vn_p,
    float* nll, float* X, float* W, float* P, float* Dg, int R, int L, float n_rows,
    float l_dims) {
  __shared__ __align__(16) float D[NB * DLD];
  __shared__ __align__(16) float Ls[NB * SLD];
  __shared__ __align__(16) float Lt[NB * SLD];
  __shared__ float inv_diag[NB];
  __shared__ float red[THREADS];
  cg::grid_group grid = cg::this_grid();
  const Flat s{R, L, X, W, P};
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int nblk = cdiv(R, NB);
  const int wt = cdiv(L, NB);
  // warp gw: warp 0 of every CTA first, so that units spread over the SMs
  const int gw = warp * gridDim.x + blockIdx.x;
  const int T = gridDim.x * WARPS;
  const float vn = *vn_p;

  // B's lower triangle (zeros above) into X, UtZ into W
  const size_t first = (size_t)blockIdx.x * THREADS + tid;
  const size_t stride = (size_t)gridDim.x * THREADS;
  for (size_t e = first; e < (size_t)R * R; e += stride) {
    const size_t r = e / R;
    const size_t c = e - r * R;
    X[e] = c <= r ? G[e] / vn + (r == c ? 1.f : 0.f) : 0.f;
  }
  for (size_t e = first; e < (size_t)R * L; e += stride) W[e] = UtZ[e];
  grid.sync();

  float lsum = 0.f;  // CTA 0's warp 0 factors every block
  int k = -1;  // panel −1: block 0's factorization alone
  for (; k < nblk; ++k) {
    const int c0 = k * NB;
    if (k >= 0) {
      const int nb = min(NB, R - c0);
      step_clock(k, 0);
      if (blockIdx.x != 0) {
        for (int e = tid; e < NB * DLD; e += THREADS) D[e] = Dg[e];
      }
      step_clock(k, 1);
      __syncthreads();
      step_clock(k, 2);
      const int n_below = nblk - k - 1;
      for (int u = gw; u < n_below + wt + k; u += T) {
        if (u < n_below) {
          solve_rows(s, c0, D, k + 1 + u);
        } else {
          solve_block_row(s, c0, nb, D, u - n_below, wt);
        }
      }
      step_clock(k, 3);
      grid.sync();
      step_clock(k, 4);
    }
    if (k + 1 < nblk) {
      if (gw == 0) {
        if (k >= 0) {
          update_trailing(s, k + 1, k + 1);
          __syncwarp();
        }
        const int slot = k >= 0 ? k : 511;
        step_clock(slot, 6);
        factor_block(s, c0 + NB, min(NB, R - c0 - NB), Ls, Lt, inv_diag, D, lsum, slot);
        for (int e = lane; e < NB * DLD; e += 32) Dg[e] = D[e];
        step_clock(slot, 7);
      } else if (k >= 0) {
        update_units(s, k, nblk, wt, [](int) { return true; }, 1, gw - 1, T - 1);
      }
    }
    if (k >= 0) step_clock(k, 5);
    grid.sync();
  }
  step_clock(k, 0);
  if (blockIdx.x == 0) {
    float wsq = 0.f;
    for (int e = tid; e < R * L; e += THREADS) wsq = fmaf(W[e], W[e], wsq);
    wsq = block_sum(wsq, red);
    if (warp == 0) lsum = warp_sum(lsum);
    if (tid == 0) *nll = assemble(lsum, wsq, *zn_p, vn, n_rows, l_dims);
  }
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

// Per device: the dynamic shared memory allowed so far for each of the
// cta and cluster kernels, and whether clusters above 8 are allowed.
size_t g_smem_allowed[MAX_DEVICES][2];
bool g_nonportable[MAX_DEVICES];

template <bool CLUSTER>
cudaError_t allow(size_t bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (CLUSTER && !g_nonportable[dev]) {
    err = cudaFuncSetAttribute(nll_core_dist<true>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    g_nonportable[dev] = true;
  }
  if (bytes > g_smem_allowed[dev][CLUSTER]) {
    err = cudaFuncSetAttribute(nll_core_dist<CLUSTER>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    g_smem_allowed[dev][CLUSTER] = bytes;
  }
  return cudaSuccess;
}

cudaLaunchConfig_t cluster_config(int C, size_t smem, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

extern "C" {

// The current device's properties the plan reads (ops/nll_core.py), once per
// device: out = [SMs, shared-memory opt-in per block (bytes), the largest
// cluster of the cluster kernel at its full shared memory, resident CTAs of
// the grid kernel per SM]. Returns a CUDA error.
int gppvae_nll_core_props(int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&out[0], cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&out[1], cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err == cudaSuccess) err = allow<true>((size_t)out[1]);
  if (err == cudaSuccess) {
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = cluster_config(1, (size_t)out[1], nullptr, &attr);
    cfg.numAttrs = 0;
    cfg.gridDim = dim3(MAX_CLUSTER);
    err = cudaOccupancyMaxPotentialClusterSize(&out[2], nll_core_dist<true>, &cfg);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3], nll_core_grid, THREADS, 0);
  }
  return (int)err;
}

// How many clusters of C CTAs with `smem` bytes each the current device can
// hold at once (cudaOccupancyMaxActiveClusters): the plan takes the cluster
// driver only where this is at least 1. Negative: a CUDA error.
int gppvae_nll_core_clusters(int C, int smem) {
  if (C < 1 || C > MAX_CLUSTER || smem < 0) return -(int)cudaErrorInvalidValue;
  cudaError_t err = allow<true>((size_t)smem);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(C, (size_t)smem, nullptr, &attr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, nll_core_dist<true>, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

// nll (one float), X (R×R) and W (R×L) from G (R×R), UtZ (R×L) and the
// device scalars zn and vn, by the plan's driver (0 cta, 1 cluster of `ctas`
// CTAs, 2 grid of `ctas` CTAs) with `smem` bytes of dynamic shared memory per
// CTA (the cta and cluster drivers: exactly what their layout needs) and, for
// the grid, `scratch` of R·36 + 32·36 floats. The plan's numbers are checked,
// not trusted. One launch on `stream`; allocates nothing, does not
// synchronise; returns the launch's error, else cudaGetLastError().
int gppvae_nll_core(const float* G, const float* UtZ, const float* zn, const float* vn,
                    float* nll, float* X, float* W, float* scratch, int R, int L,
                    int n_rows, int l_dims, int driver, int ctas, int smem,
                    cudaStream_t stream) {
  if (R < 1 || L < 1 || ctas < 1) return (int)cudaErrorInvalidValue;
  float nr = (float)n_rows;
  float ld = (float)l_dims;
  if (driver == kCta || driver == kCluster) {
    const bool cluster = driver == kCluster;
    if (cluster ? (ctas < 2 || ctas > MAX_CLUSTER) : ctas != 1) return (int)cudaErrorInvalidValue;
    const int mfl = dist_mfl(R, ctas);
    const int wbl = cdiv(cdiv(R, NB), ctas);
    if ((long long)smem != 4 * dist_layout(mfl, wbl, L, cdiv(R, NB)).total) {
      return (int)cudaErrorInvalidValue;
    }
    const int bulk = R % 4 == 0 && L % 4 == 0 && aligned16(G) && aligned16(UtZ);
    cudaError_t err = cluster ? allow<true>((size_t)smem) : allow<false>((size_t)smem);
    if (err != cudaSuccess) return (int)err;
    if (!cluster) {
      nll_core_dist<false><<<1, THREADS, smem, stream>>>(G, UtZ, zn, vn, nll, X, W, R, L, mfl, wbl,
                                                         bulk, nr, ld);
      return (int)cudaGetLastError();
    }
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(ctas, (size_t)smem, stream, &attr);
    err = cudaLaunchKernelEx(&cfg, nll_core_dist<true>, G, UtZ, zn, vn, nll, X, W, R, L, mfl,
                             wbl, bulk, nr, ld);
    return (int)(err != cudaSuccess ? err : cudaGetLastError());
  }
  if (driver != kGrid || scratch == nullptr || smem != 0) return (int)cudaErrorInvalidValue;
  float* P = scratch;
  float* Dg = scratch + (size_t)R * PLD;
  void* args[] = {&G, &UtZ, &zn, &vn, &nll, &X, &W, &P, &Dg, &R, &L, &nr, &ld};
  const cudaError_t err = cudaLaunchCooperativeKernel((const void*)nll_core_grid, dim3(ctas),
                                                      dim3(THREADS), args, 0, stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

#ifdef GPPVAE_STEP_CLOCK
// Where the step clock writes: per CTA b, panel k and stamp i, at
// buf[(b·512 + k)·11 + i] (nullptr: nowhere).
int gppvae_nll_core_clock(unsigned long long* buf) {
  return (int)cudaMemcpyToSymbol(g_step_clock, &buf, sizeof(buf));
}

int gppvae_nll_core_stamps() { return STAMPS; }
#endif

}  // extern "C"
