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
// What bounds it on the H100: latency. The work is 2R³/3 + R²L FLOP; it
// reads G's lower triangle and UtZ and writes X and W (R = 232, L = 32:
// 10 MFLOP, 0.38 MB, 0.15 µs at the fp32 peak), far less than one launch
// costs, so the design shortens the chain of dependent steps and keeps every
// operand it can on chip.
//
// The algorithm: a right-looking blocked Cholesky in panels of 32 columns
// that carries the right-hand side [W | X] = [UtZ | I] along, so that X and W
// come out of the factorization. L_B's columns are dead once their panel is
// done, and X is lower triangular, so one lower triangle M holds both: X in
// the columns of finished panels, B's trailing block in the rest. For each
// panel k (columns c0 … s−1, s = c0 + nb, nb ≤ 32):
//   1. one warp factors the diagonal block in registers with shuffles and
//      rsqrt (no __syncthreads), inverts it (D = L_kk⁻¹, one lane per column,
//      right-looking) and writes X_kk = D over it;
//   2. in parallel, one thread (one-CTA driver) or one warp of 32 (grid
//      driver) per row or column: every row below the panel is solved,
//      L_ik = A_ik Dᵀ, and every column of block row k of [W | X] (W's L
//      columns, X's c0) is scaled, Y_k = D·Y_k; both results are also
//      copied, with 16-byte rows, into compact buffers for step 3;
//   3. in 64×64 tiles of 256 threads, 4×4 outputs each in registers, from
//      those copies with float4 loads: the rank-32 update A_ij −= L_ik L_jkᵀ
//      of the trailing lower triangle and Y_i −= L_ik Y_k of the rows below,
//      over W and X's first c0 columns;
//   4. likewise per row below the panel: X_ik = −L_ik D, in place.
// That is three barriers per panel (8 panels at R = 232) where the first
// version had three per column; D is read as 16-byte broadcasts. The
// triangular products of steps 2 and 4 are one compact loop: this code runs
// once per panel, and fully unrolled it waited on instruction fetch (step 1's
// factorization, by contrast, ran faster unrolled than as a loop: one warp's
// issue rate and shuffle latency bound it; spread over eight warps with a
// barrier per column it was slower still).
//
// Two drivers of the same device code:
//   * while M (packed), W and step 3's copies fit the 227 KB shared-memory
//     opt-in (R = 232, L = 32: 224 KB): one CTA of 512 threads, the steps
//     separated by __syncthreads, step 4 of panel k run by the other warps
//     while warp 0 factors panel k+1; global memory is read once at the start
//     and written once at the end;
//   * larger R: M is the X output buffer itself (row stride R, 16.8 MB at
//     R = 2048, resident in the 50 MB L2), step 3's copies live in the
//     scratch buffer, and one cooperative launch runs every panel, its steps
//     separated by grid-wide barriers (two per panel): every CTA factors the
//     diagonal block itself (so no CTA waits on another's factorization), then
//     warps take groups of 32 rows or columns for step 2, CTAs take tiles for
//     step 3 while warps of the last CTAs take step 4's row groups. A warp
//     stages its group through a 32×33 shared tile, so that global memory is
//     read and written a 128-byte row at a time: with one thread per row, the
//     rows' scattered loads and stores took most of the time.
// Precision: fp32 FFMA throughout, no tensor cores. TF32 keeps about three
// decimal digits and the value is held to 1e-5 relative; the FLOPs take
// microseconds at any R the paths use. The pivots use rsqrtf (2 ulp); the
// value still matches the plain version well inside 1e-5 at R = 2048
// (chip_smoke.py, phase 3). Sums run in a fixed order
// (no float atomics), so the same inputs give bit-identical outputs on every
// run. A non-positive pivot gives NaN (rsqrtf of a negative number, or 0·∞)
// and is never clamped: the trainer's spike guard handles non-finite values.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>

namespace {

namespace cg = cooperative_groups;

constexpr int NB = 32;               // panel width: one warp's lanes
constexpr int DT_LD = 36;            // Dᵀ's row stride: 16-byte rows, fewer bank conflicts
constexpr int ST_LD = 36;            // the step-3 copies' row stride, likewise
constexpr int TILE = 64;             // step-3 tile edge
constexpr int TILE_THREADS = 256;    // 16×16 threads, 4×4 outputs each
constexpr int CTA_THREADS = 512;     // the one-CTA driver: two tile workers
constexpr int GRID_WARPS = TILE_THREADS / 32;  // the grid driver's warps per CTA
constexpr int DEFAULT_SMEM = 48 * 1024;
constexpr int MAX_DEVICES = 64;
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2PI = 1.8378770664093453f;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// Lower-triangular storage of M: element (r, c ≤ r) at row(r)[c].
struct Packed {  // row r after the r(r+1)/2 elements of the rows above
  float* base;
  __device__ __forceinline__ float* row(int r) const {
    return base + (size_t)r * (r + 1) / 2;
  }
};
struct Strided {  // a full R×R row-major matrix
  float* base;
  int ld;
  __device__ __forceinline__ float* row(int r) const {
    return base + (size_t)r * ld;
  }
};

// Column c of the right-hand side [W | X] at row r: W's L columns (row
// stride L), then X's, which live in M.
template <class Mat>
struct Rhs {
  Mat M;
  float* W;
  int L;
  __device__ __forceinline__ float* at(int r, int c) const {
    return c < L ? W + (size_t)r * L + c : M.row(r) + (c - L);
  }
};

// Step-3 tiles of a panel ending at s = c0 + nb: the lower triangle of the
// (R−s)² trailing block, then (R−s) × (L+c0) of [W | X] below the panel.
__host__ __device__ inline int count_tiles(int R, int L, int c0, int s) {
  const int nt = cdiv(R - s, TILE);
  return nt * (nt + 1) / 2 + nt * cdiv(L + c0, TILE);
}

// Shared-memory floats of the one-CTA driver, in layout order: D (two
// panels), Dᵀ and step 3's copies of the panel (R rows) and of the block row
// (transposed, L + R rows), all with 16-byte aligned rows; the diagonal
// block (32×33), its inverse diagonal, the reduction buffer, the log
// diagonal, W, packed M.
size_t cta_smem_floats(int R, int L) {
  return 2 * NB * NB + NB * DT_LD + (size_t)(R + L + R) * ST_LD +
         NB * (NB + 1) + NB + CTA_THREADS + R + (size_t)R * L +
         (size_t)R * (R + 1) / 2;
}

// Step 1, warp 0: L_kk, the Cholesky factor of M's nb×nb diagonal block at
// c0, padded to 32×32 with the identity. Lane i holds row i; column j's
// pivot and multipliers reach the other lanes by shuffles. Writes L_kk to Ls
// (32×33), 1/diag to inv_diag and, where logd is given, log diag to
// logd[c0 + i].
template <class Mat>
__device__ __forceinline__ void factor_diag(const Mat& M, int c0, int nb,
                                            float* Ls, float* inv_diag,
                                            float* logd) {
  const int i = threadIdx.x & 31;
  const float* src = i < nb ? M.row(c0 + i) + c0 : nullptr;
  float a[NB];
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    a[j] = (i < nb && j <= i) ? src[j] : (i == j ? 1.f : 0.f);
  }
  float diag = 1.f;
  float inv = 1.f;
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const float piv = __shfl_sync(FULL, a[j], j);
    const float rs = rsqrtf(piv);
    if (i == j) {
      diag = piv * rs;
      inv = rs;
      a[j] = diag;
    } else if (i > j) {
      a[j] *= rs;
    }
#pragma unroll
    for (int c = j + 1; c < NB; ++c) {
      const float lcj = __shfl_sync(FULL, a[j], c);
      if (i >= c) a[c] = fmaf(-a[j], lcj, a[c]);
    }
  }
#pragma unroll
  for (int j = 0; j < NB; ++j) Ls[i * (NB + 1) + j] = j <= i ? a[j] : 0.f;
  inv_diag[i] = inv;
  if (logd != nullptr && i < nb) logd[c0 + i] = logf(diag);
}

// Step 1, warp 0: D = L_kk⁻¹, lane c computing column c by right-looking
// substitution (each step one multiply, then independent FMAs). Writes D
// (row stride NB) to Ds and Dᵀ (row stride DT_LD) to DsT, both with
// 16-byte aligned rows for step 2's and step 4's float4 reads.
__device__ __forceinline__ void invert_diag(const float* Ls,
                                            const float* inv_diag, float* Ds,
                                            float* DsT) {
  const int c = threadIdx.x & 31;
  float x[NB];
#pragma unroll
  for (int r = 0; r < NB; ++r) x[r] = r == c ? 1.f : 0.f;
#pragma unroll
  for (int m = 0; m < NB; ++m) {
    x[m] *= inv_diag[m];
#pragma unroll
    for (int r = m + 1; r < NB; ++r) x[r] = fmaf(-Ls[r * (NB + 1) + m], x[m], x[r]);
  }
#pragma unroll
  for (int r = 0; r < NB; ++r) {
    Ds[r * NB + c] = x[r];
    DsT[c * DT_LD + r] = x[r];
  }
}

// The 32×32 products of steps 2 and 4, one thread per vector:
//   out[j] = sign · Σ_{m < nb} x_m T[m][j],  x_m = *src(m),
// then *dst(j) = out[j] (and stage[j · stride], where given) for j < nb.
// With T = Dᵀ, sign 1 it is v ← D·v (step 2); with T = D, sign −1 it is
// v ← −v·D (step 4). A compact loop over m with the 32 sums in registers
// (unrolled by 8, so that eight loads of x are in flight where it lives in
// global memory): D's zeros are summed too (exactly), so every m has the same
// body. All reads come before any write, so src and dst may be the same
// vector.
template <class Src, class Dst>
__device__ __forceinline__ void times_d(Src src, Dst dst, int nb,
                                        const float* T, int ldt, float sign,
                                        float* stage, int stride) {
  float out[NB];
#pragma unroll
  for (int j = 0; j < NB; ++j) out[j] = 0.f;
#pragma unroll 8
  for (int m = 0; m < nb; ++m) {
    const float x = *src(m);
    const float4* t = reinterpret_cast<const float4*>(T + m * ldt);
#pragma unroll
    for (int q = 0; q < NB / 4; ++q) {
      const float4 w = t[q];
      out[4 * q] = fmaf(w.x, x, out[4 * q]);
      out[4 * q + 1] = fmaf(w.y, x, out[4 * q + 1]);
      out[4 * q + 2] = fmaf(w.z, x, out[4 * q + 2]);
      out[4 * q + 3] = fmaf(w.w, x, out[4 * q + 3]);
    }
  }
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    if (j < nb) {
      *dst(j) = sign * out[j];
      if (stage != nullptr) stage[j * stride] = sign * out[j];
    }
  }
}

// Step 2, item `it` of panel (c0, nb): items [0, R−s) are the rows below the
// panel, the rest the columns [0, L + c0) of block row k of [W | X]. Where
// the staging buffers are given (the one-CTA driver), each result also goes
// to row `it` of Pb or row c of YbT (row stride ST_LD), for step 3.
template <class Mat>
__device__ __forceinline__ void panel_item(const Rhs<Mat>& y, int R, int c0,
                                           int nb, int it, const float* DsT,
                                           float* Pb, float* YbT) {
  const int rows = R - (c0 + nb);
  if (it < rows) {
    float* v = y.M.row(c0 + nb + it) + c0;
    const auto at = [v](int m) { return v + m; };
    times_d(at, at, nb, DsT, DT_LD, 1.f, Pb ? Pb + it * ST_LD : nullptr, 1);
  } else {
    const int c = it - rows;
    const auto at = [&y, c0, c](int m) { return y.at(c0 + m, c); };
    times_d(at, at, nb, DsT, DT_LD, 1.f, YbT ? YbT + c * ST_LD : nullptr, 1);
  }
}

// Step 4 for one row below panel (c0, nb): X_ik = −L_ik D, from src to dst.
__device__ __forceinline__ void neg_times_d(const float* src, float* dst,
                                            int nb, const float* Ds) {
  times_d([src](int m) { return src + m; }, [dst](int j) { return dst + j; },
          nb, Ds, NB, -1.f, nullptr, 0);
}

// Step 3: tile `tile` (of count_tiles) of a full panel (nb = 32; only the
// last panel is narrower, and it has no rows below it), by threads
// t = 0 … 255. Thread (ty, tx) owns rows r0 + ty + 16i and columns
// q0 + tx + 16j, i, j < 4. L_ik comes from Pb (rows s … R−1) and block row k
// of [W | X] from YbT (its transpose), the copies step 2 made: both operands
// run along m in 16-byte rows, so one float4 load feeds four steps. Writes
// only columns ≥ s of M's rows ≥ s and [W | X]'s first L + c0 columns of rows
// ≥ s, so concurrent tiles never race. Reads past the last row or column are
// clamped to it and their outputs dropped.
template <class Mat>
__device__ __forceinline__ void update_tile(const Rhs<Mat>& y, int R, int c0,
                                            const float* Pb, const float* YbT,
                                            int tile, int t) {
  const int s = c0 + NB;
  const int nt = cdiv(R - s, TILE);
  const int n_lower = nt * (nt + 1) / 2;
  const int tx = t & 15;
  const int ty = t >> 4;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  const bool lower = tile < n_lower;
  int r0, q0, ncols;
  if (lower) {
    int ti = 0;
    while ((ti + 1) * (ti + 2) / 2 <= tile) ++ti;
    r0 = s + ti * TILE;
    q0 = s + (tile - ti * (ti + 1) / 2) * TILE;
    ncols = R;
  } else {
    ncols = y.L + c0;
    const int ct = cdiv(ncols, TILE);
    r0 = s + ((tile - n_lower) / ct) * TILE;
    q0 = ((tile - n_lower) % ct) * TILE;
  }
  const float4* pa[4];
  const float4* pb[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    pa[i] = reinterpret_cast<const float4*>(
        Pb + (min(r0 + ty + 16 * i, R - 1) - s) * ST_LD);
    const int c = min(q0 + tx + 16 * i, ncols - 1);
    pb[i] = reinterpret_cast<const float4*>(lower ? Pb + (c - s) * ST_LD
                                                  : YbT + c * ST_LD);
  }
#pragma unroll 2
  for (int q = 0; q < NB / 4; ++q) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = pa[i][q];
      b[i] = pb[i][q];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float v = acc[i][j];
        v = fmaf(a[i].x, b[j].x, v);
        v = fmaf(a[i].y, b[j].y, v);
        v = fmaf(a[i].z, b[j].z, v);
        acc[i][j] = fmaf(a[i].w, b[j].w, v);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= R) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = q0 + tx + 16 * j;
      if (lower ? c <= r : c < ncols) *y.at(r, lower ? c + y.L : c) -= acc[i][j];
    }
  }
}

// Fixed-order tree over the block (blockDim.x a power of two); every thread
// gets the sum.
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

// log|B|, ‖W‖² and the scalar assembly, by one block.
__device__ void finish(const float* logd, const float* W, int R, int L,
                       float zn, float vn, float n_rows, float l_dims,
                       float* nll, float* red) {
  float lsum = 0.f;
  float wsq = 0.f;
  for (int e = threadIdx.x; e < R; e += blockDim.x) lsum += logd[e];
#pragma unroll 4
  for (int e = threadIdx.x; e < R * L; e += blockDim.x) {
    wsq = fmaf(W[e], W[e], wsq);
  }
  lsum = block_sum(lsum, red);
  wsq = block_sum(wsq, red);
  if (threadIdx.x == 0) {
    const float quad = (zn - wsq / vn) / vn;
    *nll = 0.5f * (l_dims * (n_rows * logf(vn) + 2.f * lsum) + quad +
                   n_rows * l_dims * LOG2PI);
  }
}

// ---- the one-CTA driver: everything in shared memory

__global__ void __launch_bounds__(CTA_THREADS) nll_core_cta(
    const float* __restrict__ G, const float* __restrict__ UtZ,
    const float* __restrict__ zn_p, const float* __restrict__ vn_p,
    float* __restrict__ nll, float* __restrict__ X, float* __restrict__ Wout,
    int R, int L, float n_rows, float l_dims) {
  extern __shared__ __align__(16) float smem[];
  float* Ds2 = smem;  // two panels' D, alternating
  float* DsT = Ds2 + 2 * NB * NB;
  float* Pb = DsT + NB * DT_LD;
  float* YbT = Pb + (size_t)R * ST_LD;
  float* Ls = YbT + (size_t)(L + R) * ST_LD;
  float* inv_diag = Ls + NB * (NB + 1);
  float* red = inv_diag + NB;
  float* logd = red + CTA_THREADS;
  float* W = logd + R;
  const Rhs<Packed> y{Packed{W + (size_t)R * L}, W, L};
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int warps = CTA_THREADS / 32;
  const float vn = *vn_p;

  // B's lower triangle into packed M: thread tid takes packed elements
  // p = tid + k·512, eight at a time (their (r, c) stepped first, then the
  // eight loads issued together)
  {
    const int P = R * (R + 1) / 2;
    int r = (int)((sqrtf(8.f * tid + 1.f) - 1.f) * 0.5f);
    while (r * (r + 1) / 2 > tid) --r;
    while ((r + 1) * (r + 2) / 2 <= tid) ++r;
    int c = tid - r * (r + 1) / 2;
    for (int p0 = tid; p0 < P; p0 += 8 * CTA_THREADS) {
      int rr[8], cc[8];
      float g[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        rr[k] = r;
        cc[k] = c;
        for (c += CTA_THREADS; c > r; c -= r) ++r;
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        g[k] = p0 + k * CTA_THREADS < P ? G[(size_t)rr[k] * R + cc[k]] : 0.f;
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int p = p0 + k * CTA_THREADS;
        if (p < P) y.M.base[p] = g[k] / vn + (rr[k] == cc[k] ? 1.f : 0.f);
      }
    }
  }
#pragma unroll 8
  for (int e = tid; e < R * L; e += CTA_THREADS) W[e] = UtZ[e];
  __syncthreads();

  for (int c0 = 0, k = 0; c0 < R; c0 += NB, ++k) {
    const int nb = min(NB, R - c0);
    const int s = c0 + nb;
    float* Ds = Ds2 + (k & 1) * NB * NB;
    if (warp == 0) {  // step 1 of panel k
      factor_diag(y.M, c0, nb, Ls, inv_diag, logd);
      __syncwarp();
      invert_diag(Ls, inv_diag, Ds, DsT);
      __syncwarp();
#pragma unroll
      for (int r = 0; r < NB; ++r) {
        if (r < nb && lane <= r) y.M.row(c0 + r)[c0 + lane] = Ds[r * NB + lane];
      }
    } else if (k > 0) {  // meanwhile step 4 of panel k − 1
      const float* Dp = Ds2 + ((k - 1) & 1) * NB * NB;
      for (int r = c0 + tid - 32; r < R; r += CTA_THREADS - 32) {
        float* v = y.M.row(r) + c0 - NB;
        neg_times_d(v, v, NB, Dp);
      }
    }
    __syncthreads();
    const int items = (R - s) + (L + c0);
    for (int it = tid; it < items; it += CTA_THREADS) {
      panel_item(y, R, c0, nb, it, DsT, Pb, YbT);
    }
    __syncthreads();
    const int tiles = count_tiles(R, L, c0, s);
    for (int tile = tid / TILE_THREADS; tile < tiles;
         tile += CTA_THREADS / TILE_THREADS) {
      update_tile(y, R, c0, Pb, YbT, tile, tid % TILE_THREADS);
    }
    __syncthreads();
  }
  // the last panel leaves no rows below it, so no step 4

  for (int r = warp; r < R; r += warps) {
    const float* in = y.M.row(r);
#pragma unroll 4
    for (int c = lane; c < R; c += 32) X[(size_t)r * R + c] = c <= r ? in[c] : 0.f;
  }
#pragma unroll 4
  for (int e = tid; e < R * L; e += CTA_THREADS) Wout[e] = W[e];
  finish(logd, W, R, L, *zn_p, vn, n_rows, l_dims, nll, red);
}

// Steps 2 and 4 of the grid driver, by one warp for a group of up to 32
// vectors, staged through the warp's 32×33 tile T (row stride NB + 1, so
// that both a lane's row and a lane's column are read without bank
// conflicts) so that global memory is read and written 128 bytes at a time.
//
// Rows r0 … r0+n−1 (n ≤ 32) of M, their columns c0 … c0+nb−1: lane k takes
// row k, v ← D·v (T = Dᵀ, sign 1, step 2; also copied to the group's rows
// of Pb) or v ← −v·D (T = D, sign −1, step 4).
__device__ __forceinline__ void rows_times_d(const Strided& M, int c0, int nb,
                                             int r0, int n, float* T,
                                             const float* Tm, int ldt,
                                             float sign, float* Pb) {
  const int lane = threadIdx.x & 31;
  constexpr int TLD = NB + 1;
#pragma unroll 8
  for (int k = 0; k < n; ++k) T[k * TLD + lane] = lane < nb ? M.row(r0 + k)[c0 + lane] : 0.f;
  __syncwarp();
  const auto at = [T, lane](int m) { return T + lane * TLD + m; };
  times_d(at, at, nb, Tm, ldt, sign, nullptr, 0);
  __syncwarp();
  if (lane < nb) {
#pragma unroll 8
    for (int k = 0; k < n; ++k) {
      const float v = T[k * TLD + lane];
      M.row(r0 + k)[c0 + lane] = v;
      if (Pb != nullptr) Pb[k * ST_LD + lane] = v;
    }
  }
  __syncwarp();
}

// Columns q0 … q0+n−1 (n ≤ 32) of block row k of [W | X] (rows c0 …
// c0+nb−1): lane k takes column q0+k, v ← D·v, and the results also go to
// YbT's rows q0 … q0+n−1 for step 3.
__device__ __forceinline__ void cols_times_d(const Rhs<Strided>& y, int c0,
                                             int nb, int q0, int n, float* T,
                                             const float* DsT, float* YbT) {
  const int lane = threadIdx.x & 31;
  constexpr int TLD = NB + 1;
  const bool ok = lane < n;
#pragma unroll 8
  for (int m = 0; m < nb; ++m) T[m * TLD + lane] = ok ? *y.at(c0 + m, q0 + lane) : 0.f;
  __syncwarp();
  const auto at = [T, lane](int m) { return T + m * TLD + lane; };
  times_d(at, at, nb, DsT, DT_LD, 1.f, nullptr, 0);
  __syncwarp();
  if (ok) {
#pragma unroll 8
    for (int m = 0; m < nb; ++m) *y.at(c0 + m, q0 + lane) = T[m * TLD + lane];
  }
  if (lane < nb) {
#pragma unroll 8
    for (int k = 0; k < n; ++k) YbT[(size_t)(q0 + k) * ST_LD + lane] = T[lane * TLD + k];
  }
  __syncwarp();
}

// ---- the grid driver: M is the X output buffer, one cooperative launch;
// the steps of a panel are separated by grid-wide barriers

__global__ void __launch_bounds__(TILE_THREADS) nll_core_grid(
    const float* __restrict__ G, const float* __restrict__ UtZ,
    const float* __restrict__ zn_p, const float* __restrict__ vn_p,
    float* __restrict__ nll, float* X, float* W, float* Pb, float* YbT,
    float* logd, int R, int L, float n_rows, float l_dims) {
  __shared__ __align__(16) float Ds[NB * NB];
  __shared__ __align__(16) float DsT[NB * DT_LD];
  __shared__ float Ls[NB * (NB + 1)];
  __shared__ float inv_diag[NB];
  __shared__ float red[TILE_THREADS];
  __shared__ float tiles_T[GRID_WARPS * NB * (NB + 1)];  // a 32×33 tile per warp
  cg::grid_group grid = cg::this_grid();
  const Rhs<Strided> y{Strided{X, R}, W, L};
  const int tid = threadIdx.x;
  const int first = blockIdx.x * TILE_THREADS + tid;
  const int stride = gridDim.x * TILE_THREADS;
  const int warp = tid >> 5;
  float* T = tiles_T + warp * NB * (NB + 1);
  // the warp groups of steps 2 and 4: warp 0 of every CTA first, so that
  // they spread over the SMs; step 4's from the last CTA down, away from
  // the tiles, which step 3 hands out from CTA 0 up
  const int g_first = blockIdx.x + gridDim.x * warp;
  const int g_last = (gridDim.x - 1 - blockIdx.x) + gridDim.x * warp;
  const int g_stride = gridDim.x * GRID_WARPS;
  const float vn = *vn_p;

  // B's lower triangle (zeros above) into X, UtZ into W
  for (size_t e = first; e < (size_t)R * R; e += stride) {
    const size_t r = e / R;
    const size_t c = e - r * R;
    X[e] = c <= r ? G[e] / vn + (r == c ? 1.f : 0.f) : 0.f;
  }
  for (size_t e = first; e < (size_t)R * L; e += stride) W[e] = UtZ[e];
  grid.sync();

  for (int c0 = 0; c0 < R; c0 += NB) {
    const int nb = min(NB, R - c0);
    const int s = c0 + nb;
    // step 1 in every CTA (nothing writes the diagonal block before the
    // next barrier); CTA 0 keeps the log diagonal
    if (tid < 32) {
      factor_diag(y.M, c0, nb, Ls, inv_diag, blockIdx.x == 0 ? logd : nullptr);
      __syncwarp();
      invert_diag(Ls, inv_diag, Ds, DsT);
    }
    __syncthreads();
    // step 2: groups of 32 rows below the panel, then of 32 columns of
    // block row k of [W | X]
    const int row_groups = cdiv(R - s, NB);
    const int groups = row_groups + cdiv(L + c0, NB);
    for (int g = g_first; g < groups; g += g_stride) {
      if (g < row_groups) {
        rows_times_d(y.M, c0, nb, s + g * NB, min(NB, R - s - g * NB), T, DsT,
                     DT_LD, 1.f, Pb + (size_t)g * NB * ST_LD);
      } else {
        const int q0 = (g - row_groups) * NB;
        cols_times_d(y, c0, nb, q0, min(NB, L + c0 - q0), T, DsT, YbT);
      }
    }
    grid.sync();
    // step 3, one CTA per tile; step 4 (the panel's columns of the rows
    // below, which no tile touches) by warp groups; X_kk = D over the
    // diagonal block by CTA 0
    const int tiles = count_tiles(R, L, c0, s);
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      update_tile(y, R, c0, Pb, YbT, tile, tid);
    }
    for (int g = g_last; g < row_groups; g += g_stride) {
      rows_times_d(y.M, c0, nb, s + g * NB, min(NB, R - s - g * NB), T, Ds, NB,
                   -1.f, nullptr);
    }
    if (blockIdx.x == 0) {
      for (int e = tid; e < nb * NB; e += TILE_THREADS) {
        const int r = e / NB;
        const int c = e % NB;
        if (c <= r) y.M.row(c0 + r)[c0 + c] = Ds[e];
      }
    }
    grid.sync();
  }
  if (blockIdx.x == 0) {
    finish(logd, W, R, L, *zn_p, vn, n_rows, l_dims, nll, red);
  }
}

// CTAs of the grid driver at (R, L): no more than can be resident at once
// on the current device (up to two per SM), nor than the most work units
// (tiles, or warp groups of 32 rows or columns) of any one step.
int grid_blocks(int R, int L) {
  static int per_device[MAX_DEVICES];  // resident capacity, cached
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  int cap = dev < MAX_DEVICES ? per_device[dev] : 0;
  if (cap == 0) {
    int sms = 0;
    int per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, nll_core_grid,
                                                      TILE_THREADS, 0) !=
            cudaSuccess) {
      return 0;
    }
    cap = sms * std::min(per_sm, 2);
    if (dev < MAX_DEVICES) per_device[dev] = cap;
  }
  int work = 1;
  for (int c0 = 0; c0 < R; c0 += NB) {
    const int s = c0 + std::min(NB, R - c0);
    work = std::max({work, count_tiles(R, L, c0, s),
                     cdiv(R - s, NB) + cdiv(L + c0, NB)});
  }
  return std::min(cap, work);
}

// Whether the one-CTA driver's shared memory fits the current device's
// opt-in (232,448 bytes on an H100).
bool fits_one_cta(int R, int L, size_t* bytes) {
  int dev = 0;
  int optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess) {
    return false;
  }
  *bytes = cta_smem_floats(R, L) * sizeof(float);
  return *bytes <= (size_t)optin;
}

cudaError_t allow_smem(size_t bytes) {
  static size_t allowed[MAX_DEVICES];  // per device: the opt-in set so far
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (bytes <= DEFAULT_SMEM || (dev < MAX_DEVICES && bytes <= allowed[dev])) {
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(nll_core_cta,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err == cudaSuccess && dev < MAX_DEVICES) allowed[dev] = bytes;
  return err;
}

}  // namespace

extern "C" {

// Floats of global scratch gppvae_nll_core needs at (R, L) on the current
// device: 0 for the one-CTA driver, else step 3's copies of the panel and
// the block row, and the log diagonal.
size_t gppvae_nll_core_scratch(int R, int L) {
  size_t bytes = 0;
  if (R < 1 || L < 1 || fits_one_cta(R, L, &bytes)) return 0;
  return (size_t)(R + L + R) * ST_LD + R;
}

// nll (one float), X (R×R) and W (R×L) from G (R×R), UtZ (R×L) and the
// device scalars zn and vn; scratch holds gppvae_nll_core_scratch(R, L)
// floats. One launch on `stream` (cooperative beyond the shared-memory
// bound), allocates nothing, does not synchronise; returns the launch's
// error, else cudaGetLastError().
int gppvae_nll_core(const float* G, const float* UtZ, const float* zn,
                    const float* vn, float* nll, float* X, float* W,
                    float* scratch, int R, int L, int n_rows, int l_dims,
                    cudaStream_t stream) {
  if (R < 1 || L < 1) return (int)cudaErrorInvalidValue;
  size_t bytes = 0;
  float nr = (float)n_rows;
  float ld = (float)l_dims;
  if (fits_one_cta(R, L, &bytes)) {
    cudaError_t err = allow_smem(bytes);
    if (err != cudaSuccess) return (int)err;
    nll_core_cta<<<1, CTA_THREADS, bytes, stream>>>(G, UtZ, zn, vn, nll, X, W,
                                                    R, L, nr, ld);
    return (int)cudaGetLastError();
  }
  const int blocks = grid_blocks(R, L);
  if (scratch == nullptr || blocks < 1) return (int)cudaErrorInvalidValue;
  float* Pb = scratch;  // 16-byte aligned, as is the copy after it
  float* YbT = Pb + (size_t)R * ST_LD;
  float* logd = YbT + (size_t)(L + R) * ST_LD;
  void* args[] = {&G, &UtZ, &zn, &vn, &nll, &X, &W, &Pb, &YbT, &logd,
                  &R, &L, &nr, &ld};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)nll_core_grid, dim3(blocks), dim3(TILE_THREADS), args, 0,
      stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // extern "C"
