// factor_prep: G = UᵀU, UᵀZ and ‖Z‖²_F in one pass over the N rows of
// U (N×R) and Z (N×L), row-major float32.
//
// Replaces gppvae_tpu/ops/pallas_gemm.py::_factor_prep_pallas (the Pallas
// kernel _make_factor_prep_kernel), which walked the N tiles in order on one
// TPU core and carried the sums in VMEM from one grid step to the next.
//
// What bounds it on the H100: bytes. At the main path's N = 5700, R = 56,
// L = 16 the inputs are 1.6 MB and the work 2·N·R·(R+L) ≈ 46 MFLOP, far below
// the card's FLOP/byte ridge, so the pass is a bandwidth-bound (at this size
// launch-bound) split-N reduction, not the TPU's sequential grid.
//
// Design:
//   * the output [G | UᵀZ] (R × (R+L)) is cut into 64×64 tiles and N into
//     row chunks; block (tile, chunk) streams its chunk's rows of U and of
//     the augmented row [U | Z] through shared memory 16 rows at a time and
//     accumulates its tile in registers (4×4 per thread). The ragged end of
//     N is masked in the kernel: rows past N load as zero, nothing is padded
//     on the host;
//   * each chunk writes its partial tile to a workspace the caller allocates;
//     a second pass sums the partials over chunks in a fixed order, and the
//     ‖Z‖² partials likewise. No float atomics: the same inputs give
//     bit-identical outputs on every run;
//   * precision: fp32 in, fp32 FMA accumulation, no tensor cores. The TPU
//     kernel fed the MXU bf16 operands (pallas_gemm.py:34-40); this port
//     deliberately keeps full fp32.
//   * large R (e.g. 2048 random-Fourier features) only adds output tiles;
//     the number of chunks shrinks so blocks × chunks stays near 4 per SM
//     and the workspace stays bounded.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int TILE = 64;           // output tile edge
constexpr int KS = 16;             // rows staged in shared memory per step
constexpr int THREADS = 256;       // 16×16 threads, 4×4 outputs each
constexpr int TARGET_BLOCKS = 528; // 4 blocks per SM on a 132-SM H100
constexpr int MIN_ROWS_PER_CHUNK = 128;
constexpr int REDUCE_THREADS = 256;

struct Plan {
  int col_tiles;
  int tiles;
  int rows_per_chunk;
  int chunks;
};

int ceil_div(int a, int b) { return (a + b - 1) / b; }

Plan make_plan(int N, int R, int L) {
  Plan p;
  const int row_tiles = ceil_div(R, TILE);
  p.col_tiles = ceil_div(R + L, TILE);
  p.tiles = row_tiles * p.col_tiles;
  int chunks = ceil_div(TARGET_BLOCKS, p.tiles);
  const int max_chunks = ceil_div(N, MIN_ROWS_PER_CHUNK);
  if (chunks > max_chunks) chunks = max_chunks;
  if (chunks < 1) chunks = 1;
  p.rows_per_chunk = ceil_div(ceil_div(N, chunks), KS) * KS;
  p.chunks = ceil_div(N, p.rows_per_chunk);
  return p;
}

__global__ void __launch_bounds__(THREADS) factor_prep_partial(
    const float* __restrict__ U, const float* __restrict__ Z,
    float* __restrict__ ws_g, float* __restrict__ ws_zn, int N, int R, int L,
    int rows_per_chunk, int col_tiles) {
  __shared__ float sa[KS][TILE];  // U[n, r0 + i]
  __shared__ float sb[KS][TILE];  // [U | Z][n, c0 + j]
  __shared__ float red[THREADS];

  const int C = R + L;
  const int tr = blockIdx.x / col_tiles;
  const int tc = blockIdx.x % col_tiles;
  const int r0 = tr * TILE;
  const int c0 = tc * TILE;
  const int chunk = blockIdx.y;
  const int n_begin = chunk * rows_per_chunk;
  const int n_end = min(N, n_begin + rows_per_chunk);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  // the first tile row of every column tile also sums ‖Z‖² over the Z
  // columns it stages, so each Z entry is counted exactly once
  const bool count_z = tr == 0;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float zacc = 0.f;

  for (int n0 = n_begin; n0 < n_end; n0 += KS) {
    for (int e = threadIdx.x; e < KS * TILE; e += THREADS) {
      const int k = e / TILE;
      const int j = e % TILE;
      const int n = n0 + k;
      float a = 0.f;
      float b = 0.f;
      if (n < n_end) {
        const int r = r0 + j;
        if (r < R) a = U[(size_t)n * R + r];
        const int c = c0 + j;
        if (c < R) {
          b = U[(size_t)n * R + c];
        } else if (c < C) {
          b = Z[(size_t)n * L + (c - R)];
          if (count_z) zacc = fmaf(b, b, zacc);
        }
      }
      sa[k][j] = a;
      sb[k][j] = b;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      float a[4];
      float b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sa[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sb[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* out = ws_g + (size_t)chunk * R * C;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx + 16 * j;
      if (r < R && c < C) out[(size_t)r * C + c] = acc[i][j];
    }
  }

  if (count_z) {  // uniform across the block
    red[threadIdx.x] = zacc;
    __syncthreads();
    for (int s = THREADS / 2; s > 0; s >>= 1) {
      if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
      __syncthreads();
    }
    if (threadIdx.x == 0) ws_zn[(size_t)chunk * col_tiles + tc] = red[0];
  }
}

__global__ void __launch_bounds__(REDUCE_THREADS) factor_prep_reduce(
    const float* __restrict__ ws_g, const float* __restrict__ ws_zn,
    float* __restrict__ G, float* __restrict__ UtZ, float* __restrict__ zn,
    int R, int L, int chunks, int zn_parts) {
  const int C = R + L;
  const size_t total = (size_t)R * C;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
#pragma unroll 8
    for (int k = 0; k < chunks; ++k) s += ws_g[(size_t)k * total + e];
    const int r = (int)(e / C);
    const int c = (int)(e % C);
    if (c < R) {
      G[(size_t)r * R + c] = s;
    } else {
      UtZ[(size_t)r * L + (c - R)] = s;
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    float s = 0.f;
    for (int k = 0; k < zn_parts; ++k) s += ws_zn[k];
    *zn = s;
  }
}

}  // namespace

extern "C" {

// Floats of workspace gppvae_factor_prep needs for these shapes.
size_t gppvae_factor_prep_workspace(int N, int R, int L) {
  const Plan p = make_plan(N, R, L);
  return (size_t)p.chunks * R * (R + L) + (size_t)p.chunks * p.col_tiles;
}

// G (R×R), UtZ (R×L) and zn (one float) from U (N×R) and Z (N×L); ws holds
// gppvae_factor_prep_workspace(N, R, L) floats. Launches on `stream`,
// allocates nothing, does not synchronise; returns cudaGetLastError().
int gppvae_factor_prep(const float* U, const float* Z, float* G, float* UtZ,
                       float* zn, float* ws, int N, int R, int L,
                       cudaStream_t stream) {
  if (N < 1 || R < 1 || L < 1) return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(N, R, L);
  float* ws_g = ws;
  float* ws_zn = ws + (size_t)p.chunks * R * (R + L);
  factor_prep_partial<<<dim3(p.tiles, p.chunks), THREADS, 0, stream>>>(
      U, Z, ws_g, ws_zn, N, R, L, p.rows_per_chunk, p.col_tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t total = (size_t)R * (R + L);
  size_t blocks = (total + REDUCE_THREADS - 1) / REDUCE_THREADS;
  if (blocks > 1024) blocks = 1024;
  factor_prep_reduce<<<(unsigned)blocks, REDUCE_THREADS, 0, stream>>>(
      ws_g, ws_zn, G, UtZ, zn, R, L, p.chunks, p.chunks * p.col_tiles);
  return (int)cudaGetLastError();
}

const char* gppvae_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
