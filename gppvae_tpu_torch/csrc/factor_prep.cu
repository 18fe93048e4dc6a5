// factor_prep: G = UᵀU, UᵀZ and ‖Z‖²_F in one pass over the N rows of
// U (N×R) and Z (N×L), row-major float32.
//
// Replaces gppvae_tpu/ops/pallas_gemm.py::_factor_prep_pallas (the Pallas
// kernel _make_factor_prep_kernel), which walked the N tiles in order on one
// TPU core and carried the sums in VMEM from one grid step to the next.
//
// What bounds it on the H100: bytes, then latency. G is symmetric, so the
// function needs N·R·(R+1) + 2·N·R·L FLOP (G's lower triangle and UᵀZ) on
// 4·N·(R+L) bytes of input; at the main path's N = 5700, R = 56, L = 16 that
// is 28.4 MFLOP on 1.66 MB, 17.1 FLOP/B, just under the card's fp32 ridge
// (67 TFLOP/s over 3.35 TB/s = 20 FLOP/B), and the bound is 0.49 µs of
// memory traffic, well under what one launch costs. So the kernel is one
// launch that keeps every SM busy:
//   * the output block [G | UᵀZ] (R × (R+L)) is cut into as few tiles as fit
//     256 threads of 4×4 register outputs (four adjacent rows by four
//     adjacent columns, each read from the ring as one 16-byte load per
//     staged row), each sized to the block (56×72 at
//     R = 56, L = 16: one tile, no padded rows or columns computed); large R
//     still splits into tiles of up to 64×96. Tiles wholly above G's diagonal
//     are not computed: the tiles that are write G's lower triangle and its
//     mirror. A tile that straddles the diagonal computes its upper part too
//     (at R = 56 the one tile does: 46 MFLOP, the whole of G), and the mirror
//     overwrites it, so G comes out exactly symmetric;
//   * N is cut into contiguous row chunks so that tiles × chunks is at most
//     two CTAs per SM. Each CTA streams its chunk through a double-buffered
//     ring in shared memory, 32 rows per stage, with cp.async: the next
//     stage's loads are in flight while this stage's FMAs run. Loads are
//     16 bytes where R and L are multiples of 4 and the pointers 16-byte
//     aligned, else 4 bytes; the ragged end of N and of the tile is
//     zero-filled by the copy itself, nothing is padded on the host;
//   * with more than one chunk, each CTA writes its partial tile to a
//     workspace, __threadfence()s and takes a ticket for its tile with an
//     integer atomicAdd; the CTA that draws the last ticket sums the partials
//     in chunk order, writes its tile of G and UᵀZ (and ‖Z‖² for tile 0) and
//     resets the ticket. No float atomics: the same inputs give bit-identical
//     outputs on every run;
//   * the finished tile goes through shared memory, so that its rows and its
//     mirror (G's columns) are both written with coalesced stores;
//   * precision: fp32 in, fp32 FFMA accumulation, no tensor cores. The TPU
//     kernel fed the MXU bf16 operands (pallas_gemm.py:34-40); TF32 would
//     keep about three decimal digits and the outputs are held to 1e-5
//     relative, so this port keeps full fp32.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int KS = 32;              // rows per pipeline stage
constexpr int STAGES = 2;
constexpr int MAX_EDGE = 64;        // output tile rows bound (16 threads × 4)
constexpr int MAX_TN = 24;          // threads along a tile's columns

// The launch's shape: made by the caller's plan (ops/factor_prep.py
// plan_factor_prep, which also sizes the chunks: at most two CTAs per SM,
// so that one's loads hide behind the other's FMAs, and at least 160 rows
// per chunk).
struct Plan {
  int tm, tn;                 // threads along the tile's rows and columns
  int row_tiles, col_tiles;   // the grid of 4·tm × 4·tn tiles over [G | UᵀZ]
  int tiles;                  // those computed (row_tile_span)
  int chunks;
  int rows_per_chunk;
  int vec;                    // 16-byte copies
};

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// The column tiles row tile rt computes: [0, below), which reach G's lower
// triangle (q0 < r0 + TM), and [from, col_tiles), which hold UᵀZ's columns.
// The tiles between lie wholly above G's diagonal: the mirror of tiles below
// it gives their values.
__host__ __device__ inline void row_tile_span(const Plan& p, int R, int rt,
                                              int* below, int* from) {
  const int b = cdiv((rt + 1) * 4 * p.tm, 4 * p.tn);
  *below = b < p.col_tiles ? b : p.col_tiles;
  const int f = R / (4 * p.tn);
  *from = f > *below ? f : *below;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ float block_sum(float v, float* red) {
  const int tid = threadIdx.x;
  red[tid] = v;
  __syncthreads();
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  const float out = red[0];
  __syncthreads();
  return out;
}

// CTA b: computed tile b % tiles of [G | UᵀZ] (row tile by row tile, in
// row_tile_span's order) over the rows of chunk b / tiles.
__global__ void __launch_bounds__(THREADS) factor_prep_kernel(
    const float* __restrict__ U, const float* __restrict__ Z,
    float* __restrict__ G, float* __restrict__ UtZ, float* __restrict__ zn,
    float* __restrict__ ws, unsigned* __restrict__ tickets, int N, int R,
    int L, Plan p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[THREADS];
  __shared__ unsigned s_ticket;

  const int C = R + L;
  const int TM = 4 * p.tm;
  const int TN = 4 * p.tn;
  const int tile = blockIdx.x % p.tiles;
  const int chunk = blockIdx.x / p.tiles;
  int rt = 0;
  int k_tile = tile;  // this tile's place in its row tile
  int below, from;
  for (;;) {
    row_tile_span(p, R, rt, &below, &from);
    const int n = below + p.col_tiles - from;
    if (k_tile < n) break;
    k_tile -= n;
    ++rt;
  }
  const int r0 = rt * TM;
  const int q0 = (k_tile < below ? k_tile : from + (k_tile - below)) * TN;
  const int n_begin = chunk * p.rows_per_chunk;
  const int n_end = min(N, n_begin + p.rows_per_chunk);
  const int t = threadIdx.x;
  const int tx = t % p.tn;
  const int ty = t / p.tn;
  const bool computes = ty < p.tm;

  // The copy each thread issues per staged row: one 16-byte vector (or one
  // float) of U's tile columns [r0, r0+TM) or of [U | Z]'s [q0, q0+TN),
  // fixed for the whole chunk; rows k0, k0 + kstep, … of each stage.
  const int width = p.vec ? 4 : 1;
  const int va = TM / width;
  const int nv = va + TN / width;
  const int kstep = THREADS / nv;
  const int k0 = t / nv;
  const int v = t % nv;
  const float* src;          // row 0's address of this thread's columns
  size_t src_ld;
  int dst;                   // offset in the stage: sa[k][·] or sb[k][·]
  bool col_ok;
  if (v < va) {
    const int r = r0 + width * v;
    col_ok = r < R;
    src = U + r;
    src_ld = R;
    dst = width * v;
  } else {
    const int q = q0 + width * (v - va);
    col_ok = q < C;
    src = q < R ? U + q : Z + (q - R);
    src_ld = q < R ? R : L;
    dst = STAGES * KS * TM + width * (v - va);
  }
  const int dst_ld = v < va ? TM : TN;
  const int stage_floats = v < va ? KS * TM : KS * TN;

  auto load_stage = [&](int buf, int n0) {
    if (k0 >= kstep) return;
    for (int k = k0; k < KS; k += kstep) {
      const int n = n0 + k;
      const bool ok = col_ok && n < n_end;
      float* d = smem + dst + buf * stage_floats + k * dst_ld;
      const float* s = ok ? src + (size_t)n * src_ld : U;
      if (p.vec) {
        cp_async16(d, s, ok);
      } else {
        cp_async4(d, s, ok);
      }
    }
  };

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int steps = cdiv(n_end - n_begin, KS);
  load_stage(0, n_begin);
  cp_async_commit();

  // ‖Z‖² of this chunk's rows, once per chunk (by tile 0's CTA), read while
  // the first stage's copies are in flight
  float zsum = 0.f;
  if (tile == 0) {
    const size_t end = (size_t)n_end * L;
#pragma unroll 4
    for (size_t e = (size_t)n_begin * L + t; e < end; e += THREADS) {
      zsum = fmaf(Z[e], Z[e], zsum);
    }
    zsum = block_sum(zsum, red);
  }

  for (int it = 0; it < steps; ++it) {
    if (it + 1 < steps) load_stage((it + 1) & 1, n_begin + (it + 1) * KS);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const float* sa = smem + (it & 1) * KS * TM;
    const float* sb = smem + STAGES * KS * TM + (it & 1) * KS * TN;
    if (computes) {
#pragma unroll 8
      for (int k = 0; k < KS; ++k) {
        const float4 a4 = *reinterpret_cast<const float4*>(sa + k * TM + 4 * ty);
        const float4 b4 = *reinterpret_cast<const float4*>(sb + k * TN + 4 * tx);
        const float a[4] = {a4.x, a4.y, a4.z, a4.w};
        const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  // The finished tile in shared memory (the ring is free once the loop's
  // last barrier has passed), row stride TN + 1; then its rows of G's lower
  // triangle and of UᵀZ, and the mirror of G's strictly lower part, each
  // written with consecutive threads on consecutive addresses.
  float* tile_s = smem;
  const int tld = TN + 1;
  auto store_tile = [&]() {
    for (int e = t; e < TM * TN; e += THREADS) {
      const int r = r0 + e / TN;
      const int c = q0 + e % TN;
      if (r >= R || c >= C) continue;
      if (c >= R) {
        UtZ[(size_t)r * L + (c - R)] = tile_s[(e / TN) * tld + e % TN];
      } else if (c <= r) {
        G[(size_t)r * R + c] = tile_s[(e / TN) * tld + e % TN];
      }
    }
    for (int e = t; e < TM * TN; e += THREADS) {
      const int r = r0 + e % TM;
      const int c = q0 + e / TM;
      if (r < R && c < r) G[(size_t)c * R + r] = tile_s[(e % TM) * tld + e / TM];
    }
  };

  if (p.chunks == 1) {
    if (computes) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) tile_s[(4 * ty + i) * tld + 4 * tx + j] = acc[i][j];
    }
    if (tile == 0 && t == 0) *zn = zsum;
    __syncthreads();
    store_tile();
    return;
  }

  const size_t tile_floats = (size_t)TM * TN;
  float* zpart = ws + (size_t)p.tiles * p.chunks * tile_floats;
  float* part = ws + ((size_t)tile * p.chunks + chunk) * tile_floats;
  if (computes) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      *reinterpret_cast<float4*>(part + (4 * ty + i) * TN + 4 * tx) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }
  if (tile == 0 && t == 0) zpart[chunk] = zsum;
  __threadfence();
  __syncthreads();
  if (t == 0) s_ticket = atomicAdd(&tickets[tile], 1u);
  __syncthreads();
  if (s_ticket != (unsigned)p.chunks - 1) return;

  // the last CTA of this tile: sum the partials in chunk order. The tile is
  // summed as a flat run of float4s (TM·TN is a multiple of 16), every
  // thread taking a few, with several chunks' loads in flight at once
  __threadfence();
  const float4* first =
      reinterpret_cast<const float4*>(ws + (size_t)tile * p.chunks * tile_floats);
  const int n4 = (int)(tile_floats / 4);
  for (int e4 = t; e4 < n4; e4 += THREADS) {
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int ch = 0; ch < p.chunks; ++ch) {
      const float4 v = __ldcg(first + (size_t)ch * n4 + e4);
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    const float vals[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int e = 4 * e4 + q;
      tile_s[(e / TN) * tld + e % TN] = vals[q];
    }
  }
  if (t == 0) {
    if (tile == 0) {
      float s = 0.f;
      for (int ch = 0; ch < p.chunks; ++ch) s += __ldcg(zpart + ch);
      *zn = s;
    }
    tickets[tile] = 0;
  }
  __syncthreads();
  store_tile();
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

}  // namespace

extern "C" {

// G (R×R), UtZ (R×L) and zn (one float) from U (N×R) and Z (N×L), by the
// caller's plan (ops/factor_prep.py plan_factor_prep, the twin of make_plan:
// tm, tn, row_tiles, col_tiles, tiles, chunks, rows_per_chunk, and vec for
// 16-byte copies); with more than one chunk, ws holds the partial tiles and
// ‖Z‖² partials (tiles·chunks·16·tm·tn + chunks floats) and tickets one
// counter per tile, at 0 (the kernel leaves them at 0). The plan is checked,
// not trusted: it must cover the shapes and match make_plan's tile count.
// One launch on `stream`; allocates nothing, does not synchronise; returns
// cudaGetLastError().
int gppvae_factor_prep(const float* U, const float* Z, float* G, float* UtZ,
                       float* zn, float* ws, unsigned* tickets, int N, int R,
                       int L, int tm, int tn, int row_tiles, int col_tiles,
                       int tiles, int chunks, int rows_per_chunk, int vec,
                       cudaStream_t stream) {
  if (N < 1 || R < 1 || L < 1) return (int)cudaErrorInvalidValue;
  Plan p{tm, tn, row_tiles, col_tiles, 0, chunks, rows_per_chunk, vec};
  if (tm < 1 || 4 * tm > MAX_EDGE || tn < 1 || tn > MAX_TN || tm * tn > THREADS ||
      row_tiles < 1 || col_tiles < 1 || 4 * tm * row_tiles < R ||
      4 * tn * col_tiles < R + L || chunks < 1 || rows_per_chunk < KS ||
      rows_per_chunk % KS != 0 || (long long)rows_per_chunk * chunks < N ||
      (long long)rows_per_chunk * (chunks - 1) >= N) {
    return (int)cudaErrorInvalidValue;
  }
  for (int rt = 0; rt < row_tiles; ++rt) {
    int below, from;
    row_tile_span(p, R, rt, &below, &from);
    p.tiles += below + col_tiles - from;
  }
  if (p.tiles != tiles || (chunks > 1 && (ws == nullptr || tickets == nullptr)) ||
      (vec && (R % 4 != 0 || L % 4 != 0 || !aligned16(U) || !aligned16(Z)))) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = (size_t)STAGES * KS * (4 * p.tm + 4 * p.tn) * sizeof(float);
  factor_prep_kernel<<<p.tiles * p.chunks, THREADS, smem, stream>>>(
      U, Z, G, UtZ, zn, ws, tickets, N, R, L, p);
  return (int)cudaGetLastError();
}

const char* gppvae_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
