// factor_prep: G = UᵀU, UᵀZ and ‖Z‖²_F in one pass over the N rows of
// U (N×R) and Z (N×L), row-major float32.
//
// Replaces gppvae_tpu/ops/pallas_gemm.py::_factor_prep_pallas (the Pallas
// kernel _make_factor_prep_kernel), which walked the N tiles in order on one
// TPU core, fed the MXU bf16 operands and carried the sums in VMEM from one
// grid step to the next.
//
// What bounds it on the H100. The function needs N·R·(R+1) + 2·N·R·L FLOP
// (G's lower triangle and UᵀZ) on 4·N·(R+L) bytes of input.
//   * At the main path's N 5,700, R 56, L 16: bytes, 0.49 µs of them at
//     3.35 TB/s against 0.17 µs of products, and below both, latency: one
//     launch, the first stage's round trip to memory, and the sums of the
//     CTAs that split N. The design before this one (36 CTAs, one of which
//     summed all 36 partial tiles alone) spent 11.5 of its 26.8 µs in that
//     serial sum and 4 in its store (tools/torch_factor_prep_steps.py).
//   * At the bench's N 262,144 (R 256, 512): operations. Float32-accurate
//     products in split TF32 cost three tensor-core passes, an effective
//     165 TFLOP/s (0.12 and 0.44 ms), against 0.09-0.17 ms of bytes. The
//     design before this one ran them in fp32 FFMA at 13 TFLOP/s, held by
//     its shared-memory loads (two 16-byte loads per 16 FMA).
//
// The design:
//   * the output block [G | UᵀZ] is cut into BT×BT tiles (BT = 32, 64 or 128,
//     from the plan): for each row tile rt, the tiles left of G's diagonal,
//     the diagonal tile together with Z's first zw columns, then the rest of
//     Z's columns in tiles of zw. Tiles right of the diagonal are not
//     computed, nor, inside a diagonal tile, the 32×32 blocks above it. The
//     stored tiles write G's lower triangle and its mirror, so G comes out
//     exactly symmetric;
//   * N is cut into chunks; CTA (tile, chunk) runs nine warps: a producer
//     that streams the chunk's rows of the tile's columns of U (and Z)
//     through a ring of five to eight stages of 32 rows, waited on through
//     mbarriers, and eight consumer warps that take the tile's 32×32 blocks.
//     The producer copies a whole stage as one box of a 2-D tensor map per
//     operand (cp.async.bulk.tensor, encoded on the host through the
//     driver's cuTensorMapEncodeTiled; the box is BT + 8 columns wide, so
//     the stage's rows land padded to 8 mod 32 floats and the fragments'
//     loads, rows t and t+4 by columns g, hit 32 banks; columns and rows
//     past the matrix arrive as zeros). A stage cut by its chunk's end takes
//     one bulk copy per row, the rest of the stage zeroed. Rows that are not
//     16-byte aligned (R or L not a multiple of 4, or an offset pointer)
//     take 4-byte cp.asyncs that arrive on the same mbarrier. The plan
//     picks which, never a failed launch;
//   * the products on the tensor cores in split TF32 (mma.sync.m16n8k8):
//     each operand x = hi + lo, rounded to TF32 with two integer operations
//     each (split_rn of hopper.cuh, equal to cvt.rna.tf32.f32 for finite x,
//     which ptxas expands with checks for Inf and NaN), and lo·hi + hi·lo +
//     hi·hi summed into float32. A warp takes one column block against two
//     row blocks, so each B fragment is split once for both; a diagonal tile
//     stages its columns once and reads both operands from them (wgmma takes TF32
//     operands K-major from shared memory only, and a stage of U is MN-major
//     for both: mma.sync runs 1.7× as fast as cuBLAS's SGEMM at N 262,144,
//     so the transposing split pass wgmma would need is not built). Each
//     8-row step's three passes sum into a fresh accumulator that an FADD
//     adds to the running one: the tensor cores round their float32 sum
//     toward zero, and thousands of steps into one accumulator biased G's
//     diagonal by −6.5e-5 at N 262,144, R 256;
//   * the chunks of one tile run as thread-block clusters of up to 8 CTAs:
//     each CTA puts its partial tile in shared memory, and rank q sums the
//     q-th slice of the cluster's tiles over distributed shared memory, in
//     rank order. With more than one cluster per tile, rank q writes its
//     slice to a workspace and takes a ticket for (tile, q) with an integer
//     atomicAdd; the CTA that draws the last sums the clusters' slices in
//     order. So the serial sum is spread over the cluster's CTAs and sums
//     chunks / cluster partials. The final slice goes out through shared
//     memory: G's rows as they lie, then the mirror column by column, both
//     coalesced. No float atomics: the same inputs give bit-identical
//     outputs on every run;
//   * ‖Z‖² is a float32 sum on the CUDA cores by the CTAs of tile 0, from
//     the Z columns they stage (or, where Z spans more than one tile, from
//     their rows of Z in memory), carried as one more element of tile 0's
//     partial tile through the same fixed-order sums.
// Precision: float32 in and out. One TF32 pass keeps about three decimal
// digits, and the outputs are held to 1e-5 of the plain version: split TF32
// keeps each product to about float32's rounding, and every sum runs in
// float32 (tests/test_torch_factor_prep_plan.py emulates the arithmetic in
// numpy against float64: within the float32 plain version's distance, where
// one TF32 pass is 100-1000× farther). The TPU kernel's bf16 operands would
// not hold the bound either.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "hopper.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int CONSUMERS = 256;           // eight warps of products
constexpr int THREADS = CONSUMERS + 32;  // and the producer warp
constexpr int KS = 32;                   // rows per stage
constexpr int MAX_STAGES = 8;
constexpr int MAX_CLUSTER = 8;
constexpr int MAX_DEVICES = 64;
enum Kind { kOff = 0, kDiag = 1, kZ = 2 };

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// The most Z columns a diagonal tile takes beside G's lower blocks, so that
// its blocks fit the consumer warps (BT 128: 10 + 4; BT 64: 3 + 4; BT 32: 1 + 1).
__host__ __device__ constexpr int zmax(int bt) { return bt == 64 ? 64 : 32; }
// A stage's row stride in floats: 8 mod 32, so the fragments' loads hit 32 banks.
__host__ __device__ constexpr int row_ld(int bt) { return bt + 8; }
// Z's columns in a partial tile: whole 8-column products.
__host__ __device__ constexpr int zpad(int zw) { return (zw + 7) & ~7; }
// Floats of one partial tile: BT × (BT + zw) and ‖Z‖², padded to 16 bytes.
__host__ __device__ inline long long partial_floats(int bt, int zw) {
  return ((long long)bt * (bt + zpad(zw)) + 1 + 3) & ~3LL;
}
// Dynamic shared memory (floats): the ring, which the partial tile and the
// final values reuse, and 128 bytes to align it for the tensor copies.
__host__ __device__ inline long long smem_floats(int bt, int stages) {
  const long long ring = (long long)stages * 2 * KS * row_ld(bt);
  const long long part = 2 * partial_floats(bt, zmax(bt));
  return (ring > part ? ring : part) + 32;
}

// The launch's shape beyond BT, made by the caller's plan
// (ops/factor_prep.py plan_factor_prep): Z's columns per Z tile and their
// count, the tiles computed, CTAs per cluster, N's chunks (a multiple of the
// cluster) and their rows, the ring's stages, and tensor copies or 4-byte ones.
enum Copy { kCopy4 = 0, kTma = 1 };
struct Plan {
  int zw, z_tiles, tiles, cluster, chunks, rows_per_chunk, stages, copy;
};

constexpr int STAMPS = 9;
#ifdef GPPVAE_STEP_CLOCK
// tools/torch_factor_prep_steps.py: %globaltimer on thread 0 of each CTA at
// 0 its start, 1 its first stage in shared memory, 2 its last stage consumed,
// 3 its partial tile in shared memory, 4 its cluster's slice summed (and
// written to the workspace, or stored), 5 its ticket taken, 6 and 7 the last
// CTA's sum stored; 8 holds the ns thread 0 waited on the ring (buf[b·9 + i])
__device__ unsigned long long* g_fp_clock;
__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ void step_clock(int i, unsigned long long v = 0) {
  if (threadIdx.x == 0 && g_fp_clock != nullptr) {
    g_fp_clock[(size_t)blockIdx.x * STAMPS + i] = i == 8 ? v : now_ns();
  }
}
#else
__device__ __forceinline__ unsigned long long now_ns() { return 0; }
__device__ __forceinline__ void step_clock(int, unsigned long long = 0) {}
#endif

struct Tile {
  int kind, r0, c0, z0;
};

// Tile `tile` in row-tile order: for row tile rt, rt tiles left of the
// diagonal (G's columns c0 = 0, BT, …), the diagonal tile with Z's columns
// [0, zw), then Z's columns [zt·zw, …) for zt = 1 … z_tiles − 1.
__device__ __forceinline__ Tile decode(int tile, int bt, const Plan& p) {
  int rt = 0;
  while (tile >= rt + p.z_tiles) {
    tile -= rt + p.z_tiles;
    ++rt;
  }
  Tile t;
  t.r0 = rt * bt;
  if (tile < rt) {
    t.kind = kOff;
    t.c0 = tile * bt;
    t.z0 = 0;
  } else {
    t.kind = tile == rt ? kDiag : kZ;
    t.c0 = t.r0;
    t.z0 = (tile - rt) * p.zw;
  }
  return t;
}

// A consumer warp's work: one column block of the tile against one or two
// row blocks. B's 32 columns come from `b` in the stage's A rows (in_a: G's
// diagonal tile, whose columns are staged once for both operands) or its B
// rows, `o` is their place in the partial tile, and the first nn of its four
// 8-column products hold outputs; A's rows from a[0] and a[1] (a[1] = a[0]
// where n is 1; n 0: an idle warp).
struct Group {
  int a[2], b, o, nn, n;
  bool in_a;
};

// Group s of the tile, column block by column block: G's (all rows left of
// the diagonal, rows j … of a diagonal tile's column j), then Z's; row blocks
// past R left out. With more blocks than warps (`pair`), a column's rows go
// two to a warp, so that the warp splits each B fragment once for both.
__device__ __forceinline__ Group group_at(const Tile& tl, int s, int bt, int rb, int vr, int nz,
                                          int zwv, bool pair) {
  Group gp;
  gp.a[0] = gp.a[1] = gp.b = gp.o = 0;
  gp.nn = 4;
  gp.n = 0;
  gp.in_a = false;
  const int ng = tl.kind == kZ ? 0 : tl.kind == kOff ? rb : vr;  // G's column blocks
  const int nc = ng + (tl.kind == kOff ? 0 : nz);
  for (int c = 0; c < nc; ++c) {
    const int first = c < ng && tl.kind == kDiag ? c : 0;
    const int rows = vr - first;
    const int groups = pair ? cdiv(rows, 2) : rows;
    if (s < groups) {
      const int i0 = first + (pair ? 2 * s : s);
      const int i1 = pair && i0 + 1 < vr ? i0 + 1 : i0;
      gp.a[0] = 32 * i0;
      gp.a[1] = 32 * i1;
      gp.n = i1 != i0 ? 2 : 1;
      if (c < ng) {
        gp.b = gp.o = 32 * c;
        gp.in_a = tl.kind == kDiag;
      } else {
        const int z = c - ng;
        gp.b = 32 * z;
        gp.o = (tl.kind == kDiag ? bt : 0) + 32 * z;
        gp.nn = cdiv(min(32, zwv - 32 * z), 8);
      }
      return gp;
    }
    s -= groups;
  }
  return gp;
}

__device__ __forceinline__ int block_count(const Tile& tl, int vr, int rb, int nz) {
  if (tl.kind == kOff) return vr * rb;
  return (tl.kind == kDiag ? vr * (vr + 1) / 2 : 0) + vr * nz;
}

// tf32_rn and split_rn (x = hi + lo in TF32, two integer operations each):
// hopper.cuh

// acc[w] += the product of row block w (A0, A1) and the column block (B) over
// the stage's rows k0 … k0+7, in split TF32: lo·hi + hi·lo + hi·hi, all four
// 8-column products (a Z block's columns past zw are computed and never
// stored). B is split once for both. The three passes of a step sum into a
// fresh accumulator, added to acc by an FADD: the tensor cores' float32 sum
// rounds toward zero, which over thousands of steps into one accumulator
// biased G's diagonal by −6.5e-5 (N 262,144, R 256), where rounding to
// nearest keeps it unbiased. No branch: the warp's work is one stretch of
// code that the compiler can interleave.
// acc[w][mt][nt][e] holds row 16mt + g + 8(e/2), column 8nt + 2t + e%2 of
// the block (g = lane / 4, t = lane % 4); A0, A1, B point at the lane's
// element (row t, column g).
template <int LD>
__device__ __forceinline__ void pair_mma(float (&acc)[2][2][4][4], const float* A0,
                                         const float* A1, const float* B) {
  uint32_t bh[4][2], bl[4][2];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    split_rn(B[8 * nt], bh[nt][0], bl[nt][0]);
    split_rn(B[4 * LD + 8 * nt], bh[nt][1], bl[nt][1]);
  }
#pragma unroll
  for (int w = 0; w < 2; ++w) {
    const float* A = w == 0 ? A0 : A1;
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      split_rn(A[16 * mt], ah[mt][0], al[mt][0]);
      split_rn(A[16 * mt + 8], ah[mt][1], al[mt][1]);
      split_rn(A[4 * LD + 16 * mt], ah[mt][2], al[mt][2]);
      split_rn(A[4 * LD + 16 * mt + 8], ah[mt][3], al[mt][3]);
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        float step[4] = {0.f, 0.f, 0.f, 0.f};
        mma_tf32(step, al[mt], bh[nt]);
        mma_tf32(step, ah[mt], bl[nt]);
        mma_tf32(step, ah[mt], bh[nt]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[w][mt][nt][e] += step[e];
      }
  }
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

// The box of a 2-D tensor map at (column x, row y) into shared memory,
// counted by `bar` in bytes; rows and columns past the tensor's end are zeros.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int x, int y,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// The mbarrier sees one arrival when this thread's earlier cp.asyncs land.
__device__ __forceinline__ void mbar_arrive_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// Σ v over the consumer warps in a fixed order: a butterfly in each warp,
// then the eight warps' sums in warp order (named barrier 1).
__device__ float consumer_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
  float s = red[0];
#pragma unroll
  for (int w = 1; w < CONSUMERS / 32; ++w) s += red[w];
  return s;
}

// CTA b: tile b / chunks over the rows of chunk b % chunks; a cluster holds
// `cluster` consecutive chunks of one tile, its rank the chunk's place.
template <int BT>
__global__ void __launch_bounds__(THREADS, 1)
    factor_prep_kernel(const float* __restrict__ U, const float* __restrict__ Z,
                       float* __restrict__ G, float* __restrict__ UtZ, float* __restrict__ zn,
                       float* __restrict__ ws, unsigned* __restrict__ tickets, int N, int R,
                       int L, Plan p, const __grid_constant__ CUtensorMap map_u,
                       const __grid_constant__ CUtensorMap map_z) {
  constexpr int LD = row_ld(BT);
  constexpr int RB = BT / 32;  // row blocks of a tile
  constexpr int WG = BT / 16;  // warps over a tile's blocks
  constexpr int KG = 8 / WG;   // consumer warp groups over a stage's rows
  constexpr int STAGE = 2 * KS * LD;
  extern __shared__ __align__(16) float smem_raw[];
  float* ring = reinterpret_cast<float*>((reinterpret_cast<uintptr_t>(smem_raw) + 127) &
                                         ~uintptr_t(127));  // the tensor copies' alignment
  __shared__ __align__(8) uint64_t full[MAX_STAGES];
  __shared__ __align__(8) uint64_t empty[MAX_STAGES];
  __shared__ float red[CONSUMERS / 32];
  __shared__ unsigned s_ticket;

  step_clock(0);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int tile = blockIdx.x / p.chunks;
  const int chunk = blockIdx.x % p.chunks;
  const Tile tl = decode(tile, BT, p);
  const int n_begin = chunk * p.rows_per_chunk;
  const int n_end = min(N, n_begin + p.rows_per_chunk);
  const int steps = n_end > n_begin ? cdiv(n_end - n_begin, KS) : 0;
  const int aw = min(BT, R - tl.r0);                           // A's columns that exist
  const int zwv = tl.kind == kOff ? 0 : min(p.zw, L - tl.z0);  // Z's
  const int bw = tl.kind == kOff ? BT : zwv;                   // B's

  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], p.copy == kCopy4 ? 32 : 1);
      mbar_init(&empty[s], CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // ---- the producer warp: the chunk's rows of the tile's columns, stage by stage
  if (warp == CONSUMERS / 32) {
    for (int it = 0; it < steps; ++it) {
      const int s = it % p.stages;
      if (it >= p.stages) mbar_wait(&empty[s], ((it / p.stages) - 1) & 1);
      float* sa = ring + s * STAGE;
      float* sb = sa + KS * LD;
      const int n0 = n_begin + it * KS;
      const int rows = min(KS, n_end - n0);
      if (p.copy == kTma && (rows == KS || n_end == N)) {
        // whole stages (or N's end, which the copy zero-fills): one box of
        // KS rows by LD columns per operand
        if (lane == 0) {
          mbar_expect(&full[s], 2u * 4u * KS * LD);
          tma_load(sa, &map_u, tl.r0, n0, &full[s]);
          if (tl.kind == kOff) {
            tma_load(sb, &map_u, tl.c0, n0, &full[s]);
          } else {
            tma_load(sb, &map_z, tl.z0, n0, &full[s]);
          }
        }
      } else if (p.copy == kTma) {  // a stage cut by its chunk's end: a bulk copy per row
        for (int e = lane; e < (KS - rows) * LD; e += 32) {  // the ragged end adds nothing
          sa[rows * LD + e] = 0.f;
          sb[rows * LD + e] = 0.f;
        }
        __syncwarp();
        if (lane == 0) mbar_expect(&full[s], 4u * (uint32_t)(rows * (aw + bw)));
        __syncwarp();
        for (int k = lane; k < rows; k += 32) {
          const size_t n = (size_t)(n0 + k);
          bulk_load(sa + k * LD, U + n * R + tl.r0, 4u * aw, &full[s]);
          if (tl.kind == kOff) {
            bulk_load(sb + k * LD, U + n * R + tl.c0, 4u * BT, &full[s]);
          } else {
            bulk_load(sb + k * LD, Z + n * L + tl.z0, 4u * zwv, &full[s]);
          }
        }
      } else {  // 4-byte cp.asyncs, the rows past the chunk zero-filled
        const int w = aw + bw;  // copies per row
        int k = lane / w, c = lane % w;
        for (; k < KS; c += 32) {
          while (c >= w) {
            c -= w;
            ++k;
          }
          if (k >= KS) break;
          const bool ok = k < rows;
          const size_t n = (size_t)(n0 + (ok ? k : 0));
          float* d;
          const float* src;
          if (c < aw) {
            d = sa + k * LD + c;
            src = U + n * R + tl.r0 + c;
          } else if (tl.kind == kOff) {
            d = sb + k * LD + (c - aw);
            src = U + n * R + tl.c0 + (c - aw);
          } else {
            d = sb + k * LD + (c - aw);
            src = Z + n * L + tl.z0 + (c - aw);
          }
          cp_async4(d, src, ok);
        }
        mbar_arrive_copies(&full[s]);
      }
    }
  }

  // ---- the consumer warps: this warp's row blocks, over its rows of each stage
  float acc[2][2][4][4];
#pragma unroll
  for (int w = 0; w < 2; ++w)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[w][mt][nt][e] = 0.f;
  const int vr = min(RB, cdiv(R - tl.r0, 32));  // row blocks with rows of G
  const int nz = cdiv(zwv, 32);
  const int kg = warp / WG;
  const Group gp = group_at(tl, warp % WG, BT, RB, vr, nz, zwv, block_count(tl, vr, RB, nz) > WG);
  // ‖Z‖²: tile 0 (row tile 0's diagonal) holds all of Z's columns where they
  // fit one tile, and sums them from its stages; else it reads its rows first
  const bool z_staged = tile == 0 && p.z_tiles == 1;
  float zsum = 0.f;
  if (warp < CONSUMERS / 32) {
    if (tile == 0 && !z_staged) {
      const size_t end = (size_t)n_end * L;
#pragma unroll 4
      for (size_t e = (size_t)n_begin * L + tid; e < end; e += CONSUMERS) {
        zsum = fmaf(Z[e], Z[e], zsum);
      }
    }
    const int g = lane >> 2, t = lane & 3;
    const int a0 = t * LD + gp.a[0] + g;
    const int a1 = t * LD + gp.a[1] + g;
    const int bo = (gp.in_a ? 0 : KS * LD) + t * LD + gp.b + g;
    unsigned long long waited = 0;
    for (int it = 0; it < steps; ++it) {
      const int s = it % p.stages;
      const unsigned long long w0 = now_ns();
      mbar_wait(&full[s], (it / p.stages) & 1);
      waited += now_ns() - w0;
      if (it == 0) step_clock(1);
      const float* st = ring + s * STAGE;
      if (z_staged) {
        for (int e = tid; e < KS * L; e += CONSUMERS) {
          const float v = st[KS * LD + (e / L) * LD + e % L];
          zsum = fmaf(v, v, zsum);
        }
      }
      // one 8-row step at a time: nine warps put three on one of the SM's
      // four register files, so a thread has 168 registers, and two or four
      // steps unrolled spilled (and ran slower on the card)
#pragma unroll 1
      for (int q = 0; q < KS / 8 / KG; ++q) {
        const int k0 = 8 * (kg + q * KG) * LD;
        pair_mma<LD>(acc, st + k0 + a0, st + k0 + a1, st + k0 + bo);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    if (tile == 0) zsum = consumer_sum(zsum, red);
    if (steps == 0) step_clock(1);
    step_clock(2);
    step_clock(8, waited);
  }
  __syncthreads();  // every stage consumed: the ring is free

  // ---- the partial tile in shared memory, the warp groups summed in order
  const int gw = tl.kind == kZ ? 0 : BT;  // G's columns in the partial tile
  const int ow = gw + (tl.kind == kOff ? 0 : zpad(p.zw));
  float* part = ring;
  for (int grp = 0; grp < KG; ++grp) {
    if (warp < CONSUMERS / 32 && kg == grp) {
      const int g = lane >> 2, t = lane & 3;
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        if (w < gp.n) {
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              if (nt < gp.nn) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  float* o = part + (gp.a[w] + 16 * mt + g + 8 * (e >> 1)) * ow + gp.o + 8 * nt +
                             2 * t + (e & 1);
                  *o = grp == 0 ? acc[w][mt][nt][e] : *o + acc[w][mt][nt][e];
                }
              }
            }
        }
      }
    }
    __syncthreads();
  }
  const int P = BT * ow + 1;  // and ‖Z‖² last
  if (tid == 0) part[P - 1] = zsum;
  __syncthreads();
  step_clock(3);

  // ---- the sums over N: the cluster's partial tiles over distributed shared
  // memory, then (more than one cluster per tile) the clusters' by ticket,
  // four floats at a time (the partial tile padded to PW floats)
  const int C = p.cluster;
  const int K = p.chunks / C;
  const int q = chunk % C;
  const int PW = (int)partial_floats(BT, p.zw);
  const int S4 = cdiv(PW / 4, C);  // float4s per rank's slice
  const int f0 = q * S4;
  const int f1 = min(PW / 4, f0 + S4);
  // the slice's final values: fin[e − 4·f0] for element e = row · ow + col of
  // the partial tile (‖Z‖² at P − 1), which this CTA stores where chunks are
  // not split past its cluster or it drew the last ticket
  float* fin = ring + PW;
  float4* fin4 = reinterpret_cast<float4*>(fin);
  bool stores = K == 1;
  // this cluster's slot in the workspace (K > 1)
  float4* mine = K > 1 ? reinterpret_cast<float4*>(ws + ((size_t)tile * K + chunk / C) * PW)
                       : nullptr;
  if (C > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    const float4* peer[MAX_CLUSTER];
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r) {
      peer[r] = reinterpret_cast<const float4*>(cluster.map_shared_rank(part, r < C ? r : 0));
    }
    for (int f = f0 + tid; f < f1; f += THREADS) {
      float4 v = peer[0][f];
#pragma unroll
      for (int r = 1; r < MAX_CLUSTER; ++r) {
        if (r < C) {
          const float4 x = peer[r][f];
          v.x += x.x;
          v.y += x.y;
          v.z += x.z;
          v.w += x.w;
        }
      }
      (K > 1 ? mine : fin4 - f0)[f] = v;
    }
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  } else if (K > 1) {
    const float4* own = reinterpret_cast<const float4*>(part);
    for (int f = tid; f < PW / 4; f += THREADS) mine[f] = own[f];
  } else {
    fin = part;
  }
  if (K > 1) {
    __threadfence();
    __syncthreads();
    step_clock(4);
    if (tid == 0) s_ticket = atomicAdd(&tickets[tile * C + q], 1u);
    __syncthreads();
    step_clock(5);
    stores = s_ticket == (unsigned)K - 1;
    if (stores) {  // the last cluster's rank q: the slice over the clusters
      __threadfence();
      const float4* first = reinterpret_cast<const float4*>(ws + (size_t)tile * K * PW);
      for (int f = f0 + tid; f < f1; f += 2 * THREADS) {  // two float4s in flight
        const int f2 = f + THREADS < f1 ? f + THREADS : f;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f), u = v;
#pragma unroll 8
        for (int k = 0; k < K; ++k) {
          const float4 x = __ldcg(first + (size_t)k * (PW / 4) + f);
          const float4 y = __ldcg(first + (size_t)k * (PW / 4) + f2);
          v.x += x.x;
          v.y += x.y;
          v.z += x.z;
          v.w += x.w;
          u.x += y.x;
          u.y += y.y;
          u.z += y.z;
          u.w += y.w;
        }
        fin4[f - f0] = v;
        fin4[f2 - f0] = u;
      }
      if (tid == 0) tickets[tile * C + q] = 0;
      step_clock(6);
    }
  } else {
    step_clock(4);
  }
  if (stores) {
    // G's rows and UtZ as they lie (and zn), then G's mirror column by
    // column: both coalesced; warps over rows (columns), lanes along them
    __syncthreads();
    const int e0 = 4 * f0, e1 = min(P, 4 * f1);
    const int ra = e0 / ow, rb = min(BT + 1, (e1 - 1) / ow + 1);  // the slice's rows
    for (int row = ra + warp; row < rb; row += THREADS / 32) {
      const int gr = tl.r0 + row;
      for (int col = lane; col < ow; col += 32) {
        const int e = row * ow + col;
        if (e < e0 || e >= e1) continue;
        const float v = fin[e - e0];
        if (row == BT) {
          if (tile == 0 && col == 0) *zn = v;
        } else if (gr < R && col < gw) {
          if (tl.c0 + col <= gr) G[(size_t)gr * R + tl.c0 + col] = v;
        } else if (gr < R && col - gw < p.zw && tl.z0 + col - gw < L) {
          UtZ[(size_t)gr * L + tl.z0 + col - gw] = v;
        }
      }
    }
    for (int col = warp; col < gw; col += THREADS / 32) {
      const int gc = tl.c0 + col;
      for (int row = ra + lane; row < min(rb, BT); row += 32) {
        const int e = row * ow + col;
        const int gr = tl.r0 + row;
        if (e >= e0 && e < e1 && gr < R && gc < gr) G[(size_t)gc * R + gr] = fin[e - e0];
      }
    }
    __syncthreads();
    step_clock(7);
  }
  if (C > 1) asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

const void* kernel_for(int bt) {
  switch (bt) {
    case 32: return (const void*)factor_prep_kernel<32>;
    case 64: return (const void*)factor_prep_kernel<64>;
    case 128: return (const void*)factor_prep_kernel<128>;
    default: return nullptr;
  }
}

// The dynamic shared memory each kernel may use, per device, raised on demand.
size_t g_smem_allowed[MAX_DEVICES][3];

cudaError_t allow(int bt, size_t bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  size_t& allowed = g_smem_allowed[dev][bt == 32 ? 0 : bt == 64 ? 1 : 2];
  if (bytes > allowed) {
    err = cudaFuncSetAttribute(kernel_for(bt), cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return err;
    allowed = bytes;
  }
  return cudaSuccess;
}

// cuTensorMapEncodeTiled, from the driver through the runtime (the library
// links no libcuda), looked up once.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(f);
    }
  }
  return fn;
}

// The row-major float32 matrix at `base` (rows × cols, 16-byte aligned rows)
// in boxes of KS rows by `box` columns, zeros past its end. The last map made
// for each of two operands is kept: the same tensors come back call after call.
bool tensor_map(CUtensorMap* map, const float* base, int rows, int cols, int box, int slot) {
  struct Key {
    const float* base;
    int rows, cols, box;
  };
  static Key keys[2] = {};
  static CUtensorMap maps[2];
  Key& k = keys[slot];
  if (k.base == base && k.rows == rows && k.cols == cols && k.box == box) {
    *map = maps[slot];
    return true;
  }
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(float)};
  const cuuint32_t boxes[2] = {(cuuint32_t)box, (cuuint32_t)KS};
  const cuuint32_t steps[2] = {1, 1};
  if (encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base), dims, strides,
             boxes, steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    return false;
  }
  maps[slot] = *map;
  k = Key{base, rows, cols, box};
  return true;
}

cudaLaunchConfig_t launch_config(int ctas, int cluster, size_t smem, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

extern "C" {

// How many CTAs of the BT kernel with `smem` bytes, in clusters of
// `cluster`, the current device holds at once (cluster 1: CTAs per SM ×
// SMs; else cudaOccupancyMaxActiveClusters × cluster): the plan sizes N's
// chunks by it. Negative: a CUDA error.
int gppvae_factor_prep_capacity(int bt, int smem, int cluster) {
  if (kernel_for(bt) == nullptr || smem < 0 || cluster < 1 || cluster > MAX_CLUSTER) {
    return -(int)cudaErrorInvalidValue;
  }
  cudaError_t err = allow(bt, (size_t)smem);
  if (err != cudaSuccess) return -(int)err;
  int n = 0;
  if (cluster == 1) {
    int dev = 0, sms = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel_for(bt), THREADS,
                                                          (size_t)smem);
    }
    return err == cudaSuccess ? n * sms : -(int)err;
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(cluster, cluster, (size_t)smem, nullptr, &attr);
  err = cudaOccupancyMaxActiveClusters(&n, kernel_for(bt), &cfg);
  return err == cudaSuccess ? n * cluster : -(int)err;
}

// G (R×R), UtZ (R×L) and zn (one float) from U (N×R) and Z (N×L), by the
// caller's plan (ops/factor_prep.py plan_factor_prep: bt, zw, tiles,
// cluster, chunks, rows_per_chunk, stages, copy (0 4-byte cp.asyncs, 1 a
// 2-D tensor map's boxes, encoded here), and smem,
// the dynamic shared memory of that bt and stages). With more than one cluster per tile
// (chunks > cluster), ws holds tiles · (chunks / cluster) partial tiles of
// partial_floats(bt, zw) floats and tickets tiles · cluster counters, at 0
// (the kernel leaves them at 0). The plan is checked, not trusted. One
// launch on `stream`; allocates nothing, does not synchronise; returns the
// launch's error, else cudaGetLastError().
int gppvae_factor_prep(const float* U, const float* Z, float* G, float* UtZ, float* zn,
                       float* ws, unsigned* tickets, int N, int R, int L, int bt, int zw,
                       int tiles, int cluster, int chunks, int rows_per_chunk, int stages,
                       int copy, int smem, cudaStream_t stream) {
  if (N < 1 || R < 1 || L < 1 || kernel_for(bt) == nullptr || zw < 1 || zw > L ||
      zw > zmax(bt) || cluster < 1 || cluster > MAX_CLUSTER || (cluster & (cluster - 1)) ||
      chunks < 1 || chunks % cluster || rows_per_chunk < 1 ||
      (long long)rows_per_chunk * chunks < N || stages < 2 || stages > MAX_STAGES ||
      (long long)smem != 4 * smem_floats(bt, stages)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long row_tiles = cdiv(R, bt);
  const long long z_tiles = cdiv(L, zw);
  if ((long long)tiles != row_tiles * (row_tiles - 1) / 2 + row_tiles * z_tiles ||
      (long long)tiles * chunks > 0x7fffffffLL ||
      (chunks > cluster && (ws == nullptr || tickets == nullptr)) ||
      copy < kCopy4 || copy > kTma ||
      (copy != kCopy4 && (R % 4 != 0 || L % 4 != 0 || !aligned16(U) || !aligned16(Z)))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = allow(bt, (size_t)smem);
  if (err != cudaSuccess) return (int)err;
  const Plan p{zw, (int)z_tiles, tiles, cluster, chunks, rows_per_chunk, stages, copy};
  CUtensorMap map_u = {}, map_z = {};
  if (copy == kTma && (!tensor_map(&map_u, U, N, R, row_ld(bt), 0) ||
                       !tensor_map(&map_z, Z, N, L, row_ld(bt), 1))) {
    return (int)cudaErrorNotSupported;
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(tiles * chunks, cluster, (size_t)smem, stream, &attr);
  switch (bt) {
    case 32:
      err = cudaLaunchKernelEx(&cfg, factor_prep_kernel<32>, U, Z, G, UtZ, zn, ws, tickets, N, R,
                               L, p, map_u, map_z);
      break;
    case 64:
      err = cudaLaunchKernelEx(&cfg, factor_prep_kernel<64>, U, Z, G, UtZ, zn, ws, tickets, N, R,
                               L, p, map_u, map_z);
      break;
    default:
      err = cudaLaunchKernelEx(&cfg, factor_prep_kernel<128>, U, Z, G, UtZ, zn, ws, tickets, N, R,
                               L, p, map_u, map_z);
  }
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

#ifdef GPPVAE_STEP_CLOCK
// Where the step clock writes: per CTA b and stamp i, at buf[b·9 + i]
// (nullptr: nowhere).
int gppvae_factor_prep_clock(unsigned long long* buf) {
  return (int)cudaMemcpyToSymbol(g_fp_clock, &buf, sizeof(buf));
}

int gppvae_factor_prep_stamps() { return STAMPS; }
#endif

const char* gppvae_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
