// conv3x3: the VAE's float32 3×3 convolutions in NHWC, with their bias and
// ELU, forward and both gradients.
//
// Replaces no TPU kernel: on the TPU the JAX package leaves its convolutions
// to XLA. On the H100 the port's float32 convolutions went to cuDNN, whose
// float32 engines want NCHW (a layout transform around every pass over the
// port's NHWC activations), pick FFT and Winograd paths of several launches
// each, and run off the tensor cores with TF32 off; ELU and the bias were
// passes of their own. They were over 80 % of a float32 training epoch's
// kernel time (PERF.md).
//
// What bounds it on the H100. A 32 → 32 convolution does 2·9·32·32 = 18,432
// FLOP per output pixel on 256 bytes of input and output: 72 FLOP a byte.
// At split TF32's effective 165 TFLOP/s (three tensor-core passes for one
// float32-accurate product) that is operations, not bytes; the layers with
// 3 channels on one side (the image's) are bytes. Below both, the issue
// rate: mma.sync, the split of each operand and the fresh accumulator's adds
// share the warps' instruction slots, and the gathers' address arithmetic.
// Dropping two of the three passes saved 16 % of a 32 → 32 forward on an
// H100 (PERF.md): the MMA rate is not what holds these tiles, so wgmma,
// which would want the operands split into shared memory first, is not used.
//
// The design: one implicit GEMM per pass, on mma.sync.m16n8k8 in split TF32.
//   * fprop: M = output pixels (n, oy, ox), N = Cout, K = taps × Cin with
//     k = tap·Cin + c, so that four consecutive k are four channels of one
//     pixel, 16 contiguous bytes of NHWC. Persistent CTAs of four warps walk
//     tiles of 128 pixels by up to 64 output channels (8, 16, 32 or 64 from
//     the plan); a warp takes 32 pixels by all of them. The layer's weights
//     are loaded once per CTA into shared memory, straight from OIHW (no
//     rearranged copy; a wide K takes fewer channels a tile): read again at
//     every stage, the same 37 KB from every SM cost more than the products.
//     K runs in stages of 32 through a ring of three stages filled by
//     cp.async, 16 bytes a copy where Cin % 4 == 0, else 4, the ring running
//     on from one tile into the next. A tap that falls outside the input is
//     a copy of 0 bytes, which fills zeros: the padding, per side, is folded
//     into the load, so neither 'SAME''s (0, 1) nor (1, 1) needs a padded
//     copy. The epilogue adds the bias, applies ELU where the layer has one
//     and stores NHWC.
//   * dgrad is the same kernel body: dX is a convolution of the output's
//     gradient g with the kernel turned 180° and transposed, which is only
//     which weight and which input offset each tap takes (`Axis`). At
//     stride 2 the output's pixels fall into four parity classes, each a
//     convolution over g with its own taps (one or two per axis), so no
//     zero-inserted tensor is made: one launch, the classes' tiles in turn.
//   * g itself is the output's gradient times ELU′, 1 where y > 0 and y + 1
//     elsewhere, from the saved output y: one elementwise pass
//     (conv3x3_dgrad_elu) that both gradients read.
//   * wgrad: dW is a GEMM over K = all output pixels of x's taps (M, one
//     column per (tap, channel)) and g's channels (N), with db as one more
//     column of ones. Where Cout is small (at most 3, stride 1, padding 1)
//     it runs over the input pixels instead, x's channels against g gathered
//     at each tap (`swap`): 32 → 3 gathered 289 columns a pixel the first
//     way and 27 the second. Each CTA sums a chunk of the pixels into a
//     partial tile of its own (a warp per 32 columns, or up to four warps
//     dealt one column block's steps, summed in warp order), and a second
//     kernel (conv3x3_wgrad_sum) adds the chunks' tiles in chunk order: no
//     float atomics, the same inputs give the same bits.
//   * the products in split TF32 as factor_prep.cu's: x = hi + lo, each
//     rounded to TF32 (split_rn of hopper.cuh), lo·hi + hi·lo + hi·hi, a
//     stage's three passes of each 8-deep step into a fresh accumulator
//     that is then added to the running one (the tensor cores round their
//     sum toward zero; twelve products at most, where thousands would bias
//     the sum).
// Every kernel's name holds fprop, dgrad or wgrad: the benchmark's reader of
// the layer's time counts convolution kernels by those words.
// Precision: float32 in and out; within the float32 plain version's distance
// from float64 (tests/test_torch_conv3x3_plan.py emulates the arithmetic),
// where one TF32 pass is not.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 128;  // four warps
constexpr int BM = 128;       // output pixels of a fprop / dgrad tile: one a thread
static_assert(BM == THREADS, "the 4-byte loader takes one row a thread");
constexpr int KS = 32;        // K of a stage
constexpr int LDK = KS + 4;   // a stage's row stride: fragments' loads hit 32 banks
constexpr int STAGES = 3;
constexpr int MAX_CLASSES = 4;
constexpr int MAX_DEVICES = 64;
constexpr int WGRAD_MAX_WARPS = 8;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// n / d for 0 <= n < 2^31 as (umulhi(n, mul) + n) >> shr, with shr = ceil(log2 d)
// and mul = floor(2^32 (2^shr - d) / d) + 1 (ops/conv3x3.py fast_div)
struct FastDiv {
  int d, mul, shr;
};

__device__ __forceinline__ int fdiv(int n, const FastDiv& f) {
  return (int)((__umulhi((unsigned)n, (unsigned)f.mul) + (unsigned)n) >> f.shr);
}

// One axis of a pass's taps: per tap the weight's index along the axis and
// the input offset, so that the input coordinate is o·istep + off[i].
struct Axis {
  int n, w[3], off[3];
};

// The output pixels of one class: a grid gh × gw of output coordinates
// (oy·ostep + oy0, ox·ostep + ox0), its taps, K = taps · cg, its weights in
// shared memory at `woff` (BN rows of ldw floats), its tiles of BM pixels,
// numbered from tile0 in the launch.
struct Class {
  int gh, gw, oy0, ox0, ostep, istep;
  Axis r, s;
  FastDiv fgw, fgh;
  int k, ldw, woff, tiles, tile0;
};

// The plan of one fprop or dgrad launch (ops/conv3x3.py GemmPlan.ints, the
// same ints in this order). The source is NHWC (batch, ih, iw, cg), the
// output NHWC (batch, oh, ow, cn); the weight of output channel n and source
// channel c at tap (r, s) is w[n·sn + c·sc + 3r + s]. grid_m persistent CTAs
// walk the `tiles` tiles; wfloats: the classes' weights in shared memory.
struct GemmPlan {
  int batch, ih, iw, cg, oh, ow, cn, sn, sc;
  int nt, vec, elu, smem, classes, grid_m, grid_n, tiles, wfloats;
  Class cls[MAX_CLASSES];
};

// The plan of one wgrad launch (ops/conv3x3.py WgradPlan.ints). x is NHWC
// (batch, ih, iw, cin), g NHWC (batch, oh, ow, cout); dW's columns J =
// tap·cin + ci and J = 9·cin for db (cols in all). A CTA takes 8·nt
// columns of the N side from 8·nt·blockIdx.z, `bpc` column blocks of 32 of
// the M side from 32·bpc·blockIdx.y with kw warps on each (the stage's
// 8-pixel steps dealt among them), and the pixels [chunk_px·blockIdx.x,
// +chunk_px). The M side gathers x at each column's tap over the output
// pixels, the N side is g's channels; with `swap` (stride 1, padding 1, few
// output channels) K runs over the input pixels instead, the M side is x's
// channels and a column of ones, and the N side gathers g at each tap:
// fewer bytes gathered where Cout is small.
struct WgradPlan {
  int batch, ih, iw, cin, oh, ow, cout, stride, pt, pl;
  int nt, row_tiles, cols, blocks, bpc, groups, kw, chunks, chunk_px, vec_x, vec_g, smem, swap;
  FastDiv fow, foh;
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Wait until at most STAGES − 2 groups of this thread are in flight.
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2) : "memory");
}

// step += a · b for one 8-deep step in split TF32: lo·hi + hi·lo + hi·hi.
__device__ __forceinline__ void split_mma(float (&step)[4], const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                          const uint32_t (&bl)[2]) {
  mma_tf32(step, al, bh);
  mma_tf32(step, ah, bl);
  mma_tf32(step, ah, bh);
}

// ---- fprop and dgrad: persistent CTAs walk the tiles of BM output pixels

// Where a CTA's walk is: tile (−1 past the last), its class, the stage of
// K in it and the class's stages.
struct Cursor {
  int tile, z, step, steps;
};

__device__ __forceinline__ void seek(const GemmPlan& p, Cursor& cu) {
  if (cu.tile >= p.tiles) {
    cu.tile = -1;
    return;
  }
  int z = 0;
  while (z + 1 < p.classes && cu.tile >= p.cls[z + 1].tile0) ++z;
  cu.z = z;
  cu.step = 0;
  cu.steps = cdiv(p.cls[z].k, KS);
}

__device__ __forceinline__ void advance(const GemmPlan& p, Cursor& cu) {
  if (++cu.step == cu.steps) {
    cu.tile += gridDim.x;
    seek(p, cu);
  }
}

template <int NT, bool VEC>
__device__ __forceinline__ void gemm_body(const GemmPlan& p, const float* __restrict__ src,
                                          const float* __restrict__ w,
                                          const float* __restrict__ bias,
                                          float* __restrict__ out) {
  constexpr int BN = 8 * NT;
  extern __shared__ __align__(16) float smem[];
  float* Ws = smem;              // per class: [BN][ldw], loaded once
  float* As = smem + p.wfloats;  // the ring: [STAGES][BM][LDK]
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  // the weights: row n, column k = tap·cg + c of class z (zeros past K and cn)
  for (int z = 0; z < p.classes; ++z) {
    const Class& c = p.cls[z];
    float* Wz = Ws + c.woff;
    for (int i = tid; i < BN * c.ldw; i += THREADS) {
      const int n = i / c.ldw, k = i - n * c.ldw;
      float v = 0.f;
      if (k < c.k && n0 + n < p.cn) {
        const int tap = k / p.cg, ch = k - tap * p.cg;
        const int tr = tap / c.s.n;
        v = w[(size_t)(n0 + n) * p.sn + (size_t)ch * p.sc + 3 * c.r.w[tr] +
              c.s.w[tap - tr * c.s.n]];
      }
      Wz[i] = v;
    }
  }

  // The rows this thread loads of the tile being loaded (VEC: rows tid / 8 +
  // 16i; else row tid): the source's pixel base n·ih·iw (−1 past M) and the
  // input coordinate of tap offset 0, packed (iy0 << 16 | ix0); set when the
  // loads enter a tile.
  constexpr int RPT = VEC ? BM / (THREADS / 8) : 1;
  int rbase[RPT], ryx[RPT];
  auto enter = [&](const Cursor& cu) {
    const Class& c = p.cls[cu.z];
    const int m0 = (cu.tile - c.tile0) * BM;
    const int M = p.batch * c.gh * c.gw;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int m = m0 + (VEC ? (tid >> 3) + (THREADS / 8) * i : tid);
      const int rest = fdiv(m, c.fgw);
      const int nimg = fdiv(rest, c.fgh);
      rbase[i] = m < M ? nimg * p.ih * p.iw : -1;
      ryx[i] = (((rest - nimg * c.gh) * c.istep) << 16) | ((m - rest * c.gw) * c.istep);
    }
  };

  // the loads of one stage of the source into ring slot `slot`
  auto load = [&](const Cursor& cu, int slot) {
    if (cu.step == 0) enter(cu);
    const Class& c = p.cls[cu.z];
    const int k0 = cu.step * KS;
    float* A = As + slot * BM * LDK;
    if (VEC) {  // 8 groups of 4 channels a row; thread: group tid % 8, rows tid / 8 + 16i
      const int q = tid & 7;
      const int k = k0 + 4 * q;
      const bool kok = k < c.k;
      const int tap = kok ? k / p.cg : 0;
      const int ch = k - tap * p.cg;
      const int tr = tap / c.s.n;
      const int dy = c.r.off[tr], dx = c.s.off[tap - tr * c.s.n];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int iy = (ryx[i] >> 16) + dy, ix = (ryx[i] & 0xffff) + dx;
        const bool ok = kok && rbase[i] >= 0 && iy >= 0 && iy < p.ih && ix >= 0 && ix < p.iw;
        const float* s = ok ? src + ((size_t)(rbase[i] + iy * p.iw + ix) * p.cg + ch) : src;
        cp_async16(A + ((tid >> 3) + (THREADS / 8) * i) * LDK + 4 * q, s, ok);
      }
    } else {  // one channel a copy; thread: row tid, all 32 k, one tap's bounds at a time
      const int taps = c.r.n * c.s.n;
      const int iy0 = ryx[0] >> 16, ix0 = ryx[0] & 0xffff;
      int tap = k0 / p.cg;
      int ch = k0 - tap * p.cg;
      const float* tp = src;
      bool tok = false;
      auto at_tap = [&]() {
        tok = false;
        if (tap < taps && rbase[0] >= 0) {
          const int tr = tap / c.s.n;
          const int iy = iy0 + c.r.off[tr], ix = ix0 + c.s.off[tap - tr * c.s.n];
          tok = iy >= 0 && iy < p.ih && ix >= 0 && ix < p.iw;
          tp = src + (size_t)(rbase[0] + iy * p.iw + ix) * p.cg;
        }
      };
      at_tap();
      for (int kk = 0; kk < KS; ++kk) {
        cp_async4(A + tid * LDK + kk, tok ? tp + ch : src, tok);
        if (++ch == p.cg) {
          ch = 0;
          ++tap;
          at_tap();
        }
      }
    }
  };

  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  Cursor ld{(int)blockIdx.x, 0, 0, 1};
  seek(p, ld);
  Cursor cc = ld;
  int nl = 0, nc = 0;  // stages loaded (or committed empty) and computed
  for (int i = 0; i < STAGES - 1; ++i, ++nl) {
    if (ld.tile >= 0) {
      load(ld, nl % STAGES);
      advance(p, ld);
    }
    cp_commit();
  }
  while (cc.tile >= 0) {
    cp_wait();
    __syncthreads();
    if (ld.tile >= 0) {
      load(ld, nl % STAGES);
      advance(p, ld);
    }
    ++nl;
    cp_commit();
    const Class& c = p.cls[cc.z];
    const float* A = As + (nc % STAGES) * BM * LDK + (warp * 32 + g) * LDK + t;
    const float* B = Ws + c.woff + g * c.ldw + t + cc.step * KS;
    // the stage's four 8-deep steps into a fresh accumulator, added to acc
    float st[2][NT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[mt][nt][e] = 0.f;
#pragma unroll
    for (int k8 = 0; k8 < KS; k8 += 8) {
      uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        split_rn(B[8 * nt * c.ldw + k8], bh[nt][0], bl[nt][0]);
        split_rn(B[8 * nt * c.ldw + k8 + 4], bh[nt][1], bl[nt][1]);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        uint32_t ah[4], al[4];
        const float* a = A + 16 * mt * LDK + k8;
        split_rn(a[0], ah[0], al[0]);
        split_rn(a[8 * LDK], ah[1], al[1]);
        split_rn(a[4], ah[2], al[2]);
        split_rn(a[8 * LDK + 4], ah[3], al[3]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) split_mma(st[mt][nt], ah, al, bh[nt], bl[nt]);
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] += st[mt][nt][e];
    ++nc;
    if (cc.step + 1 == cc.steps) {
      // the tile's end: + bias, ELU, NHWC store. acc[mt][nt][e]: row
      // 32·warp + 16mt + g + 8(e/2), column 8nt + 2t + e%2
      const int m0 = (cc.tile - c.tile0) * BM;
      const int M = p.batch * c.gh * c.gw;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + warp * 32 + 16 * mt + g + 8 * h;
          if (m < M) {
            const int rest = fdiv(m, c.fgw);
            const int ox = m - rest * c.gw;
            const int nimg = fdiv(rest, c.fgh);
            const int oy = rest - nimg * c.gh;
            const size_t pix =
                ((size_t)nimg * p.oh + oy * c.ostep + c.oy0) * p.ow + ox * c.ostep + c.ox0;
            float* o = out + pix * p.cn;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int col = n0 + 8 * nt + 2 * t + e;
                if (col < p.cn) {
                  float v = acc[mt][nt][2 * h + e];
                  if (bias != nullptr) v += bias[col];
                  if (p.elu) v = v > 0.f ? v : expm1f(v);
                  o[col] = v;
                }
              }
          }
        }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    }
    advance(p, cc);
  }
}

template <int NT, bool VEC>
__global__ void __launch_bounds__(THREADS)
    conv3x3_fprop(const __grid_constant__ GemmPlan p, const float* __restrict__ x,
                  const float* __restrict__ w, const float* __restrict__ bias,
                  float* __restrict__ y) {
  gemm_body<NT, VEC>(p, x, w, bias, y);
}

template <int NT, bool VEC>
__global__ void __launch_bounds__(THREADS)
    conv3x3_dgrad(const __grid_constant__ GemmPlan p, const float* __restrict__ g,
                  const float* __restrict__ w, float* __restrict__ dx) {
  gemm_body<NT, VEC>(p, g, w, nullptr, dx);
}

// g = dy · ELU′ from the saved output y: 1 where y > 0, else y + 1
__global__ void conv3x3_dgrad_elu(const float* __restrict__ dy, const float* __restrict__ y,
                                  float* __restrict__ g, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const float v = y[i];
    g[i] = dy[i] * (v > 0.f ? 1.f : v + 1.f);
  }
}

// ---- wgrad: partial tiles over pixel chunks, then their sum in chunk order

// g's row stride in shared memory: 8 or 24 mod 32 floats, so that the
// fragments' loads (rows t, columns g) hit 32 banks.
__host__ __device__ constexpr int wgrad_ldg(int br) { return br == 8 ? 8 : br + 8; }

// Per stage pixel: x's pixel base n·ih·iw and the input coordinate of tap
// (0, 0), or base −1 past the chunk.
struct PixInfo {
  int base, iy0, ix0, pad;
};

// dW (as the product of x's taps, M = column J, and g, N = output channel,
// over K = pixels) for one chunk of pixels; the partial tile into ws.
template <int NT>
__global__ void __launch_bounds__(32 * WGRAD_MAX_WARPS)
    conv3x3_wgrad(const __grid_constant__ WgradPlan p, const float* __restrict__ x,
                  const float* __restrict__ g, float* __restrict__ ws) {
  constexpr int BR = 8 * NT;           // output channels of a CTA
  constexpr int LDG = wgrad_ldg(BR);
  const int LDB = 32 * p.bpc + 8;      // 8 mod 32
  const int nthreads = 32 * p.bpc * p.kw;
  extern __shared__ __align__(16) float smem[];
  float* Gs = smem;                      // [STAGES][KS][LDG]: g, pixel-major
  float* Xs = smem + STAGES * KS * LDG;  // [STAGES][KS][LDB]: x's taps, pixel-major
  __shared__ PixInfo pix[STAGES][KS];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int jb = warp / p.kw, ks = warp % p.kw;  // the warp's column block and step share
  const int co0 = blockIdx.z * BR;
  const int J0 = blockIdx.y * p.bpc * 32;
  const int P = p.batch * p.oh * p.ow;
  const int px0 = blockIdx.x * p.chunk_px;
  const int px1 = min(P, px0 + p.chunk_px);
  const int steps = px1 > px0 ? cdiv(px1 - px0, KS) : 0;
  const int taps_cols = 9 * p.cin;
  const int mcols = p.swap ? p.cin + 1 : p.cols;  // the M side's columns

  auto table = [&](int st) {  // warp 0: the pixels of stage st
    if (warp == 0) {
      const int q = px0 + st * KS + lane;
      PixInfo pi{-1, 0, 0, 0};
      if (st < steps && q < px1) {
        const int rest = fdiv(q, p.fow);
        const int ox = q - rest * p.ow;
        const int nimg = fdiv(rest, p.foh);
        pi.base = nimg * p.ih * p.iw;  // = n·oh·ow with swap
        const int oy = rest - nimg * p.oh;
        // x's coordinate of tap (0, 0); with swap, g's pixel of tap (0, 0)
        pi.iy0 = p.swap ? oy + p.pt : oy * p.stride - p.pt;
        pi.ix0 = p.swap ? ox + p.pl : ox * p.stride - p.pl;
      }
      pix[st % STAGES][lane] = pi;
    }
  };

  // what this thread loads, the same at every stage: g's channel group
  // gcq at rows gr0 + i·grs; x's column group xcq (column J, its tap and
  // channel) at rows xr0 + i·xrs
  const int gpr = p.vec_g ? BR / 4 : BR;
  const int gcq = tid % gpr, gr0 = tid / gpr, grs = nthreads / gpr;
  const int gco = co0 + (p.vec_g ? 4 * gcq : gcq);
  const int xpr = p.vec_x ? 8 * p.bpc : 32 * p.bpc;
  const int xcq = tid % xpr, xr0 = tid / xpr, xrs = nthreads / xpr;
  const int xJ = J0 + (p.vec_x ? 4 * xcq : xcq);
  const int xtap = xJ < taps_cols ? xJ / p.cin : 0;
  const int xci = xJ - xtap * p.cin;
  const int xdy = xtap / 3, xdx = xtap % 3;
  // swap: the N side's column gco = tap·cout + co gathers g at (tap, co)
  const int gtap = gco / p.cout, gch = gco - gtap * p.cout;

  auto load = [&](int st, int slot) {
    const int q0 = px0 + st * KS;
    float* G = Gs + slot * KS * LDG + (p.vec_g ? 4 * gcq : gcq);
    float* X = Xs + slot * KS * LDB + (p.vec_x ? 4 * xcq : xcq);
    const PixInfo* tb = pix[slot];
    if (p.swap) {  // g at each tap of the input pixel; x's channels, then ones
      for (int r = gr0; r < KS; r += grs) {
        const PixInfo pi = tb[r];
        const int oy = pi.iy0 - gtap / 3, ox = pi.ix0 - gtap % 3;
        const bool ok = pi.base >= 0 && gtap < 9 && oy >= 0 && oy < p.oh && ox >= 0 && ox < p.ow;
        cp_async4(G + r * LDG, ok ? g + ((size_t)(pi.base + oy * p.ow + ox) * p.cout + gch) : g,
                  ok);
      }
      for (int r = xr0; r < KS; r += xrs) {
        const bool in = q0 + r < px1;
        float* d = X + r * LDB;
        if (xJ < p.cin) {
          const float* s = in ? x + ((size_t)(q0 + r) * p.cin + xJ) : x;
          if (p.vec_x) {
            cp_async16(d, s, in);
          } else {
            cp_async4(d, s, in);
          }
        } else {
          d[0] = xJ == p.cin && in ? 1.f : 0.f;
          if (p.vec_x) d[1] = d[2] = d[3] = 0.f;
        }
      }
      return;
    }
    // g: KS pixels × BR channels from co0
    for (int r = gr0; r < KS; r += grs) {
      const bool ok = q0 + r < px1 && gco < p.cout;
      const float* s = ok ? g + ((size_t)(q0 + r) * p.cout + gco) : g;
      if (p.vec_g) {
        cp_async16(G + r * LDG, s, ok);
      } else {
        cp_async4(G + r * LDG, s, ok);
      }
    }
    // x at the column's tap: J = tap·cin + ci (tap = 3r + s); J = 9·cin: ones
    for (int r = xr0; r < KS; r += xrs) {
      const PixInfo pi = tb[r];
      float* d = X + r * LDB;
      if (xJ < taps_cols) {
        const int iy = pi.iy0 + xdy, ix = pi.ix0 + xdx;
        const bool ok = pi.base >= 0 && iy >= 0 && iy < p.ih && ix >= 0 && ix < p.iw;
        const float* s = ok ? x + ((size_t)(pi.base + iy * p.iw + ix) * p.cin + xci) : x;
        if (p.vec_x) {
          cp_async16(d, s, ok);
        } else {
          cp_async4(d, s, ok);
        }
      } else {
        d[0] = xJ == taps_cols && pi.base >= 0 ? 1.f : 0.f;
        if (p.vec_x) d[1] = d[2] = d[3] = 0.f;
      }
    }
  };

  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  for (int st = 0; st < STAGES; ++st) table(st);
  __syncthreads();
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < steps) load(st, st);
    cp_commit();
  }
  const bool active = J0 + 32 * jb < mcols;
  for (int st = 0; st < steps; ++st) {
    cp_wait();
    __syncthreads();
    if (st + STAGES - 1 < steps) load(st + STAGES - 1, (st + STAGES - 1) % STAGES);
    cp_commit();
    table(st + STAGES);  // into the slot of stage st, whose loads were issued before
    if (!active) continue;
    const int slot = st % STAGES;
    // A (row J, column pixel) = x's taps; B (row pixel, column co) = g
    const float* A = Xs + slot * KS * LDB + t * LDB + 32 * jb + gq;
    const float* B = Gs + slot * KS * LDG + t * LDG + gq;
    float sa[2][NT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sa[mt][nt][e] = 0.f;
    for (int k8 = 8 * ks; k8 < KS; k8 += 8 * p.kw) {
      uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        split_rn(B[k8 * LDG + 8 * nt], bh[nt][0], bl[nt][0]);
        split_rn(B[(k8 + 4) * LDG + 8 * nt], bh[nt][1], bl[nt][1]);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        uint32_t ah[4], al[4];
        const float* a = A + k8 * LDB + 16 * mt;
        split_rn(a[0], ah[0], al[0]);
        split_rn(a[8], ah[1], al[1]);
        split_rn(a[4 * LDB], ah[2], al[2]);
        split_rn(a[4 * LDB + 8], ah[3], al[3]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) split_mma(sa[mt][nt], ah, al, bh[nt], bl[nt]);
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] += sa[mt][nt][e];
  }

  // the warps of one column block: their sums added in step-share order
  if (p.kw > 1) {
    cp_wait();
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    float* red = smem + (size_t)warp * 32 * 8 * NT;
    if (ks > 0) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) red[((mt * NT + nt) * 4 + e) * 32 + lane] = acc[mt][nt][e];
    }
    __syncthreads();
    if (ks > 0) return;
    for (int j = 1; j < p.kw; ++j) {
      const float* other = smem + (size_t)(warp + j) * 32 * 8 * NT;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] += other[((mt * NT + nt) * 4 + e) * 32 + lane];
    }
  }

  // the partial tile: ws[chunk][co][J]; acc[mt][nt][e]: M side 32jb + 16mt + g + 8(e/2),
  // N side 8nt + 2t + e%2 (with swap: ci or the ones, and tap·cout + co)
  if (!active) return;
  float* o = ws + (size_t)blockIdx.x * p.cout * p.cols;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int J = J0 + 32 * jb + 16 * mt + gq + 8 * h;
      if (J >= mcols) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = co0 + 8 * nt + 2 * t + e;
          const float v = acc[mt][nt][2 * h + e];
          if (!p.swap) {
            if (n < p.cout) o[(size_t)n * p.cols + J] = v;
          } else if (n < 9 * p.cout) {
            const int tap = n / p.cout, co = n - tap * p.cout;
            if (J < p.cin) {
              o[(size_t)co * p.cols + tap * p.cin + J] = v;
            } else if (tap == 3 * p.pt + p.pl) {  // the ones against g at p = q: db
              o[(size_t)co * p.cols + taps_cols] = v;
            }
          }
        }
    }
}

// dW (OIHW) and db from the chunks' partial tiles, summed in chunk order.
__global__ void conv3x3_wgrad_sum(const float* __restrict__ ws, int chunks, int cout, int cin,
                                  float* __restrict__ dw, float* __restrict__ db) {
  const int cols = 9 * cin + 1;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cout * cols) return;
  const size_t tile = (size_t)cout * cols;
  float s = 0.f;
  for (int c = 0; c < chunks; ++c) s += ws[c * tile + i];
  const int co = i / cols, J = i % cols;
  if (J == cols - 1) {
    if (db != nullptr) db[co] = s;
  } else {
    const int tap = J / cin, ci = J % cin;
    dw[((size_t)co * cin + ci) * 9 + tap] = s;
  }
}

// ---- launch

int nt_index(int nt) { return nt == 1 ? 0 : nt == 2 ? 1 : nt == 4 ? 2 : nt == 8 ? 3 : -1; }

// kernel 0: fprop, 1: dgrad (nt 1, 2, 4, 8; vec), 2: wgrad (nt 1, 2, 4)
const void* kernel_for(int kernel, int nt, int vec) {
  static const void* gemm[2][4][2] = {
      {{(const void*)conv3x3_fprop<1, false>, (const void*)conv3x3_fprop<1, true>},
       {(const void*)conv3x3_fprop<2, false>, (const void*)conv3x3_fprop<2, true>},
       {(const void*)conv3x3_fprop<4, false>, (const void*)conv3x3_fprop<4, true>},
       {(const void*)conv3x3_fprop<8, false>, (const void*)conv3x3_fprop<8, true>}},
      {{(const void*)conv3x3_dgrad<1, false>, (const void*)conv3x3_dgrad<1, true>},
       {(const void*)conv3x3_dgrad<2, false>, (const void*)conv3x3_dgrad<2, true>},
       {(const void*)conv3x3_dgrad<4, false>, (const void*)conv3x3_dgrad<4, true>},
       {(const void*)conv3x3_dgrad<8, false>, (const void*)conv3x3_dgrad<8, true>}}};
  const int i = nt_index(nt);
  if (kernel == 2) {
    return nt == 1 ? (const void*)conv3x3_wgrad<1>
           : nt == 2 ? (const void*)conv3x3_wgrad<2>
           : nt == 4 ? (const void*)conv3x3_wgrad<4>
                     : nullptr;
  }
  if (kernel < 0 || kernel > 1 || i < 0) return nullptr;
  return gemm[kernel][i][vec ? 1 : 0];
}

int kernel_slot(int kernel, int nt, int vec) {
  return kernel * 8 + nt_index(nt) * 2 + (vec ? 1 : 0);
}

// the shared memory each kernel may use, set once per device
size_t g_smem_allowed[MAX_DEVICES][24];

cudaError_t allow(const void* fn, int slot, int bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  size_t& allowed = g_smem_allowed[dev][slot];
  if ((size_t)bytes > allowed) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    allowed = (size_t)bytes;
  }
  return cudaSuccess;
}

bool gemm_plan_ok(const GemmPlan& p) {
  if (p.batch < 1 || p.ih < 1 || p.iw < 1 || p.cg < 1 || p.oh < 1 || p.ow < 1 || p.cn < 1 ||
      nt_index(p.nt) < 0 || p.classes < 1 || p.classes > MAX_CLASSES || p.grid_m < 1 ||
      p.grid_n != cdiv(p.cn, 8 * p.nt) || (p.vec && p.cg % 4) || p.tiles < p.grid_m ||
      p.wfloats < 0 || p.smem != 4 * (p.wfloats + STAGES * BM * LDK)) {
    return false;
  }
  int tiles = 0, wfloats = 0;
  for (int i = 0; i < p.classes; ++i) {
    const Class& c = p.cls[i];
    if (c.r.n < 1 || c.r.n > 3 || c.s.n < 1 || c.s.n > 3 || c.gh < 1 || c.gw < 1 ||
        c.fgw.d != c.gw || c.fgh.d != c.gh || c.k != c.r.n * c.s.n * p.cg ||
        c.ldw < cdiv(c.k, KS) * KS || c.woff != wfloats || c.tile0 != tiles ||
        c.tiles != cdiv(p.batch * c.gh * c.gw, BM)) {
      return false;
    }
    tiles += c.tiles;
    wfloats += 8 * p.nt * c.ldw;
  }
  return tiles == p.tiles && wfloats == p.wfloats;
}

cudaError_t launch_gemm(int kernel, GemmPlan& p, void** args, cudaStream_t stream) {
  const void* fn = kernel_for(kernel, p.nt, p.vec);
  cudaError_t err = allow(fn, kernel_slot(kernel, p.nt, p.vec), p.smem);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernel(fn, dim3(p.grid_m, p.grid_n), dim3(THREADS), args, (size_t)p.smem,
                         stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

cudaError_t launch_elu_grad(const float* dy, const float* y, float* g, long long n,
                            cudaStream_t stream) {
  if (n < 1) return cudaErrorInvalidValue;
  const long long blocks = (n + 255) / 256;
  conv3x3_dgrad_elu<<<(unsigned)(blocks < 8192 ? blocks : 8192), 256, 0, stream>>>(dy, y, g, n);
  return cudaGetLastError();
}

cudaError_t launch_wgrad(WgradPlan& p, const float* x, const float* g, float* ws, float* dw,
                         float* db, cudaStream_t stream) {
  const void* fn = kernel_for(2, p.nt, 0);
  const int br = 8 * p.nt;
  const int ring = STAGES * KS * (wgrad_ldg(br) + 32 * p.bpc + 8);
  const int red = p.kw > 1 ? 32 * p.bpc * p.kw * br : 0;
  if (p.swap && (p.stride != 1 || p.pt != 1 || p.pl != 1 || p.oh != p.ih || p.ow != p.iw ||
                 9 * p.cout > br || p.vec_g)) {
    return cudaErrorInvalidValue;
  }
  if (fn == nullptr || p.batch < 1 || p.cin < 1 || p.cout < 1 || p.oh < 1 || p.ow < 1 ||
      p.row_tiles != cdiv(p.swap ? 9 * p.cout : p.cout, br) || p.cols != 9 * p.cin + 1 ||
      p.blocks != cdiv(p.swap ? p.cin + 1 : p.cols, 32) || p.bpc < 1 || p.kw < 1 || p.kw > 4 ||
      p.bpc * p.kw > WGRAD_MAX_WARPS ||
      p.groups != cdiv(p.blocks, p.bpc) || p.chunks < 1 || p.chunk_px < 1 || p.chunk_px % KS ||
      (long long)p.chunks * p.chunk_px < (long long)p.batch * p.oh * p.ow ||
      (p.vec_x && p.cin % 4) || (p.vec_g && p.cout % 4) || p.fow.d != p.ow ||
      p.foh.d != p.oh || p.smem != 4 * (ring > red ? ring : red)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = allow(fn, 16 + nt_index(p.nt), p.smem);
  if (err != cudaSuccess) return err;
  void* args[] = {&p, &x, &g, &ws};
  err = cudaLaunchKernel(fn, dim3(p.chunks, p.groups, p.row_tiles), dim3(32 * p.bpc * p.kw),
                         args, (size_t)p.smem, stream);
  if (err != cudaSuccess) return err;
  const int outs = p.cout * p.cols;
  conv3x3_wgrad_sum<<<cdiv(outs, 256), 256, 0, stream>>>(ws, p.chunks, p.cout, p.cin, dw, db);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Resident CTAs of one kernel (kernel 0 fprop, 1 dgrad, 2 wgrad; its nt and
// vec) with `threads` threads and `smem` bytes, on the whole current device:
// the plans size their grids by it. Negative: a CUDA error.
int gppvae_conv3x3_ctas(int kernel, int nt, int vec, int threads, int smem) {
  const void* fn = kernel_for(kernel, nt, vec);
  if (fn == nullptr || smem < 0) return -(int)cudaErrorInvalidValue;
  cudaError_t err = allow(fn, kernel == 2 ? 16 + nt_index(nt) : kernel_slot(kernel, nt, vec), smem);
  int dev = 0, sms = 0, n = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, threads, (size_t)smem);
  }
  return err == cudaSuccess ? n * sms : -(int)err;
}

// y (NHWC) = conv3x3(x (NHWC), w (OIHW)) + bias, ELU where plan.elu, by the
// caller's plan (`plan`: the ints of GemmPlan). bias may be null. One launch
// on `stream`; allocates nothing, does not synchronise; returns the
// launch's error, else cudaGetLastError().
int gppvae_conv3x3_fprop(const float* x, const float* w, const float* bias, float* y,
                         const int* plan, cudaStream_t stream) {
  GemmPlan p;
  std::memcpy(&p, plan, sizeof(p));
  if (!gemm_plan_ok(p) || p.classes != 1) return (int)cudaErrorInvalidValue;
  void* args[] = {&p, &x, &w, &bias, &y};
  return (int)launch_gemm(0, p, args, stream);
}

// A layer's backward in one call, each part where its outputs are given:
// g = dy · ELU′(y) into `g` where y is not null (else g is dy); dx (NHWC)
// from g and w (OIHW) by `dgrad_plan` (the ints of GemmPlan) where dx is
// not null; dw (OIHW) and db (may be null) from x (NHWC) and g by
// `wgrad_plan` (the ints of WgradPlan), the chunks' partial tiles in ws
// (chunks · cout · cols floats), where dw is not null. n: the floats of
// dy. Launches on `stream`; allocates nothing, does not synchronise;
// returns the first launch error.
int gppvae_conv3x3_backward(const float* dy, const float* y, float* g, const float* x,
                            const float* w, float* dx, float* ws, float* dw, float* db,
                            const int* dgrad_plan, const int* wgrad_plan, long long n,
                            cudaStream_t stream) {
  cudaError_t err = cudaSuccess;
  const float* gs = dy;
  if (y != nullptr) {
    err = launch_elu_grad(dy, y, g, n, stream);
    gs = g;
  }
  if (err == cudaSuccess && dx != nullptr) {
    GemmPlan p;
    std::memcpy(&p, dgrad_plan, sizeof(p));
    if (!gemm_plan_ok(p) || p.elu) return (int)cudaErrorInvalidValue;
    void* args[] = {&p, &gs, &w, &dx};
    err = launch_gemm(1, p, args, stream);
  }
  if (err == cudaSuccess && dw != nullptr) {
    WgradPlan p;
    std::memcpy(&p, wgrad_plan, sizeof(p));
    err = launch_wgrad(p, x, gs, ws, dw, db, stream);
  }
  return (int)err;
}

}  // extern "C"
