// nll_core: the Woodbury NLL tail from the R-sized core, in one CTA.
//
// From G (R×R), UtZ (R×L), ‖Z‖² and v_n, with B = I + G/v_n = L_B L_Bᵀ:
//   log|B| = 2·Σ log diag(L_B)
//   W      = L_B⁻¹ UtZ,   X = L_B⁻¹
//   nll    = ½[ L·(N·log v_n + log|B|) + (‖Z‖² − ‖W‖²/v_n)/v_n + N·L·log 2π ]
// X and W are emitted as the backward pass's residuals (M = XᵀW, B⁻¹ = XᵀX).
//
// Replaces gppvae_tpu/ops/pallas_chol.py::_nll_core_pallas (the Pallas kernel
// _nll_core_kernel), which padded R and L to multiples of 128 for the TPU's
// lanes; nothing is padded here.
//
// What bounds it on the H100: latency, not bytes or FLOPs. At R = 56 the
// factorization is ~30 kFLOP and the inputs 16 KB; the time is the serial
// chain of R columns, each a barrier. So the kernel is one CTA:
//   * left-looking Cholesky, column j at a time, rows i ≥ j in parallel, a
//     __syncthreads between the update, the pivot and the scaling;
//   * L_B lives in shared memory while it fits (R = 56 → 12.8 KB; up to
//     R = 225 with the opt-in above 48 KB), otherwise in a global scratch
//     buffer the caller allocates. Either way R ≤ 512, the TPU kernel's own
//     range; blocking the factorization across CTAs is later work;
//   * the two forward substitutions run with one thread per right-hand-side
//     column: W's L columns and X's R columns side by side;
//   * Σ log diag, ‖W‖² (a fixed-order tree over the block) and the scalar
//     assembly are fp32, as in the TPU kernel.
// A non-positive pivot gives NaN (sqrtf of a negative number) and is never
// clamped: the trainer's spike guard handles non-finite values.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_R = 512;
constexpr size_t DEFAULT_SMEM = 48 * 1024;
constexpr size_t SMEM_LIMIT = 200 * 1024;
constexpr float LOG2PI = 1.8378770664093453f;

size_t l_bytes(int R) { return (size_t)R * (R + 1) * sizeof(float); }

__global__ void __launch_bounds__(THREADS) nll_core_kernel(
    const float* __restrict__ G, const float* __restrict__ UtZ,
    const float* __restrict__ zn_p, const float* __restrict__ vn_p,
    float* __restrict__ nll, float* __restrict__ X, float* __restrict__ W,
    float* __restrict__ scratch, int R, int L, float n_rows, float l_dims,
    int use_smem) {
  extern __shared__ float smem[];
  __shared__ float red[THREADS];
  __shared__ float s_pivot;

  const int ld = R + 1;  // odd row stride: rows land on different banks
  float* Lm = use_smem ? smem : scratch;
  const int tid = threadIdx.x;
  const float vn = *vn_p;
  float logdet = 0.f;  // accumulated by thread 0

  // ---- left-looking Cholesky of B = I + G/vn
  for (int j = 0; j < R; ++j) {
    const float* lj = Lm + (size_t)j * ld;
    for (int i = j + tid; i < R; i += THREADS) {
      float s = G[(size_t)i * R + j] / vn + (i == j ? 1.f : 0.f);
      const float* li = Lm + (size_t)i * ld;
      for (int k = 0; k < j; ++k) s = fmaf(-li[k], lj[k], s);
      Lm[(size_t)i * ld + j] = s;
    }
    __syncthreads();
    if (tid == 0) {
      const float d = sqrtf(Lm[(size_t)j * ld + j]);
      s_pivot = d;
      logdet += 2.f * logf(d);
    }
    __syncthreads();
    const float d = s_pivot;
    for (int i = j + tid; i < R; i += THREADS) {
      Lm[(size_t)i * ld + j] = i == j ? d : Lm[(size_t)i * ld + j] / d;
    }
    __syncthreads();
  }

  // ---- forward substitutions: W = L⁻¹ UtZ and X = L⁻¹, one column each
  float wsq = 0.f;
  for (int col = tid; col < L + R; col += THREADS) {
    if (col < L) {
      for (int j = 0; j < R; ++j) {
        const float* lj = Lm + (size_t)j * ld;
        float s = UtZ[(size_t)j * L + col];
        for (int k = 0; k < j; ++k) s = fmaf(-lj[k], W[(size_t)k * L + col], s);
        const float w = s / lj[j];
        W[(size_t)j * L + col] = w;
        wsq = fmaf(w, w, wsq);
      }
    } else {
      const int c = col - L;
      for (int j = 0; j < c; ++j) X[(size_t)j * R + c] = 0.f;
      for (int j = c; j < R; ++j) {
        const float* lj = Lm + (size_t)j * ld;
        float s = j == c ? 1.f : 0.f;
        for (int k = c; k < j; ++k) s = fmaf(-lj[k], X[(size_t)k * R + c], s);
        X[(size_t)j * R + c] = s / lj[j];
      }
    }
  }

  // ---- ‖W‖² (fixed-order tree) and the scalar assembly
  red[tid] = wsq;
  __syncthreads();
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  if (tid == 0) {
    const float wn2 = red[0];
    const float quad = (*zn_p - wn2 / vn) / vn;
    *nll = 0.5f * (l_dims * (n_rows * logf(vn) + logdet) + quad +
                   n_rows * l_dims * LOG2PI);
  }
}

}  // namespace

extern "C" {

// Floats of global scratch gppvae_nll_core needs at rank R: 0 while L_B fits
// in shared memory.
size_t gppvae_nll_core_scratch(int R) {
  return l_bytes(R) <= SMEM_LIMIT ? 0 : (size_t)R * (R + 1);
}

// nll (one float), X (R×R) and W (R×L) from G (R×R), UtZ (R×L) and the
// device scalars zn and vn; scratch holds gppvae_nll_core_scratch(R) floats.
// Launches on `stream`, allocates nothing, does not synchronise; returns
// cudaGetLastError().
int gppvae_nll_core(const float* G, const float* UtZ, const float* zn,
                    const float* vn, float* nll, float* X, float* W,
                    float* scratch, int R, int L, int n_rows, int l_dims,
                    cudaStream_t stream) {
  if (R < 1 || R > MAX_R || L < 1) return (int)cudaErrorInvalidValue;
  const size_t bytes = l_bytes(R);
  const int use_smem = bytes <= SMEM_LIMIT;
  const size_t dyn = use_smem ? bytes : 0;
  if (dyn > DEFAULT_SMEM) {
    cudaError_t err = cudaFuncSetAttribute(
        nll_core_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    if (err != cudaSuccess) return (int)err;
  }
  nll_core_kernel<<<1, THREADS, dyn, stream>>>(
      G, UtZ, zn, vn, nll, X, W, scratch, R, L, (float)n_rows, (float)l_dims,
      use_smem);
  return (int)cudaGetLastError();
}

}  // extern "C"
