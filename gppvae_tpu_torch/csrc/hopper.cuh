// Device helpers of both kernels: split-TF32 products on the tensor cores
// (mma.sync.m16n8k8), the bulk asynchronous copy and the mbarrier that waits
// for it. Internal linkage: each kernel source gets its own copy.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// ---- split TF32: x = hi + lo, each rounded to TF32 to nearest, ties away

// The rounding: the float32 bits rounded at TF32's 10 mantissa bits with two
// integer operations. Equal to cvt.rna.tf32.f32 for finite x (which ptxas
// expands into about eight instructions, with checks for Inf and NaN); a
// non-finite x gives a non-finite lo either way. factor_prep's products use
// it.
__device__ __forceinline__ uint32_t tf32_rn(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_rn(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rn(x);
  lo = tf32_rn(x - __uint_as_float(hi));
}

// The same split through cvt.rna.tf32.f32: nll_core's, until that kernel
// moves onto split_rn.
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// c += a · b for one m16n8k8 tile: a (16×8, row) and b (8×8, col) in TF32,
// c in f32.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ---- the bulk asynchronous copy and its mbarrier

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n"
      "}\n" ::"r"(smem_addr(bar)), "r"(parity)
      : "memory");
}

}  // namespace
