// Register-level pieces of the hand-written sm_90 kernels that run bf16
// tensor-core products on mma.sync fragments (the splash attention forward
// and backward, splash_attention_fwd.cu and splash_attention_bwd.cu, and the
// fused SPLADE pool forward and the backward's match pass, through
// fused_splade_walk.cuh): the m16n8k16 product with
// its documented fragment layout, ldmatrix loads of its operands from
// shared memory, cp.async copies, ex2 and paired stores. Nothing here knows
// a kernel's tiling or mask.
//
// Fragment layout of mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32
// (PTX ISA, "Matrix fragments for mma.m16n8k16"), g = lane / 4 and
// c = 2 * (lane % 4):
//   A, 16 x 16, 4 registers of 2 bf16: a0 (row g, cols c, c+1),
//      a1 (g+8, c..), a2 (g, c+8..), a3 (g+8, c+8..)
//   B, 16 x 8, 2 registers: b0 (k = c, c+1; n = g), b1 (k = c+8, c+9; n = g)
//   C, 16 x 8, 4 f32: (g, c), (g, c+1), (g+8, c), (g+8, c+1)
// So the C fragments of two neighbouring n8 tiles hold the A fragment of the
// 16 columns they cover: a product's f32 result, rounded to bf16, is the A
// operand of the next product without leaving the registers, and each lane
// knows the rows and columns of what it holds (masks, row statistics).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// d += a . b for one 16 x 8 tile, f32 sums. Not volatile: a product of
// registers only, which the compiler may schedule among the loads.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 rounded to nearest bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The bf16 A fragment of columns 16j..16j+15 from the f32 C fragments of the
// n8 tiles 2j and 2j+1 that cover them.
__device__ __forceinline__ void a_from_c(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// cp.async of 16 bytes from global src to shared dst, or zeros where !valid
// (src is then not read, but must still be an address of the tensor)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0));
}

// cp.async of 4 bytes
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most `pending` of this thread's committed groups are in flight
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(pending) : "memory");
}

// 2^x, the special-function unit's approximation (what __expf computes
// after scaling its argument by log2(e))
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// f32 pair to global memory as float2 or as a bf16 pair (rounded to nearest,
// as a cast of the f32 values would round them)
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a,
                                           float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

}  // namespace sm90
