// The score arithmetic of the fused SPLADE pool, shared by every kernel that
// computes its scores: the walk (fused_splade_walk.cuh) under the pool
// forward of both families (fused_splade_fwd.cu) and the match pass that both
// families' backward runs (fused_splade_v2_bwd.cu).
//
// The backward finds each column's argmax by equality with the maxima m that
// the forward wrote, so it must recompute every score with exactly the
// forward's arithmetic. Each score is the sum over k of h[s, k] * W[v, k]
// taken as bf16 tensor-core products of k-slices of 16 accumulated in f32,
// in ascending order from a zeroed accumulator up to H rounded to whole
// BK-wide steps (zeros past H), and the caller adds bias[v] in f32
// afterwards. On sm_90 an mma.sync m16n8k16 is one HMMA.16816 instruction
// adding one k-slice, and a WMMA 16x16x16 product is two of them, one per n8
// half. So the per-element sequence does not depend on the tile's shape, on
// which warp owns a fragment, on how the operands reached shared memory or on
// which of the two the code issues: the walk issues mma.sync on fragments
// loaded by ldmatrix (mma_sm90.cuh), slice by slice in the same order, and
// every score stays bitwise the forward's.
#pragma once

namespace splade_tile {

constexpr int BK = 64;  // the k-step the products are rounded up to
constexpr float NEG = -1e30f;

// The order-preserving int image of a float (atomicMax key) and its inverse.
__device__ __forceinline__ int float_key(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7FFFFFFF;
}

__device__ __forceinline__ float float_from_key(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7FFFFFFF);
}

}  // namespace splade_tile
