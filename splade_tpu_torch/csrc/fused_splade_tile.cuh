// The score arithmetic of the fused SPLADE pool, shared by its forward and
// backward kernels (fused_splade_fwd.cu, fused_splade_bwd.cu) and by the
// row-blocked family (fused_splade_v2_fwd.cu, fused_splade_v2_bwd.cu).
//
// The backward finds each column's argmax by equality with the maxima m that
// the forward wrote, so it must recompute every score with exactly the
// forward's arithmetic. Each score is the sum over k of h[s, k] * W[v, k]
// taken as bf16 tensor-core products of k-slices of 16 accumulated in f32,
// in ascending order from a zeroed accumulator up to H rounded to whole
// BK-wide steps (zeros past H), and the caller adds bias[v] in f32
// afterwards. On sm_90 a WMMA 16x16x16 product is two HMMA.16816
// instructions, one per n8 half, each adding one k-slice; an mma.sync
// m16n8k16 is one. So the per-element sequence does not depend on the
// chunk's shape, on which warp owns a fragment, on how the operands reached
// shared memory or on which of the two the code issues: the kernels may pick
// the tiling that suits them while every score stays bitwise the forward's.
// mma_step below is the WMMA form (the row-blocked forward, through
// score_chunk_resident, which stages A one k-step at a time against a W tile
// that stays in shared memory for its whole hidden width); the per-row match
// pass issues the same WMMA products from its own cp.async ring; the per-row
// forward and the row-blocked match pass (fused_splade_walk.cuh) issue
// mma.sync m16n8k16 on fragments loaded by ldmatrix (mma_sm90.cuh), slice by
// slice in the same order.
#pragma once

#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace splade_tile {

constexpr int BK = 64;        // hidden slice staged per k-step
constexpr int LDS = BK + 8;   // bf16 row stride in shared memory (bank pad)
constexpr int THREADS = 256;  // 8 warps
constexpr float NEG = -1e30f;

template <int BM, int BN>
struct Chunk {
  static_assert(BM % 16 == 0 && BN % 16 == 0, "chunk of whole fragments");
  static constexpr int LDC = BN + 4;  // f32 row stride of the score chunk
  static constexpr int FRAG_COLS = BN / 16;
  static constexpr int PER_WARP = (BM / 16) * FRAG_COLS / (THREADS / 32);
  static_assert(PER_WARP >= 1 && FRAG_COLS % PER_WARP == 0,
                "each warp owns fragments of one fragment row");
  static constexpr int A_BYTES = BM * LDS * 2;
  static constexpr int C_BYTES = BM * LDC * 4;
  // with B resident elsewhere: the A staging buffer aliased by the scores
  static constexpr int AC_BYTES = A_BYTES > C_BYTES ? A_BYTES : C_BYTES;
};

// One BK-wide k-step of the chunk's products from the staged A and B: the
// per-fragment sequence of mma_sync calls every score goes through. ldb is
// the bf16 row stride of Bs (LDS for a staged k-step, the resident tile's
// own stride otherwise); a stride changes no product.
template <int BM, int BN>
__device__ __forceinline__ void mma_step(
    const __nv_bfloat16* As, const __nv_bfloat16* Bs, int fr, int fc,
    nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float>*
        acc,
    int ldb = LDS) {
  using namespace nvcuda;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                   wmma::row_major> af;
    wmma::load_matrix_sync(af, As + (fr * 16) * LDS + kk, LDS);
#pragma unroll
    for (int j = 0; j < Chunk<BM, BN>::PER_WARP; ++j) {
      // B = W_tile^T: W rows [v][k] read as a col-major [k, v] matrix
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> bf;
      wmma::load_matrix_sync(bf, Bs + ((fc + j) * 16) * ldb + kk, ldb);
      wmma::mma_sync(acc[j], af, bf, acc[j]);
    }
  }
}

// 16 bytes (8 bf16) at row r, column k of a [n_rows, H] matrix, or zeros
// past its edge: the staging of A (h rows) and B (W rows) alike.
__device__ __forceinline__ uint4 load16(const __nv_bfloat16* __restrict__ base,
                                        int r, int n_rows, int k, int H) {
  if (r < n_rows && k < H)
    return *reinterpret_cast<const uint4*>(base + (size_t)r * H + k);
  return make_uint4(0u, 0u, 0u, 0u);
}

// ---- the row-blocked family: a W tile resident in shared memory ----------

// bf16 row stride of a resident W tile: the hidden width rounded up to whole
// k-steps, plus the bank pad of LDS (a multiple of 8, so rows stay 16-byte
// aligned and fragment pointers 32-byte aligned).
__host__ __device__ __forceinline__ int resident_ld(int H) {
  return (H + BK - 1) / BK * BK + 8;
}

// Bytes of a resident W tile of BN vocab rows, rounded up to 128 so that what
// follows it in shared memory stays aligned.
template <int BN>
__host__ __device__ __forceinline__ int w_tile_bytes(int H) {
  return (BN * resident_ld(H) * 2 + 127) / 128 * 128;
}

// Bring vocab rows v0..v0+n_cols of w ([V, H]) into Wt ([BN, ldb]) for their
// whole hidden width, zeros past n_cols and past H. No barrier: the first
// k-step of score_chunk_resident has one before any product reads Wt.
template <int BN>
__device__ __forceinline__ void stage_w_tile(const __nv_bfloat16* __restrict__ w,
                                             int v0, int n_cols, int H,
                                             __nv_bfloat16* Wt, int ldb) {
  const int q_row = (ldb - 8) / 8;  // 16-byte slices per row
  const __nv_bfloat16* wv = w + (size_t)v0 * H;
  for (int i = threadIdx.x; i < BN * q_row; i += THREADS) {
    const int r = i / q_row, k = (i % q_row) * 8;
    *reinterpret_cast<uint4*>(Wt + r * ldb + k) = load16(wv, r, n_cols, k, H);
  }
}

// Scores without bias of rows s0..s0+BM of ``rows`` ([n_rows, H]: the
// flattened batch rows of one row block) against the BN vocab rows held in
// Wt, a resident W tile, into Cs = (float*)smem_ac, row stride Chunk::LDC;
// rows past n_rows come out 0. Only A is staged per k-step (the next step's
// 16-byte loads wait in registers while the current one multiplies); the
// products are mma_step's. smem_ac holds Chunk::AC_BYTES. All THREADS
// threads call it; it ends with a barrier after Cs is written, and the
// caller must barrier again before the next call overwrites Cs.
template <int BM, int BN>
__device__ __forceinline__ void score_chunk_resident(
    const __nv_bfloat16* __restrict__ rows, int s0, int n_rows,
    const __nv_bfloat16* Wt, int ldb, int H, unsigned char* smem_ac) {
  using namespace nvcuda;
  using C = Chunk<BM, BN>;
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem_ac);
  float* Cs = reinterpret_cast<float*>(smem_ac);
  const int tid = threadIdx.x;
  const int first = (tid >> 5) * C::PER_WARP;
  const int fr = first / C::FRAG_COLS;
  const int fc = first % C::FRAG_COLS;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[C::PER_WARP];
#pragma unroll
  for (int j = 0; j < C::PER_WARP; ++j) wmma::fill_fragment(acc[j], 0.f);

  constexpr int Q = BK / 8;
  constexpr int NA = (BM * Q + THREADS - 1) / THREADS;
  const __nv_bfloat16* hs = rows + (size_t)s0 * H;
  const int a_rows = n_rows - s0;
  uint4 ra[NA];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int it = 0; it < NA; ++it) {
      const int i = tid + it * THREADS;
      ra[it] = i < BM * Q ? load16(hs, i / Q, a_rows, k0 + i % Q * 8, H)
                          : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  fetch(0);
  for (int k0 = 0; k0 < H; k0 += BK) {
#pragma unroll
    for (int it = 0; it < NA; ++it) {
      const int i = tid + it * THREADS;
      if (i < BM * Q)
        *reinterpret_cast<uint4*>(As + (i / Q) * LDS + i % Q * 8) = ra[it];
    }
    __syncthreads();
    if (k0 + BK < H) fetch(k0 + BK);  // in flight during the products
    mma_step<BM, BN>(As, Wt + k0, fr, fc, acc, ldb);
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < C::PER_WARP; ++j)
    wmma::store_matrix_sync(Cs + (fr * 16) * C::LDC + (fc + j) * 16, acc[j],
                            C::LDC, wmma::mem_row_major);
  __syncthreads();
}

// The order-preserving int image of a float (atomicMax key) and its inverse.
__device__ __forceinline__ int float_key(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7FFFFFFF;
}

__device__ __forceinline__ float float_from_key(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7FFFFFFF);
}

}  // namespace splade_tile
