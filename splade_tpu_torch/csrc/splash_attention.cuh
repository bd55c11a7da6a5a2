// Shared pieces of the sliding-window + segment-id flash attention kernels:
// the tiling, the mask and the operand strides, which both directions use
// (splash_attention_fwd.cu, splash_attention_bwd.cu), and the forward's
// staging of a strided [S, 64] operand tile and its two WMMA products (the
// backward's register-level pieces are in splash_mma.cuh).
//
// A block of 4 warps owns one 64-row tile of one (batch row, head); each warp
// owns 16 of its rows and walks the 64-row tiles of the other axis that the
// mask can reach. In the forward, products are bf16 WMMA 16x16x16 with f32
// sums. A score tile goes through shared memory in f32 (WMMA fragments have
// no documented element layout, so row-wise softmax arithmetic needs one),
// where two lanes share a row and each handles 32 of its 64 columns; what is
// multiplied next (p) is written back as bf16 over the same rows.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace splash {

constexpr int HD = 64;        // head width the kernels are built for
constexpr int BT = 64;        // rows of a query tile and of a kv tile
constexpr int THREADS = 128;  // 4 warps, 16 tile rows each
constexpr int LDS = HD + 8;   // bf16 row stride of a staged operand tile
constexpr int LDF = BT + 4;   // f32 row stride of a score tile
constexpr int LDP = 2 * LDF;  // bf16 row stride of p / ds laid over the scores
constexpr int HALF = BT / 2;  // columns a lane handles in its row
constexpr float NEG = -1e30f;  // finite -inf: exp(NEG - m) = 0, never inf - inf
constexpr int TILE_BYTES = BT * LDS * 2;
constexpr int SCORE_BYTES = BT * LDF * 4;

using Acc = nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16,
                                   float>;

// Elements between batch rows, heads and positions of a [B, N, S, HD] view
// whose last dimension is contiguous.
struct Strides {
  long long b, n, s;
};

// May query position qi attend to key position kj? Same segment (padding
// rides the segment ids), inside the sequence, and within the window when
// there is one (hw == 0: full attention).
__device__ __forceinline__ bool allowed(int qi, int kj, int sq, int sk, int S,
                                        int hw) {
  if (qi >= S || kj >= S || sq != sk) return false;
  const int d = qi - kj;
  return hw == 0 || (d <= hw && -d <= hw);
}

// Tiles lo..hi of the other axis that the tile of rows t0..t0+BT can reach.
// The mask is symmetric in (q, k), so query tiles and kv tiles share it.
__device__ __forceinline__ void tile_range(int t0, int S, int hw, int& lo,
                                           int& hi) {
  lo = 0;
  hi = (S - 1) / BT;
  if (hw == 0) return;
  const int end = min(t0 + BT, S) - 1;
  lo = max(t0 - hw, 0) / BT;
  hi = min(end + hw, S - 1) / BT;
}

// Rows s0..s0+BT of one (b, head) operand, `stride_s` elements apart in
// device memory, into dst [BT][LDS]; rows past S are zeros. 16 bytes a load.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* __restrict__ src,
                                          long long stride_s, int s0, int S) {
  constexpr int Q = HD / 8;
  for (int i = threadIdx.x; i < BT * Q; i += THREADS) {
    const int r = i / Q, c = (i % Q) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (s0 + r < S)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(s0 + r) * stride_s +
                                            c);
    *reinterpret_cast<uint4*>(dst + r * LDS + c) = val;
  }
}

// C[16, BT] = A[16, HD] . Bt[BT, HD]^T for one warp: A its 16 rows of a staged
// tile, Bt a whole staged tile read as a column-major [HD, BT] matrix; C f32
// with row stride LDF.
__device__ __forceinline__ void rows_times_transposed(const __nv_bfloat16* A,
                                                      const __nv_bfloat16* Bt,
                                                      float* C) {
  using namespace nvcuda;
  Acc acc[BT / 16];
#pragma unroll
  for (int j = 0; j < BT / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
  for (int kk = 0; kk < HD; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>
        af;
    wmma::load_matrix_sync(af, A + kk, LDS);
#pragma unroll
    for (int j = 0; j < BT / 16; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> bf;
      wmma::load_matrix_sync(bf, Bt + (j * 16) * LDS + kk, LDS);
      wmma::mma_sync(acc[j], af, bf, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < BT / 16; ++j)
    wmma::store_matrix_sync(C + j * 16, acc[j], LDF, wmma::mem_row_major);
}

// acc[16, HD] += P[16, BT] . Bm[BT, HD] for one warp: P its 16 rows of bf16
// values laid over a score tile (row stride LDP), Bm a whole staged tile.
__device__ __forceinline__ void accumulate(const __nv_bfloat16* P,
                                           const __nv_bfloat16* Bm,
                                           Acc* acc) {
  using namespace nvcuda;
#pragma unroll
  for (int kk = 0; kk < BT; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>
        af;
    wmma::load_matrix_sync(af, P + kk, LDP);
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> bf;
      wmma::load_matrix_sync(bf, Bm + kk * LDS + j * 16, LDS);
      wmma::mma_sync(acc[j], af, bf, acc[j]);
    }
  }
}

}  // namespace splash
