// Shared pieces of the sliding-window + segment-id flash attention kernels
// (splash_attention_fwd.cu, splash_attention_bwd.cu): the tiling, the
// operand strides, the mask as two tests on a fragment's positions, and the
// loads of operand tiles into shared memory and of their fragments out of
// it. The generic register-level pieces they are built on (the mma.sync
// product and its fragment layout, ldmatrix, cp.async) are in mma_sm90.cuh.
//
// A block of 4 warps owns one 64-row tile of one (batch row, head); each warp
// owns 16 of its rows and walks the 64-row tiles of the other axis that the
// mask can reach.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace splash {

// the attention kernels use the generic pieces unqualified
using namespace sm90;

constexpr int HD = 64;        // head width the kernels are built for
constexpr int BT = 64;        // rows of a query tile and of a kv tile
constexpr int THREADS = 128;  // 4 warps, 16 tile rows each
constexpr int LDS = HD + 8;   // bf16 row stride of a staged operand tile
constexpr float NEG = -1e30f;  // finite -inf: exp(NEG - m) = 0, never inf - inf
constexpr int TILE_BYTES = BT * LDS * 2;

// Elements between batch rows, heads and positions of a [B, N, S, HD] view
// whose last dimension is contiguous.
struct Strides {
  long long b, n, s;
};

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

// ex2 takes log2 units; lse leaves as a natural log
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
// Segment ids of the positions past S, so that the mask is two tests
// (in_mask): the model's ids are >= 0 and never match them (and a match
// would add exact zeros: rows past S are zeros, with lse and delta 0)
constexpr int ROW_PAST_S = -1;
constexpr uint32_t COL_PAST_S = 0xfffffffeu;  // -2

// May query position i attend to key position j, for d = i - j, with hwe =
// the half window, or S when there is none? Equal segment ids (padding,
// packing and the ends of the sequence ride them) and |d| <= hwe.
__device__ __forceinline__ bool in_mask(int si, int sj, int d, int hwe) {
  return si == sj && (unsigned)(d + hwe) <= (unsigned)(2 * hwe);
}

// Tiles are [rows][LDS] bf16 in shared memory. A row of LDS = 72 values is
// 144 bytes, so the 8 rows an 8 x 8 ldmatrix reads start 4 banks apart and
// its 16-byte rows cover all 32 banks once: no conflict.

// A operand: rows r0..r0+15, columns k0..k0+15 of a tile.
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* tile, int r0,
                                       int k0) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(a, tile + (r0 + (lane & 15)) * LDS + k0 + (lane >> 4) * 8);
}

// B operands of the n8 tiles n0 and n0+8 (b[0..1] and b[2..3]) at depth
// k0..k0+15, from a tile whose rows are n and columns k (B = tile^T).
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4],
                                          const __nv_bfloat16* tile, int n0,
                                          int k0) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(b, tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * LDS + k0 +
                     ((lane >> 3) & 1) * 8);
}

// The same from a tile whose rows are k and columns n (B = tile), through
// ldmatrix's transpose.
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4],
                                          const __nv_bfloat16* tile, int k0,
                                          int n0) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4_trans(b, tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS +
                           n0 + (lane >> 4) * 8);
}

// Rows s0..s0+BT of one (b, head) operand, `stride_s` elements apart, into
// dst [BT][LDS] by cp.async, 16 bytes a copy; rows past S are zeros.
__device__ __forceinline__ void load_tile_async(
    __nv_bfloat16* dst, const __nv_bfloat16* __restrict__ src,
    long long stride_s, int s0, int S) {
  constexpr int Q = HD / 8;
  for (int i = threadIdx.x; i < BT * Q; i += THREADS) {
    const int r = i / Q, c = (i % Q) * 8;
    const bool in = s0 + r < S;
    cp_async16(dst + r * LDS + c,
               src + (size_t)(in ? s0 + r : s0) * stride_s + c, in);
  }
}

// BT 4-byte values src[s0..s0+BT) into dst by cp.async, one thread a value
// (threads first..first+BT); past S, the bits of `fill` are stored instead.
__device__ __forceinline__ void load_row_async(void* dst, const void* src,
                                               int s0, int S, int first,
                                               uint32_t fill) {
  const int i = threadIdx.x - first;
  if (i < 0 || i >= BT) return;
  uint32_t* d = static_cast<uint32_t*>(dst) + i;
  if (s0 + i < S)
    cp_async4(d, static_cast<const uint32_t*>(src) + s0 + i);
  else
    *d = fill;
}

}  // namespace splash
