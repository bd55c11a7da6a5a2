// Row-blocked fused SPLADE projection + masked sequence max, backward
// (Hopper): the match pass of the row-blocked family.
//
// Replaces splade_tpu/ops/fused_splade_v2.py::_bwd_dh_kernel (:65, launched
// at :188) and ::_bwd_dw_kernel (:87, launched at :197), the Pallas kernels
// of fused_splade_pool_v2's custom VJP. With m[b, v] the forward's maxima and
// g[b, v] the cotangent folded through log1p(relu) by the wrapper, the
// function is fused_splade_bwd.cu's:
//
//     score[s, v] = h[b, s, :] . W[v, :] + bias[v]          (invalid s: none)
//     G[s, v]     = g[b, v] if score[s, v] == m[b, v] else 0
//     dh[b, s, :] = sum_v G[s, v] W[v, :]
//     dW[v, :]    = sum_b sum_s G[s, v] h[b, s, :]     (row blocks ascending)
//
// Ties get the full, duplicated gradient; dbias = sum_b g is the wrapper's.
//
// What bounds it: the recompute, 2*valid*H*V bf16 operations on the tensor
// cores (1.2 ms at the document batch B=128 S=256 with about half the
// positions valid), plus one f32 row of H multiply-adds a match (1.34 ms with
// both). The kernels this replaces (one recomputing kernel a gradient) each
// recomputed every score through WMMA chunks staged in shared memory in f32,
// padding included, at one block an SM (a 97 KB resident W tile), and added
// every match into an H-wide f32 row in device memory, one after the other:
// 33-166x their bound. Here the backward runs "match once, gather twice":
// 1. splade_fused_pool_v2_bwd_match (this file) recomputes every score once
//    and writes the argmax set as a bitmask match[b, j, v] (uint32,
//    [B, ceil(S/32), V]): bit r of word j is set when valid position 32j + r
//    has score == m[b, v] and g[b, v] != 0. Every word is written (zeros
//    where nothing is computed), so nothing zeroes it first. Both pool
//    families launch it: the per-row family (fused_splade_pool, the V33
//    path) at the largest row block that divides B and fits, this one at
//    its own row_block.
// 2. The dh and dW gathers of fused_splade_bwd.cu read it; the dh gather
//    splits each word row's vocabulary into ordered ranges where word rows
//    are few, each range's sums its own partial, added in range order by the
//    wrapper.
// One recompute serves both gradients, where the replaced kernels ran two.
//
// The match pass: a block owns one tile of 128 vocab columns and the live
// 16-row groups of the family's row_block batch rows: row_block is the
// number of batch rows that share one W tile. It walks them as the pool
// forward does (fused_splade_walk.cuh): bf16 mma.sync m16n8k16 with f32
// sums in registers, operands by ldmatrix from a 4-stage cp.async ring of
// 32-wide k-slices, a group with no valid row never loaded or multiplied,
// blocks numbered vocab tile first so that the blocks running together
// share their W tile in L2. No resident W tile: two blocks an SM. The
// epilogue runs on the fragments: + bias in f32, compared with m[b, v],
// which is staged once a (batch row, tile) with g folded in (a NaN key where
// g = 0: equal to no score). A batch row whose g is 0 on the whole tile lists
// no group. The 16 bits of a group's half word, one column, sit in the 8
// lanes of a column group: they are joined by OR-halving across those
// lanes (two columns packed a shuffle) and stored as 16-bit halves of the
// word (the low half from group 2j, the high from 2j + 1), which have one
// writer each. Halves of the groups the walk skips, and past S, are written
// as zeros by the block that owns them.
//
// Bits must not move: each score keeps fused_splade_tile.cuh's sequence
// (k-slices of 16 ascending from a zeroed f32 accumulator up to H rounded to
// whole 64-wide steps, one HMMA.16816 a slice, then + bias in f32), so the
// bitmask is the same bit for bit at every row_block, and the match holds
// against either family's forward.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "fused_splade_walk.cuh"

namespace {

using namespace splade_walk;

// dynamic shared memory: the ring | m keys [RB][BN] | bias [BN] | the live
// groups [RB * G] as int2 | row flags [RB] | left-out flags [RB * G]
__host__ __device__ __forceinline__ int shared_bytes(int S, int RB) {
  const int G = (S + GR - 1) / GR;
  return PIPE_BYTES + RB * BN * 4 + BN * 4 + RB * G * 8 + RB * 4 + RB * G;
}

__global__ void __launch_bounds__(FT, 2)
fused_splade_v2_bwd_match_kernel(const __nv_bfloat16* __restrict__ h,
                                 const __nv_bfloat16* __restrict__ w,
                                 const float* __restrict__ bias,
                                 const float* __restrict__ mask,
                                 const float* __restrict__ m,
                                 const float* __restrict__ g,
                                 uint16_t* __restrict__ half, int B, int S,
                                 int H, int V, int RB) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int warp_live[FT / 32];
  const int G = (S + GR - 1) / GR, J = (S + 31) / 32;
  float* mkey = reinterpret_cast<float*>(smem + PIPE_BYTES);  // [RB][BN]
  float* bias_s = mkey + RB * BN;                             // [BN]
  int2* groups = reinterpret_cast<int2*>(bias_s + BN);        // [RB * G]
  int* row_on = reinterpret_cast<int*>(groups + RB * G);      // [RB]
  unsigned char* dead = reinterpret_cast<unsigned char*>(row_on + RB);

  // blocks numbered vocab tile first: the blocks that run together share
  // their W tile in L2
  const int n_ranges = B / RB;
  const int v0 = (int)(blockIdx.x / n_ranges) * BN;
  const int b0 = (int)(blockIdx.x % n_ranges) * RB;
  const int n_cols = min(BN, V - v0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid < BN) bias_s[tid] = (tid < n_cols && bias) ? bias[v0 + tid] : 0.f;
  for (int i = tid; i < RB; i += FT) row_on[i] = 0;
  __syncthreads();
  for (int i = tid; i < RB * BN; i += FT) {
    const int bl = i / BN, col = i % BN;
    float key = __int_as_float(0x7fc00000);  // NaN: equal to no score
    if (col < n_cols) {
      const size_t at = (size_t)(b0 + bl) * V + v0 + col;
      if (g[at] != 0.f) {
        key = m[at];
        row_on[bl] = 1;
      }
    }
    mkey[i] = key;
  }
  __syncthreads();
  const int n_live =
      list_live_groups(mask, b0, RB, S, groups, warp_live, row_on, dead);

  // zeros for the halves no tile writes: groups left out and the one past S
  // (a word of the last group alone), whole words where both halves are
  for (int r = warp; r < RB * J; r += FT / 32) {
    const int bl = r / J, jw = r % J;
    const bool lo = dead[bl * G + 2 * jw];
    const bool hi = 2 * jw + 1 >= G || dead[bl * G + 2 * jw + 1];
    if (!(lo || hi)) continue;
    const size_t word = ((size_t)(b0 + bl) * J + jw) * V + v0;
    for (int col = lane; col < n_cols; col += 32) {
      if (lo && hi)
        reinterpret_cast<uint32_t*>(half)[word + col] = 0u;
      else
        half[(word + col) * 2 + (hi ? 1 : 0)] = 0;
    }
  }

  const int wm = warp >> 1, wn = warp & 1;  // 64-row half, 64-column half
  const int gq = lane >> 2, c = 2 * (lane & 3);
  const auto bit_or = [](uint32_t a, uint32_t b) { return a | b; };
  walk_tiles(smem, groups, n_live, h, w, v0, V, H,
             [&](int tile, int live, const float (&acc)[4][8][4]) {
    float2 bv[8];  // bias of this lane's columns 8j + c, 8j + c + 1
#pragma unroll
    for (int j = 0; j < 8; ++j)
      bv[j] = *reinterpret_cast<const float2*>(bias_s + wn * 64 + 8 * j + c);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i >= live) break;
      const int2 e = groups[tile * GROUPS_A_TILE + wm * 4 + i];
      const int bl = e.y & 0xffff;
      const bool ok0 = row_valid(e, gq), ok1 = row_valid(e, gq + 8);
      const float* mrow = mkey + bl * BN + wn * 64 + c;
      // v[j]: this lane's bits of columns 8j + c (low 16) and 8j + c + 1
      // (high 16), rows gq and gq + 8
      uint32_t v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 mv = *reinterpret_cast<const float2*>(mrow + 8 * j);
        const uint32_t b00 = ok0 && acc[i][j][0] + bv[j].x == mv.x;
        const uint32_t b01 = ok0 && acc[i][j][1] + bv[j].y == mv.y;
        const uint32_t b10 = ok1 && acc[i][j][2] + bv[j].x == mv.x;
        const uint32_t b11 = ok1 && acc[i][j][3] + bv[j].y == mv.y;
        v[j] = (b00 << gq) | (b10 << (gq + 8)) | (b01 << (gq + 16)) |
               (b11 << (gq + 24));
      }
      halve<4>(v, lane & 16, 16, bit_or);
      halve<2>(v, lane & 8, 8, bit_or);
      halve<1>(v, lane & 4, 4, bit_or);
      // lane gq holds the group's 16 bits of columns 8gq + c and + 1
      const int s0 = e.x - (b0 + bl) * S;
      const int col = wn * 64 + 8 * gq + c;
      uint16_t* out = half +
                      (((size_t)(b0 + bl) * J + (s0 >> 5)) * V + v0 + col) *
                          2 +
                      ((s0 >> 4) & 1);
      if (col < n_cols) out[0] = (uint16_t)(v[0] & 0xffffu);
      if (col + 1 < n_cols) out[2] = (uint16_t)(v[0] >> 16);
    }
  });
}

}  // namespace

// Dynamic shared memory the match pass asks for at sequence length S and
// row block RB: the wrapper refuses a size above the card's limit by this
// number.
extern "C" int splade_fused_pool_v2_bwd_shared_bytes(int S, int RB) {
  return shared_bytes(S, RB);
}

// Static shared memory of the match pass, which a block holds beside the
// dynamic part: the two together must fit the card's opt-in limit. -1 if the
// runtime cannot say.
extern "C" int splade_fused_pool_v2_bwd_static_bytes() {
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, fused_splade_v2_bwd_match_kernel) !=
      cudaSuccess)
    return -1;
  return (int)attr.sharedSizeBytes;
}

// h [B,S,H] bf16, w [V,H] bf16, bias [V] f32 or null, mask [B,S] f32,
// m and g [B,V] f32, out match [B, ceil(S/32), V] uint32, every word
// written. RB divides B. H % 8 == 0, 16-byte aligned rows and the
// shared-memory size are checked by the wrapper.
extern "C" int splade_fused_pool_v2_bwd_match(const void* h, const void* w,
                                              const void* bias,
                                              const void* mask, const void* m,
                                              const void* g, void* match,
                                              int B, int S, int H, int V,
                                              int RB, void* stream) {
  if (RB < 1 || RB > 0xffff || B % RB || H % 8)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)((V + BN - 1) / BN) * (B / RB);
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const int bytes = shared_bytes(S, RB);
  cudaError_t err = cudaFuncSetAttribute(
      fused_splade_v2_bwd_match_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  fused_splade_v2_bwd_match_kernel<<<(unsigned)blocks, FT, bytes,
                                     (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)h, (const __nv_bfloat16*)w, (const float*)bias,
      (const float*)mask, (const float*)m, (const float*)g,
      (uint16_t*)match, B, S, H, V, RB);
  return (int)cudaGetLastError();
}
