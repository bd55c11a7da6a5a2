// Fused SPLADE vocabulary projection + masked sequence max, backward (Hopper).
//
// Replaces splade_tpu/ops/fused_splade.py::_bwd_dh_kernel and ::_bwd_dw_kernel
// (the Pallas kernels of fused_splade_pool's custom VJP). With m[b, v] the
// forward's pre-activation maxima and g[b, v] the cotangent already folded
// through log1p(relu) (g_pre, computed by the wrapper), both recompute
//
//     score[s, v] = h[b, s, :] . W[v, :] + bias[v]          (invalid s: none)
//     G[s, v]     = g[b, v] if score[s, v] == m[b, v] else 0
//
// and contract it:
//
//     dh[b, s, :] = sum_v G[s, v] W[v, :]        splade_fused_pool_bwd_dh
//     dW[v, :]    = sum_b sum_s G[s, v] h[b, s, :]   splade_fused_pool_bwd_dw
//
// Ties get duplicate gradient, as in the Pallas kernels. dbias = sum_b g is
// the wrapper's. The scores come from fused_splade_tile.cuh, the forward's own
// routine, so the equality with m holds bit for bit where the forward took its
// maximum: a recompute that differed by one ulp would match almost nothing.
//
// Blocks run in no order, so neither kernel carries a sum across blocks:
// - dh: one block per (b, chunk of 32 rows, vocab split) loops over the
//   split's vocab tiles; each thread keeps 96 f32 sums of dh (one row, 96
//   of its <= 768 columns) in registers for the whole loop. With few rows
//   (the query batch: B*S/32 = 128 blocks, one a multiprocessor) the wrapper
//   splits the vocabulary so the card fills, and sums the splits' partial
//   dh in a fixed order afterwards.
// - dW: one block per tile of 32 vocab columns loops over every b and every
//   64-row chunk; each thread keeps 96 f32 sums of one dW row the same way.
// Both are deterministic (no atomics): a repeated step is bitwise identical.
//
// What bounds it: the recompute is the forward's tensor-core work,
// 2*valid*H*V operations. G holds one entry per (b, v) and column, ties
// aside, so its contraction is done sparsely: each match adds one f32 row
// (H multiply-adds) in CUDA cores, about B*V*H in all, instead of the dense
// 2*valid*H*V product the TPU kernels run on the MXU. Tiles and chunks where g
// is all zero (m <= 0, padded rows) or no row is valid are skipped. The bound
// chip_smoke.py holds both kernels to is that work: the recompute on the
// tensor cores plus one f32 row a match on the CUDA cores.
// One block a multiprocessor (the register sums), so the recompute holds the
// next k-step's loads in registers while the current one multiplies. Still
// the simple first version: one shared-memory stage, WMMA, no TMA or wgmma.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fused_splade_tile.cuh"

namespace {

using splade_tile::THREADS;

constexpr int MAX_H = 768;              // 96 register sums per thread
constexpr int PARTS = 8;                // threads sharing one row of sums
constexpr int KJ = MAX_H / (PARTS * 8); // 16-byte slices per thread (12)

constexpr int DH_BM = 32, DH_BN = 128;
using DhTile = splade_tile::Chunk<DH_BM, DH_BN>;
constexpr int DW_BM = 64, DW_BN = 32;
using DwTile = splade_tile::Chunk<DW_BM, DW_BN>;
static_assert(DH_BM * PARTS == THREADS && DW_BN * PARTS == THREADS,
              "PARTS threads per row of sums");

// acc[j*8 + e] += g * row[j*64 + part*8 + e] for the in-range slices
__device__ __forceinline__ void add_row(float* acc, float g,
                                        const __nv_bfloat16* __restrict__ row,
                                        int part, int H) {
#pragma unroll
  for (int j = 0; j < KJ; ++j) {
    const int k = j * (PARTS * 8) + part * 8;
    if (k < H) {
      const uint4 raw = *reinterpret_cast<const uint4*>(row + k);
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(p[e]);
        acc[j * 8 + 2 * e] = fmaf(g, f.x, acc[j * 8 + 2 * e]);
        acc[j * 8 + 2 * e + 1] = fmaf(g, f.y, acc[j * 8 + 2 * e + 1]);
      }
    }
  }
}

__device__ __forceinline__ void store_row(float* __restrict__ out,
                                          const float* acc, int part, int H) {
#pragma unroll
  for (int j = 0; j < KJ; ++j) {
    const int k = j * (PARTS * 8) + part * 8;
    if (k < H) {
      float4* o = reinterpret_cast<float4*>(out + k);
      o[0] = make_float4(acc[j * 8], acc[j * 8 + 1], acc[j * 8 + 2],
                         acc[j * 8 + 3]);
      o[1] = make_float4(acc[j * 8 + 4], acc[j * 8 + 5], acc[j * 8 + 6],
                         acc[j * 8 + 7]);
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
fused_splade_bwd_dh_kernel(const __nv_bfloat16* __restrict__ h,
                           const __nv_bfloat16* __restrict__ w,
                           const float* __restrict__ bias,
                           const float* __restrict__ mask,
                           const float* __restrict__ m,
                           const float* __restrict__ g,
                           float* __restrict__ dh, int S, int H, int V,
                           int split_cols) {
  __shared__ __align__(128) unsigned char smem[DhTile::SMEM_BYTES];
  __shared__ float bias_s[DH_BN], m_s[DH_BN], g_s[DH_BN];
  const float* Cs = reinterpret_cast<const float*>(smem);
  constexpr int LDC = DhTile::LDC;

  const int b = blockIdx.y;
  const int s0 = blockIdx.x * DH_BM;
  const int tid = threadIdx.x;
  const int r = tid / PARTS, part = tid % PARTS;
  const int s = s0 + r;
  const bool valid = s < S && mask[(size_t)b * S + s] > 0.f;
  const __nv_bfloat16* hb = h + (size_t)b * S * H;
  const int v_begin = blockIdx.z * split_cols;
  const int v_end = min(V, v_begin + split_cols);
  dh += (size_t)blockIdx.z * gridDim.y * S * H;  // this split's partial dh

  float acc[KJ * 8];
#pragma unroll
  for (int i = 0; i < KJ * 8; ++i) acc[i] = 0.f;

  if (__syncthreads_or(valid)) {
    for (int v0 = v_begin; v0 < v_end; v0 += DH_BN) {
      const int n_cols = min(DH_BN, v_end - v0);
      bool live = false;
      if (tid < DH_BN) {
        const bool in = tid < n_cols;
        bias_s[tid] = (in && bias) ? bias[v0 + tid] : 0.f;
        m_s[tid] = in ? m[(size_t)b * V + v0 + tid] : 0.f;
        g_s[tid] = in ? g[(size_t)b * V + v0 + tid] : 0.f;
        live = g_s[tid] != 0.f;
      }
      if (!__syncthreads_or(live)) continue;  // G is 0 on this tile
      splade_tile::score_chunk<DH_BM, DH_BN, true>(hb, w, s0, S, v0, n_cols, H,
                                                   smem);
      if (valid) {
        for (int c = 0; c < n_cols; ++c) {
          const float gc = g_s[c];
          if (gc != 0.f && Cs[r * LDC + c] + bias_s[c] == m_s[c])
            add_row(acc, gc, w + (size_t)(v0 + c) * H, part, H);
        }
      }
      __syncthreads();  // Cs and the tile vectors are rewritten next
    }
  }
  if (s < S) store_row(dh + ((size_t)b * S + s) * H, acc, part, H);
}

__global__ void __launch_bounds__(THREADS, 1)
fused_splade_bwd_dw_kernel(const __nv_bfloat16* __restrict__ h,
                           const __nv_bfloat16* __restrict__ w,
                           const float* __restrict__ bias,
                           const float* __restrict__ mask,
                           const float* __restrict__ m,
                           const float* __restrict__ g,
                           float* __restrict__ dw, int B, int S, int H,
                           int V) {
  __shared__ __align__(128) unsigned char smem[DwTile::SMEM_BYTES];
  __shared__ float bias_s[DW_BN], m_s[DW_BN], g_s[DW_BN];
  __shared__ bool valid_s[DW_BM];
  const float* Cs = reinterpret_cast<const float*>(smem);
  constexpr int LDC = DwTile::LDC;

  const int v0 = blockIdx.x * DW_BN;
  const int n_cols = min(DW_BN, V - v0);
  const int tid = threadIdx.x;
  const int c = tid / PARTS, part = tid % PARTS;

  if (tid < DW_BN) bias_s[tid] = (tid < n_cols && bias) ? bias[v0 + tid] : 0.f;

  float acc[KJ * 8];
#pragma unroll
  for (int i = 0; i < KJ * 8; ++i) acc[i] = 0.f;

  for (int b = 0; b < B; ++b) {
    bool live = false;
    if (tid < DW_BN) {
      const bool in = tid < n_cols;
      m_s[tid] = in ? m[(size_t)b * V + v0 + tid] : 0.f;
      g_s[tid] = in ? g[(size_t)b * V + v0 + tid] : 0.f;
      live = g_s[tid] != 0.f;
    }
    if (!__syncthreads_or(live)) continue;  // G is 0 for this b and tile
    const __nv_bfloat16* hb = h + (size_t)b * S * H;
    const float gc = c < n_cols ? g_s[c] : 0.f;
    const float mc = m_s[c];
    const float bc = bias_s[c];
    for (int s0 = 0; s0 < S; s0 += DW_BM) {
      bool any = false;
      if (tid < DW_BM) {
        const int s = s0 + tid;
        valid_s[tid] = s < S && mask[(size_t)b * S + s] > 0.f;
        any = valid_s[tid];
      }
      if (!__syncthreads_or(any)) continue;  // no valid row in this chunk
      splade_tile::score_chunk<DW_BM, DW_BN, true>(hb, w, s0, S, v0, n_cols, H,
                                                   smem);
      if (gc != 0.f) {
        for (int rr = 0; rr < DW_BM; ++rr) {
          if (valid_s[rr] && Cs[rr * LDC + c] + bc == mc)
            add_row(acc, gc, hb + (size_t)(s0 + rr) * H, part, H);
        }
      }
      __syncthreads();  // Cs and valid_s are rewritten next
    }
    // m_s and g_s are rewritten for the next b: every thread has read them
    __syncthreads();
  }
  if (c < n_cols) store_row(dw + (size_t)(v0 + c) * H, acc, part, H);
}

}  // namespace

// h [B,S,H] bf16, w [V,H] bf16, bias [V] f32 or null, mask [B,S] f32,
// m and g [B,V] f32, out dh [splits,B,S,H] f32: split z sums the vocab
// tiles of columns [z*c, (z+1)*c), c = ceil(ceil(V/128)/splits)*128.
// H % 8 == 0, H <= 768 and 16-byte aligned rows are checked by the wrapper
// (H > 768 is refused here too).
extern "C" int splade_fused_pool_bwd_dh(const void* h, const void* w,
                                        const void* bias, const void* mask,
                                        const void* m, const void* g, void* dh,
                                        int B, int S, int H, int V, int splits,
                                        void* stream) {
  if (H > MAX_H || H % 8 || splits < 1) return (int)cudaErrorInvalidValue;
  const int tiles = (V + DH_BN - 1) / DH_BN;
  const int split_cols = (tiles + splits - 1) / splits * DH_BN;
  dim3 grid((S + DH_BM - 1) / DH_BM, B, splits);
  fused_splade_bwd_dh_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)h, (const __nv_bfloat16*)w, (const float*)bias,
      (const float*)mask, (const float*)m, (const float*)g, (float*)dh, S, H,
      V, split_cols);
  return (int)cudaGetLastError();
}

// as above, out dw [V,H] f32
extern "C" int splade_fused_pool_bwd_dw(const void* h, const void* w,
                                        const void* bias, const void* mask,
                                        const void* m, const void* g, void* dw,
                                        int B, int S, int H, int V,
                                        void* stream) {
  if (H > MAX_H || H % 8) return (int)cudaErrorInvalidValue;
  dim3 grid((V + DW_BN - 1) / DW_BN);
  fused_splade_bwd_dw_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)h, (const __nv_bfloat16*)w, (const float*)bias,
      (const float*)mask, (const float*)m, (const float*)g, (float*)dw, B, S,
      H, V);
  return (int)cudaGetLastError();
}
