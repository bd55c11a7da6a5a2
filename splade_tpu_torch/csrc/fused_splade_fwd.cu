// Fused SPLADE vocabulary projection + masked sequence max, forward (Hopper).
//
// Replaces splade_tpu/ops/fused_splade.py::_fwd_kernel (the Pallas forward
// behind fused_splade_pool). For one batch row b and one tile of BN vocab
// columns a block computes
//
//     score[s, v] = h[b, s, :] . W[v, :] + bias[v]      (invalid s -> -1e30)
//     m[b, v]     = max_s score[s, v]                     written once
//     pos[b, s]   = max_v score[s, v]                     atomicMax across tiles
//
// and never writes the [S, BN] score tile to device memory: [B, S, V] never
// exists. The wrapper (ops/fused_splade.py) applies log1p(relu) and the mask.
//
// What bounds it: at document encode (B=32, S=256, H=768, V=50,000) the work
// is 2*B*S*H*V = 6.3e11 FLOP against ~27 MB of unique input, so the tensor
// cores bound it (0.64 ms at 989 TFLOP/s bf16). The design feeds them with
// bf16 WMMA 16x16x16 products accumulated in f32, the k-loop over H staged
// through shared memory in 64-wide slices, 8 warps each owning a 16x64
// strip of the 64x128 score chunk. It is the simple first version: one
// shared-memory stage, no TMA or wgmma pipeline (a later PR's work).
//
// Blocks run in no order, so the per-position maxima cross vocab tiles
// through atomicMax on the order-preserving integer image of the float
// (float_key); the wrapper fills the buffer with key(-1e30) and decodes it.
// The ragged last vocab tile (50,000 is not a multiple of BN) is masked here:
// W is never padded or copied. The score chunk comes from
// fused_splade_tile.cuh, which the backward kernels share, so that their
// recompute equals these scores bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fused_splade_tile.cuh"

namespace {

using splade_tile::float_key;
using splade_tile::NEG;
using splade_tile::THREADS;

constexpr int BM = 64;         // sequence rows per chunk
constexpr int BN = 128;        // vocab columns per block
using Tile = splade_tile::Chunk<BM, BN>;
constexpr int LDC = Tile::LDC;

__global__ void __launch_bounds__(THREADS)
fused_splade_fwd_kernel(const __nv_bfloat16* __restrict__ h,
                        const __nv_bfloat16* __restrict__ w,
                        const float* __restrict__ bias,
                        const float* __restrict__ mask,
                        float* __restrict__ m_out, int* __restrict__ pos_key,
                        int S, int H, int V) {
  __shared__ __align__(128) unsigned char smem[Tile::SMEM_BYTES];
  __shared__ float bias_s[BN];
  float* Cs = reinterpret_cast<float*>(smem);

  const int b = blockIdx.y;
  const int v0 = blockIdx.x * BN;
  const int n_cols = min(BN, V - v0);
  const int tid = threadIdx.x;

  const __nv_bfloat16* hb = h + (size_t)b * S * H;
  const float* maskb = mask + (size_t)b * S;

  if (tid < BN) bias_s[tid] = (tid < n_cols && bias) ? bias[v0 + tid] : 0.f;

  // column maxima: thread owns column (tid & 127) over rows of half (tid>>7)
  const int col = tid & (BN - 1);
  const int half = tid >> 7;
  float colmax = NEG;

  for (int s0 = 0; s0 < S; s0 += BM) {
    splade_tile::score_chunk<BM, BN>(hb, w, s0, S, v0, n_cols, H, smem);

    // column max over the valid rows of this chunk
    if (col < n_cols) {
      const float bv = bias_s[col];
      for (int r = half * (BM / 2); r < (half + 1) * (BM / 2); ++r) {
        const int s = s0 + r;
        if (s < S && maskb[s] > 0.f)
          colmax = fmaxf(colmax, Cs[r * LDC + col] + bv);
      }
    }
    // row max over the in-range columns: 4 neighbouring lanes per row
    {
      const int r = tid >> 2, part = tid & 3;
      const int s = s0 + r;
      float rm = NEG;
      for (int c = part; c < n_cols; c += 4)
        rm = fmaxf(rm, Cs[r * LDC + c] + bias_s[c]);
      rm = fmaxf(rm, __shfl_xor_sync(0xffffffffu, rm, 1));
      rm = fmaxf(rm, __shfl_xor_sync(0xffffffffu, rm, 2));
      if (part == 0 && s < S && maskb[s] > 0.f)
        atomicMax(pos_key + (size_t)b * S + s, float_key(rm));
    }
    __syncthreads();  // Cs is overwritten by the next chunk's staging
  }

  // combine the two row halves of each column
  float* red = Cs;
  if (half == 1) red[col] = colmax;
  __syncthreads();
  if (half == 0 && col < n_cols)
    m_out[(size_t)b * V + v0 + col] = fmaxf(colmax, red[col]);
}

}  // namespace

// h [B,S,H] bf16, w [V,H] bf16, bias [V] f32 or null, mask [B,S] f32,
// m_out [B,V] f32, pos_key [B,S] int32 pre-filled with key(-1e30).
// H % 8 == 0 and 16-byte aligned rows are checked by the wrapper.
extern "C" int splade_fused_pool_fwd(const void* h, const void* w,
                                     const void* bias, const void* mask,
                                     void* m_out, void* pos_key, int B, int S,
                                     int H, int V, void* stream) {
  dim3 grid((V + BN - 1) / BN, B);
  fused_splade_fwd_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)h, (const __nv_bfloat16*)w, (const float*)bias,
      (const float*)mask, (float*)m_out, (int*)pos_key, S, H, V);
  return (int)cudaGetLastError();
}
