// Row-blocked fused SPLADE projection + masked sequence max, forward (Hopper).
//
// Replaces splade_tpu/ops/fused_splade_v2.py::_fwd_kernel (the Pallas forward
// behind fused_splade_pool_v2): the same function as fused_splade_fwd.cu,
//
//     score[s, v] = h[b, s, :] . W[v, :] + bias[v]      (invalid s -> -1e30)
//     m[b, v]     = max_s score[s, v]
//     pos[b, s]   = max_v score[s, v]                     atomicMax across tiles
//
// with one block owning RB batch rows and one tile of BN vocab columns: the
// product [RB*S, H] x [H, BN]. What makes it the row-blocked kernel and not
// the per-row one in a loop: the block brings its W tile into shared memory
// once, for the whole hidden width (64 x 768 bf16 = 97 KB, dynamic shared
// memory opted in above 48 KB), and uses it for all RB*S rows, which it walks
// in chunks of BM flattened rows; only the h chunk is staged per k-step. The
// per-row kernel re-stages its W slice for every (batch row, tile) block and
// leans on L2 for it.
//
// A chunk of flattened rows may cross a batch-row boundary (S need not be a
// multiple of BM), so each row finds its own b: the column maxima of the RB
// batch rows are joined in shared memory by atomicMax on the integer key (a
// maximum has no order, so m equals the per-row kernel's bit for bit), and
// the per-position maxima cross vocab tiles through the same key in device
// memory. Chunks without a valid position are skipped.
//
// What bounds it: the tensor cores, as the per-row kernel (2*valid*H*V
// operations). The score chunk is fused_splade_tile.cuh's arithmetic (bf16
// WMMA 16x16x16, k-slices of 16 ascending, bias added after in f32). The
// resident tile leaves room for one block of 8 warps a multiprocessor, so
// the next k-step's h loads wait in registers during the products. Still a
// simple first version: WMMA, no TMA or wgmma.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fused_splade_tile.cuh"

namespace {

using splade_tile::float_from_key;
using splade_tile::float_key;
using splade_tile::NEG;
using splade_tile::THREADS;

constexpr int BM = 128;  // flattened rows per chunk
constexpr int BN = 64;   // vocab columns per block: the resident W tile
using Tile = splade_tile::Chunk<BM, BN>;
constexpr int LDC = Tile::LDC;
constexpr int GROUPS = THREADS / BN;  // row groups of the column maxima
static_assert(THREADS == 2 * BM, "two threads per row for the row maxima");

// the kernel's dynamic shared memory: W tile | A/C | bias | column keys
// [RB, BN]
__host__ __device__ inline int shared_bytes(int H, int RB) {
  return splade_tile::w_tile_bytes<BN>(H) + Tile::AC_BYTES + BN * 4 +
         RB * BN * 4;
}

__global__ void __launch_bounds__(THREADS, 1)
fused_splade_v2_fwd_kernel(const __nv_bfloat16* __restrict__ h,
                           const __nv_bfloat16* __restrict__ w,
                           const float* __restrict__ bias,
                           const float* __restrict__ mask,
                           float* __restrict__ m_out,
                           int* __restrict__ pos_key, int S, int H, int V,
                           int RB) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldb = splade_tile::resident_ld(H);
  __nv_bfloat16* Wt = reinterpret_cast<__nv_bfloat16*>(smem);
  unsigned char* ac = smem + splade_tile::w_tile_bytes<BN>(H);
  const float* Cs = reinterpret_cast<const float*>(ac);
  float* bias_s = reinterpret_cast<float*>(ac + Tile::AC_BYTES);
  int* col_key = reinterpret_cast<int*>(bias_s + BN);  // [RB, BN]

  const int v0 = blockIdx.x * BN;
  const int n_cols = min(BN, V - v0);
  const int rb0 = blockIdx.y * RB;  // first batch row of the block
  const int R = RB * S;             // its flattened rows
  const int tid = threadIdx.x;
  const __nv_bfloat16* rows = h + (size_t)rb0 * S * H;
  const float* maskr = mask + (size_t)rb0 * S;

  if (tid < BN) bias_s[tid] = (tid < n_cols && bias) ? bias[v0 + tid] : 0.f;
  for (int i = tid; i < RB * BN; i += THREADS) col_key[i] = float_key(NEG);
  splade_tile::stage_w_tile<BN>(w, v0, n_cols, H, Wt, ldb);
  __syncthreads();

  const int col = tid % BN, grp = tid / BN;
  for (int s0 = 0; s0 < R; s0 += BM) {
    bool any = false;
    if (tid < BM) any = s0 + tid < R && maskr[s0 + tid] > 0.f;
    if (!__syncthreads_or(any)) continue;  // no valid position in the chunk
    splade_tile::score_chunk_resident<BM, BN>(rows, s0, R, Wt, ldb, H, ac);

    // column maxima, each row under its own batch row
    if (col < n_cols) {
      const float bv = bias_s[col];
      int cur = -1;
      float cmax = NEG;
      for (int r = grp * (BM / GROUPS); r < (grp + 1) * (BM / GROUPS); ++r) {
        const int flat = s0 + r;
        if (flat < R && maskr[flat] > 0.f) {
          const int bl = flat / S;
          if (bl != cur) {
            if (cur >= 0) atomicMax(col_key + cur * BN + col, float_key(cmax));
            cur = bl;
            cmax = NEG;
          }
          cmax = fmaxf(cmax, Cs[r * LDC + col] + bv);
        }
      }
      if (cur >= 0) atomicMax(col_key + cur * BN + col, float_key(cmax));
    }
    // row maxima over the in-range columns: two neighbouring lanes per row
    {
      const int r = tid >> 1, part = tid & 1;
      const int flat = s0 + r;
      float rm = NEG;
      for (int c = part; c < n_cols; c += 2)
        rm = fmaxf(rm, Cs[r * LDC + c] + bias_s[c]);
      rm = fmaxf(rm, __shfl_xor_sync(0xffffffffu, rm, 1));
      if (part == 0 && flat < R && maskr[flat] > 0.f)
        atomicMax(pos_key + (size_t)rb0 * S + flat, float_key(rm));
    }
    __syncthreads();  // Cs is overwritten by the next chunk's staging
  }

  for (int i = tid; i < RB * BN; i += THREADS) {
    const int bl = i / BN, c = i % BN;
    if (c < n_cols)
      m_out[(size_t)(rb0 + bl) * V + v0 + c] = float_from_key(col_key[i]);
  }
}

}  // namespace

// Dynamic shared memory the forward kernel asks for at hidden width H and row
// block RB: the wrapper refuses a size above the card's limit by this number.
extern "C" int splade_fused_pool_v2_fwd_shared_bytes(int H, int RB) {
  return shared_bytes(H, RB);
}

// h [B,S,H] bf16, w [V,H] bf16, bias [V] f32 or null, mask [B,S] f32,
// m_out [B,V] f32, pos_key [B,S] int32 pre-filled with key(-1e30); RB divides
// B. H % 8 == 0, 16-byte aligned rows and the shared-memory size are checked
// by the wrapper (a size the card refuses comes back as the launch's error).
extern "C" int splade_fused_pool_v2_fwd(const void* h, const void* w,
                                        const void* bias, const void* mask,
                                        void* m_out, void* pos_key, int B,
                                        int S, int H, int V, int RB,
                                        void* stream) {
  if (RB < 1 || B % RB || H % 8) return (int)cudaErrorInvalidValue;
  const int bytes = shared_bytes(H, RB);
  cudaError_t err = cudaFuncSetAttribute(
      fused_splade_v2_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((V + BN - 1) / BN, B / RB);
  fused_splade_v2_fwd_kernel<<<grid, THREADS, bytes, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)h, (const __nv_bfloat16*)w, (const float*)bias,
      (const float*)mask, (float*)m_out, (int*)pos_key, S, H, V, RB);
  return (int)cudaGetLastError();
}
