// Row-blocked fused SPLADE projection + masked sequence max, backward (Hopper).
//
// Replaces splade_tpu/ops/fused_splade_v2.py::_bwd_dh_kernel and
// ::_bwd_dw_kernel (the Pallas kernels of fused_splade_pool_v2's custom VJP):
// the same function as fused_splade_bwd.cu. With m[b, v] the forward's maxima
// and g[b, v] the cotangent folded through log1p(relu) by the wrapper, both
// recompute, over the RB*S flattened rows of a row block,
//
//     score[s, v] = h[b, s, :] . W[v, :] + bias[v]          (invalid s: none)
//     G[s, v]     = g[b, v] if score[s, v] == m[b, v] else 0
//
// (a chunk of flattened rows may cross a batch-row boundary, so m, g and the
// mask are looked up by each row's own b) and contract it:
//
//     dh[b, s, :] = sum_v G[s, v] W[v, :]            splade_fused_pool_v2_bwd_dh
//     dW[v, :]    = sum_b sum_s G[s, v] h[b, s, :]   splade_fused_pool_v2_bwd_dw
//
// What makes the family row-blocked: a block keeps its W tile (BN vocab rows,
// the whole hidden width, 97 KB at H = 768) resident in shared memory across
// rows, where the per-row kernels re-stage W for every chunk of rows. The
// scores are fused_splade_tile.cuh's arithmetic, so they equal the maxima of
// either forward kernel bit for bit.
//
// Pallas takes its order of summation from a sequential grid axis (vocab
// tiles for dh, row blocks for dW). A CUDA grid has no order, so here each
// output row has one owner that walks that axis itself:
// - dh: a block owns one row block (and one split of the vocabulary, so that
//   few row blocks still fill the card) and walks its vocab tiles in
//   ascending order; for each resident tile it walks the row block's chunks.
//   The sums do not fit in registers across a whole row block, so they live
//   in the output: the 4 threads that own a row add each match's W row (read
//   from the resident tile) into dh[row] in device memory, tiles ascending
//   and columns ascending within a tile. The wrapper zeroes the buffer and
//   adds the splits' partial dh in a fixed order.
// - dW: a block owns one tile of BN vocab columns, resident for the whole
//   kernel, and walks every row block and its chunks in ascending order; the
//   4 threads that own a column add each match's h row into dW[column].
// No atomics and a fixed owner and order for every sum: a repeated call is
// bitwise equal.
//
// What bounds it: as the per-row kernels, the recompute on the tensor cores
// (2*valid*H*V operations) plus one f32 row of H multiply-adds a match.
// Tiles whose g is all zero and chunks without a valid row are skipped. One
// block of 8 warps a multiprocessor (the resident tile); WMMA, no TMA or
// wgmma: the simple first version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fused_splade_tile.cuh"

namespace {

using splade_tile::THREADS;

constexpr int BM = 64;               // flattened rows per chunk
constexpr int BN = 64;               // vocab columns of the resident W tile
constexpr int PARTS = THREADS / BM;  // threads sharing one output row (4)
using Tile = splade_tile::Chunk<BM, BN>;
constexpr int LDC = Tile::LDC;
static_assert(BM == BN, "dh owns BM rows and dW BN columns, PARTS threads each");

// the kernels' dynamic shared memory: W tile | A/C | bias | m, g [RB, BN] |
// per-chunk row flags
__host__ __device__ inline int shared_bytes(int H, int RB) {
  return splade_tile::w_tile_bytes<BN>(H) + Tile::AC_BYTES + BN * 4 + 2 * RB * BN * 4 + BM * 8;
}

// out[k] += g * row[k] over this thread's 16-byte slices of the H-wide row:
// out in device memory (f32), row bf16 in shared or device memory
__device__ __forceinline__ void add_row_to(float* __restrict__ out, float g,
                                           const __nv_bfloat16* row, int part,
                                           int H) {
  for (int k = part * 8; k < H; k += PARTS * 8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(row + k);
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
    float4* o = reinterpret_cast<float4*>(out + k);
    float4 a = o[0], b = o[1];
    float2 f = __bfloat1622float2(p[0]);
    a.x = fmaf(g, f.x, a.x);
    a.y = fmaf(g, f.y, a.y);
    f = __bfloat1622float2(p[1]);
    a.z = fmaf(g, f.x, a.z);
    a.w = fmaf(g, f.y, a.w);
    f = __bfloat1622float2(p[2]);
    b.x = fmaf(g, f.x, b.x);
    b.y = fmaf(g, f.y, b.y);
    f = __bfloat1622float2(p[3]);
    b.z = fmaf(g, f.x, b.z);
    b.w = fmaf(g, f.y, b.w);
    o[0] = a;
    o[1] = b;
  }
}

struct Shared {
  __nv_bfloat16* Wt;
  unsigned char* ac;
  float* bias_s;
  float* m_s;  // [RB, BN]
  float* g_s;  // [RB, BN]
  int* row_b;  // [BM] batch row (within the block) of each chunk row
  int* row_ok;  // [BM] whether it is a valid position
};

__device__ __forceinline__ Shared carve(unsigned char* smem, int H, int RB) {
  Shared s;
  s.Wt = reinterpret_cast<__nv_bfloat16*>(smem);
  s.ac = smem + splade_tile::w_tile_bytes<BN>(H);
  s.bias_s = reinterpret_cast<float*>(s.ac + Tile::AC_BYTES);
  s.m_s = s.bias_s + BN;
  s.g_s = s.m_s + RB * BN;
  s.row_b = reinterpret_cast<int*>(s.g_s + RB * BN);
  s.row_ok = s.row_b + BM;
  return s;
}

// m and g of batch rows rb0..rb0+RB, columns v0..v0+n_cols, into shared
// memory; true if any g is nonzero (ends with a barrier)
__device__ __forceinline__ bool load_tile_vectors(const Shared& sh,
                                                  const float* __restrict__ m,
                                                  const float* __restrict__ g,
                                                  int rb0, int RB, int v0,
                                                  int n_cols, int V) {
  bool live = false;
  for (int i = threadIdx.x; i < RB * BN; i += THREADS) {
    const int bl = i / BN, c = i % BN;
    const bool in = c < n_cols;
    const size_t at = (size_t)(rb0 + bl) * V + v0 + c;
    sh.m_s[i] = in ? m[at] : 0.f;
    const float gv = in ? g[at] : 0.f;
    sh.g_s[i] = gv;
    live |= gv != 0.f;
  }
  return __syncthreads_or(live);
}

__global__ void __launch_bounds__(THREADS, 1)
fused_splade_v2_bwd_dh_kernel(const __nv_bfloat16* __restrict__ h,
                              const __nv_bfloat16* __restrict__ w,
                              const float* __restrict__ bias,
                              const float* __restrict__ mask,
                              const float* __restrict__ m,
                              const float* __restrict__ g,
                              float* __restrict__ dh, int S, int H, int V,
                              int RB, int split_cols) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Shared sh = carve(smem, H, RB);
  const float* Cs = reinterpret_cast<const float*>(sh.ac);
  const int ldb = splade_tile::resident_ld(H);

  const int rb0 = blockIdx.x * RB;
  const int R = RB * S;
  const int tid = threadIdx.x;
  const int r = tid / PARTS, part = tid % PARTS;
  const __nv_bfloat16* rows = h + (size_t)rb0 * S * H;
  const float* maskr = mask + (size_t)rb0 * S;
  const int v_begin = blockIdx.y * split_cols;
  const int v_end = min(V, v_begin + split_cols);
  // this split's partial dh, at this row block
  dh += ((size_t)blockIdx.y * gridDim.x * RB + rb0) * S * H;

  bool any_row = false;
  for (int i = tid; i < R; i += THREADS) any_row |= maskr[i] > 0.f;
  if (!__syncthreads_or(any_row)) return;  // a fully padded row block

  for (int v0 = v_begin; v0 < v_end; v0 += BN) {
    const int n_cols = min(BN, v_end - v0);
    if (tid < BN)
      sh.bias_s[tid] = (tid < n_cols && bias) ? bias[v0 + tid] : 0.f;
    if (!load_tile_vectors(sh, m, g, rb0, RB, v0, n_cols, V))
      continue;  // G is 0 on this tile for every row of the block
    splade_tile::stage_w_tile<BN>(w, v0, n_cols, H, sh.Wt, ldb);
    for (int s0 = 0; s0 < R; s0 += BM) {
      const int flat = s0 + r;
      const bool valid = flat < R && maskr[flat] > 0.f;
      if (!__syncthreads_or(valid)) continue;  // no valid row in the chunk
      splade_tile::score_chunk_resident<BM, BN>(rows, s0, R, sh.Wt, ldb, H,
                                                sh.ac);
      if (valid) {
        const int bl = flat / S;
        const float* mrow = sh.m_s + bl * BN;
        const float* grow = sh.g_s + bl * BN;
        float* out = dh + (size_t)flat * H;
        for (int c = 0; c < n_cols; ++c) {
          const float gc = grow[c];
          if (gc != 0.f && Cs[r * LDC + c] + sh.bias_s[c] == mrow[c])
            add_row_to(out, gc, sh.Wt + c * ldb, part, H);
        }
      }
      __syncthreads();  // Cs is rewritten by the next chunk
    }
    __syncthreads();  // the tile and its vectors are rewritten next
  }
}

__global__ void __launch_bounds__(THREADS, 1)
fused_splade_v2_bwd_dw_kernel(const __nv_bfloat16* __restrict__ h,
                              const __nv_bfloat16* __restrict__ w,
                              const float* __restrict__ bias,
                              const float* __restrict__ mask,
                              const float* __restrict__ m,
                              const float* __restrict__ g,
                              float* __restrict__ dw, int B, int S, int H,
                              int V, int RB) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Shared sh = carve(smem, H, RB);
  const float* Cs = reinterpret_cast<const float*>(sh.ac);
  const int ldb = splade_tile::resident_ld(H);

  const int v0 = blockIdx.x * BN;
  const int n_cols = min(BN, V - v0);
  const int R = RB * S;
  const int tid = threadIdx.x;
  const int c = tid / PARTS, part = tid % PARTS;
  float* out = dw + (size_t)(v0 + c) * H;  // this thread group's dW row

  if (tid < BN) sh.bias_s[tid] = (tid < n_cols && bias) ? bias[v0 + tid] : 0.f;
  // the block's W tile, resident for every row of the batch
  splade_tile::stage_w_tile<BN>(w, v0, n_cols, H, sh.Wt, ldb);
  __syncthreads();
  const float bc = sh.bias_s[c];

  for (int rb0 = 0; rb0 < B; rb0 += RB) {
    if (!load_tile_vectors(sh, m, g, rb0, RB, v0, n_cols, V))
      continue;  // G is 0 for this row block and tile
    const __nv_bfloat16* rows = h + (size_t)rb0 * S * H;
    const float* maskr = mask + (size_t)rb0 * S;
    for (int s0 = 0; s0 < R; s0 += BM) {
      bool any = false;
      if (tid < BM) {
        const int flat = s0 + tid;
        any = flat < R && maskr[flat] > 0.f;
        sh.row_ok[tid] = any;
        sh.row_b[tid] = flat / S;
      }
      if (!__syncthreads_or(any)) continue;  // no valid row in the chunk
      splade_tile::score_chunk_resident<BM, BN>(rows, s0, R, sh.Wt, ldb, H,
                                                sh.ac);
      if (c < n_cols) {
        for (int rr = 0; rr < BM; ++rr) {
          if (!sh.row_ok[rr]) continue;
          const int at = sh.row_b[rr] * BN + c;
          const float gc = sh.g_s[at];
          if (gc != 0.f && Cs[rr * LDC + c] + bc == sh.m_s[at])
            add_row_to(out, gc, rows + (size_t)(s0 + rr) * H, part, H);
        }
      }
      __syncthreads();  // Cs and the row flags are rewritten next
    }
    __syncthreads();  // m_s and g_s are rewritten for the next row block
  }
}

cudaError_t opt_in(const void* kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

// Dynamic shared memory either backward kernel asks for at hidden width H and
// row block RB: the wrapper refuses a size above the card's limit by this
// number.
extern "C" int splade_fused_pool_v2_bwd_shared_bytes(int H, int RB) {
  return shared_bytes(H, RB);
}

// h [B,S,H] bf16, w [V,H] bf16, bias [V] f32 or null, mask [B,S] f32,
// m and g [B,V] f32, out dh [splits,B,S,H] f32 ZEROED by the caller: split z
// sums the vocab tiles of columns [z*c, (z+1)*c), c =
// ceil(ceil(V/64)/splits)*64. RB divides B. H % 8 == 0 and 16-byte aligned
// rows are checked by the wrapper.
extern "C" int splade_fused_pool_v2_bwd_dh(const void* h, const void* w,
                                           const void* bias, const void* mask,
                                           const void* m, const void* g,
                                           void* dh, int B, int S, int H,
                                           int V, int RB, int splits,
                                           void* stream) {
  if (RB < 1 || B % RB || H % 8 || splits < 1)
    return (int)cudaErrorInvalidValue;
  const int bytes = shared_bytes(H, RB);
  cudaError_t err = opt_in((const void*)fused_splade_v2_bwd_dh_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (V + BN - 1) / BN;
  const int split_cols = (tiles + splits - 1) / splits * BN;
  dim3 grid(B / RB, splits);
  fused_splade_v2_bwd_dh_kernel<<<grid, THREADS, bytes,
                                  (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)h, (const __nv_bfloat16*)w, (const float*)bias,
      (const float*)mask, (const float*)m, (const float*)g, (float*)dh, S, H,
      V, RB, split_cols);
  return (int)cudaGetLastError();
}

// as above, out dw [V,H] f32 ZEROED by the caller
extern "C" int splade_fused_pool_v2_bwd_dw(const void* h, const void* w,
                                           const void* bias, const void* mask,
                                           const void* m, const void* g,
                                           void* dw, int B, int S, int H,
                                           int V, int RB, void* stream) {
  if (RB < 1 || B % RB || H % 8) return (int)cudaErrorInvalidValue;
  const int bytes = shared_bytes(H, RB);
  cudaError_t err = opt_in((const void*)fused_splade_v2_bwd_dw_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((V + BN - 1) / BN);
  fused_splade_v2_bwd_dw_kernel<<<grid, THREADS, bytes,
                                  (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)h, (const __nv_bfloat16*)w, (const float*)bias,
      (const float*)mask, (const float*)m, (const float*)g, (float*)dw, B, S,
      H, V, RB);
  return (int)cudaGetLastError();
}
