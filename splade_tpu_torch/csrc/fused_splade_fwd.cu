// Fused SPLADE vocabulary projection + masked sequence max, forward (Hopper),
// for both kernel families of the pool.
//
// Replaces splade_tpu/ops/fused_splade.py::_fwd_kernel (the Pallas forward
// behind fused_splade_pool) and splade_tpu/ops/fused_splade_v2.py::_fwd_kernel
// (:46, launched at :156, behind fused_splade_pool_v2, which hands row_block
// batch rows to one grid step):
//
//     score[b, s, v] = h[b, s, :] . W[v, :] + bias[v]     (invalid s -> -1e30)
//     m[b, v]        = max_s score[b, s, v]
//     pos[b, s]      = max_v score[b, s, v]                (valid s only)
//
// The [B, S, V] scores never reach device memory. The wrapper
// (ops/fused_splade.py) fills pos with the key of -1e30, decodes it, and
// applies log1p(relu) and the mask. The two families differ only in how many
// batch rows a block owns: the per-row family (splade_fused_pool_fwd) about
// 1,024 positions' worth (rows_a_block), the row-blocked one
// (splade_fused_pool_v2_fwd) exactly its row_block, as the TPU kernel's grid
// step does. One kernel and one epilogue serve both, so their m and pos are
// equal bit for bit: every score keeps one arithmetic and a maximum has no
// order.
//
// What bounds it: the tensor cores, 2*valid*H*V operations (0.32 ms at the
// served document batch, B=32 S=256 H=768 V=50,000, with about half the
// positions valid, at 989 TFLOP/s). The first version (one block a (batch
// row, 128 columns), one synchronous shared-memory stage a 64-wide k-step,
// every score chunk stored to shared memory in f32 and read back by both
// maxima, padded rows computed like valid ones) ran at 6% of that: W (77 MB,
// more than L2) crossed from device memory once per batch row, and the
// tensor cores waited on loads. The row-blocked family's first version kept
// a 64 x H W tile resident in shared memory instead (97 KB at H = 768: one
// block an SM, and H = 2048 did not fit), walked the row block's flattened
// rows padding included, and ran at 5.6%. Here:
// - A block owns one tile of BN = 128 vocab columns and the valid rows of RB
//   batch rows: the flattened list of its live 16-row groups (16 positions
//   of one batch row, at least one of them valid, with their valid rows as a
//   bitmask), which it builds from the mask. A group with no valid row is
//   never loaded or multiplied, and invalid rows are never loaded, so
//   padding costs nothing. The paths pad:
//   served query batches are 10-20% valid (short queries padded to 64,
//   the batch to a multiple of 8 rows), V33 queries about 30%, V33
//   documents about 90%. On an H100 (scripts/bench_forward_kernels.py,
//   against the same launch on an all-valid mask) the skip saves 72% of
//   the launch at 32 served queries (19% valid), 49% at a V33 query batch
//   and at 32 indexed documents, 7% at a V33 document batch.
// - Blocks are numbered vocab tile first, so the blocks that run together
//   share their W tile in L2 and W should cross from device memory about
//   once a launch: an estimate from the block order, since nothing on the
//   card counts the bytes. Numbered batch range first instead
//   (splade_fused_pool_fwd_batch_first: each batch range walks all of W),
//   the same launch is 12% slower at the V33 document batch (32 ranges)
//   and within noise where there are only a few ranges (same script).
// - The rows are walked in tiles of BM = 128 (8 groups) against the W tile:
//   a 128 x 128 product a tile, 4 warps of 64 x 64, bf16 mma.sync m16n8k16
//   with f32 sums, operands by ldmatrix from a 4-stage cp.async ring of
//   32-wide k-slices of both h and W (80-byte rows: no bank conflict). The
//   ring runs on across tiles, so the next tile's first slices load during
//   this tile's last products and its epilogue. Two blocks an SM (214
//   registers a thread, 92-112 KB of shared memory a block at the per-row
//   family's row counts). The walk is fused_splade_walk.cuh, which the
//   row-blocked match pass shares. It streams the hidden width, so H does
//   not bound the shared memory: only the column keys and the group list of
//   RB batch rows do (shared_bytes(S, RB), which the row-blocked wrapper
//   asks before it launches).
// - The scores stay in the accumulator fragments. + bias in f32, then the
//   column maxima are reduced on the fragments (folded across a warp's
//   fragments of one batch row, then over the 8 lanes that share a column
//   group by halving, 14 shuffles for 16 values) into a [RB, BN] key array
//   in shared memory, written to m once at the end; the row maxima over the
//   quad that shares a row, joined across the two warps of a row through 1
//   KB of shared memory, then one integer atomicMax per (valid row, tile)
//   into pos. Integer max is exact, so nothing depends on the order of
//   blocks or lanes.
// What holds it above the bound (reasoned, not measured): the L2 -> shared
// memory traffic of the two streamed operands (64 operations a byte of
// it), then the epilogue, which the other block of the SM covers only in
// part. With few batch rows a block (the row-blocked family at a small
// row_block), each W tile crosses from L2 into shared memory once per batch
// range, and a range's live groups may fill only part of a 128-row tile.
//
// The backward's match pass finds each argmax by equality with this
// kernel's m, so each score keeps the arithmetic of fused_splade_tile.cuh:
// bf16 products in k-slices of 16, ascending from a zeroed f32 accumulator up
// to H rounded to whole 64-wide steps, one HMMA.16816 a slice, then + bias in
// f32. The tile shapes and the ring change no product. The ragged last vocab
// tile (50,000 is not a multiple of BN) is masked here: W is never padded or
// copied.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fused_splade_tile.cuh"
#include "fused_splade_walk.cuh"

namespace {

using splade_tile::float_from_key;
using splade_tile::float_key;
using splade_tile::NEG;
using namespace splade_walk;

constexpr int ROWS_PER_BLOCK = 1024;    // positions a block aims at
constexpr int MAX_RB = 16;              // batch rows a block at most

// batch rows a block of the per-row family owns at sequence length S
__host__ __device__ __forceinline__ int rows_a_block(int S) {
  return max(1, min(MAX_RB, ROWS_PER_BLOCK / max(S, 1)));
}

// dynamic shared memory: the ring | column keys [RB][BN] | row maxima
// [2][BM] | bias [BN] | the live groups [RB * G] as int2
__host__ __device__ __forceinline__ int shared_bytes(int S, int RB) {
  const int G = (S + GR - 1) / GR;
  return PIPE_BYTES + RB * BN * 4 + 2 * BM * 4 + BN * 4 + RB * G * 8;
}

// One fragment row's scores (16 rows x this warp's 64 columns) + bias,
// folded into this lane's column maxima over its valid rows (cm) and row
// maxima over the columns inside V (r0: row g, r1: row g + 8). kTests: some
// row is invalid or some column past V.
template <bool kTests>
__device__ __forceinline__ void fragment_maxima(
    const float (&a)[8][4], const float2 (&bv)[8], int c, int wn, int n_cols,
    bool ok0, bool ok1, float (&cm)[8][2], float& r0, float& r1) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float x00 = a[j][0] + bv[j].x, x01 = a[j][1] + bv[j].y;
    const float x10 = a[j][2] + bv[j].x, x11 = a[j][3] + bv[j].y;
    if (!kTests) {
      cm[j][0] = fmaxf(cm[j][0], fmaxf(x00, x10));
      cm[j][1] = fmaxf(cm[j][1], fmaxf(x01, x11));
      r0 = fmaxf(r0, fmaxf(x00, x01));
      r1 = fmaxf(r1, fmaxf(x10, x11));
      continue;
    }
    cm[j][0] = fmaxf(cm[j][0], fmaxf(ok0 ? x00 : NEG, ok1 ? x10 : NEG));
    cm[j][1] = fmaxf(cm[j][1], fmaxf(ok0 ? x01 : NEG, ok1 ? x11 : NEG));
    const int col = wn * 64 + 8 * j + c;
    if (col < n_cols) {
      r0 = fmaxf(r0, x00);
      r1 = fmaxf(r1, x10);
    }
    if (col + 1 < n_cols) {
      r0 = fmaxf(r0, x01);
      r1 = fmaxf(r1, x11);
    }
  }
}

__global__ void __launch_bounds__(FT, 2)
fused_splade_fwd_kernel(const __nv_bfloat16* __restrict__ h,
                        const __nv_bfloat16* __restrict__ w,
                        const float* __restrict__ bias,
                        const float* __restrict__ mask,
                        float* __restrict__ m_out, int* __restrict__ pos_key,
                        int B, int S, int H, int V, int RB, bool vocab_first) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int warp_live[FT / 32];
  int* colkey = reinterpret_cast<int*>(smem + PIPE_BYTES);   // [RB][BN]
  float* rowmax = reinterpret_cast<float*>(colkey + RB * BN);  // [2][BM]
  float* bias_s = rowmax + 2 * BM;                             // [BN]
  int2* groups = reinterpret_cast<int2*>(bias_s + BN);         // [RB * G]

  // blocks numbered vocab tile first, so that the blocks that run together
  // share their W tile in L2; or batch range first, which does the same
  // work with each batch range walking all of W (only for measuring what
  // that sharing saves)
  const int n_ranges = (B + RB - 1) / RB;
  const int n_vt = (V + BN - 1) / BN;
  const int vt = vocab_first ? blockIdx.x / n_ranges : blockIdx.x % n_vt;
  const int b0 =
      (vocab_first ? blockIdx.x % n_ranges : blockIdx.x / n_vt) * RB;
  const int nb = min(RB, B - b0);
  const int v0 = vt * BN;
  const int n_cols = min(BN, V - v0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  for (int i = tid; i < RB * BN; i += FT) colkey[i] = float_key(NEG);
  if (tid < BN) bias_s[tid] = (tid < n_cols && bias) ? bias[v0 + tid] : 0.f;
  const int n_live = list_live_groups(mask, b0, nb, S, groups, warp_live,
                                      nullptr, nullptr);

  const int wm = warp >> 1, wn = warp & 1;  // 64-row half, 64-column half
  const int g = lane >> 2, c = 2 * (lane & 3);
  const auto max_of = [](float a, float b) { return fmaxf(a, b); };
  // ---- a tile's epilogue: + bias, column and row maxima -------------------
  walk_tiles(smem, groups, n_live, h, w, v0, V, H,
             [&](int tile, int live, const float (&acc)[4][8][4]) {
    float cm[8][2];  // column maxima of the fragments folded so far
    int cur = -1;    // their batch row in the block
    // the 8 lanes of a column group (same c, g = 0..7) join their 16
    // maxima by halving: lane g keeps those of n8 tile j = g, two columns
    auto flush = [&]() {
      float v[16];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        v[2 * j] = cm[j][0];
        v[2 * j + 1] = cm[j][1];
      }
      halve<8>(v, lane & 16, 16, max_of);
      halve<4>(v, lane & 8, 8, max_of);
      halve<2>(v, lane & 4, 4, max_of);
      int* key = colkey + cur * BN + wn * 64 + 8 * g + c;
      atomicMax(key, float_key(v[0]));
      atomicMax(key + 1, float_key(v[1]));
    };
    float2 bv[8];  // bias of this lane's columns 8j + c, 8j + c + 1
#pragma unroll
    for (int j = 0; j < 8; ++j)
      bv[j] = *reinterpret_cast<const float2*>(bias_s + wn * 64 + 8 * j + c);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i >= live) break;
      const int2 e = groups[tile * GROUPS_A_TILE + wm * 4 + i];
      const int bl = e.y & 0xffff;
      const bool ok0 = row_valid(e, g), ok1 = row_valid(e, g + 8);
      if (bl != cur) {
        if (cur >= 0) flush();
        cur = bl;
#pragma unroll
        for (int j = 0; j < 8; ++j) cm[j][0] = cm[j][1] = NEG;
      }
      float r0 = NEG, r1 = NEG;
      // the common case, every row valid and every column inside V, without
      // the per-element tests (warp-uniform)
      if (((unsigned)e.y >> 16) == 0xffffu && n_cols == BN)
        fragment_maxima<false>(acc[i], bv, c, wn, n_cols, true, true, cm, r0,
                               r1);
      else
        fragment_maxima<true>(acc[i], bv, c, wn, n_cols, ok0, ok1, cm, r0,
                              r1);
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        r0 = fmaxf(r0, __shfl_xor_sync(0xffffffffu, r0, o));
        r1 = fmaxf(r1, __shfl_xor_sync(0xffffffffu, r1, o));
      }
      if (c == 0) {
        rowmax[wn * BM + wm * 64 + i * 16 + g] = r0;
        rowmax[wn * BM + wm * 64 + i * 16 + g + 8] = r1;
      }
    }
    if (cur >= 0) flush();
    __syncthreads();  // both column halves of every row are in rowmax
    for (int row = tid; row < BM; row += FT) {
      const int gi = tile * GROUPS_A_TILE + (row >> 4);
      if (gi < n_live) {
        const int2 e = groups[gi];
        const int r = row & 15;
        if (row_valid(e, r)) {
          atomicMax(pos_key + e.x + r,
                    float_key(fmaxf(rowmax[row], rowmax[BM + row])));
        }
      }
    }
  });
  // every column key is in (walk_tiles ends with a barrier)
  for (int i = tid; i < nb * BN; i += FT) {
    const int bl = i / BN, col = i % BN;
    if (col < n_cols)
      m_out[(size_t)(b0 + bl) * V + v0 + col] =
          float_from_key(colkey[bl * BN + col]);
  }
}

// The kernel with RB batch rows a block; a shared-memory size the card
// refuses comes back as the launch's error.
int launch(const void* h, const void* w, const void* bias, const void* mask,
           void* m_out, void* pos_key, int B, int S, int H, int V, int RB,
           void* stream, bool vocab_first) {
  const int bytes = shared_bytes(S, RB);
  // above 48 KB, dynamic shared memory needs the kernel's opt-in
  cudaError_t err = cudaFuncSetAttribute(
      fused_splade_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  const long long blocks =
      (long long)((V + BN - 1) / BN) * ((B + RB - 1) / RB);
  fused_splade_fwd_kernel<<<(unsigned)blocks, FT, bytes,
                            (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)h, (const __nv_bfloat16*)w, (const float*)bias,
      (const float*)mask, (float*)m_out, (int*)pos_key, B, S, H, V, RB,
      vocab_first);
  return (int)cudaGetLastError();
}

}  // namespace

// h [B,S,H] bf16, w [V,H] bf16, bias [V] f32 or null, mask [B,S] f32,
// m_out [B,V] f32 (every element written), pos_key [B,S] int32 pre-filled
// with key(-1e30). H % 8 == 0 and 16-byte aligned rows are checked by the
// wrapper.
extern "C" int splade_fused_pool_fwd(const void* h, const void* w,
                                     const void* bias, const void* mask,
                                     void* m_out, void* pos_key, int B, int S,
                                     int H, int V, void* stream) {
  return launch(h, w, bias, mask, m_out, pos_key, B, S, H, V,
                rows_a_block(S), stream, true);
}

// The same launch with its blocks numbered batch range first: the same
// blocks, operations and results, but blocks that run together hold
// different W tiles. No wrapper calls it; it measures what sharing W in L2
// saves (scripts/bench_forward_kernels.py).
extern "C" int splade_fused_pool_fwd_batch_first(
    const void* h, const void* w, const void* bias, const void* mask,
    void* m_out, void* pos_key, int B, int S, int H, int V, void* stream) {
  return launch(h, w, bias, mask, m_out, pos_key, B, S, H, V,
                rows_a_block(S), stream, false);
}

// The row-blocked family's forward: the same kernel with exactly RB batch
// rows a block. Arguments as splade_fused_pool_fwd's, RB dividing B; the
// wrapper refuses an RB whose shared memory exceeds the card's by
// splade_fused_pool_v2_fwd_shared_bytes.
extern "C" int splade_fused_pool_v2_fwd(const void* h, const void* w,
                                        const void* bias, const void* mask,
                                        void* m_out, void* pos_key, int B,
                                        int S, int H, int V, int RB,
                                        void* stream) {
  if (RB < 1 || B % RB || H % 8) return (int)cudaErrorInvalidValue;
  return launch(h, w, bias, mask, m_out, pos_key, B, S, H, V, RB, stream,
                true);
}

// Dynamic shared memory the forward asks for at sequence length S and RB
// batch rows a block (a size, not an error code).
extern "C" int splade_fused_pool_v2_fwd_shared_bytes(int S, int RB) {
  return shared_bytes(S, RB);
}

// Static shared memory of the forward kernel, held beside the dynamic part
// (-1 if the runtime cannot say).
extern "C" int splade_fused_pool_v2_fwd_static_bytes() {
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, fused_splade_fwd_kernel) != cudaSuccess)
    return -1;
  return (int)attr.sharedSizeBytes;
}
