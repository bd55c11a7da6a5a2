// Fused SPLADE vocabulary projection + masked sequence max, forward (Hopper).
//
// Replaces splade_tpu/ops/fused_splade.py::_fwd_kernel (the Pallas forward
// behind fused_splade_pool):
//
//     score[b, s, v] = h[b, s, :] . W[v, :] + bias[v]     (invalid s -> -1e30)
//     m[b, v]        = max_s score[b, s, v]
//     pos[b, s]      = max_v score[b, s, v]                (valid s only)
//
// The [B, S, V] scores never reach device memory. The wrapper
// (ops/fused_splade.py) fills pos with the key of -1e30, decodes it, and
// applies log1p(relu) and the mask.
//
// What bounds it: the tensor cores, 2*valid*H*V operations (0.32 ms at the
// served document batch, B=32 S=256 H=768 V=50,000, with about half the
// positions valid, at 989 TFLOP/s). The first version (one block a (batch
// row, 128 columns), one synchronous shared-memory stage a 64-wide k-step,
// every score chunk stored to shared memory in f32 and read back by both
// maxima, padded rows computed like valid ones) ran at 6% of that: W (77 MB,
// more than L2) crossed from device memory once per batch row, and the
// tensor cores waited on loads. Here:
// - A block owns one tile of BN = 128 vocab columns and the valid rows of RB
//   batch rows (about 1,024 positions): the flattened list of its live
//   16-row groups (16 positions of one batch row, at least one of them
//   valid, with their valid rows as a bitmask), which it builds from the
//   mask. A group with no valid row is never loaded or multiplied, and
//   invalid rows are never loaded, so padding costs nothing. The paths pad:
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
//   registers a thread, 92-112 KB of shared memory a block).
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
// part.
//
// The backward's match pass (fused_splade_bwd.cu) and the row-blocked family
// find each argmax by equality with this kernel's m, so each score keeps the
// arithmetic of fused_splade_tile.cuh: bf16 products in k-slices of 16,
// ascending from a zeroed f32 accumulator up to H rounded to whole 64-wide
// steps, one HMMA.16816 a slice (what a WMMA 16x16x16 product compiles to on
// sm_90, one per n8 half), then + bias in f32. The tile shapes and the ring
// change no product. The ragged last vocab tile (50,000 is not a multiple of
// BN) is masked here: W is never padded or copied.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fused_splade_tile.cuh"
#include "mma_sm90.cuh"

namespace {

using splade_tile::float_from_key;
using splade_tile::float_key;
using splade_tile::NEG;

constexpr int FT = 128;                 // 4 warps, each 64 x 64 of a tile
constexpr int BM = 128, BN = 128;       // rows of a tile x vocab columns
constexpr int GR = 16;                  // rows of a group (one m16 fragment)
constexpr int KSL = 32;                 // hidden slice of one ring stage
constexpr int STAGES = 4;
constexpr int PLDS = KSL + 8;           // 80-byte rows: conflict-free ldmatrix
constexpr int STAGE_ELEMS = (BM + BN) * PLDS;
constexpr int PIPE_BYTES = STAGES * STAGE_ELEMS * 2;
constexpr int COPIES = BM * (KSL / 8) / FT;  // 16-byte copies a thread, each
constexpr int GROUPS_A_TILE = BM / GR;
constexpr int ROWS_PER_BLOCK = 1024;    // positions a block aims at
constexpr int MAX_RB = 16;              // batch rows a block at most
static_assert(BM == BN && COPIES * FT == BM * (KSL / 8), "even copies");
static_assert(splade_tile::BK % KSL == 0, "whole forward k-steps");

// batch rows a block owns at sequence length S
__host__ __device__ __forceinline__ int rows_a_block(int S) {
  return max(1, min(MAX_RB, ROWS_PER_BLOCK / max(S, 1)));
}

// dynamic shared memory: the ring | column keys [RB][BN] | row maxima
// [2][BM] | bias [BN] | the live groups [RB * G] as int2
__host__ __device__ __forceinline__ int shared_bytes(int S, int RB) {
  const int G = (S + GR - 1) / GR;
  return PIPE_BYTES + RB * BN * 4 + 2 * BM * 4 + BN * 4 + RB * G * 8;
}

// One halving step of a reduction over lanes: v[0..2n) of this lane and of
// the lane `bit` apart become v[0..n), the pairwise maxima of the half this
// lane keeps (the upper one where `upper`).
template <int n>
__device__ __forceinline__ void halve(float (&v)[16], bool upper, int bit) {
#pragma unroll
  for (int k = 0; k < n; ++k) {
    const float mine = upper ? v[n + k] : v[k];
    const float other = upper ? v[k] : v[n + k];
    v[k] = fmaxf(mine, __shfl_xor_sync(0xffffffffu, other, bit));
  }
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

// Is row r of a live group valid (inside S, mask > 0)?
__device__ __forceinline__ bool row_valid(int2 e, int r) {
  return ((unsigned)e.y >> (16 + r)) & 1u;
}

// The products of one ring stage (KSL of the hidden width) for a warp's 64 x
// 64 piece: k-slices of 16 in ascending order, each one mma a (fragment row,
// n8 tile). Fragment rows from `live` on hold no live group and are skipped.
template <bool kFull>
__device__ __forceinline__ void slice_products(float (&acc)[4][8][4],
                                               const __nv_bfloat16* As,
                                               const __nv_bfloat16* Bs,
                                               int wm, int wn, int lane,
                                               int live) {
  using sm90::ldmatrix_x4;
  using sm90::mma16816;
#pragma unroll
  for (int kk = 0; kk < KSL; kk += 16) {
    uint32_t bf[4][4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)  // B = W_tile^T: rows n, columns k
      ldmatrix_x4(bf[jj], Bs + (wn * 64 + jj * 16 + (lane & 7) +
                                ((lane >> 4) << 3)) * PLDS +
                              kk + ((lane >> 3) & 1) * 8);
    uint32_t af[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (kFull || i < live)
        ldmatrix_x4(af[i], As + (wm * 64 + i * 16 + (lane & 15)) * PLDS +
                               kk + (lane >> 4) * 8);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (!kFull && i >= live) break;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        mma16816(acc[i][2 * jj], af[i], bf[jj][0], bf[jj][1]);
        mma16816(acc[i][2 * jj + 1], af[i], bf[jj][2], bf[jj][3]);
      }
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
  using namespace sm90;  // cp.async
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int warp_live[FT / 32];
  __nv_bfloat16* pipe = reinterpret_cast<__nv_bfloat16*>(smem);
  int* colkey = reinterpret_cast<int*>(smem + PIPE_BYTES);   // [RB][BN]
  float* rowmax = reinterpret_cast<float*>(colkey + RB * BN);  // [2][BM]
  float* bias_s = rowmax + 2 * BM;                             // [BN]
  // a live group: {its first row in [B*S], (its valid rows as 16 bits <<
  // 16) | its batch row in the block}; a row past S is not valid
  int2* groups = reinterpret_cast<int2*>(bias_s + BN);

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
  const int G = (S + GR - 1) / GR;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  for (int i = tid; i < RB * BN; i += FT) colkey[i] = float_key(NEG);
  if (tid < BN) bias_s[tid] = (tid < n_cols && bias) ? bias[v0 + tid] : 0.f;

  // the live groups of batch rows b0..b0+nb, in order
  int n_live = 0;
  for (int i0 = 0; i0 < nb * G; i0 += FT) {
    const int i = i0 + tid;
    int2 e = make_int2(0, 0);
    unsigned bits = 0u;
    if (i < nb * G) {
      const int bl = i / G, s0 = (i % G) * GR;
      const int rows = min(GR, S - s0);
      const float* mrow = mask + (size_t)(b0 + bl) * S + s0;
#pragma unroll
      for (int r = 0; r < GR; ++r)
        bits |= (unsigned)(r < rows && mrow[r] > 0.f) << r;
      e = make_int2((b0 + bl) * S + s0, (int)(bits << 16) | bl);
    }
    const bool live = bits != 0u;
    const unsigned vote = __ballot_sync(0xffffffffu, live);
    if (lane == 0) warp_live[warp] = __popc(vote);
    __syncthreads();
    int at = n_live, total = 0;
#pragma unroll
    for (int wi = 0; wi < FT / 32; ++wi) {
      at += wi < warp ? warp_live[wi] : 0;
      total += warp_live[wi];
    }
    if (live) groups[at + __popc(vote & ((1u << lane) - 1u))] = e;
    n_live += total;
    __syncthreads();  // warp_live is refilled; the list is complete
  }

  // the forward's k-loop runs whole 64-wide steps past H on zeros: so does
  // this one
  const int k_steps = (H + splade_tile::BK - 1) / splade_tile::BK *
                      (splade_tile::BK / KSL);
  const int n_tiles = (n_live * GR + BM - 1) / BM;
  const int total = n_tiles * k_steps;
  const int cr = tid >> 2, cq = (tid & 3) * 8;  // copy row (+32 it), column

  auto load_stage = [&](int step) {
    __nv_bfloat16* As = pipe + (step % STAGES) * STAGE_ELEMS;
    __nv_bfloat16* Bs = As + BM * PLDS;
    const int tile = step / k_steps;
    const int k = (step - tile * k_steps) * KSL + cq;
    const bool kin = k < H;
#pragma unroll
    for (int it = 0; it < COPIES; ++it) {
      const int r = cr + it * 32;
      const int gi = tile * GROUPS_A_TILE + (r >> 4);
      bool ok = kin && gi < n_live;
      const __nv_bfloat16* src = h;
      if (ok) {  // only valid rows are read: the others are never used
        const int2 e = groups[gi];
        ok = row_valid(e, r & 15);
        src = h + (size_t)(e.x + (r & 15)) * H + k;
      }
      cp_async16(As + r * PLDS + cq, ok ? src : h, ok);
      const bool wok = kin && v0 + r < V;
      cp_async16(Bs + r * PLDS + cq, wok ? w + (size_t)(v0 + r) * H + k : w,
                 wok);
    }
  };

  const int wm = warp >> 1, wn = warp & 1;  // 64-row half, 64-column half
  const int g = lane >> 2, c = 2 * (lane & 3);
  float acc[4][8][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < total) load_stage(st);
    cp_async_commit();
  }
  for (int step = 0; step < total; ++step) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage `step` landed; stage step-1 is free to refill
    if (step + STAGES - 1 < total) load_stage(step + STAGES - 1);
    cp_async_commit();
    const int tile = step / k_steps;
    // fragments of this warp whose group is live (warp-uniform)
    const int live = min(4, n_live - tile * GROUPS_A_TILE - wm * 4);
    const __nv_bfloat16* As = pipe + (step % STAGES) * STAGE_ELEMS;
    const __nv_bfloat16* Bs = As + BM * PLDS;
    if (live == 4)  // every fragment live: no branch between the products
      slice_products<true>(acc, As, Bs, wm, wn, lane, 4);
    else
      slice_products<false>(acc, As, Bs, wm, wn, lane, live);
    if (step - tile * k_steps != k_steps - 1) continue;

    // ---- the tile's epilogue: + bias, column and row maxima -------------
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
      halve<8>(v, lane & 16, 16);
      halve<4>(v, lane & 8, 8);
      halve<2>(v, lane & 4, 4);
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
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
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
  }
  cp_async_wait<0>();
  __syncthreads();  // every column key is in
  for (int i = tid; i < nb * BN; i += FT) {
    const int bl = i / BN, col = i % BN;
    if (col < n_cols)
      m_out[(size_t)(b0 + bl) * V + v0 + col] =
          float_from_key(colkey[bl * BN + col]);
  }
}

int launch(const void* h, const void* w, const void* bias, const void* mask,
           void* m_out, void* pos_key, int B, int S, int H, int V,
           void* stream, bool vocab_first) {
  const int RB = rows_a_block(S);
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
  return launch(h, w, bias, mask, m_out, pos_key, B, S, H, V, stream, true);
}

// The same launch with its blocks numbered batch range first: the same
// blocks, operations and results, but blocks that run together hold
// different W tiles. No wrapper calls it; it measures what sharing W in L2
// saves (scripts/bench_forward_kernels.py).
extern "C" int splade_fused_pool_fwd_batch_first(
    const void* h, const void* w, const void* bias, const void* mask,
    void* m_out, void* pos_key, int B, int S, int H, int V, void* stream) {
  return launch(h, w, bias, mask, m_out, pos_key, B, S, H, V, stream, false);
}
