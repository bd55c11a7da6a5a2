// The walk of the fused SPLADE pool's register-resident kernels, shared by
// the pool forward of both families (fused_splade_fwd.cu) and the match pass
// of both families' backward (fused_splade_v2_bwd.cu): what they compute from
// the scores differs (maxima, argmax bits), how they reach the scores does
// not.
//
// A block of 4 warps owns one tile of BN = 128 vocab columns and the live
// 16-row groups of a range of batch rows: 16 positions of one batch row, at
// least one of them valid, listed from the mask by the block itself with
// their valid rows as a bitmask. A group with no valid row is never loaded
// or multiplied, and invalid rows are never loaded. The listed groups are
// walked in tiles of BM = 128 rows (8 groups) against the W tile: a 128 x
// 128 product a tile, 4 warps of 64 x 64, bf16 mma.sync m16n8k16 with f32
// sums in registers, operands by ldmatrix from a 4-stage cp.async ring of
// 32-wide k-slices of both h and W (80-byte rows: no bank conflict). The
// ring runs on across tiles, so the next tile's first slices load during
// this tile's last products and its epilogue, which the caller gives: it
// reads the tile's scores (without bias) from the accumulator fragments.
//
// Each score keeps the arithmetic of fused_splade_tile.cuh: bf16 products
// in k-slices of 16, ascending from a zeroed f32 accumulator up to H
// rounded to whole 64-wide steps, one HMMA.16816 a slice. The epilogue adds
// the bias in f32. So every kernel that walks this way computes every score
// bit for bit alike.
//
// Fragment layout (mma_sm90.cuh): with g = lane / 4 and c = 2 * (lane % 4),
// acc[i][j] of the warp (wm, wn) holds rows g and g + 8 of its fragment row i
// (the tile's group 4 wm + i) and columns wn * 64 + 8 j + c, c + 1.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "fused_splade_tile.cuh"
#include "mma_sm90.cuh"

namespace splade_walk {

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
static_assert(BM == BN && COPIES * FT == BM * (KSL / 8), "even copies");
static_assert(splade_tile::BK % KSL == 0, "whole forward k-steps");

// A live group: {its first row in [B*S], (its valid rows as 16 bits << 16) |
// its batch row in the block}. Is row r of it valid (inside S, mask > 0)?
__device__ __forceinline__ bool row_valid(int2 e, int r) {
  return ((unsigned)e.y >> (16 + r)) & 1u;
}

// One halving step of a reduction over lanes: v[0..2n) of this lane and of
// the lane `bit` apart become v[0..n), the pairwise `op` of the half this
// lane keeps (the upper one where `upper`). Three steps over the 8 lanes of
// a column group (bits 16, 8, 4) leave lane g with the values of n8 tile
// j = g.
template <int n, class T, int N, class Op>
__device__ __forceinline__ void halve(T (&v)[N], bool upper, int bit, Op op) {
#pragma unroll
  for (int k = 0; k < n; ++k) {
    const T mine = upper ? v[n + k] : v[k];
    const T other = upper ? v[k] : v[n + k];
    v[k] = op(mine, __shfl_xor_sync(0xffffffffu, other, bit));
  }
}

// The live groups of batch rows b0..b0+nb, in order, into `groups`; returns
// how many. A row whose `row_on` is 0 (if given) lists no group; `dead` (if
// given) gets, for every group bl * G + k, whether it was left out. All
// threads of the block call it; it ends with a barrier.
__device__ __forceinline__ int list_live_groups(
    const float* __restrict__ mask, int b0, int nb, int S, int2* groups,
    int* warp_live, const int* row_on, unsigned char* dead) {
  const int G = (S + GR - 1) / GR;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int n_live = 0;
  for (int i0 = 0; i0 < nb * G; i0 += FT) {
    const int i = i0 + tid;
    int2 e = make_int2(0, 0);
    unsigned bits = 0u;
    if (i < nb * G) {
      const int bl = i / G, s0 = (i % G) * GR;
      if (!row_on || row_on[bl]) {
        const int rows = min(GR, S - s0);
        const float* mrow = mask + (size_t)(b0 + bl) * S + s0;
#pragma unroll
        for (int r = 0; r < GR; ++r)
          bits |= (unsigned)(r < rows && mrow[r] > 0.f) << r;
      }
      e = make_int2((b0 + bl) * S + s0, (int)(bits << 16) | bl);
      if (dead) dead[i] = bits == 0u;
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
  return n_live;
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

// Walk the n_live listed groups in tiles of BM rows against vocab columns
// v0..v0+BN of w: after the last k-slice of each tile, every thread calls
// epilogue(tile, live, acc), live being how many of this warp's 4 fragment
// rows hold a listed group (warp-uniform), acc the scores without bias (0
// in the other fragment rows). The ring lives in the first PIPE_BYTES of
// `smem`. All threads of the block call it; it ends with a barrier after
// every copy has landed.
template <class Epilogue>
__device__ __forceinline__ void walk_tiles(
    unsigned char* smem, const int2* groups, int n_live,
    const __nv_bfloat16* __restrict__ h, const __nv_bfloat16* __restrict__ w,
    int v0, int V, int H, Epilogue&& epilogue) {
  using namespace sm90;  // cp.async
  __nv_bfloat16* pipe = reinterpret_cast<__nv_bfloat16*>(smem);
  // the forward's k-loop runs whole 64-wide steps past H on zeros: so does
  // this one
  const int k_steps = (H + splade_tile::BK - 1) / splade_tile::BK *
                      (splade_tile::BK / KSL);
  const int n_tiles = (n_live * GR + BM - 1) / BM;
  const int total = n_tiles * k_steps;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
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
    epilogue(tile, live, acc);
    // An epilogue without a barrier of its own (the match pass's) let the
    // compiler interleave it with the next tile's ring steps, past the
    // register limit into spills. This compiler fence keeps the schedule the
    // forward's barrier gives it (ptxas: 210 and 214 registers, no spill).
    asm volatile("" ::: "memory");
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  }
  cp_async_wait<0>();
  __syncthreads();
}

}  // namespace splade_walk
