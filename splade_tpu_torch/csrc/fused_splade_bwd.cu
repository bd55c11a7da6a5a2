// Fused SPLADE vocabulary projection + masked sequence max, backward (Hopper).
//
// Replaces splade_tpu/ops/fused_splade.py::_bwd_dh_kernel (:93) and
// ::_bwd_dw_kernel (:111), the Pallas kernels of fused_splade_pool's custom
// VJP. With m[b, v] the forward's pre-activation maxima and g[b, v] the
// cotangent already folded through log1p(relu) (g_pre, computed by the
// wrapper), the function is
//
//     score[s, v] = h[b, s, :] . W[v, :] + bias[v]          (invalid s: none)
//     G[s, v]     = g[b, v] if score[s, v] == m[b, v] else 0
//     dh[b, s, :] = sum_v G[s, v] W[v, :]
//     dW[v, :]    = sum_b sum_s G[s, v] h[b, s, :]
//
// Ties get duplicate gradient, as in the Pallas kernels. dbias = sum_b g is
// the wrapper's.
//
// "Match once, gather twice": three kernels.
// 1. splade_fused_pool_bwd_match recomputes every score of the batch once and
//    writes the argmax set as a bitmask match[b, j, v] (uint32, [B, ceil(S/32),
//    V]): bit r of word j is set when valid position 32j + r has score ==
//    m[b, v] and g[b, v] != 0. No bit for an invalid position, a g = 0 column
//    or a column past V. Every word is written (zeros for a tile it skips),
//    so no separate zeroing pass is needed.
// 2. splade_fused_pool_bwd_dh gathers, for each set bit, g[b, v] W[v, :] into
//    row 32j + r of dh[b]. The row-blocked family (fused_splade_v2_bwd.cu)
//    writes the same bitmask and launches the same two gathers.
// 3. splade_fused_pool_bwd_dw gathers, for each set bit, g[b, v] h[b, 32j+r, :]
//    into dW[v].
//
// What bounds it: the recompute, 2*valid*H*V bf16 operations on the tensor
// cores (1.3 ms at the document batch B=128 S=256), plus one f32 row of H
// multiply-adds a match on the CUDA cores. The kernels this replaces each
// recomputed the whole [B*S, V] score matrix in 32-wide chunks, streaming W
// (or h) about 1,000 times, and added each match serially into one row's
// registers. Here:
// - the match pass recomputes once, in 128 x 128 tiles (8 warps, each 64 x 32
//   of 4 x 2 fragments, every A fragment used against 2 B fragments), with a
//   3-stage cp.async pipeline and blocks ordered in groups of 16 row tiles so
//   that concurrent blocks share their h and W tiles in L2;
// - the gathers read only the bitmask, g and the matched rows (matches x H x
//   2 bytes, 9.8 GB at the document batch if every (b, v) matches) and keep
//   many rows' loads in flight; the dh gather is bound by its per-match
//   steps instead (see its kernel).
//
// The scores keep the forward's per-element arithmetic
// (fused_splade_tile.cuh): bf16 WMMA 16x16x16 products accumulated in f32,
// the k-slices of 16 in ascending order from a zeroed accumulator up to H
// rounded to the forward's 64-wide k-step, then + bias in f32. The tile
// shape, the warp tiling and the staging do not change that sequence, so the
// equality with m holds bit for bit where the forward took its maximum.
//
// Blocks run in no order, so no float sum crosses blocks, and there are no
// float atomics: every dh and dW element has one owner thread that adds its
// matches in ascending (v) resp. (b, j, r) order, so a repeated backward is
// bitwise identical. The bitmask's bits each have one writer.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <mma.h>
#include <stdint.h>

#include "fused_splade_tile.cuh"

namespace {

constexpr int MAX_H = 768;  // hidden columns a gather block owns (a slice)

// ---- 1. the match pass ------------------------------------------------------
constexpr int MT = 256;                // 8 warps
constexpr int M_BM = 128, M_BN = 128;  // rows (4 mask words) x vocab columns
constexpr int M_BK = 32;               // hidden slice of one pipeline stage
constexpr int M_STAGES = 3;
constexpr int M_LDS = M_BK + 8;  // 80-byte rows: conflict-free fragment loads
constexpr int M_LDC = M_BN + 4;  // f32 row stride of the score tile
constexpr int WORDS = M_BM / 32;
constexpr int WARP_FR = 4, WARP_FC = 2;  // fragments a warp: 64 rows x 32 cols
constexpr int GROUP = 16;                // row tiles of one block group
constexpr int STAGE_ELEMS = (M_BM + M_BN) * M_LDS;
constexpr int PIPE_BYTES = M_STAGES * STAGE_ELEMS * 2;
constexpr int SCORE_BYTES = M_BM * M_LDC * 4;
constexpr int M_SMEM = PIPE_BYTES > SCORE_BYTES ? PIPE_BYTES : SCORE_BYTES;
constexpr int M_CHUNKS = M_BM * (M_BK / 8) / MT;  // 16-byte copies a thread
static_assert(M_BM == M_BN && M_CHUNKS * MT == M_BM * (M_BK / 8),
              "A and B stages split evenly over the threads");
static_assert((M_BM / (16 * WARP_FR)) * (M_BN / (16 * WARP_FC)) == MT / 32,
              "one warp per 64 x 32 piece of the tile");
static_assert(splade_tile::BK % M_BK == 0, "whole forward k-steps");

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = pred ? 16 : 0;  // 0: nothing is read, 16 zero bytes land
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__global__ void __launch_bounds__(MT, 2)
fused_splade_bwd_match_kernel(const __nv_bfloat16* __restrict__ h,
                              const __nv_bfloat16* __restrict__ w,
                              const float* __restrict__ bias,
                              const float* __restrict__ mask,
                              const float* __restrict__ m,
                              const float* __restrict__ g,
                              uint32_t* __restrict__ match, int B, int S,
                              int H, int V, int J) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float m_s[WORDS][M_BN], g_s[WORDS][M_BN], bias_s[M_BN];
  __shared__ bool valid_s[M_BM];
  __nv_bfloat16* pipe = reinterpret_cast<__nv_bfloat16*>(smem);
  const float* Cs = reinterpret_cast<const float*>(smem);

  // grouped block order: GROUP row tiles walk the column tiles together
  const int n_row_tiles = (B * J + WORDS - 1) / WORDS;
  const int n_col_tiles = (V + M_BN - 1) / M_BN;
  const int in_group = GROUP * n_col_tiles;
  const int first = (int)(blockIdx.x / in_group) * GROUP;
  const int size = min(n_row_tiles - first, GROUP);
  const int rt = first + (int)(blockIdx.x % in_group) % size;
  const int ct = (int)(blockIdx.x % in_group) / size;
  const int gw0 = rt * WORDS;  // first (b, j) word of the tile
  const int v0 = ct * M_BN;
  const int BJ = B * J;
  const int tid = threadIdx.x;

  bool my_valid = false, my_live = false;
  if (tid < M_BM) {
    const int gw = gw0 + tid / 32;
    if (gw < BJ) {
      const int b = gw / J, s = (gw % J) * 32 + tid % 32;
      my_valid = s < S && mask[(size_t)b * S + s] > 0.f;
    }
    valid_s[tid] = my_valid;
  }
  if (tid < M_BN) bias_s[tid] = (v0 + tid < V && bias) ? bias[v0 + tid] : 0.f;
  for (int i = tid; i < WORDS * M_BN; i += MT) {
    const int wd = i / M_BN, c = i % M_BN, gw = gw0 + wd;
    float mv = 0.f, gv = 0.f;
    if (gw < BJ && v0 + c < V) {
      const size_t at = (size_t)(gw / J) * V + v0 + c;
      mv = m[at];
      gv = g[at];
    }
    m_s[wd][c] = mv;
    g_s[wd][c] = gv;
    my_live |= gv != 0.f;
  }
  const bool any_g = __syncthreads_or(my_live);
  const bool any_valid = __syncthreads_or(my_valid);
  if (!(any_g && any_valid)) {  // G is 0 on this tile: its words are 0
    for (int i = tid; i < WORDS * M_BN; i += MT) {
      const int gw = gw0 + i / M_BN, c = i % M_BN;
      if (gw < BJ && v0 + c < V) match[(size_t)gw * V + v0 + c] = 0u;
    }
    return;
  }

  // this thread's 16-byte copies: A rows (h) and B rows (W) of the tile
  const __nv_bfloat16* a_src[M_CHUNKS];
  const __nv_bfloat16* b_src[M_CHUNKS];
  bool a_ok[M_CHUNKS], b_ok[M_CHUNKS];
#pragma unroll
  for (int it = 0; it < M_CHUNKS; ++it) {
    const int row = (tid + it * MT) / (M_BK / 8);
    const int gw = gw0 + row / 32;
    const int s = (gw % J) * 32 + row % 32;
    a_ok[it] = gw < BJ && s < S;
    a_src[it] = a_ok[it] ? h + ((size_t)(gw / J) * S + s) * H : h;
    b_ok[it] = v0 + row < V;
    b_src[it] = b_ok[it] ? w + (size_t)(v0 + row) * H : w;
  }
  // the forward's k-loop runs whole 64-wide steps past H on zeros: so does this
  const int k_steps = (H + splade_tile::BK - 1) / splade_tile::BK *
                      (splade_tile::BK / M_BK);
  auto load_stage = [&](int stage, int ks) {
    __nv_bfloat16* As = pipe + stage * STAGE_ELEMS;
    __nv_bfloat16* Bs = As + M_BM * M_LDS;
#pragma unroll
    for (int it = 0; it < M_CHUNKS; ++it) {
      const int i = tid + it * MT;
      const int row = i / (M_BK / 8), q = i % (M_BK / 8);
      const int k = ks * M_BK + q * 8;
      const bool in = k < H;
      cp_async16(As + row * M_LDS + q * 8, in ? a_src[it] + k : h,
                 in && a_ok[it]);
      cp_async16(Bs + row * M_LDS + q * 8, in ? b_src[it] + k : w,
                 in && b_ok[it]);
    }
  };

  const int warp = tid >> 5;
  const int wr = warp / (M_BN / (16 * WARP_FC));  // 0..1: 64-row half
  const int wc = warp % (M_BN / (16 * WARP_FC));  // 0..3: 32-column quarter
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[WARP_FR][WARP_FC];
#pragma unroll
  for (int i = 0; i < WARP_FR; ++i)
#pragma unroll
    for (int j = 0; j < WARP_FC; ++j) wmma::fill_fragment(acc[i][j], 0.f);

#pragma unroll
  for (int st = 0; st < M_STAGES - 1; ++st) {
    if (st < k_steps) load_stage(st, st);
    cp_async_commit();
  }
  for (int ks = 0; ks < k_steps; ++ks) {
    cp_async_wait<M_STAGES - 2>();
    __syncthreads();  // stage ks landed; stage ks-1 is free for the refill
    if (ks + M_STAGES - 1 < k_steps)
      load_stage((ks + M_STAGES - 1) % M_STAGES, ks + M_STAGES - 1);
    cp_async_commit();
    const __nv_bfloat16* As = pipe + (ks % M_STAGES) * STAGE_ELEMS;
    const __nv_bfloat16* Bs = As + M_BM * M_LDS;
#pragma unroll
    for (int kk = 0; kk < M_BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> af[WARP_FR];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> bf[WARP_FC];
#pragma unroll
      for (int i = 0; i < WARP_FR; ++i)
        wmma::load_matrix_sync(af[i], As + (wr * 64 + i * 16) * M_LDS + kk,
                               M_LDS);
#pragma unroll
      for (int j = 0; j < WARP_FC; ++j)  // B = W_tile^T: W rows read as [k, v]
        wmma::load_matrix_sync(bf[j], Bs + (wc * 32 + j * 16) * M_LDS + kk,
                               M_LDS);
#pragma unroll
      for (int i = 0; i < WARP_FR; ++i)
#pragma unroll
        for (int j = 0; j < WARP_FC; ++j)
          wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every product is done: the scores may overwrite the stages
  float* Cw = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < WARP_FR; ++i)
#pragma unroll
    for (int j = 0; j < WARP_FC; ++j)
      wmma::store_matrix_sync(Cw + (wr * 64 + i * 16) * M_LDC + wc * 32 + j * 16,
                              acc[i][j], M_LDC, wmma::mem_row_major);
  __syncthreads();

  // one word a (mask word, column): 32 rows compared with m, + bias in f32
  for (int i = tid; i < WORDS * M_BN; i += MT) {
    const int wd = i / M_BN, c = i % M_BN, gw = gw0 + wd;
    if (gw >= BJ || v0 + c >= V) continue;
    const float mc = m_s[wd][c], bc = bias_s[c];
    uint32_t bits = 0u;
    if (g_s[wd][c] != 0.f) {
#pragma unroll 8
      for (int r = 0; r < 32; ++r) {
        const int row = wd * 32 + r;
        if (valid_s[row] && Cs[row * M_LDC + c] + bc == mc) bits |= 1u << r;
      }
    }
    match[(size_t)gw * V + v0 + c] = bits;
  }
}

// ---- 2. the dh gather -------------------------------------------------------
constexpr int DH_COLS = 4;        // hidden columns a thread: one 8-byte W load
constexpr int DH_WARP_COLS = 32 * DH_COLS;  // hidden columns a warp (128)
constexpr int DH_CW = 4;          // mask words a thread a chunk
constexpr int DH_UNROLL = 16;     // listed matches a batch (W rows in flight)
constexpr int DH_GROUP = 4;       // matches added together when their rows differ
constexpr int DH_MAX_T = MAX_H / DH_COLS;   // 192 threads at the widest slice
static_assert(DH_UNROLL % DH_GROUP == 0, "whole groups a batch");

// One batch of listed matches in registers: each one's W columns, g and bits.
struct DhBatch {
  uint2 raw[DH_UNROLL];
  float g[DH_UNROLL];
  uint32_t bits[DH_UNROLL];
};

__device__ __forceinline__ void dh_fetch(DhBatch& t, int e0, int n,
                                         const int* ent_v,
                                         const uint32_t* ent_bits,
                                         const float* ent_g,
                                         const __nv_bfloat16* wcol, int H) {
#pragma unroll
  for (int u = 0; u < DH_UNROLL; ++u) {
    const bool in = e0 + u < n;
    t.bits[u] = in ? ent_bits[e0 + u] : 0u;  // 0: nothing to add
    t.g[u] = in ? ent_g[e0 + u] : 0.f;
    if (in)
      t.raw[u] =
          *reinterpret_cast<const uint2*>(wcol + (size_t)ent_v[e0 + u] * H);
  }
}

__device__ __forceinline__ float4 dh_row(const uint2& raw) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 lo = __bfloat1622float2(p[0]);
  const float2 hi = __bfloat1622float2(p[1]);
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void dh_add(float4& s, float g, const float4& f) {
  s.x = fmaf(g, f.x, s.x);
  s.y = fmaf(g, f.y, s.y);
  s.z = fmaf(g, f.z, s.z);
  s.w = fmaf(g, f.w, s.w);
}

// Add one batch into the sums in list order. DH_GROUP consecutive matches
// that each name one row, all different, touch four different sums: their
// reads, adds and writes are independent and issued together. Any other
// group (a tie, two matches of one row) is added match by match, bit by bit.
__device__ __forceinline__ void dh_apply(const DhBatch& t, float* acc_s,
                                         int width, int c) {
#pragma unroll
  for (int q = 0; q < DH_UNROLL; q += DH_GROUP) {
    uint32_t all = 0u;
    bool single = true;  // each match names exactly one row
#pragma unroll
    for (int k = 0; k < DH_GROUP; ++k) {
      all |= t.bits[q + k];
      single &= __popc(t.bits[q + k]) == 1;
    }
    if (!all) break;  // the batch's list is exhausted (block-uniform)
    if (single && __popc(all) == DH_GROUP) {  // four different rows
      float4* a[DH_GROUP];
      float4 s[DH_GROUP];
#pragma unroll
      for (int k = 0; k < DH_GROUP; ++k) {
        a[k] = reinterpret_cast<float4*>(
            acc_s + (__ffs(t.bits[q + k]) - 1) * width + c);
        s[k] = *a[k];
      }
#pragma unroll
      for (int k = 0; k < DH_GROUP; ++k) {
        dh_add(s[k], t.g[q + k], dh_row(t.raw[q + k]));
        *a[k] = s[k];
      }
    } else {
#pragma unroll
      for (int k = 0; k < DH_GROUP; ++k) {
        const float4 f = dh_row(t.raw[q + k]);
        for (uint32_t b = t.bits[q + k]; b; b &= b - 1u) {
          float4* a = reinterpret_cast<float4*>(
              acc_s + (__ffs(b) - 1) * width + c);
          float4 s = *a;
          dh_add(s, t.g[q + k], f);
          *a = s;
        }
      }
    }
  }
}

// A block owns one (b, j) word row, one slice of the hidden columns and one
// range of the vocabulary (the whole of it for the per-row family; the
// row-blocked family splits it where word rows are few, so that more blocks
// share the serial walk of a word row's matches); its
// f32 sums for the word's 32 rows and the slice's columns live in shared
// memory ([32][width], 96 KB at the full 768 columns, opted in dynamically),
// each thread owning 4 columns of all 32 rows. The block walks
// match[b, j, vb:ve] in chunks of DH_CW words a thread, read coalesced with the
// next chunk in flight, and compacts each chunk's nonzero words with their g
// into a list in ascending v. Then every thread takes the list in batches of
// DH_UNROLL matches, their W rows (8 bytes each, coalesced across the block),
// g and bits loaded into registers together, then added into the rows their
// bits name. Every match is shared by the whole block: no
// divergence, and no sum has two owners.
//
// What bounds it, measured on an H100 (PERF.md): the steps each thread takes
// a match, not the W bytes (a version whose W reads all hit a few cached rows
// was no faster). Clock stamps (scripts/profile_dh_gather.py) put most of a
// block's time in the adds, about 180 cycles a match when each add waited on
// its list entry and then on its row's sums in shared memory, one match
// after the other; hence the entries in registers and the independent
// groups.
__global__ void __launch_bounds__(DH_MAX_T)
fused_splade_bwd_dh_kernel(const uint32_t* __restrict__ match,
                           const __nv_bfloat16* __restrict__ w,
                           const float* __restrict__ g, float* __restrict__ dh,
                           int S, int H, int V, int J, int slice, int range) {
  extern __shared__ __align__(16) float acc_s[];  // [32][width]
  __shared__ int ent_v[DH_MAX_T * DH_CW];
  __shared__ uint32_t ent_bits[DH_MAX_T * DH_CW];
  __shared__ float ent_g[DH_MAX_T * DH_CW];
  __shared__ int warp_n[DH_CW][DH_MAX_T / 32];
  const int gw = blockIdx.x, b = gw / J, j = gw % J;
  const int h0 = blockIdx.y * slice;
  // this block's vocab range [vb, ve) and its partial of dh
  const int vb = blockIdx.z * range, ve = min(V, vb + range);
  dh += (size_t)blockIdx.z * (gridDim.x / J) * S * H;
  const int width = min(slice, H - h0);
  const int T = blockDim.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = T / 32;
  const int c = tid * DH_COLS;  // this thread's first column in the slice
  const bool own = c < width;
  for (int i = tid; i < 32 * width; i += T) acc_s[i] = 0.f;

  const uint32_t* mrow = match + (size_t)gw * V;
  const float* grow = g + (size_t)b * V;
  const __nv_bfloat16* wcol = w + h0 + c;
  uint32_t wn[DH_CW];
  float gn[DH_CW];
#pragma unroll
  for (int k = 0; k < DH_CW; ++k) {
    const int v = vb + k * T + tid;
    wn[k] = v < ve ? mrow[v] : 0u;
    gn[k] = v < ve ? grow[v] : 0.f;
  }
  for (int v0 = vb; v0 < ve; v0 += DH_CW * T) {
    uint32_t wc[DH_CW];
    float gc[DH_CW];
    unsigned nz[DH_CW];
#pragma unroll
    for (int k = 0; k < DH_CW; ++k) {
      wc[k] = wn[k];
      gc[k] = gn[k];
      const int v = v0 + DH_CW * T + k * T + tid;  // the next chunk's words
      wn[k] = v < ve ? mrow[v] : 0u;
      gn[k] = v < ve ? grow[v] : 0.f;
      nz[k] = __ballot_sync(0xffffffffu, wc[k] != 0u);
      if (lane == 0) warp_n[k][warp] = __popc(nz[k]);
    }
    __syncthreads();  // counts written; the last list is consumed; sums zeroed
    int n = 0;
#pragma unroll
    for (int k = 0; k < DH_CW; ++k) {  // list order (k, warp, lane): ascending v
      int at = n;
      for (int q = 0; q < n_warps; ++q) {
        at += q < warp ? warp_n[k][q] : 0;
        n += warp_n[k][q];
      }
      if (wc[k]) {
        at += __popc(nz[k] & ((1u << lane) - 1u));
        ent_v[at] = v0 + k * T + tid;
        ent_bits[at] = wc[k];
        ent_g[at] = gc[k];
      }
    }
    __syncthreads();  // the list is complete
    if (own) {
      for (int e0 = 0; e0 < n; e0 += DH_UNROLL) {
        DhBatch t;
        dh_fetch(t, e0, n, ent_v, ent_bits, ent_g, wcol, H);
        dh_apply(t, acc_s, width, c);
      }
    }
  }
  __syncthreads();  // the sums are complete (and zeroed, where the range is empty)
  // every row of the word below S, its sums 0 where nothing matched
  if (own)
    for (int r = 0; r < 32 && j * 32 + r < S; ++r)
      *reinterpret_cast<float4*>(dh + ((size_t)b * S + j * 32 + r) * H + h0 +
                                 c) =
          *reinterpret_cast<const float4*>(acc_s + r * width + c);
}

// ---- 3. the dW gather -------------------------------------------------------
constexpr int DW_WARPS = 8;            // vocab columns a block, one a warp
constexpr int DW_KJ = MAX_H / 256;     // 16-byte h slices a lane (3)
constexpr int DW_UNROLL = 4;           // h rows in flight a warp

__device__ __forceinline__ void add_h_row(float* acc, float gg,
                                          const uint4* raw) {
#pragma unroll
  for (int q = 0; q < DW_KJ; ++q) {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw[q]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(p[e]);
      acc[q * 8 + 2 * e] = fmaf(gg, f.x, acc[q * 8 + 2 * e]);
      acc[q * 8 + 2 * e + 1] = fmaf(gg, f.y, acc[q * 8 + 2 * e + 1]);
    }
  }
}

__device__ __forceinline__ void load_h_row(uint4* raw,
                                           const __nv_bfloat16* row, int lane,
                                           int width) {
#pragma unroll
  for (int q = 0; q < DW_KJ; ++q) {
    const int k = q * 256 + lane * 8;
    raw[q] = k < width ? *reinterpret_cast<const uint4*>(row + k)
                       : make_uint4(0u, 0u, 0u, 0u);
  }
}

// A warp owns one vocab column v and one slice of up to MAX_H hidden columns
// (blockIdx.y; a wider H walks the bitmask once a slice) and walks the (b, j)
// words in ascending order, 32 at a time (lane l reads word k0 + l; the next
// 32 in flight). Each lane keeps 24 f32 sums of dW[v] (the slice's columns
// lane*8 + 256q + e) in registers. Where every nonzero word of the 32 holds one bit (no tie), the
// warp loads DW_UNROLL matched h rows at once and adds them in order; a
// group with a tie is walked bit by bit. Either way the adds run in
// ascending (b, j, r).
__global__ void __launch_bounds__(DW_WARPS * 32)
fused_splade_bwd_dw_kernel(const uint32_t* __restrict__ match,
                           const __nv_bfloat16* __restrict__ h,
                           const float* __restrict__ g, float* __restrict__ dw,
                           int B, int S, int H, int V, int J) {
  const int lane = threadIdx.x & 31;
  const int v = blockIdx.x * DW_WARPS + (threadIdx.x >> 5);
  if (v >= V) return;  // a whole warp; the kernel has no block barrier
  const int h0 = blockIdx.y * MAX_H, width = min(MAX_H, H - h0);
  h += h0;
  const int BJ = B * J;
  float acc[DW_KJ * 8];
#pragma unroll
  for (int i = 0; i < DW_KJ * 8; ++i) acc[i] = 0.f;

  uint32_t next = lane < BJ ? match[(size_t)lane * V + v] : 0u;
  for (int k0 = 0; k0 < BJ; k0 += 32) {
    const uint32_t word = next;
    const int kn = k0 + 32 + lane;
    next = kn < BJ ? match[(size_t)kn * V + v] : 0u;
    const int k = k0 + lane;
    const float gk = word ? g[(size_t)(k / J) * V + v] : 0.f;
    unsigned live = __ballot_sync(0xffffffffu, word != 0u);
    if (!live) continue;
    if (__any_sync(0xffffffffu, __popc(word) > 1)) {  // ties: bit by bit
      for (; live; live &= live - 1u) {
        const int L = __ffs(live) - 1;
        const float gg = __shfl_sync(0xffffffffu, gk, L);
        const int kl = k0 + L;
        const __nv_bfloat16* hb = h + ((size_t)(kl / J) * S + (kl % J) * 32) * H;
        for (uint32_t bits = __shfl_sync(0xffffffffu, word, L); bits;
             bits &= bits - 1u) {
          uint4 raw[DW_KJ];
          load_h_row(raw, hb + (size_t)(__ffs(bits) - 1) * H, lane, width);
          add_h_row(acc, gg, raw);
        }
      }
      continue;
    }
    while (live) {  // one bit a nonzero word: DW_UNROLL rows in flight
      uint4 raw[DW_UNROLL][DW_KJ];
      float gs[DW_UNROLL];
#pragma unroll
      for (int u = 0; u < DW_UNROLL; ++u) {
        const int L = live ? __ffs(live) - 1 : 0;
        const bool any = live != 0u;
        live &= live - 1u;
        const uint32_t bits = __shfl_sync(0xffffffffu, word, L);
        const float gl = __shfl_sync(0xffffffffu, gk, L);
        gs[u] = any ? gl : 0.f;
        if (any) {
          const int kl = k0 + L;
          load_h_row(raw[u],
                     h + ((size_t)(kl / J) * S + (kl % J) * 32 + __ffs(bits) -
                          1) * H,
                     lane, width);
        }
      }
#pragma unroll
      for (int u = 0; u < DW_UNROLL; ++u)
        if (gs[u] != 0.f) add_h_row(acc, gs[u], raw[u]);
    }
  }
  float* out = dw + (size_t)v * H + h0;
#pragma unroll
  for (int q = 0; q < DW_KJ; ++q) {
    const int k = q * 256 + lane * 8;
    if (k < width) {
      float4* o = reinterpret_cast<float4*>(out + k);
      o[0] = make_float4(acc[q * 8], acc[q * 8 + 1], acc[q * 8 + 2],
                         acc[q * 8 + 3]);
      o[1] = make_float4(acc[q * 8 + 4], acc[q * 8 + 5], acc[q * 8 + 6],
                         acc[q * 8 + 7]);
    }
  }
}

cudaError_t opt_in(const void* kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

// h [B,S,H] bf16, w [V,H] bf16, bias [V] f32 or null, mask [B,S] f32,
// m and g [B,V] f32, out match [B, ceil(S/32), V] uint32, every word written.
// H % 8 == 0 and 16-byte aligned rows are checked by the wrapper.
extern "C" int splade_fused_pool_bwd_match(const void* h, const void* w,
                                           const void* bias, const void* mask,
                                           const void* m, const void* g,
                                           void* match, int B, int S, int H,
                                           int V, void* stream) {
  if (H % 8) return (int)cudaErrorInvalidValue;
  const int J = (S + 31) / 32;
  const long long tiles = ((long long)B * J + WORDS - 1) / WORDS *
                          ((V + M_BN - 1) / M_BN);
  if (tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = opt_in((const void*)fused_splade_bwd_match_kernel, M_SMEM);
  if (err != cudaSuccess) return (int)err;
  fused_splade_bwd_match_kernel<<<(unsigned)tiles, MT, M_SMEM,
                                  (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)h, (const __nv_bfloat16*)w, (const float*)bias,
      (const float*)mask, (const float*)m, (const float*)g, (uint32_t*)match,
      B, S, H, V, J);
  return (int)cudaGetLastError();
}

// match [B, ceil(S/32), V] uint32 (either family's match pass), w [V,H]
// bf16, g [B,V] f32, out dh [vocab_splits, B, S, H] f32, every element
// written. The hidden columns are cut into `splits` slices of whole
// 128-column groups (the wrapper's dh_hidden_splits); the vocabulary into
// `vocab_splits` ranges of ceil(ceil(V/32) / vocab_splits) * 32 columns, range
// z summing its matches into partial z (zeros for a range past V), which the
// wrapper adds in range order. H % 8 == 0; a slice is at most 768 columns.
extern "C" int splade_fused_pool_bwd_dh(const void* match, const void* w,
                                        const void* g, void* dh, int B, int S,
                                        int H, int V, int splits,
                                        int vocab_splits, void* stream) {
  if (H % 8 || splits < 1 || vocab_splits < 1)
    return (int)cudaErrorInvalidValue;
  const int range = ((V + 31) / 32 + vocab_splits - 1) / vocab_splits * 32;
  const int groups = (H + DH_WARP_COLS - 1) / DH_WARP_COLS;
  const int slice = (groups + splits - 1) / splits * DH_WARP_COLS;
  const int width = slice < H ? slice : H;
  if (width > MAX_H) return (int)cudaErrorInvalidValue;
  const int threads = (width / DH_COLS + 31) / 32 * 32;
  const int bytes = 32 * width * 4;
  cudaError_t err = opt_in((const void*)fused_splade_bwd_dh_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  const int J = (S + 31) / 32;
  dim3 grid(B * J, (H + slice - 1) / slice, vocab_splits);
  fused_splade_bwd_dh_kernel<<<grid, threads, bytes, (cudaStream_t)stream>>>(
      (const uint32_t*)match, (const __nv_bfloat16*)w, (const float*)g,
      (float*)dh, S, H, V, J, slice, range);
  return (int)cudaGetLastError();
}

// match as above, h [B,S,H] bf16, g [B,V] f32, out dw [V,H] f32, every
// element written, in slices of 768 hidden columns. H % 8 == 0.
extern "C" int splade_fused_pool_bwd_dw(const void* match, const void* h,
                                        const void* g, void* dw, int B, int S,
                                        int H, int V, void* stream) {
  if (H % 8) return (int)cudaErrorInvalidValue;
  const int J = (S + 31) / 32;
  dim3 grid((V + DW_WARPS - 1) / DW_WARPS, (H + MAX_H - 1) / MAX_H);
  fused_splade_bwd_dw_kernel<<<grid, DW_WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)match, (const __nv_bfloat16*)h, (const float*)g,
      (float*)dw, B, S, H, V, J);
  return (int)cudaGetLastError();
}
