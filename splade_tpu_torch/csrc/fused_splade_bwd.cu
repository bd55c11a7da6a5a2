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
// "Match once, gather twice": a match pass, then two gathers.
// 1. The match pass is the row-blocked family's, splade_fused_pool_v2_bwd_match
//    (fused_splade_v2_bwd.cu), which both pool families launch: it recomputes
//    every score of the batch once and writes the argmax set as a bitmask
//    match[b, j, v] (uint32, [B, ceil(S/32), V]): bit r of word j is set when
//    valid position 32j + r has score == m[b, v] and g[b, v] != 0. No bit for
//    an invalid position, a g = 0 column or a column past V; every word is
//    written.
// 2. splade_fused_pool_bwd_dh (this file) gathers, for each set bit,
//    g[b, v] W[v, :] into row 32j + r of dh[b], each word row's vocabulary
//    cut into ordered ranges where word rows are few.
// 3. splade_fused_pool_bwd_dw (this file) gathers, for each set bit,
//    g[b, v] h[b, 32j+r, :] into dW[v].
//
// What bounds the gathers: they read only the bitmask, g and the matched
// rows (matches x H x 2 bytes, 9.8 GB at the document batch if every (b, v)
// matches) and keep many rows' loads in flight; the dh gather is bound by
// its per-match steps instead (see its kernel). The recompute is the match
// pass's (2*valid*H*V bf16 operations on the tensor cores).
//
// Blocks run in no order, so no float sum crosses blocks, and there are no
// float atomics: every dh and dW element has one owner thread that adds its
// matches in ascending (v) resp. (b, j, r) order (dh's vocab ranges each
// into their own partial, added in range order by the wrapper), so a
// repeated backward is bitwise identical.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_H = 768;  // hidden columns a gather block owns (a slice)

// ---- the dh gather -------------------------------------------------------
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
// range of the vocabulary (the wrapper splits it where word rows are few, so
// that more blocks share the serial walk of a word row's matches); its f32
// sums for the word's 32 rows and the slice's columns live in shared
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

// ---- the dW gather -------------------------------------------------------
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

// match [B, ceil(S/32), V] uint32 (the match pass's), w [V,H] bf16, g [B,V]
// f32, out dh [vocab_splits, B, S, H] f32, every element written. The hidden
// columns are cut into `splits` slices of whole 128-column groups (the
// wrapper's min_hidden_slices: one up to H = 768); the vocabulary into
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
