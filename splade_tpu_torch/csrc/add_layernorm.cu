// The encoder's residual add and the LayerNorm after it (Hopper): the f32
// residual stream and the bf16 operand of the next product in one pass, and
// one backward pass that writes the residual's and the branch's gradients,
// with gamma's gradient summed by a second, small kernel.
//
// Replaces no TPU kernel. The JAX package adds and normalises in plain jnp
// (splade_tpu/models/modernbert.py, its blocks and nn.LayerNorm with
// use_fast_variance=False), which XLA fuses; run eagerly under autocast,
// with the residual kept in f32, each site is a mixed bf16 + f32 add, an f32
// LayerNorm and the cast to bf16 inside the next nn.Linear (24 bytes an
// element), and in the backward the cast's backward, LayerNorm's input
// gradient, GammaBetaBackward reading dy and x again, the add of the residual
// gradient and the branch gradient's cast (about 44 bytes). For a row x of H
// (bias-free, eps from the config):
//
//     forward:  r' = r + b                  (f32; b bf16, or no branch)
//               mean = sum(r') / H,  var = sum((r' - mean)^2) / H
//               rstd = rsqrt(var + eps),  xh = (r' - mean) * rstd
//               n = xh * gamma                         (bf16 or f32 out)
//     backward: g = dn * gamma,  c1 = sum(g) / H,  c2 = sum(g * xh) / H
//               dr = rstd * (g - c1 - xh * c2) + d_above         (f32)
//               db = bf16(dr),  dgamma = sum over rows of dn * xh
//
// The add is one f32 rounding of r + f32(b), bitwise the eager mixed add;
// the variance takes two passes over the row held in registers, as JAX's
// use_fast_variance=False does.
//
// What bounds it: bytes. A site moves 12 bytes an element forward (b 2, r 4
// in; r' 4, n 2 out) and 16 backward (dn 2, r' 4, d_above 4 in; dr 4, db 2
// out), plus 8 bytes a row of mean and rstd and the gamma partials: at the
// V33 micro-batch (36,864 rows of 768) 340 MB forward, 0.101 ms at 3.35
// TB/s, and 453 MB backward, 0.135 ms.
//
// Design: one warp a row. Lane l holds chunks c = l + 32 j (j < J, H = 256
// J) of 8 elements: one 16-byte load of bf16, two of f32, so a warp's loads
// of a chunk column are contiguous and every sector is used whole. The row
// stays in registers from its load to its store; both sums are a lane's own
// chunks in order and then a butterfly of shuffles, so every lane holds the
// same mean, rstd, c1 and c2 and a row's result does not depend on where it
// ran. A block of 8 warps owns a run of rows_per_block rows (the wrapper's
// choice), warp w rows w, w + 8, ...; gamma is loaded once a warp. In the
// backward each lane keeps its chunks' dn * xh sums over the warp's rows,
// the block adds its 8 warps in order through shared memory and writes one
// partial row of H; the dgamma kernel adds the blocks' partials in a fixed
// order. No atomics: a repeat is bitwise equal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int VEC = 8;                   // elements a chunk
constexpr int CHUNK_COLS = 32 * VEC;     // elements a chunk column of a warp
constexpr int MAX_J = 4;                 // H up to 1024
// the dgamma kernel: 32 columns a block, SLICES threads down each
constexpr int SLICES = 16;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void load_f32(const float* p, float (&f)[VEC]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

__device__ __forceinline__ void store_f32(float* p, const float (&f)[VEC]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

__device__ __forceinline__ void load_vec(const float* p, float (&f)[VEC]) {
  load_f32(p, f);
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&f)[VEC]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ void store_vec(float* p, const float (&f)[VEC]) {
  store_f32(p, f);
}

__device__ __forceinline__ void store_vec(__nv_bfloat16* p,
                                          const float (&f)[VEC]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i)
    h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// r [rows, H] f32; b [rows, H] bf16 or null (no branch); gamma [H] f32;
// r_out [rows, H] f32 (null with no branch); n [rows, H] OutT; stats
// [2, rows] f32: mean, then rstd.
template <int J, typename OutT>
__global__ void __launch_bounds__(THREADS) add_layernorm_fwd_kernel(
    const float* __restrict__ r, const __nv_bfloat16* __restrict__ b,
    const float* __restrict__ gamma, float* __restrict__ r_out,
    OutT* __restrict__ n, float* __restrict__ stats, long long rows,
    int rows_per_block, float eps) {
  constexpr int H = J * CHUNK_COLS;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const long long first = (long long)blockIdx.x * rows_per_block;
  const long long end =
      first + rows_per_block < rows ? first + rows_per_block : rows;
  float g[J][VEC];
#pragma unroll
  for (int j = 0; j < J; ++j) load_f32(gamma + (lane + 32 * j) * VEC, g[j]);
  for (long long row = first + warp; row < end; row += WARPS) {
    const long long base = row * H + lane * VEC;
    float x[J][VEC];
#pragma unroll
    for (int j = 0; j < J; ++j) load_f32(r + base + j * CHUNK_COLS, x[j]);
    if (b != nullptr) {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        float v[VEC];
        load_vec(b + base + j * CHUNK_COLS, v);
#pragma unroll
        for (int i = 0; i < VEC; ++i) x[j][i] = __fadd_rn(x[j][i], v[i]);
        store_f32(r_out + base + j * CHUNK_COLS, x[j]);
      }
    }
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int i = 0; i < VEC; ++i) s += x[j][i];
    const float mean = __fdiv_rn(warp_sum(s), (float)H);
    float s2 = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        x[j][i] = __fsub_rn(x[j][i], mean);
        s2 = __fmaf_rn(x[j][i], x[j][i], s2);
      }
    const float rstd = rsqrtf(__fdiv_rn(warp_sum(s2), (float)H) + eps);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      float y[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        y[i] = __fmul_rn(__fmul_rn(x[j][i], rstd), g[j][i]);
      store_vec(n + base + j * CHUNK_COLS, y);
    }
    if (lane == 0) {
      stats[row] = mean;
      stats[rows + row] = rstd;
    }
  }
}

// dn [rows, H] DnT; x = r' [rows, H] f32; stats as the forward wrote them;
// d_above [rows, H] f32 or null; dr [rows, H] f32; db [rows, H] bf16 or null;
// partial [gridDim.x, H] f32: each block's sum of dn * xh over its rows.
template <int J, typename DnT>
__global__ void __launch_bounds__(THREADS, 2) add_layernorm_bwd_kernel(
    const DnT* __restrict__ dn, const float* __restrict__ x,
    const float* __restrict__ stats, const float* __restrict__ gamma,
    const float* __restrict__ d_above, float* __restrict__ dr,
    __nv_bfloat16* __restrict__ db, float* __restrict__ partial,
    long long rows, int rows_per_block) {
  constexpr int H = J * CHUNK_COLS;
  __shared__ __align__(16) float red[WARPS][H];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const long long first = (long long)blockIdx.x * rows_per_block;
  const long long end =
      first + rows_per_block < rows ? first + rows_per_block : rows;
  float g[J][VEC], acc[J][VEC];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    load_f32(gamma + (lane + 32 * j) * VEC, g[j]);
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[j][i] = 0.f;
  }
  for (long long row = first + warp; row < end; row += WARPS) {
    const long long base = row * H + lane * VEC;
    const float mean = __ldg(stats + row), rstd = __ldg(stats + rows + row);
    float xh[J][VEC], gd[J][VEC];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      float d[VEC];
      load_f32(x + base + j * CHUNK_COLS, xh[j]);
      load_vec(dn + base + j * CHUNK_COLS, d);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        xh[j][i] = __fmul_rn(__fsub_rn(xh[j][i], mean), rstd);
        gd[j][i] = __fmul_rn(d[i], g[j][i]);
        acc[j][i] = __fmaf_rn(d[i], xh[j][i], acc[j][i]);
        s1 += gd[j][i];
        s2 = __fmaf_rn(gd[j][i], xh[j][i], s2);
      }
    }
    const float c1 = __fdiv_rn(warp_sum(s1), (float)H);
    const float c2 = __fdiv_rn(warp_sum(s2), (float)H);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      float out[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        out[i] = __fmul_rn(
            rstd, __fsub_rn(__fsub_rn(gd[j][i], c1), __fmul_rn(xh[j][i], c2)));
      if (d_above != nullptr) {
        float a[VEC];
        load_f32(d_above + base + j * CHUNK_COLS, a);
#pragma unroll
        for (int i = 0; i < VEC; ++i) out[i] = __fadd_rn(out[i], a[i]);
      }
      store_f32(dr + base + j * CHUNK_COLS, out);
      if (db != nullptr) store_vec(db + base + j * CHUNK_COLS, out);
    }
  }
#pragma unroll
  for (int j = 0; j < J; ++j) store_f32(&red[warp][(lane + 32 * j) * VEC],
                                        acc[j]);
  __syncthreads();
  for (int col = threadIdx.x; col < H; col += THREADS) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += red[w][col];
    partial[(long long)blockIdx.x * H + col] = s;
  }
}

// partial [blocks, H] -> dgamma [H]: SLICES threads down each column add
// every SLICES-th block's row in order, then the slices in order.
__global__ void __launch_bounds__(32 * SLICES) add_layernorm_dgamma_kernel(
    const float* __restrict__ partial, float* __restrict__ dgamma, int blocks,
    int H) {
  __shared__ float red[SLICES][32];
  const int col = blockIdx.x * 32 + threadIdx.x;
  float s = 0.f;
  if (col < H)
    for (int k = threadIdx.y; k < blocks; k += SLICES)
      s += __ldg(partial + (long long)k * H + col);
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && col < H) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < SLICES; ++k) t += red[k][threadIdx.x];
    dgamma[col] = t;
  }
}

bool width_ok(int H) {
  return H > 0 && H % CHUNK_COLS == 0 && H / CHUNK_COLS <= MAX_J;
}

unsigned blocks_for(long long rows, int rows_per_block) {
  return (unsigned)((rows + rows_per_block - 1) / rows_per_block);
}

template <typename OutT>
cudaError_t launch_fwd(const float* r, const __nv_bfloat16* b,
                       const float* gamma, float* r_out, OutT* n,
                       float* stats, long long rows, int H,
                       int rows_per_block, float eps, cudaStream_t stream) {
  const dim3 grid(blocks_for(rows, rows_per_block));
#define SPLADE_ADD_LN_FWD(J)                                             \
  case J:                                                                \
    add_layernorm_fwd_kernel<J, OutT><<<grid, THREADS, 0, stream>>>(     \
        r, b, gamma, r_out, n, stats, rows, rows_per_block, eps);        \
    break;
  switch (H / CHUNK_COLS) {
    SPLADE_ADD_LN_FWD(1)
    SPLADE_ADD_LN_FWD(2)
    SPLADE_ADD_LN_FWD(3)
    SPLADE_ADD_LN_FWD(4)
    default: return cudaErrorInvalidValue;
  }
#undef SPLADE_ADD_LN_FWD
  return cudaGetLastError();
}

template <typename DnT>
cudaError_t launch_bwd(const DnT* dn, const float* x, const float* stats,
                       const float* gamma, const float* d_above, float* dr,
                       __nv_bfloat16* db, float* partial, float* dgamma,
                       long long rows, int H, int rows_per_block,
                       cudaStream_t stream) {
  const unsigned blocks = blocks_for(rows, rows_per_block);
#define SPLADE_ADD_LN_BWD(J)                                             \
  case J:                                                                \
    add_layernorm_bwd_kernel<J, DnT><<<blocks, THREADS, 0, stream>>>(    \
        dn, x, stats, gamma, d_above, dr, db, partial, rows,             \
        rows_per_block);                                                 \
    break;
  switch (H / CHUNK_COLS) {
    SPLADE_ADD_LN_BWD(1)
    SPLADE_ADD_LN_BWD(2)
    SPLADE_ADD_LN_BWD(3)
    SPLADE_ADD_LN_BWD(4)
    default: return cudaErrorInvalidValue;
  }
#undef SPLADE_ADD_LN_BWD
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  add_layernorm_dgamma_kernel<<<(H + 31) / 32, dim3(32, SLICES), 0, stream>>>(
      partial, dgamma, (int)blocks, H);
  return cudaGetLastError();
}

}  // namespace

// r [rows, H] f32 contiguous; b [rows, H] bf16 or null; gamma [H] f32;
// r_out [rows, H] f32 (null exactly when b is); n [rows, H], bf16 when
// n_bf16 else f32; stats [2, rows] f32. Every pointer 16-byte aligned.
extern "C" int splade_add_layernorm_fwd(const void* r, const void* b,
                                        const void* gamma, void* r_out,
                                        void* n, void* stats, long long rows,
                                        int H, int rows_per_block, float eps,
                                        int n_bf16, void* stream) {
  if (!width_ok(H) || rows < 0 || rows_per_block <= 0 ||
      (b == nullptr) != (r_out == nullptr))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const auto* rr = (const float*)r;
  const auto* bb = (const __nv_bfloat16*)b;
  const auto* gg = (const float*)gamma;
  auto* ro = (float*)r_out;
  auto* st = (float*)stats;
  const auto s = (cudaStream_t)stream;
  return (int)(n_bf16 ? launch_fwd(rr, bb, gg, ro, (__nv_bfloat16*)n, st,
                                   rows, H, rows_per_block, eps, s)
                      : launch_fwd(rr, bb, gg, ro, (float*)n, st, rows, H,
                                   rows_per_block, eps, s));
}

// dn [rows, H], bf16 when dn_bf16 else f32; x [rows, H] f32 (the forward's
// r'); stats [2, rows]; gamma [H]; d_above [rows, H] f32 or null; dr [rows,
// H] f32; db [rows, H] bf16 or null; partial [ceil(rows / rows_per_block),
// H] f32 scratch; dgamma [H] f32. Every pointer 16-byte aligned.
extern "C" int splade_add_layernorm_bwd(
    const void* dn, const void* x, const void* stats, const void* gamma,
    const void* d_above, void* dr, void* db, void* partial, void* dgamma,
    long long rows, int H, int rows_per_block, int dn_bf16, void* stream) {
  if (!width_ok(H) || rows < 0 || rows_per_block <= 0)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const auto* xx = (const float*)x;
  const auto* st = (const float*)stats;
  const auto* gg = (const float*)gamma;
  const auto* da = (const float*)d_above;
  auto* out = (float*)dr;
  auto* bb = (__nv_bfloat16*)db;
  auto* pp = (float*)partial;
  auto* dg = (float*)dgamma;
  const auto s = (cudaStream_t)stream;
  return (int)(dn_bf16
                   ? launch_bwd((const __nv_bfloat16*)dn, xx, st, gg, da, out,
                                bb, pp, dg, rows, H, rows_per_block, s)
                   : launch_bwd((const float*)dn, xx, st, gg, da, out, bb, pp,
                                dg, rows, H, rows_per_block, s));
}
