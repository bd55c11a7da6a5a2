// RoPE on the splash route (Hopper): q and k rotated straight from the bf16
// fused QKV product into the bf16 operands the splash kernels read, and one
// backward pass that writes the product's whole gradient.
//
// Replaces no TPU kernel. The JAX package rotates in plain jnp
// (splade_tpu/models/modernbert.py::apply_rope), which XLA fuses with the
// QKV split; run eagerly, the same chain is a cut, a negation, a
// concatenation, two broadcast f32 products and an f32 sum for each of q and
// k, a cast of each to bf16 before the attention, and about a dozen kernels
// in its backward (products, casts, two zero-filled slice gradients, the
// stack of the three gradients). With h = D / 2 and the tables c, s of the
// token's position:
//
//     forward:  y[:h]  = x[:h] * c[:h] - x[h:] * s[:h]
//               y[h:]  = x[h:] * c[h:] + x[:h] * s[h:]
//     backward: dx[:h] = g[:h] * c[:h] + g[h:] * s[h:]
//               dx[h:] = g[h:] * c[h:] - g[:h] * s[:h]
//
// Each product and each sum is rounded in f32 (__fmul_rn, __fadd_rn: nothing
// contracts into an FMA) and the result rounded once to bf16, so the forward
// equals bitwise the eager chain's f32 result (x * c + rotate_half(x) * s)
// cast to bf16, which is what the splash kernels were given before.
//
// What bounds it: bytes. The forward reads q and k of the product and writes
// them rotated, 4 * B*S*N*D * 2 bytes, plus the tables (f32, one row of D
// cos and D sin a token, or a position when the batch shares them): 245 MB
// at B=144 S=256 N=12 D=64 with per-row tables, 73 us at 3.35 TB/s. The
// backward reads dq, dk and dv and writes the [B, S, 3, N, D] gradient, 6 *
// B*S*N*D * 2 bytes plus the tables, 359 MB there, 107 us.
//
// Design: a thread owns one token, one pair of 16-byte vectors of a head
// row, elements 8l..8l+7 and h+8l..h+8l+7 (l < 4 at D = 64), which is
// exactly what its rotation pairs, and every SPLIT-th head row from its
// split j < SPLIT on: in the forward rows j, j + 4, ... of the token's 2N q
// and k rows, in the backward heads j, j + 4, ... of each of the three
// gradients. It loads its 32 table values once, into registers. The 16
// threads of a token lie in one warp, so the four splits' table loads are
// one broadcast: a table row is read once a token, not once a head. A
// warp covers 2 tokens, each row in two 64-byte runs, so every 32-byte
// sector it touches is used whole; each access is one 16-byte load or
// store. The split keeps a thread's walk short (6 rows forward, 3 heads
// backward at N = 12) and the grid wide: with a whole token a thread, the
// forward's 1,152 blocks at B=144 S=256 (64 registers, 8 blocks an SM)
// ran one full wave and a second of 96 blocks, 39% of its bound on an
// H100 (0.189 ms); split, 85% (0.087 ms), and the backward 85% (0.126 ms,
// from 78%; chip_smoke.py's check_rope).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int D = 64;                    // the head width the kernels take
constexpr int HALF = D / 2;
constexpr int VEC = 8;                   // bf16 values in 16 bytes
constexpr int LANES = HALF / VEC;        // threads a head row
constexpr int SPLIT = 4;                 // threads that share a token's rows
constexpr int THREADS = 128;
constexpr int TOKENS = THREADS / (LANES * SPLIT);  // tokens a block

struct Grad {                            // one gradient [B, S, N, D]
  const __nv_bfloat16* p;
  long long sb, ss, sn;                  // strides: batch row, position, head
};

__device__ __forceinline__ void unpack(const uint4& u, float (&f)[VEC]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack(const float (&f)[VEC]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i)
    h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return u;
}

__device__ __forceinline__ uint4 load16(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ void store16(__nv_bfloat16* p, const uint4& u) {
  *reinterpret_cast<uint4*>(p) = u;
}

// A table row's elements 8l..8l+7 (lo) and h+8l..h+8l+7 (hi).
__device__ __forceinline__ void load_table(const float* row, int lane,
                                           float (&lo)[VEC],
                                           float (&hi)[VEC]) {
  const float4* a = reinterpret_cast<const float4*>(row + lane * VEC);
  const float4* b = reinterpret_cast<const float4*>(row + HALF + lane * VEC);
  const float4 a0 = __ldg(a), a1 = __ldg(a + 1);
  const float4 b0 = __ldg(b), b1 = __ldg(b + 1);
  lo[0] = a0.x; lo[1] = a0.y; lo[2] = a0.z; lo[3] = a0.w;
  lo[4] = a1.x; lo[5] = a1.y; lo[6] = a1.z; lo[7] = a1.w;
  hi[0] = b0.x; hi[1] = b0.y; hi[2] = b0.z; hi[3] = b0.w;
  hi[4] = b1.x; hi[5] = b1.y; hi[6] = b1.z; hi[7] = b1.w;
}

// qkv [B, S, 3, N, D] contiguous; out [2, B, S, N, D]: q, then k.
__global__ void __launch_bounds__(THREADS) rope_qkv_fwd_kernel(
    const __nv_bfloat16* __restrict__ qkv, const float* __restrict__ cos_t,
    const float* __restrict__ sin_t, __nv_bfloat16* __restrict__ out,
    long long tokens, int S, int N, long long table_batch) {
  const long long t =
      (long long)blockIdx.x * TOKENS + threadIdx.x / (LANES * SPLIT);
  const int split = threadIdx.x / LANES % SPLIT;
  const int lane = threadIdx.x % LANES;
  if (t >= tokens) return;
  const long long b = t / S, s = t - b * S;
  float c_lo[VEC], c_hi[VEC], s_lo[VEC], s_hi[VEC];
  load_table(cos_t + b * table_batch + s * D, lane, c_lo, c_hi);
  load_table(sin_t + b * table_batch + s * D, lane, s_lo, s_hi);
  const long long heads = (long long)N * D;
  // the token's q heads and then its k heads: 2N rows in a row
  const __nv_bfloat16* src = qkv + t * 3 * heads + lane * VEC;
  __nv_bfloat16* dst = out + t * heads + lane * VEC;
#pragma unroll 3
  for (int r = split; r < 2 * N; r += SPLIT) {
    float x1[VEC], x2[VEC], y1[VEC], y2[VEC];
    unpack(load16(src + (long long)r * D), x1);
    unpack(load16(src + (long long)r * D + HALF), x2);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      y1[i] = __fadd_rn(__fmul_rn(x1[i], c_lo[i]), __fmul_rn(-x2[i], s_lo[i]));
      y2[i] = __fadd_rn(__fmul_rn(x2[i], c_hi[i]), __fmul_rn(x1[i], s_hi[i]));
    }
    const int part = r >= N;  // 0: q, 1: k
    __nv_bfloat16* row =
        dst + part * tokens * heads + (long long)(r - part * N) * D;
    store16(row, pack(y1));
    store16(row + HALF, pack(y2));
  }
}

// dq, dk, dv [B, S, N, D] through their strides; dqkv [B, S, 3, N, D]
// contiguous: dq and dk rotated back, dv copied into its slot.
__global__ void __launch_bounds__(THREADS) rope_qkv_bwd_kernel(
    Grad dq, Grad dk, Grad dv, const float* __restrict__ cos_t,
    const float* __restrict__ sin_t, __nv_bfloat16* __restrict__ dqkv,
    long long tokens, int S, int N, long long table_batch) {
  const long long t =
      (long long)blockIdx.x * TOKENS + threadIdx.x / (LANES * SPLIT);
  const int split = threadIdx.x / LANES % SPLIT;
  const int lane = threadIdx.x % LANES;
  if (t >= tokens) return;
  const long long b = t / S, s = t - b * S;
  float c_lo[VEC], c_hi[VEC], s_lo[VEC], s_hi[VEC];
  load_table(cos_t + b * table_batch + s * D, lane, c_lo, c_hi);
  load_table(sin_t + b * table_batch + s * D, lane, s_lo, s_hi);
  const long long heads = (long long)N * D;
  __nv_bfloat16* dst = dqkv + t * 3 * heads + lane * VEC;
#pragma unroll 3
  for (int h = split; h < N; h += SPLIT) {
#pragma unroll
    for (int part = 0; part < 2; ++part) {
      const Grad& g = part ? dk : dq;
      const __nv_bfloat16* src =
          g.p + b * g.sb + s * g.ss + h * g.sn + lane * VEC;
      float g1[VEC], g2[VEC], x1[VEC], x2[VEC];
      unpack(load16(src), g1);
      unpack(load16(src + HALF), g2);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        x1[i] = __fadd_rn(__fmul_rn(g1[i], c_lo[i]), __fmul_rn(g2[i], s_hi[i]));
        x2[i] = __fadd_rn(__fmul_rn(g2[i], c_hi[i]),
                          __fmul_rn(-g1[i], s_lo[i]));
      }
      __nv_bfloat16* row = dst + (long long)(part * N + h) * D;
      store16(row, pack(x1));
      store16(row + HALF, pack(x2));
    }
    const __nv_bfloat16* src =
        dv.p + b * dv.sb + s * dv.ss + h * dv.sn + lane * VEC;
    __nv_bfloat16* row = dst + (long long)(2 * N + h) * D;
    store16(row, load16(src));
    store16(row + HALF, load16(src + HALF));
  }
}

bool shape_ok(int B, int S, int N, int d) {
  return d == D && B >= 0 && S > 0 && N > 0;
}

unsigned blocks(long long tokens) {
  return (unsigned)((tokens + TOKENS - 1) / TOKENS);
}

}  // namespace

// qkv [B, S, 3, N, D] bf16 contiguous; cos, sin f32 [S, D] (table_batch 0)
// or [B, S, D] (table_batch S * D); out [2, B, S, N, D] bf16.
extern "C" int splade_rope_qkv_fwd(const void* qkv, const void* cos_t,
                                   const void* sin_t, void* out, int B,
                                   int S, int N, int d,
                                   long long table_batch, void* stream) {
  if (!shape_ok(B, S, N, d)) return (int)cudaErrorInvalidValue;
  const long long tokens = (long long)B * S;
  if (tokens == 0) return 0;
  rope_qkv_fwd_kernel<<<blocks(tokens), THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)qkv, (const float*)cos_t, (const float*)sin_t,
      (__nv_bfloat16*)out, tokens, S, N, table_batch);
  return (int)cudaGetLastError();
}

// dq, dk, dv bf16 [B, S, N, D], each with its strides (batch row, position,
// head; the last dimension contiguous); the tables as the forward's; dqkv
// [B, S, 3, N, D] bf16.
extern "C" int splade_rope_qkv_bwd(
    const void* dq, const void* dk, const void* dv, const void* cos_t,
    const void* sin_t, void* dqkv, long long dq_b, long long dq_s,
    long long dq_n, long long dk_b, long long dk_s, long long dk_n,
    long long dv_b, long long dv_s, long long dv_n, int B, int S, int N,
    int d, long long table_batch, void* stream) {
  if (!shape_ok(B, S, N, d)) return (int)cudaErrorInvalidValue;
  const long long tokens = (long long)B * S;
  if (tokens == 0) return 0;
  const Grad gq{(const __nv_bfloat16*)dq, dq_b, dq_s, dq_n};
  const Grad gk{(const __nv_bfloat16*)dk, dk_b, dk_s, dk_n};
  const Grad gv{(const __nv_bfloat16*)dv, dv_b, dv_s, dv_n};
  rope_qkv_bwd_kernel<<<blocks(tokens), THREADS, 0, (cudaStream_t)stream>>>(
      gq, gk, gv, (const float*)cos_t, (const float*)sin_t,
      (__nv_bfloat16*)dqkv, tokens, S, N, table_batch);
  return (int)cudaGetLastError();
}
