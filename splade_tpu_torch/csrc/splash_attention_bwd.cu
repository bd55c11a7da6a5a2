// Sliding-window + segment-id flash attention, backward (Hopper).
//
// Replaces the flash-style VJP of the Pallas splash attention behind
// splade_tpu/models/modernbert.py::_splash_attention (its dq kernel and its
// dk/dv kernel). With the forward's out and lse, on the allowed (i, j) of the
// forward's mask:
//
//     delta[i] = sum_d dO[i, d] * out[i, d]
//     p[i, j]  = exp(s[i, j] - lse[i])          s = (q . k^T) * scale
//     dp[i, j] = dO[i, :] . v[j, :]
//     ds[i, j] = p[i, j] * (dp[i, j] - delta[i])
//     dq = scale * ds . k      dk = scale * ds^T . q      dv = p^T . dO
//
// Two kernels, launched in this order on one stream, so that every sum has
// one owner and one order and nothing is added atomically (a repeated
// backward is bitwise equal):
//   * splash_bwd_dq_kernel: a block owns one (b, head, 64-query tile). It
//     first computes delta for its rows from the bf16 dO and out (two lanes
//     a row, 32 products each in order, then the pair's sum) and writes it
//     [B, N, S] f32 for the dk/dv kernel; then walks the kv tiles its mask
//     reaches with dq in registers. With dq == nullptr it stops after delta
//     (the backward of a q that needs no gradient).
//   * splash_bwd_dkv_kernel: a block owns one (b, head, 64-row kv tile),
//     walks the query tiles with dk and dv in registers, and computes
//     s^T = k . q^T directly, so p^T and ds^T are A operands.
// Both recompute s and dp, so the [B, N, S, S] tensors never reach device
// memory; local layers skip every tile wholly outside the band.
//
// What bounds them: at the V33 micro-batch (144 x 256, 12 heads) the dq
// kernel reads q, k, v, dO and out (bf16) and writes dq (f32 on the training
// path) and delta, 400 MB or 0.119 ms at 3.35 TB/s, against 3 products (at
// most 43 GFLOP on a global layer, 0.044 ms at 989 TFLOP/s); the dk/dv kernel
// reads q, k, v and dO and writes dk (f32) and dv (bf16), 400 MB again,
// against 4 products (0.059 ms): bytes, in both. What holds them above that
// is the work between the products and its latency. So everything between
// the products stays in registers: each warp owns 16 rows and runs bf16
// mma.sync m16n8k16 (mma_sm90.cuh), whose documented fragment layout tells
// each lane the rows and columns it holds; the mask, exp, - delta and the
// bf16 rounding run on the f32 accumulator fragments in place, and a
// product's result is the next product's A operand (p and ds are rounded to
// bf16 before the second products, as the forward rounds p). The mask is two
// tests (in_mask: positions past S carry segment ids nothing else has) and p
// one ex2 of an FMA, since per element that work costs as much as the
// products. The walked tiles are double-buffered with cp.async: the loads of
// tile t+1 are in flight while tile t is multiplied. Operand tiles are padded
// to 72 values a row, so every ldmatrix is free of bank conflicts.
// __launch_bounds__(128, 3) holds each kernel to 168 registers, 3 blocks (12
// warps) an SM. Gradients are written in the dtype autograd returns (f32 or
// bf16, rounded to nearest from the f32 sums, as a cast would round them).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "splash_attention.cuh"

namespace {

using namespace splash;

static_assert(HD == 64 && BT == 64, "fragment loops are unrolled for 64");
constexpr int NT = 8;  // n8 tiles across 64 columns
constexpr int KS = 4;  // k16 steps across a depth of 64

// dq kernel: the two buffers of the walked K and V tiles (q and dO stage in
// the second pair before the walk), the walked tiles' segment ids
constexpr int DQ_SMEM_BYTES = 4 * TILE_BYTES + 2 * BT * 4;
// dk/dv kernel: the owned K and V tiles, two buffers of the walked Q and dO
// tiles, and the walked tiles' segment ids, lse and delta
constexpr int DKV_SMEM_BYTES = 6 * TILE_BYTES + 2 * 3 * BT * 4;

template <typename G>
__global__ void __launch_bounds__(THREADS, 3)
splash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const int* __restrict__ seg,
                     const __nv_bfloat16* __restrict__ d_out,
                     const __nv_bfloat16* __restrict__ out,
                     const float* __restrict__ lse, float* __restrict__ delta,
                     G* __restrict__ dq, Strides qs, Strides ks, Strides vs,
                     int N, int S, int hw, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* tiles = reinterpret_cast<__nv_bfloat16*>(smem);  // K0 V0 K1 V1
  int* segk = reinterpret_cast<int*>(smem + 4 * TILE_BYTES);      // [2][BT]

  const int q0 = blockIdx.x * BT, n = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = 2 * (lane & 3);
  const int* segb = seg + (size_t)b * S;
  const size_t head = ((size_t)b * N + n) * S;
  // dO, out and dq are contiguous [B, S, N, HD]
  const long long row_stride = (long long)N * HD;
  const size_t tile0 = ((size_t)b * S * N + n) * HD;
  const __nv_bfloat16* kb = k + (size_t)b * ks.b + (size_t)n * ks.n;
  const __nv_bfloat16* vb = v + (size_t)b * vs.b + (size_t)n * vs.n;
  int lo, hi;
  tile_range(q0, S, hw, lo, hi);

  auto load_kv = [&](int t, int buf) {
    load_tile_async(tiles + (2 * buf) * BT * LDS, kb, ks.s, t * BT, S);
    load_tile_async(tiles + (2 * buf + 1) * BT * LDS, vb, vs.s, t * BT, S);
    load_row_async(segk + buf * BT, segb, t * BT, S, 0, COL_PAST_S);
  };
  if (dq != nullptr) {  // q and dO into the second buffers, tile lo the first
    load_tile_async(tiles + 2 * BT * LDS, q + (size_t)b * qs.b +
                    (size_t)n * qs.n, qs.s, q0, S);
    load_tile_async(tiles + 3 * BT * LDS, d_out + tile0, row_stride, q0, S);
    load_kv(lo, 0);
    cp_async_commit();
  }

  // delta of the block's rows while those copies fly: lanes 2r and 2r+1 of
  // a warp own its row r, 32 columns each
  float dsum = 0.f;
  {
    const int qi = q0 + warp * 16 + (lane >> 1);
    if (qi < S) {
      const size_t at = tile0 + (size_t)qi * row_stride + (lane & 1) * 32;
      const uint4* pd = reinterpret_cast<const uint4*>(d_out + at);
      const uint4* po = reinterpret_cast<const uint4*>(out + at);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint4 a = pd[j], o = po[j];
        const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&o);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 af = __bfloat1622float2(a2[e]);
          const float2 of = __bfloat1622float2(o2[e]);
          dsum = fmaf(af.x, of.x, dsum);
          dsum = fmaf(af.y, of.y, dsum);
        }
      }
    }
    dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);
    if ((lane & 1) == 0 && qi < S) delta[head + qi] = dsum;
  }
  if (dq == nullptr) return;
  // this lane's fragment rows g and g+8 of the warp's 16
  const float delta0 = __shfl_sync(0xffffffffu, dsum, 2 * g);
  const float delta1 = __shfl_sync(0xffffffffu, dsum, 2 * g + 16);
  const int qi0 = q0 + warp * 16 + g, qi1 = qi0 + 8;
  const int sq0 = qi0 < S ? segb[qi0] : ROW_PAST_S;
  const int sq1 = qi1 < S ? segb[qi1] : ROW_PAST_S;
  // p = 2^(s * scale * log2(e) - lse * log2(e))
  const float sl2 = scale * LOG2E;
  const float ml0 = qi0 < S ? lse[head + qi0] * LOG2E : 0.f;
  const float ml1 = qi1 < S ? lse[head + qi1] * LOG2E : 0.f;
  const int hwe = hw ? hw : S;

  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[KS][4], df[KS][4];  // A fragments of the warp's q and dO rows
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    load_a(qf[kk], tiles + 2 * BT * LDS, warp * 16, kk * 16);
    load_a(df[kk], tiles + 3 * BT * LDS, warp * 16, kk * 16);
  }
  __syncthreads();  // the second buffers are free for tile lo+1

  float acc[NT][4] = {};
  for (int t = lo; t <= hi; ++t) {
    const int buf = (t - lo) & 1;
    if (t < hi) load_kv(t + 1, buf ^ 1);
    cp_async_commit();  // an empty group on the last tile
    cp_async_wait<1>();  // tile t has landed
    __syncthreads();
    const __nv_bfloat16* Kt = tiles + (2 * buf) * BT * LDS;
    const __nv_bfloat16* Vt = Kt + BT * LDS;
    const int* sk = segk + buf * BT;
    const int k0 = t * BT;

    float s[NT][4] = {}, dp[NT][4] = {};
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int nn = 0; nn < NT / 2; ++nn) {
        uint32_t bk[4], bv[4];
        load_b_nk(bk, Kt, nn * 16, kk * 16);  // s  = q . k^T
        mma16816(s[2 * nn], qf[kk], bk[0], bk[1]);
        mma16816(s[2 * nn + 1], qf[kk], bk[2], bk[3]);
        load_b_nk(bv, Vt, nn * 16, kk * 16);  // dp = dO . v^T
        mma16816(dp[2 * nn], df[kk], bv[0], bv[1]);
        mma16816(dp[2 * nn + 1], df[kk], bv[2], bv[3]);
      }
    }
    // ds = p * (dp - delta) in place of s, 0 off the mask
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int d = qi0 - (k0 + 8 * j + c);  // row g, column 8j + c
      const int2 skj = *reinterpret_cast<const int2*>(sk + 8 * j + c);
      s[j][0] = in_mask(sq0, skj.x, d, hwe)
                    ? ex2(fmaf(s[j][0], sl2, -ml0)) * (dp[j][0] - delta0)
                    : 0.f;
      s[j][1] = in_mask(sq0, skj.y, d - 1, hwe)
                    ? ex2(fmaf(s[j][1], sl2, -ml0)) * (dp[j][1] - delta0)
                    : 0.f;
      s[j][2] = in_mask(sq1, skj.x, d + 8, hwe)
                    ? ex2(fmaf(s[j][2], sl2, -ml1)) * (dp[j][2] - delta1)
                    : 0.f;
      s[j][3] = in_mask(sq1, skj.y, d + 7, hwe)
                    ? ex2(fmaf(s[j][3], sl2, -ml1)) * (dp[j][3] - delta1)
                    : 0.f;
    }
    // dq += ds . k, ds rounded to bf16
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[4];
      a_from_c(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int nn = 0; nn < NT / 2; ++nn) {
        uint32_t bk[4];
        load_b_kn(bk, Kt, kk * 16, nn * 16);
        mma16816(acc[2 * nn], a, bk[0], bk[1]);
        mma16816(acc[2 * nn + 1], a, bk[2], bk[3]);
      }
    }
    __syncthreads();  // every warp is done with buffer buf
  }
  G* row0 = dq + tile0 + (size_t)qi0 * row_stride;
  G* row1 = row0 + 8 * row_stride;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (qi0 < S) store_pair(row0 + 8 * j + c, acc[j][0] * scale,
                            acc[j][1] * scale);
    if (qi1 < S) store_pair(row1 + 8 * j + c, acc[j][2] * scale,
                            acc[j][3] * scale);
  }
}

template <typename GK, typename GV>
__global__ void __launch_bounds__(THREADS, 3)
splash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const int* __restrict__ seg,
                      const __nv_bfloat16* __restrict__ d_out,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, GK* __restrict__ dk,
                      GV* __restrict__ dv, Strides qs, Strides ks, Strides vs,
                      int N, int S, int hw, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  // K, V, then two buffers of (Q, dO)
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = Ks + BT * LDS;
  __nv_bfloat16* walked = Vs + BT * LDS;
  int* segq = reinterpret_cast<int*>(smem + 6 * TILE_BYTES);  // [2][BT]
  float* lse_s = reinterpret_cast<float*>(segq + 2 * BT);      // [2][BT]
  float* delta_s = lse_s + 2 * BT;                             // [2][BT]

  const int k0 = blockIdx.x * BT, n = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = 2 * (lane & 3);
  const int* segb = seg + (size_t)b * S;
  const size_t head = ((size_t)b * N + n) * S;
  const long long row_stride = (long long)N * HD;
  const size_t tile0 = ((size_t)b * S * N + n) * HD;
  const __nv_bfloat16* qb = q + (size_t)b * qs.b + (size_t)n * qs.n;
  const int kj0 = k0 + warp * 16 + g, kj1 = kj0 + 8;
  const int sk0 = kj0 < S ? segb[kj0] : ROW_PAST_S;
  const int sk1 = kj1 < S ? segb[kj1] : ROW_PAST_S;
  const float sl2 = scale * LOG2E;
  const int hwe = hw ? hw : S;
  int lo, hi;
  tile_range(k0, S, hw, lo, hi);

  auto load_q = [&](int t, int buf) {
    __nv_bfloat16* dst = walked + 2 * buf * BT * LDS;
    load_tile_async(dst, qb, qs.s, t * BT, S);
    load_tile_async(dst + BT * LDS, d_out + tile0, row_stride, t * BT, S);
    load_row_async(segq + buf * BT, segb, t * BT, S, 0, COL_PAST_S);
    load_row_async(lse_s + buf * BT, lse + head, t * BT, S, BT, 0u);
    load_row_async(delta_s + buf * BT, delta + head, t * BT, S, 0, 0u);
  };
  load_tile_async(Ks, k + (size_t)b * ks.b + (size_t)n * ks.n, ks.s, k0, S);
  load_tile_async(Vs, v + (size_t)b * vs.b + (size_t)n * vs.n, vs.s, k0, S);
  load_q(lo, 0);
  cp_async_commit();

  float acc_k[NT][4] = {}, acc_v[NT][4] = {};
  for (int t = lo; t <= hi; ++t) {
    const int buf = (t - lo) & 1;
    if (t < hi) load_q(t + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* Qt = walked + 2 * buf * BT * LDS;
    const __nv_bfloat16* dOt = Qt + BT * LDS;
    const int* sq = segq + buf * BT;
    const float* ls = lse_s + buf * BT;
    const float* dl = delta_s + buf * BT;
    const int q0 = t * BT;

    // p^T = exp(s^T - lse), s^T = k . q^T
    float p[NT][4] = {};
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[4];
      load_a(a, Ks, warp * 16, kk * 16);
#pragma unroll
      for (int nn = 0; nn < NT / 2; ++nn) {
        uint32_t bq[4];
        load_b_nk(bq, Qt, nn * 16, kk * 16);
        mma16816(p[2 * nn], a, bq[0], bq[1]);
        mma16816(p[2 * nn + 1], a, bq[2], bq[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int d = q0 + 8 * j + c - kj0;  // column 8j + c, row g
      const int2 sqj = *reinterpret_cast<const int2*>(sq + 8 * j + c);
      const float2 lj = *reinterpret_cast<const float2*>(ls + 8 * j + c);
      const float m0 = lj.x * LOG2E, m1 = lj.y * LOG2E;
      p[j][0] = in_mask(sqj.x, sk0, d, hwe)
                    ? ex2(fmaf(p[j][0], sl2, -m0)) : 0.f;
      p[j][1] = in_mask(sqj.y, sk0, d + 1, hwe)
                    ? ex2(fmaf(p[j][1], sl2, -m1)) : 0.f;
      p[j][2] = in_mask(sqj.x, sk1, d - 8, hwe)
                    ? ex2(fmaf(p[j][2], sl2, -m0)) : 0.f;
      p[j][3] = in_mask(sqj.y, sk1, d - 7, hwe)
                    ? ex2(fmaf(p[j][3], sl2, -m1)) : 0.f;
    }
    // dv += p^T . dO, p rounded to bf16
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[4];
      a_from_c(a, p[2 * kk], p[2 * kk + 1]);
#pragma unroll
      for (int nn = 0; nn < NT / 2; ++nn) {
        uint32_t bd[4];
        load_b_kn(bd, dOt, kk * 16, nn * 16);
        mma16816(acc_v[2 * nn], a, bd[0], bd[1]);
        mma16816(acc_v[2 * nn + 1], a, bd[2], bd[3]);
      }
    }
    // dp^T = v . dO^T
    float dp[NT][4] = {};
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[4];
      load_a(a, Vs, warp * 16, kk * 16);
#pragma unroll
      for (int nn = 0; nn < NT / 2; ++nn) {
        uint32_t bd[4];
        load_b_nk(bd, dOt, nn * 16, kk * 16);
        mma16816(dp[2 * nn], a, bd[0], bd[1]);
        mma16816(dp[2 * nn + 1], a, bd[2], bd[3]);
      }
    }
    // ds^T = p^T * (dp^T - delta) from the f32 p, in place of p
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float2 dj = *reinterpret_cast<const float2*>(dl + 8 * j + c);
      p[j][0] *= dp[j][0] - dj.x;
      p[j][1] *= dp[j][1] - dj.y;
      p[j][2] *= dp[j][2] - dj.x;
      p[j][3] *= dp[j][3] - dj.y;
    }
    // dk += ds^T . q, ds rounded to bf16
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[4];
      a_from_c(a, p[2 * kk], p[2 * kk + 1]);
#pragma unroll
      for (int nn = 0; nn < NT / 2; ++nn) {
        uint32_t bq[4];
        load_b_kn(bq, Qt, kk * 16, nn * 16);
        mma16816(acc_k[2 * nn], a, bq[0], bq[1]);
        mma16816(acc_k[2 * nn + 1], a, bq[2], bq[3]);
      }
    }
    __syncthreads();  // every warp is done with buffer buf
  }
  const size_t at0 = tile0 + (size_t)kj0 * row_stride;
  const size_t at1 = at0 + 8 * row_stride;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (kj0 < S) {
      store_pair(dk + at0 + 8 * j + c, acc_k[j][0] * scale,
                 acc_k[j][1] * scale);
      store_pair(dv + at0 + 8 * j + c, acc_v[j][0], acc_v[j][1]);
    }
    if (kj1 < S) {
      store_pair(dk + at1 + 8 * j + c, acc_k[j][2] * scale,
                 acc_k[j][3] * scale);
      store_pair(dv + at1 + 8 * j + c, acc_v[j][2], acc_v[j][3]);
    }
  }
}

template <typename Kernel>
int launch(Kernel kernel, int bytes, dim3 grid, cudaStream_t stream,
           const void** args) {
  // above 48 KB, dynamic shared memory needs the kernel's opt-in
  int err = (int)cudaFuncSetAttribute(
      (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != 0) return err;
  err = (int)cudaLaunchKernel((const void*)kernel, grid, dim3(THREADS),
                              const_cast<void**>(args), bytes, stream);
  return err != 0 ? err : (int)cudaGetLastError();
}

}  // namespace

// q, k, v as the forward takes them (bf16 [B, N, S, 64] views read through
// their strides); seg [B, S] int32; d_out and out [B, S, N, 64] bf16 and lse
// [B, N, S] f32, contiguous. Writes delta [B, N, S] f32 and, unless dq is
// null, dq [B, S, N, 64] (bf16 if dq_bf16, else f32); every element of each.
extern "C" int splade_splash_attn_bwd_dq(
    const void* q, const void* k, const void* v, const void* seg,
    const void* d_out, const void* out, const void* lse, void* delta, void* dq,
    int dq_bf16, long long q_b, long long q_n, long long q_s, long long k_b,
    long long k_n, long long k_s, long long v_b, long long v_n, long long v_s,
    int B, int N, int S, int D, int half_window, float scale, void* stream) {
  if (D != HD || half_window < 0) return (int)cudaErrorInvalidValue;
  Strides qs{q_b, q_n, q_s}, ks{k_b, k_n, k_s}, vs{v_b, v_n, v_s};
  const void* args[] = {&q,  &k,  &v,  &seg, &d_out, &out, &lse, &delta,
                        &dq, &qs, &ks, &vs, &N,    &S,   &half_window,
                        &scale};
  const dim3 grid((S + BT - 1) / BT, N, B);
  return dq_bf16
             ? launch(splash_bwd_dq_kernel<__nv_bfloat16>, DQ_SMEM_BYTES,
                      grid, (cudaStream_t)stream, args)
             : launch(splash_bwd_dq_kernel<float>, DQ_SMEM_BYTES, grid,
                      (cudaStream_t)stream, args);
}

// The same q, k, v, seg, d_out and lse, and the dq kernel's delta; writes dk
// and dv [B, S, N, 64] (bf16 where dk_bf16 / dv_bf16, else f32), every
// element. Launch it after the dq kernel, on the same stream.
extern "C" int splade_splash_attn_bwd_dkv(
    const void* q, const void* k, const void* v, const void* seg,
    const void* d_out, const void* lse, const void* delta, void* dk, void* dv,
    int dk_bf16, int dv_bf16, long long q_b, long long q_n, long long q_s,
    long long k_b, long long k_n, long long k_s, long long v_b, long long v_n,
    long long v_s, int B, int N, int S, int D, int half_window, float scale,
    void* stream) {
  if (D != HD || half_window < 0) return (int)cudaErrorInvalidValue;
  Strides qs{q_b, q_n, q_s}, ks{k_b, k_n, k_s}, vs{v_b, v_n, v_s};
  const void* args[] = {&q,  &k,  &v,  &seg, &d_out, &lse, &delta, &dk,
                        &dv, &qs, &ks, &vs,  &N,     &S,   &half_window,
                        &scale};
  const dim3 grid((S + BT - 1) / BT, N, B);
  const cudaStream_t st = (cudaStream_t)stream;
  using bf = __nv_bfloat16;
  if (dk_bf16 && dv_bf16)
    return launch(splash_bwd_dkv_kernel<bf, bf>, DKV_SMEM_BYTES, grid, st,
                  args);
  if (dk_bf16)
    return launch(splash_bwd_dkv_kernel<bf, float>, DKV_SMEM_BYTES, grid, st,
                  args);
  if (dv_bf16)
    return launch(splash_bwd_dkv_kernel<float, bf>, DKV_SMEM_BYTES, grid, st,
                  args);
  return launch(splash_bwd_dkv_kernel<float, float>, DKV_SMEM_BYTES, grid, st,
                args);
}
