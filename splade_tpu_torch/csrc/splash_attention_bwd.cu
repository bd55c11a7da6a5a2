// Sliding-window + segment-id flash attention, backward (Hopper).
//
// Replaces the flash-style VJP of the Pallas splash attention behind
// splade_tpu/models/modernbert.py::_splash_attention (its dq kernel and its
// dk/dv kernel). With the forward's lse and delta[i] = sum_d dO[i,d]*out[i,d]
// (a plain f32 reduction in the wrapper, as JAX computes it outside its
// kernels), on the allowed (i, j) of the forward's mask:
//
//     p[i, j]  = exp(s[i, j] - lse[i])          s = (q . k^T) * scale
//     dp[i, j] = dO[i, :] . v[j, :]
//     ds[i, j] = p[i, j] * (dp[i, j] - delta[i])
//     dq = scale * ds . k      dk = scale * ds^T . q      dv = p^T . dO
//
// Two kernels, so that every sum has one owner and one order and nothing is
// added atomically (a repeated backward is bitwise equal):
//   * splash_bwd_dq_kernel: a block owns one (b, head, 64-query tile), walks
//     the kv tiles its mask reaches and keeps dq in WMMA accumulators;
//   * splash_bwd_dkv_kernel: a block owns one (b, head, 64-row kv tile),
//     walks the query tiles and keeps dk and dv in WMMA accumulators; it
//     computes s^T = k . q^T directly, so p^T and ds^T come out in the
//     layout the two products need.
// Both recompute s and dp, so the [B, N, S, S] tensors never reach device
// memory; local layers skip every tile wholly outside the band.
//
// What bounds them: at the V33 micro-batch (144 x 256, 12 heads) the dq
// kernel reads q, k, v, dO (bf16) and writes dq (f32), 340 MB or 0.10 ms at
// 3.35 TB/s, against 3 products (43 GFLOP on a global layer, 0.044 ms at 989
// TFLOP/s); the dk/dv kernel moves 453 MB (0.135 ms) against 4 products
// (0.059 ms): bytes, in both. This first version stages WMMA products through
// shared memory; p and ds are rounded to bf16 before the second products, as
// the forward rounds p.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "splash_attention.cuh"

namespace {

using namespace splash;

static_assert(HD == BT, "a warp's output rows reuse the score tile's stride");

// four operand tiles, the s and dp tiles (ds, or p and ds, in bf16 laid over
// them), and BT ints or floats each of segment ids, lse and delta
constexpr int SMEM_BYTES = 4 * TILE_BYTES + 2 * SCORE_BYTES + 3 * BT * 4;

__global__ void __launch_bounds__(THREADS)
splash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const int* __restrict__ seg,
                     const __nv_bfloat16* __restrict__ d_out,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dq,
                     Strides qs, Strides ks, Strides vs, int N, int S, int hw,
                     float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* dOs = Qs + BT * LDS;
  __nv_bfloat16* Ks = dOs + BT * LDS;
  __nv_bfloat16* Vs = Ks + BT * LDS;
  float* Ss = reinterpret_cast<float*>(smem + 4 * TILE_BYTES);
  float* Ds = Ss + BT * LDF;
  int* segk = reinterpret_cast<int*>(Ds + BT * LDF);

  const int q0 = blockIdx.x * BT, n = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row = lane >> 1, half = lane & 1;  // two lanes share a row
  const int qi = q0 + warp * 16 + row;
  const int* segb = seg + (size_t)b * S;
  const int sq = qi < S ? segb[qi] : 0;
  const size_t head = ((size_t)b * N + n) * S;
  const float lse_i = qi < S ? lse[head + qi] : 0.f;
  const float delta_i = qi < S ? delta[head + qi] : 0.f;
  const __nv_bfloat16* kb = k + (size_t)b * ks.b + (size_t)n * ks.n;
  const __nv_bfloat16* vb = v + (size_t)b * vs.b + (size_t)n * vs.n;
  // dO and dq are contiguous [B, S, N, HD]
  const long long row_stride = (long long)N * HD;
  const size_t tile0 = ((size_t)b * S * N + n) * HD;

  load_tile(Qs, q + (size_t)b * qs.b + (size_t)n * qs.n, qs.s, q0, S);
  load_tile(dOs, d_out + tile0, row_stride, q0, S);
  float* Sw = Ss + warp * 16 * LDF;
  float* Dw = Ds + warp * 16 * LDF;
  __nv_bfloat16* dSw = reinterpret_cast<__nv_bfloat16*>(Sw);
  Acc acc[HD / 16];
#pragma unroll
  for (int j = 0; j < HD / 16; ++j) nvcuda::wmma::fill_fragment(acc[j], 0.f);

  int lo, hi;
  tile_range(q0, S, hw, lo, hi);
  for (int t = lo; t <= hi; ++t) {
    const int k0 = t * BT;
    __syncthreads();  // the previous tile's products have read Ks and Vs
    load_tile(Ks, kb, ks.s, k0, S);
    load_tile(Vs, vb, vs.s, k0, S);
    if (tid < BT) segk[tid] = k0 + tid < S ? segb[k0 + tid] : 0;
    __syncthreads();

    rows_times_transposed(Qs + warp * 16 * LDS, Ks, Sw);   // s  = q . k^T
    rows_times_transposed(dOs + warp * 16 * LDS, Vs, Dw);  // dp = dO . v^T
    __syncwarp();

    float r[HALF];
    const float* srow = Sw + row * LDF + half * HALF;
    const float* drow = Dw + row * LDF + half * HALF;
#pragma unroll
    for (int j = 0; j < HALF; ++j) {
      const int c = half * HALF + j;
      const float p = allowed(qi, k0 + c, sq, segk[c], S, hw)
                          ? __expf(srow[j] * scale - lse_i) : 0.f;
      r[j] = p * (drow[j] - delta_i);
    }
    __syncwarp();  // both lanes of a row have read s before ds lands on it
    __nv_bfloat16* dsrow = dSw + row * LDP + half * HALF;
#pragma unroll
    for (int j = 0; j < HALF; ++j) dsrow[j] = __float2bfloat16(r[j]);
    __syncwarp();

    accumulate(dSw, Ks, acc);  // dq += ds . k
    __syncwarp();
  }
  store_rows(acc, scale, Sw,
             dq + tile0 + (size_t)(q0 + warp * 16) * row_stride, row_stride,
             S - (q0 + warp * 16));
}

__global__ void __launch_bounds__(THREADS)
splash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const int* __restrict__ seg,
                      const __nv_bfloat16* __restrict__ d_out,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ dk,
                      float* __restrict__ dv, Strides qs, Strides ks,
                      Strides vs, int N, int S, int hw, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = Ks + BT * LDS;
  __nv_bfloat16* Qs = Vs + BT * LDS;
  __nv_bfloat16* dOs = Qs + BT * LDS;
  float* Ss = reinterpret_cast<float*>(smem + 4 * TILE_BYTES);
  float* Ds = Ss + BT * LDF;
  int* segq = reinterpret_cast<int*>(Ds + BT * LDF);
  float* lse_s = reinterpret_cast<float*>(segq + BT);
  float* delta_s = lse_s + BT;

  const int k0 = blockIdx.x * BT, n = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row = lane >> 1, half = lane & 1;  // two lanes share a kv row
  const int kj = k0 + warp * 16 + row;
  const int* segb = seg + (size_t)b * S;
  const int sk = kj < S ? segb[kj] : 0;
  const size_t head = ((size_t)b * N + n) * S;
  const __nv_bfloat16* qb = q + (size_t)b * qs.b + (size_t)n * qs.n;
  const long long row_stride = (long long)N * HD;
  const size_t tile0 = ((size_t)b * S * N + n) * HD;

  load_tile(Ks, k + (size_t)b * ks.b + (size_t)n * ks.n, ks.s, k0, S);
  load_tile(Vs, v + (size_t)b * vs.b + (size_t)n * vs.n, vs.s, k0, S);
  float* Sw = Ss + warp * 16 * LDF;
  float* Dw = Ds + warp * 16 * LDF;
  __nv_bfloat16* Pw = reinterpret_cast<__nv_bfloat16*>(Sw);
  __nv_bfloat16* dSw = reinterpret_cast<__nv_bfloat16*>(Dw);
  Acc acc_k[HD / 16], acc_v[HD / 16];
#pragma unroll
  for (int j = 0; j < HD / 16; ++j) {
    nvcuda::wmma::fill_fragment(acc_k[j], 0.f);
    nvcuda::wmma::fill_fragment(acc_v[j], 0.f);
  }

  int lo, hi;
  tile_range(k0, S, hw, lo, hi);
  for (int t = lo; t <= hi; ++t) {
    const int q0 = t * BT;
    __syncthreads();  // the previous tile's products have read Qs and dOs
    load_tile(Qs, qb, qs.s, q0, S);
    load_tile(dOs, d_out + tile0, row_stride, q0, S);
    if (tid < BT) {
      const bool in = q0 + tid < S;
      segq[tid] = in ? segb[q0 + tid] : 0;
      lse_s[tid] = in ? lse[head + q0 + tid] : 0.f;
      delta_s[tid] = in ? delta[head + q0 + tid] : 0.f;
    }
    __syncthreads();

    rows_times_transposed(Ks + warp * 16 * LDS, Qs, Sw);   // s^T  = k . q^T
    rows_times_transposed(Vs + warp * 16 * LDS, dOs, Dw);  // dp^T = v . dO^T
    __syncwarp();

    float r[HALF];
    const float* srow = Sw + row * LDF + half * HALF;
    const float* drow = Dw + row * LDF + half * HALF;
#pragma unroll
    for (int j = 0; j < HALF; ++j) {
      const int c = half * HALF + j;
      r[j] = allowed(q0 + c, kj, segq[c], sk, S, hw)
                 ? __expf(srow[j] * scale - lse_s[c]) : 0.f;
    }
    __syncwarp();  // both lanes of a row have read s^T before p^T lands on it
    __nv_bfloat16* prow = Pw + row * LDP + half * HALF;
#pragma unroll
    for (int j = 0; j < HALF; ++j) {
      prow[j] = __float2bfloat16(r[j]);
      r[j] *= drow[j] - delta_s[half * HALF + j];  // ds^T from the f32 p
    }
    __syncwarp();  // ... and dp^T before ds^T lands on it
    __nv_bfloat16* dsrow = dSw + row * LDP + half * HALF;
#pragma unroll
    for (int j = 0; j < HALF; ++j) dsrow[j] = __float2bfloat16(r[j]);
    __syncwarp();

    accumulate(Pw, dOs, acc_v);  // dv += p^T . dO
    accumulate(dSw, Qs, acc_k);  // dk += ds^T . q
    __syncwarp();
  }
  const size_t rows0 = tile0 + (size_t)(k0 + warp * 16) * row_stride;
  store_rows(acc_v, 1.f, Sw, dv + rows0, row_stride, S - (k0 + warp * 16));
  store_rows(acc_k, scale, Dw, dk + rows0, row_stride, S - (k0 + warp * 16));
}

int opt_in(const void* kernel) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
}

}  // namespace

// q, k, v as the forward takes them (bf16 [B, N, S, 64] views read through
// their strides); seg [B, S] int32; d_out [B, S, N, 64] bf16, lse and delta
// [B, N, S] f32, contiguous; dq [B, S, N, 64] f32, every element written.
extern "C" int splade_splash_attn_bwd_dq(
    const void* q, const void* k, const void* v, const void* seg,
    const void* d_out, const void* lse, const void* delta, void* dq,
    long long q_b, long long q_n, long long q_s, long long k_b, long long k_n,
    long long k_s, long long v_b, long long v_n, long long v_s, int B, int N,
    int S, int D, int half_window, float scale, void* stream) {
  if (D != HD || half_window < 0) return (int)cudaErrorInvalidValue;
  const int err = opt_in((const void*)splash_bwd_dq_kernel);
  if (err != 0) return err;
  dim3 grid((S + BT - 1) / BT, N, B);
  splash_bwd_dq_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const int*)seg, (const __nv_bfloat16*)d_out,
      (const float*)lse, (const float*)delta, (float*)dq,
      Strides{q_b, q_n, q_s}, Strides{k_b, k_n, k_s}, Strides{v_b, v_n, v_s},
      N, S, half_window, scale);
  return (int)cudaGetLastError();
}

// The same inputs; dk and dv [B, S, N, 64] f32, every element written.
extern "C" int splade_splash_attn_bwd_dkv(
    const void* q, const void* k, const void* v, const void* seg,
    const void* d_out, const void* lse, const void* delta, void* dk, void* dv,
    long long q_b, long long q_n, long long q_s, long long k_b, long long k_n,
    long long k_s, long long v_b, long long v_n, long long v_s, int B, int N,
    int S, int D, int half_window, float scale, void* stream) {
  if (D != HD || half_window < 0) return (int)cudaErrorInvalidValue;
  const int err = opt_in((const void*)splash_bwd_dkv_kernel);
  if (err != 0) return err;
  dim3 grid((S + BT - 1) / BT, N, B);
  splash_bwd_dkv_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const int*)seg, (const __nv_bfloat16*)d_out,
      (const float*)lse, (const float*)delta, (float*)dk, (float*)dv,
      Strides{q_b, q_n, q_s}, Strides{k_b, k_n, k_s}, Strides{v_b, v_n, v_s},
      N, S, half_window, scale);
  return (int)cudaGetLastError();
}
