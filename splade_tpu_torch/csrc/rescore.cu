// Exact phase-2 rescore of two-phase postings search (Hopper).
//
// Replaces both splade_tpu/ops/rescore_kernel.py::_rescore_kernel (public
// rescore_match) and ::_rescore_kernel_rows (public rescore_match_rows): the
// two differ only in a TPU lane layout and compute the same function
//
//     score[b, c] = sum_m w[doc, m] * sum_t q_val[b, t] * [terms[doc, m] == q_idx[b, t]]
//     doc = cand[b, c],  w = float(int8 d_vals) * d_scale[doc]
//
// Duplicate query terms accumulate; pad doc slots (id V, value 0) and pad
// query slots (value 0) contribute nothing.
//
// The TPU formulation streamed a gathered [B, M, C] block through a
// compare/select chain because a TPU has no fast scalar gather. Hopper has
// one, so here each thread takes one candidate, walks its doc-major row
// (terms int32, values int8) straight from device memory (the candidate-row
// gather that the JAX wrapper did in XLA is fused in), and scans the block's
// query, staged once in shared memory, for every slot. Term ids are held as
// int32 on the device (the index's uint16 host layout is widened at build).
//
// What bounds it: the bytes of the gathered rows (B*C*M*5 ~ 10.2 MB at
// B=32, C=1000, M=64), ~3 us at 3.35 TB/s. The T-term scan costs B*C*M*T
// compares (1.3e8 at T=64), served by shared-memory broadcasts. With one
// thread per candidate only B*C threads are in flight (32,000 at that
// shape, ~240 per SM), so this simple version is latency-bound well above
// the bytes bound; spreading each candidate's row over several lanes is
// the next step.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int MAX_T = 256;

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
rescore_kernel(const int* __restrict__ d_terms,
               const int8_t* __restrict__ d_vals,
               const float* __restrict__ d_scale,
               const int* __restrict__ q_idx, const float* __restrict__ q_val,
               const int* __restrict__ cand, float* __restrict__ out, int N,
               int C, int M, int T) {
  __shared__ int qi_s[MAX_T];
  __shared__ float qv_s[MAX_T];
  const int b = blockIdx.y;
  for (int t = threadIdx.x; t < T; t += THREADS) {
    qi_s[t] = q_idx[(size_t)b * T + t];
    qv_s[t] = q_val[(size_t)b * T + t];
  }
  __syncthreads();
  const int c = blockIdx.x * THREADS + threadIdx.x;
  if (c >= C) return;
  // out-of-range ids clamp, as XLA's gather does
  const int doc = min(max(cand[(size_t)b * C + c], 0), N - 1);
  const int* tr = d_terms + (size_t)doc * M;
  const int8_t* vr = d_vals + (size_t)doc * M;
  const float sc = d_scale[doc];
  float acc = 0.f;
  if (VEC) {
    // M % 4 == 0: 16-byte term loads and 4-byte value loads
    for (int m = 0; m < M; m += 4) {
      const int4 tv = *reinterpret_cast<const int4*>(tr + m);
      const char4 vv = *reinterpret_cast<const char4*>(vr + m);
      const int terms[4] = {tv.x, tv.y, tv.z, tv.w};
      const float ws[4] = {(float)vv.x * sc, (float)vv.y * sc,
                           (float)vv.z * sc, (float)vv.w * sc};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float qs = 0.f;
        for (int t = 0; t < T; ++t) qs += (qi_s[t] == terms[j]) ? qv_s[t] : 0.f;
        acc += qs * ws[j];
      }
    }
  } else {
    for (int m = 0; m < M; ++m) {
      const int term = tr[m];
      const float wv = (float)vr[m] * sc;
      float qs = 0.f;
      for (int t = 0; t < T; ++t) qs += (qi_s[t] == term) ? qv_s[t] : 0.f;
      acc += qs * wv;
    }
  }
  out[(size_t)b * C + c] = acc;
}

}  // namespace

// d_terms [N,M] int32, d_vals [N,M] int8, d_scale [N] f32, q_idx [B,T] int32,
// q_val [B,T] f32, cand [B,C] int32, out [B,C] f32. T <= 256 (checked by the
// wrapper).
extern "C" int splade_rescore_match(const void* d_terms, const void* d_vals,
                                    const void* d_scale, const void* q_idx,
                                    const void* q_val, const void* cand,
                                    void* out, int N, int B, int C, int M,
                                    int T, void* stream) {
  dim3 grid((C + THREADS - 1) / THREADS, B);
  cudaStream_t st = (cudaStream_t)stream;
  if (M % 4 == 0)
    rescore_kernel<true><<<grid, THREADS, 0, st>>>(
        (const int*)d_terms, (const int8_t*)d_vals, (const float*)d_scale,
        (const int*)q_idx, (const float*)q_val, (const int*)cand,
        (float*)out, N, C, M, T);
  else
    rescore_kernel<false><<<grid, THREADS, 0, st>>>(
        (const int*)d_terms, (const int8_t*)d_vals, (const float*)d_scale,
        (const int*)q_idx, (const float*)q_val, (const int*)cand,
        (float*)out, N, C, M, T);
  return (int)cudaGetLastError();
}
