// Sliding-window + segment-id flash attention, forward (Hopper).
//
// Replaces the Pallas splash multi-head attention that
// splade_tpu/models/modernbert.py::_splash_attention calls (the path of
// attention_impl="splash"). For q, k, v [B, N, S, 64] and seg [B, S]:
//
//     s[i, j]   = (q[i, :] . k[j, :]) * scale          on the allowed (i, j)
//     out[i, :] = softmax_j(s[i, :]) . v               bf16 [B, S, N, 64]
//     lse[i]    = log sum_j exp(s[i, j])               f32  [B, N, S]
//
// allowed(i, j): seg[i] == seg[j], and |i - j| <= half_window on local layers
// (half_window == 0: full attention). Padding rides seg, so every row sees at
// least itself and no row is empty.
//
// What bounds it: at the V33 micro-batch (144 x 256, 12 heads) q, k, v and
// out are 226 MB (0.068 ms at 3.35 TB/s) against 29 GFLOP on a global layer
// (0.029 ms at 989 TFLOP/s): bytes. The [B, N, S, S] scores, which the plain
// route writes and reads several times in f32, never reach device memory
// here: a block owns one (b, head, 64-query tile), walks the 64-row kv tiles
// its mask can reach (local layers skip every tile wholly outside the band)
// and keeps a running maximum, sum and output per row: the online softmax.
// It is the simple first version: WMMA products staged through shared
// memory, the output tile rescaled in shared memory between kv tiles; a
// wgmma/TMA pipeline with the output in registers is a later step.
//
// Likely trouble, and what is done about it: the running maximum starts at a
// finite -1e30 and a masked p is set to 0 outright, so a tile that masks a
// whole row leaves its sums untouched (exp(-1e30 - -1e30) would be 1); rows
// past S in the ragged last tile are computed on zeros and never written.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "splash_attention.cuh"

namespace {

using namespace splash;

static_assert(HD == BT, "a warp's output rows reuse the score tile's stride");

// Q, K, V tiles; the score tile (p in bf16 laid over it) and the output tile
// in f32; the kv tile's segment ids
constexpr int SMEM_BYTES = 3 * TILE_BYTES + 2 * SCORE_BYTES + BT * 4;

__global__ void __launch_bounds__(THREADS)
splash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const int* __restrict__ seg, __nv_bfloat16* __restrict__ out,
                  float* __restrict__ lse, Strides qs, Strides ks, Strides vs,
                  int N, int S, int hw, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + BT * LDS;
  __nv_bfloat16* Vs = Ks + BT * LDS;
  float* Ss = reinterpret_cast<float*>(smem + 3 * TILE_BYTES);
  float* Os = Ss + BT * LDF;
  int* segk = reinterpret_cast<int*>(Os + BT * LDF);

  const int q0 = blockIdx.x * BT, n = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row = lane >> 1, half = lane & 1;  // two lanes share a row
  const int qi = q0 + warp * 16 + row;
  const int* segb = seg + (size_t)b * S;
  const int sq = qi < S ? segb[qi] : 0;
  const __nv_bfloat16* kb = k + (size_t)b * ks.b + (size_t)n * ks.n;
  const __nv_bfloat16* vb = v + (size_t)b * vs.b + (size_t)n * vs.n;

  load_tile(Qs, q + (size_t)b * qs.b + (size_t)n * qs.n, qs.s, q0, S);
  float* Sw = Ss + warp * 16 * LDF;   // this warp's score rows
  float* Ow = Os + warp * 16 * LDF;   // this warp's output rows
  __nv_bfloat16* Pw = reinterpret_cast<__nv_bfloat16*>(Sw);
  float* orow = Ow + row * LDF + half * HALF;
#pragma unroll
  for (int j = 0; j < HALF; ++j) orow[j] = 0.f;
  float m_run = NEG, l_run = 0.f;

  int lo, hi;
  tile_range(q0, S, hw, lo, hi);
  for (int t = lo; t <= hi; ++t) {
    const int k0 = t * BT;
    __syncthreads();  // the previous tile's products have read Ks and Vs
    load_tile(Ks, kb, ks.s, k0, S);
    load_tile(Vs, vb, vs.s, k0, S);
    if (tid < BT) segk[tid] = k0 + tid < S ? segb[k0 + tid] : 0;
    __syncthreads();

    rows_times_transposed(Qs + warp * 16 * LDS, Ks, Sw);
    __syncwarp();

    // this lane's 32 scores of its row: mask, running maximum, p, sum
    float sv[HALF];
    const float* srow = Sw + row * LDF + half * HALF;
    float mx = NEG;
#pragma unroll
    for (int j = 0; j < HALF; ++j) {
      const int c = half * HALF + j;
      sv[j] = allowed(qi, k0 + c, sq, segk[c], S, hw) ? srow[j] * scale : NEG;
      mx = fmaxf(mx, sv[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_run, mx);
    const float alpha = __expf(m_run - m_new);
    __syncwarp();  // both lanes of a row have read s before p lands on it
    float sum = 0.f;
    __nv_bfloat16* prow = Pw + row * LDP + half * HALF;
#pragma unroll
    for (int j = 0; j < HALF; ++j) {
      const float p = sv[j] > 0.5f * NEG ? __expf(sv[j] - m_new) : 0.f;
      sum += p;
      prow[j] = __float2bfloat16(p);  // rounded to v's type before p . v
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l_run = l_run * alpha + sum;
    m_run = m_new;
#pragma unroll
    for (int j = 0; j < HALF; ++j) orow[j] *= alpha;
    __syncwarp();

    // out rows = out rows * alpha + p . v
    Acc acc[HD / 16];
#pragma unroll
    for (int j = 0; j < HD / 16; ++j)
      nvcuda::wmma::load_matrix_sync(acc[j], Ow + j * 16, LDF,
                                     nvcuda::wmma::mem_row_major);
    accumulate(Pw, Vs, acc);
#pragma unroll
    for (int j = 0; j < HD / 16; ++j)
      nvcuda::wmma::store_matrix_sync(Ow + j * 16, acc[j], LDF,
                                      nvcuda::wmma::mem_row_major);
    __syncwarp();
  }

  if (qi < S) {
    const float inv = 1.f / l_run;  // l_run >= 1: the row sees itself
    __nv_bfloat16* dst =
        out + (((size_t)b * S + qi) * N + n) * HD + half * HALF;
#pragma unroll
    for (int j = 0; j < HALF; j += 2)
      *reinterpret_cast<__nv_bfloat162*>(dst + j) =
          __floats2bfloat162_rn(orow[j] * inv, orow[j + 1] * inv);
    if (half == 0) lse[((size_t)b * N + n) * S + qi] = m_run + logf(l_run);
  }
}

}  // namespace

// q, k, v: bf16 [B, N, S, 64] views read through their strides (elements
// between batch rows, heads, positions; the last dimension contiguous, rows
// 16-byte aligned: checked by the wrapper); seg [B, S] int32; out [B, S, N,
// 64] bf16 and lse [B, N, S] f32, contiguous. half_window 0 = full attention.
extern "C" int splade_splash_attn_fwd(
    const void* q, const void* k, const void* v, const void* seg, void* out,
    void* lse, long long q_b, long long q_n, long long q_s, long long k_b,
    long long k_n, long long k_s, long long v_b, long long v_n, long long v_s,
    int B, int N, int S, int D, int half_window, float scale, void* stream) {
  if (D != HD || half_window < 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      splash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + BT - 1) / BT, N, B);
  splash_fwd_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const int*)seg, (__nv_bfloat16*)out,
      (float*)lse, Strides{q_b, q_n, q_s}, Strides{k_b, k_n, k_s},
      Strides{v_b, v_n, v_s}, N, S, half_window, scale);
  return (int)cudaGetLastError();
}
