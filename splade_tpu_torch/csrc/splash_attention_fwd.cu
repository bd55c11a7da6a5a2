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
// least itself and no row is empty. The backward reads lse as a natural log.
//
// What bounds it: at the V33 micro-batch (144 x 256, 12 heads) q, k, v and
// out are 226 MB (0.068 ms at 3.35 TB/s) against 29 GFLOP on a global layer
// (0.029 ms at 989 TFLOP/s): bytes. The [B, N, S, S] scores never reach
// device memory: a block owns one (b, head, 64-query tile), walks the 64-row
// kv tiles its mask can reach (local layers skip every tile wholly outside
// the band) and keeps a running maximum, sum and output per row: the online
// softmax of FlashAttention-2.
//
// Everything between the two products stays in registers. Each warp owns 16
// query rows; their q A fragments (4 k-slices) are loaded once. s = q . k^T
// lands in eight n8 C fragments of bf16 mma.sync m16n8k16 (mma_sm90.cuh),
// whose documented layout tells each lane its rows (g, g+8) and columns: the
// mask is two tests on them (in_mask), the running maximum is kept in log2
// units and reduced over the four lanes of a quad by shuffles, p is one ex2
// of an FMA, and two n8 C fragments of p, rounded to bf16, are one A
// fragment of p . v (a_from_c). The 64-wide output accumulator (8 n8
// fragments) is rescaled by alpha in place; each lane keeps its share of the
// row sum and the quad adds them once, at the end. Shared memory holds only
// the double-buffered K/V ring and its segment ids (37 KB, q staged in the
// second buffer before the walk): tile t+1 loads by cp.async while tile t
// multiplies. A masked p is 0 outright and the running maximum starts at a
// finite -1e30, so a tile that masks a whole row leaves its sums untouched;
// rows past S are computed on zeros and never written.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "splash_attention.cuh"

namespace {

using namespace splash;

static_assert(HD == 64 && BT == 64, "fragment loops are unrolled for 64");
constexpr int NT = 8;  // n8 tiles across 64 columns
constexpr int KS = 4;  // k16 steps across a depth of 64

// the two buffers of the walked K and V tiles (q stages in the second pair
// before the walk) and the walked tiles' segment ids
constexpr int SMEM_BYTES = 4 * TILE_BYTES + 2 * BT * 4;

__global__ void __launch_bounds__(THREADS, 4)
splash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const int* __restrict__ seg, __nv_bfloat16* __restrict__ out,
                  float* __restrict__ lse, Strides qs, Strides ks, Strides vs,
                  int N, int S, int hw, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* tiles = reinterpret_cast<__nv_bfloat16*>(smem);  // K0 V0 K1 V1
  int* segk = reinterpret_cast<int*>(smem + 4 * TILE_BYTES);      // [2][BT]

  const int q0 = blockIdx.x * BT, n = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = 2 * (lane & 3);
  const int* segb = seg + (size_t)b * S;
  const __nv_bfloat16* kb = k + (size_t)b * ks.b + (size_t)n * ks.n;
  const __nv_bfloat16* vb = v + (size_t)b * vs.b + (size_t)n * vs.n;
  int lo, hi;
  tile_range(q0, S, hw, lo, hi);

  auto load_kv = [&](int t, int buf) {
    load_tile_async(tiles + (2 * buf) * BT * LDS, kb, ks.s, t * BT, S);
    load_tile_async(tiles + (2 * buf + 1) * BT * LDS, vb, vs.s, t * BT, S);
    load_row_async(segk + buf * BT, segb, t * BT, S, 0, COL_PAST_S);
  };
  // q into the second K buffer, tile lo into the first
  load_tile_async(tiles + 2 * BT * LDS, q + (size_t)b * qs.b +
                  (size_t)n * qs.n, qs.s, q0, S);
  load_kv(lo, 0);
  cp_async_commit();

  // this lane's fragment rows g and g+8 of the warp's 16
  const int qi0 = q0 + warp * 16 + g, qi1 = qi0 + 8;
  const int sq0 = qi0 < S ? segb[qi0] : ROW_PAST_S;
  const int sq1 = qi1 < S ? segb[qi1] : ROW_PAST_S;
  const float sl2 = scale * LOG2E;  // scores to log2 units
  const int hwe = hw ? hw : S;

  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[KS][4];  // A fragments of the warp's q rows
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    load_a(qf[kk], tiles + 2 * BT * LDS, warp * 16, kk * 16);
  __syncthreads();  // the second buffers are free for tile lo+1

  // running maximum (log2 units) and this lane's share of the row sums, for
  // rows g and g+8; the output rows in 8 n8 fragments
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;
  float acc[NT][4] = {};
  for (int t = lo; t <= hi; ++t) {
    const int buf = (t - lo) & 1;
    if (t < hi) load_kv(t + 1, buf ^ 1);
    cp_async_commit();   // an empty group on the last tile
    cp_async_wait<1>();  // tile t has landed
    __syncthreads();
    const __nv_bfloat16* Kt = tiles + (2 * buf) * BT * LDS;
    const __nv_bfloat16* Vt = Kt + BT * LDS;
    const int* sk = segk + buf * BT;
    const int k0 = t * BT;

    // s = q . k^T
    float s[NT][4] = {};
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int nn = 0; nn < NT / 2; ++nn) {
        uint32_t bk[4];
        load_b_nk(bk, Kt, nn * 16, kk * 16);
        mma16816(s[2 * nn], qf[kk], bk[0], bk[1]);
        mma16816(s[2 * nn + 1], qf[kk], bk[2], bk[3]);
      }
    }
    // the mask, in log2 units: a masked score is NEG
    float mx0 = NEG, mx1 = NEG;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int d = qi0 - (k0 + 8 * j + c);  // row g, column 8j + c
      const int2 skj = *reinterpret_cast<const int2*>(sk + 8 * j + c);
      s[j][0] = in_mask(sq0, skj.x, d, hwe) ? s[j][0] * sl2 : NEG;
      s[j][1] = in_mask(sq0, skj.y, d - 1, hwe) ? s[j][1] * sl2 : NEG;
      s[j][2] = in_mask(sq1, skj.x, d + 8, hwe) ? s[j][2] * sl2 : NEG;
      s[j][3] = in_mask(sq1, skj.y, d + 7, hwe) ? s[j][3] * sl2 : NEG;
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    // the row maxima over the quad that shares the rows
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
    }
    const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
    const float alpha0 = ex2(m0 - n0), alpha1 = ex2(m1 - n1);
    m0 = n0;
    m1 = n1;
    // p = 2^(s - m), 0 off the mask; this lane's share of the sums
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = s[j][0] > 0.5f * NEG ? ex2(s[j][0] - n0) : 0.f;
      s[j][1] = s[j][1] > 0.5f * NEG ? ex2(s[j][1] - n0) : 0.f;
      s[j][2] = s[j][2] > 0.5f * NEG ? ex2(s[j][2] - n1) : 0.f;
      s[j][3] = s[j][3] > 0.5f * NEG ? ex2(s[j][3] - n1) : 0.f;
      sum0 += s[j][0] + s[j][1];
      sum1 += s[j][2] + s[j][3];
    }
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      acc[j][0] *= alpha0;
      acc[j][1] *= alpha0;
      acc[j][2] *= alpha1;
      acc[j][3] *= alpha1;
    }
    // out rows += p . v, p rounded to bf16
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[4];
      a_from_c(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int nn = 0; nn < NT / 2; ++nn) {
        uint32_t bv[4];
        load_b_kn(bv, Vt, kk * 16, nn * 16);
        mma16816(acc[2 * nn], a, bv[0], bv[1]);
        mma16816(acc[2 * nn + 1], a, bv[2], bv[3]);
      }
    }
    __syncthreads();  // every warp is done with buffer buf
  }

  // the quad's shares of the row sums: l >= 1, since every row sees itself
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  // out is contiguous [B, S, N, HD]
  const long long row_stride = (long long)N * HD;
  __nv_bfloat16* row0 =
      out + ((size_t)b * S * N + n) * HD + (size_t)qi0 * row_stride;
  __nv_bfloat16* row1 = row0 + 8 * row_stride;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (qi0 < S) store_pair(row0 + 8 * j + c, acc[j][0] * inv0,
                            acc[j][1] * inv0);
    if (qi1 < S) store_pair(row1 + 8 * j + c, acc[j][2] * inv1,
                            acc[j][3] * inv1);
  }
  // lse = ln(l) + m, m back from log2 units
  float* lrow = lse + ((size_t)b * N + n) * S;
  if (c == 0) {
    if (qi0 < S) lrow[qi0] = m0 * LN2 + logf(l0);
    if (qi1 < S) lrow[qi1] = m1 * LN2 + logf(l1);
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
  dim3 grid((S + BT - 1) / BT, N, B);
  splash_fwd_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const int*)seg, (__nv_bfloat16*)out,
      (float*)lse, Strides{q_b, q_n, q_s}, Strides{k_b, k_n, k_s},
      Strides{v_b, v_n, v_s}, N, S, half_window, scale);
  return (int)cudaGetLastError();
}
