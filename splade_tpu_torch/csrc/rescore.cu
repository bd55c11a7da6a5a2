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
// query slots (value 0) contribute nothing. Out-of-range candidate ids clamp
// to [0, N - 1], as XLA's gather does. Term ids are int32 on the device (the
// index's uint16 host layout is widened at build).
//
// What bounds it: the bytes of the gathered candidate rows, B*C*M*5 (int32
// term + int8 value a slot; 10.2 MB at B=32, C=1000, M=64), 3.2 us at
// 3.35 TB/s with the candidate ids, scales and scores. Its operations, one
// lookup and one multiply-add a slot, are a few million. The TPU formulation
// streamed a gathered [B, M, C] block through a T-long compare/select chain,
// because a TPU has no fast scalar gather. The first Hopper version kept that
// chain: one thread a candidate, each slot compared with all T query terms
// (4,096 dependent compare-selects a thread at M = T = 64), each lane reading
// 16 bytes of its own row a step; latency-bound at 17x the bound. Here:
// - The query is a lookup, not a scan. A block serves one query row b and 16
//   of its candidates. It builds the row's terms into an open-addressing
//   table in shared memory: 4T slots rounded up to a power of two (at most
//   1,024), linear probing from a multiplicative (Fibonacci) hash of the
//   term id; key the term id, value the sum of q_val over the query slots
//   that carry it. Pad slots (value 0) are left out. Keys go in by
//   atomicCAS, so which slot a colliding key takes depends on the race; the
//   lowest t of each key (by atomicMin) then sums that key's values in
//   ascending t, so every value, and every score, is the same in a repeated
//   call. A doc slot costs one probe, mostly one 8-byte shared-memory load
//   (key and value together), and a doc slot of value 0 none. A lane issues
//   the first probes of its 8 slots together and follows a chain only where
//   one did not end. The hash matters: term ids taken as their own slots
//   (the first version of this design) put the frequent, small ids of a
//   Zipf corpus and of the queries that match it into one run of occupied
//   slots, and a lookup that missed walked it.
// - A candidate's row is spread over 8 lanes: with M % 8 == 0 each lane
//   takes 8 consecutive slots, two 16-byte term loads and one 8-byte value
//   load, so a warp reads the 256-byte term rows of 4 candidates whole. A
//   thread's first loads are its query slots and its candidate id, issued
//   together; each lane group issues its candidate's row loads before the
//   table is filled, so the gathers are in flight while it is. The 8 lanes'
//   sums are joined by __shfl_xor_sync in a fixed order. Other M (or rows
//   the wrapper finds unaligned, which it refuses at M % 8 == 0) take the
//   scalar path: lane j of a group reads slots j, j + 8, ... one by one.
// - One candidate a lane group (PER): on an H100 (scripts/bench_rescore.py,
//   CUDA-graph timing at B=32 C=1000 M=64 T=64 over the 1M-document Zipf
//   corpus) 2,048 blocks of 16 candidates took 10.1-11.0 us, 2 and 4
//   candidates a group (1,024 and 512 blocks) 11.0-11.6 and 14.1-15.6.
// What holds it above the bound (measured, same script): the same launch
// reading no document row (M = 0: the launch, the candidate ids, the scales
// and the table) takes 3.8-4.6 us, so the row gathers add about 6.5 us for
// 10.2 MB of 320-byte rows at random places (plus a 32-byte sector for each
// 4-byte scale), each waiting on its candidate id.
// The f32 order differs from the plain version's (sum_m w * (sum_t q)
// against sum_t q * (sum_m w)): 1e-4 is the tolerance the tests and
// chip_smoke.py hold it to.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int LANES = 8;                 // lanes a candidate
constexpr int GROUPS = THREADS / LANES;  // candidates a block walks at once
constexpr int PER = 1;                   // candidates a lane group
constexpr int CANDS = GROUPS * PER;      // candidates a block
constexpr int SLOTS = 8;                 // doc slots a lane reads at once
constexpr int CHUNK = LANES * SLOTS;     // doc slots a lane group reads at once
constexpr int MAX_T = 256;
constexpr int MAX_TABLE = 4 * MAX_T;
constexpr int QPT = MAX_T / THREADS;     // query slots a thread at most
constexpr int EMPTY = INT_MIN;           // a free table slot's key
constexpr unsigned FULL = 0xffffffffu;

// The query row's table: {key, value bits} a slot, and what building it
// takes: the lowest t of each slot's key and how many query slots carry it,
// each query slot's table slot (-1: left out) and value.
struct QueryTable {
  int2 slot[MAX_TABLE];
  int first[MAX_TABLE];
  int count[MAX_TABLE];
  int slot_of[MAX_T];
  float qv[MAX_T];
};

// A term's first slot in a table of 2^bits slots: the top bits of its
// product with 2^32 / golden ratio, so neighbouring ids land apart.
__device__ __forceinline__ int home(int term, int bits) {
  return (int)(((unsigned)term * 2654435769u) >> (32 - bits));
}

// The query slots t = threadIdx.x + THREADS * j of one row, which a thread
// loads first of all and inserts once the table is empty.
struct QuerySlots {
  int term[QPT];
  float val[QPT];
};

__device__ __forceinline__ void load_query(const int* __restrict__ q_idx,
                                           const float* __restrict__ q_val,
                                           int T, QuerySlots& q) {
#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    const int t = threadIdx.x + THREADS * j;
    q.term[j] = t < T ? q_idx[t] : EMPTY;
    q.val[j] = t < T ? q_val[t] : 0.f;
  }
}

// Empty the table of 2^bits slots. No barrier.
__device__ __forceinline__ void clear_table(int bits, QueryTable& tb) {
  for (int s = threadIdx.x; s < (1 << bits); s += THREADS) {
    tb.slot[s].x = EMPTY;
    tb.first[s] = INT_MAX;
    tb.count[s] = 0;
  }
}

// Insert the T query slots of the row into the emptied table (a barrier
// after clear_table first), then set each key's value to the sum of its
// slots' values in ascending t. All threads of the block call it; it ends
// with a barrier.
__device__ __forceinline__ void fill_table(const QuerySlots& q, int T,
                                           int bits, QueryTable& tb) {
  const int mask = (1 << bits) - 1;
#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    const int t = threadIdx.x + THREADS * j;
    if (t >= T) break;
    const int term = q.term[j];
    int s = -1;
    if (q.val[j] != 0.f && term != EMPTY) {
      s = home(term, bits);
      for (;;) {  // the table holds at most T keys in 4T slots: it ends
        const int prev = atomicCAS(&tb.slot[s].x, EMPTY, term);
        if (prev == EMPTY || prev == term) break;
        s = (s + 1) & mask;
      }
      atomicMin(&tb.first[s], t);
      atomicAdd(&tb.count[s], 1);
    }
    tb.slot_of[t] = s;
    tb.qv[t] = q.val[j];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    const int t = threadIdx.x + THREADS * j;
    if (t >= T) break;
    const int s = tb.slot_of[t];
    if (s >= 0 && tb.first[s] == t) {  // each key's sum, in ascending t
      float sum = q.val[j];
      if (tb.count[s] > 1)  // a duplicated term: the rest of its slots
        for (int u = t + 1; u < T; ++u)
          if (tb.slot_of[u] == s) sum += tb.qv[u];
      tb.slot[s].y = __float_as_int(sum);
    }
  }
  __syncthreads();
}

// The query's weight of `term`, its table value or 0, from the entry e of
// slot s where its probe stands.
__device__ __forceinline__ float resolve(const QueryTable& tb, int bits,
                                         int term, int s, int2 e) {
  while (e.x != term) {
    if (e.x == EMPTY) return 0.f;
    s = (s + 1) & ((1 << bits) - 1);
    e = tb.slot[s];
  }
  return __int_as_float(e.y);
}

// The weight of one doc slot against the query, w * q, from its first
// probe's entry; a value of 0 costs no lookup.
__device__ __forceinline__ float slot_score(const QueryTable& tb, int bits,
                                            int term, int s, int2 e, int v,
                                            float sc) {
  return v ? (float)v * sc * resolve(tb, bits, term, s, e) : 0.f;
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
rescore_kernel(const int* __restrict__ d_terms,
               const int8_t* __restrict__ d_vals,
               const float* __restrict__ d_scale,
               const int* __restrict__ q_idx, const float* __restrict__ q_val,
               const int* __restrict__ cand, float* __restrict__ out, int N,
               int C, int M, int T, int bits) {
  __shared__ QueryTable tb;
  const int b = blockIdx.y;
  const int tid = threadIdx.x, sub = tid % LANES;
  // the loads that start the two chains, issued together: the query row
  // (-> the table) and this lane group's candidate ids c0 + GROUPS * i (->
  // their rows)
  QuerySlots q;
  load_query(q_idx + (size_t)b * T, q_val + (size_t)b * T, T, q);
  const int c0 = blockIdx.x * CANDS + tid / LANES;
  int doc[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = c0 + GROUPS * i;
    doc[i] = c < C ? cand[(size_t)b * C + c] : -1;
  }
  clear_table(bits, tb);
  __syncthreads();
  float sc[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    // out-of-range ids clamp, as XLA's gather does
    if (c0 + GROUPS * i < C) doc[i] = min(max(doc[i], 0), N - 1);
    sc[i] = doc[i] >= 0 ? d_scale[doc[i]] : 0.f;
  }
  float acc[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) acc[i] = 0.f;

  if (VEC) {
    // M % 8 == 0: a lane's 8 slots are all in the row or all past it
    int4 t_lo[PER], t_hi[PER];
    uint2 vv[PER];
    auto load = [&](int m0) {
      const int m = m0 + sub * SLOTS;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        vv[i] = make_uint2(0u, 0u);  // values 0: nothing looked up
        t_lo[i] = t_hi[i] = make_int4(0, 0, 0, 0);
        if (doc[i] >= 0 && m < M) {
          const int4* tr =
              reinterpret_cast<const int4*>(d_terms + (size_t)doc[i] * M + m);
          t_lo[i] = tr[0];
          t_hi[i] = tr[1];
          vv[i] = *reinterpret_cast<const uint2*>(d_vals + (size_t)doc[i] * M +
                                                  m);
        }
      }
    };
    load(0);  // in flight while the table is built
    fill_table(q, T, bits, tb);
    for (int m0 = 0; m0 < M; m0 += CHUNK) {
      if (m0) load(m0);
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int terms[SLOTS] = {t_lo[i].x, t_lo[i].y, t_lo[i].z, t_lo[i].w,
                                  t_hi[i].x, t_hi[i].y, t_hi[i].z, t_hi[i].w};
        int s[SLOTS];
        int2 e[SLOTS];  // the 8 first probes, issued together
#pragma unroll
        for (int k = 0; k < SLOTS; ++k) {
          s[k] = home(terms[k], bits);
          e[k] = tb.slot[s[k]];
        }
#pragma unroll
        for (int k = 0; k < SLOTS; ++k) {
          const unsigned word = k < 4 ? vv[i].x : vv[i].y;
          const int v = (int8_t)(word >> (8 * (k & 3)));
          acc[i] += slot_score(tb, bits, terms[k], s[k], e[k], v, sc[i]);
        }
      }
    }
  } else {
    fill_table(q, T, bits, tb);
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      if (doc[i] < 0) continue;
      const int* tr = d_terms + (size_t)doc[i] * M;
      const int8_t* vr = d_vals + (size_t)doc[i] * M;
      for (int m = sub; m < M; m += LANES) {
        const int term = tr[m], s = home(term, bits);
        acc[i] += slot_score(tb, bits, term, s, tb.slot[s], vr[m], sc[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    float a = acc[i];
#pragma unroll
    for (int o = LANES / 2; o > 0; o >>= 1)
      a += __shfl_xor_sync(FULL, a, o);
    if (sub == 0 && doc[i] >= 0) out[(size_t)b * C + c0 + GROUPS * i] = a;
  }
}

}  // namespace

// d_terms [N,M] int32, d_vals [N,M] int8, d_scale [N] f32, q_idx [B,T] int32,
// q_val [B,T] f32, cand [B,C] int32, out [B,C] f32 (every element written).
// N >= 1, B, C >= 1 and T <= 256, and at M % 8 == 0 rows of d_terms 16-byte
// and of d_vals 8-byte aligned, are checked by the wrapper.
extern "C" int splade_rescore_match(const void* d_terms, const void* d_vals,
                                    const void* d_scale, const void* q_idx,
                                    const void* q_val, const void* cand,
                                    void* out, int N, int B, int C, int M,
                                    int T, void* stream) {
  if (T < 0 || T > MAX_T) return (int)cudaErrorInvalidValue;
  int bits = 5;  // a table of 2^bits >= 4T slots, at least 32
  while ((1 << bits) < 4 * T) ++bits;
  dim3 grid((C + CANDS - 1) / CANDS, B);
  cudaStream_t st = (cudaStream_t)stream;
  if (M % SLOTS == 0)
    rescore_kernel<true><<<grid, THREADS, 0, st>>>(
        (const int*)d_terms, (const int8_t*)d_vals, (const float*)d_scale,
        (const int*)q_idx, (const float*)q_val, (const int*)cand,
        (float*)out, N, C, M, T, bits);
  else
    rescore_kernel<false><<<grid, THREADS, 0, st>>>(
        (const int*)d_terms, (const int8_t*)d_vals, (const float*)d_scale,
        (const int*)q_idx, (const float*)q_val, (const int*)cand,
        (float*)out, N, C, M, T, bits);
  return (int)cudaGetLastError();
}
