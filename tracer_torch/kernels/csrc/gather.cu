// Deterministic segmented row sum for Hopper (sm_90a): the backward of a row
// gather out = src[idx] (kernels/gather.py).
//
// Replaces no TPU kernel: the JAX package leaves this scatter-add to XLA. It
// was added because ATen's backward of x[idx] on the card (index_put_ with
// accumulate, after a sort of the indices) hands each distinct index to one
// warp, which walks every repeat of that index one dependent load after
// another. The tiled grad step's gathers repeat a few indices tens of
// thousands of times (the rays that miss all read slot 0, the ground's two
// triangles cover half the frame, every body slot points at material 0), so
// that walk took most of the step's device time.
//
// What it computes. keys (n,) are the row indices sorted stably (equal keys
// keep their entries' order) and perm (n,) each sorted entry's place in vals
// (n, w), w <= 32: out[r, :] = the sum of vals[perm[i], :] over the i with
// keys[i] == r, in order of i. Rows no key names are left as they are (the
// wrapper zeroes out).
//
// What bounds it on the card. Bytes: each gradient row and each sorted key
// and place is read once, each output row written once. A bunny512 grad step
// sums 1,082,276 rows (262,144 of 32 floats by ray; 3 x 82,048 slots'
// corners twice, vertices and normals, 82,048 slots' albedo and 6 x 40,966
// vertices' face normals, of 3 floats): some 43 MB of rows, 17 MB of keys
// and places and 12 MB written, about 22 us at 3.35 TB/s. There is next to
// no arithmetic.
//
// What the design does about it. The sorted entries are cut into chunks of
// kChunk; one warp sums a chunk, so no thread walks more than kChunk entries
// however long a run is. A run that lies inside its chunk and touches neither
// end of it is complete there and is written to out. The run at the chunk's
// start and the run at its end go to two partial slots of the chunk, (key,
// row sum) at 2c and 2c + 1 (a chunk of one run writes its sum at 2c and a
// zero row under the same key at 2c + 1), so the slots are again sorted by
// key. The same kernel then sums the slots, level after level, each level a
// fixed tree over the one before, until one chunk holds them all and writes
// every run to out. Every sum is taken in one fixed order, so the same inputs
// give the same bits on every run. Two ways to walk a chunk: for w > 4 the
// warp's lane j owns column j and the warp walks the chunk's entries in order
// (a row is one coalesced load); for w <= 4 lane l takes every 32nd entry,
// and a segmented shuffle scan sums the warp's 32 entries a step, a carry
// passing the last run from one step to the next.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 128;   // entries a warp sums (CHUNK of kernels/gather.py)
constexpr int kWarps = 4;     // warps a block
constexpr int kNarrow = 4;    // widths up to this take the scanning walk
constexpr int kUnroll = 8;    // rows in flight a lane in the column walk
constexpr unsigned kFull = 0xffffffffu;

// Where a finished run of one chunk goes: out, or one of the chunk's two
// partial slots.
struct Chunk {
  long long first, last;  // keys at the chunk's first and last entries
  int c;                  // the chunk's number
  bool top;               // one chunk holds every entry: every run goes to out
};

// The partial slot of a finished run with key k, or -1 where the run is
// complete and goes to out. A chunk of one run also fills slot 2c + 1: with a
// zero row under the same key.
__device__ __forceinline__ long long run_slot(const Chunk& ch, long long k) {
  if (ch.top || (k != ch.first && k != ch.last)) return -1;
  return 2LL * ch.c + (k == ch.first ? 0 : 1);
}

// The column walk (w > kNarrow): lane j owns column j.
__global__ void __launch_bounds__(32 * kWarps)
rows_sum_cols_kernel(const long long* __restrict__ keys, const long long* __restrict__ perm,
                     const float* __restrict__ vals, int m, int w, int n_chunks,
                     float* __restrict__ out, long long* __restrict__ pk,
                     float* __restrict__ pv) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (c >= n_chunks) return;
  const int b = c * kChunk, e = min(b + kChunk, m);
  const Chunk ch{keys[b], keys[e - 1], c, n_chunks == 1};
  long long cur = ch.first;
  float acc = 0.0f;

  auto flush = [&](long long k, float v) {
    const long long slot = run_slot(ch, k);
    const bool one_run = ch.first == ch.last;
    if (lane < w) {
      if (slot < 0) {
        out[k * w + lane] = v;
      } else {
        pv[slot * w + lane] = v;
        if (one_run) pv[(slot + 1) * w + lane] = 0.0f;
      }
    }
    if (lane == 0 && slot >= 0) {
      pk[slot] = k;
      if (one_run) pk[slot + 1] = k;
    }
  };

  for (int base = b; base < e; base += 32) {
    const int n = min(32, e - base);
    const int i = base + lane;
    const long long k_l = lane < n ? keys[i] : -1;
    const long long s_l = lane < n ? (perm ? perm[i] : (long long)i) : 0;
    for (int t0 = 0; t0 < n; t0 += kUnroll) {
      long long k[kUnroll];
      float v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        k[u] = __shfl_sync(kFull, k_l, t0 + u);
        const long long s = __shfl_sync(kFull, s_l, t0 + u);
        v[u] = (t0 + u < n && lane < w) ? vals[s * w + lane] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (t0 + u < n) {
          if (k[u] != cur) {
            flush(cur, acc);
            cur = k[u];
            acc = 0.0f;
          }
          acc += v[u];
        }
      }
    }
  }
  flush(cur, acc);
}

// The scanning walk (w <= kNarrow): lane l takes entry base + l of each step
// of 32 entries.
__global__ void __launch_bounds__(32 * kWarps)
rows_sum_scan_kernel(const long long* __restrict__ keys, const long long* __restrict__ perm,
                     const float* __restrict__ vals, int m, int w, int n_chunks,
                     float* __restrict__ out, long long* __restrict__ pk,
                     float* __restrict__ pv) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (c >= n_chunks) return;
  const int b = c * kChunk, e = min(b + kChunk, m);
  const Chunk ch{keys[b], keys[e - 1], c, n_chunks == 1};

  auto flush = [&](long long k, const float* v) {
    const long long slot = run_slot(ch, k);
    const bool one_run = ch.first == ch.last;
    float* dst = slot < 0 ? out + k * w : pv + slot * w;
#pragma unroll
    for (int j = 0; j < kNarrow; ++j) {
      if (j < w) {
        dst[j] = v[j];
        if (slot >= 0 && one_run) dst[w + j] = 0.0f;
      }
    }
    if (slot >= 0) {
      pk[slot] = k;
      if (one_run) pk[slot + 1] = k;
    }
  };

  long long carry_k = -1;  // the last run of the steps so far; -1: none
  float carry[kNarrow] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int base = b; base < e; base += 32) {
    const int i = base + lane;
    const bool valid = i < e;
    // A lane past the chunk's end takes a key no other lane has.
    const long long k = valid ? keys[i] : -2 - lane;
    const long long s = valid ? (perm ? perm[i] : (long long)i) : 0;
    float v[kNarrow];
#pragma unroll
    for (int j = 0; j < kNarrow; ++j) v[j] = (valid && j < w) ? vals[s * w + j] : 0.0f;
    // The carried run ends where this step's first key is another.
    const long long k0 = __shfl_sync(kFull, k, 0);
    if (carry_k >= 0 && carry_k != k0 && lane == 0) flush(carry_k, carry);
    // Segmented inclusive scan: a lane adds the sum of the lanes before it
    // that share its key, in a fixed tree.
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const long long ko = __shfl_up_sync(kFull, k, off);
      float vo[kNarrow];
#pragma unroll
      for (int j = 0; j < kNarrow; ++j) vo[j] = __shfl_up_sync(kFull, v[j], off);
      if (lane >= off && ko == k) {
#pragma unroll
        for (int j = 0; j < kNarrow; ++j) v[j] = vo[j] + v[j];
      }
    }
    if (carry_k == k) {
#pragma unroll
      for (int j = 0; j < kNarrow; ++j) v[j] = carry[j] + v[j];
    }
    const long long kn = __shfl_down_sync(kFull, k, 1);
    const bool more = base + 32 < e;
    const bool run_end = valid && (lane == 31 || kn != k);
    if (run_end && !(lane == 31 && more)) flush(k, v);
    if (more) {
      carry_k = __shfl_sync(kFull, k, 31);
#pragma unroll
      for (int j = 0; j < kNarrow; ++j) carry[j] = __shfl_sync(kFull, v[j], 31);
    }
  }
}

inline int chunks_of(int m) { return (m + kChunk - 1) / kChunk; }

}  // namespace

extern "C" {

// keys, perm (int64, n) and vals (float, n x w) as above; out (float,
// n_rows x w) zeroed by the caller; (ka, va) and (kb, vb) the partial slots
// of the odd and even levels, 2 * ceil(n / kChunk) and 2 * ceil(that /
// kChunk) of them. Launches the levels one after another on the stream.
int gr_rows_sum(const void* keys, const void* perm, const void* vals, int n, int w, void* out,
                void* ka, void* va, void* kb, void* vb, void* stream) {
  if (w < 1 || w > 32 || n < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const long long* k_in = (const long long*)keys;
  const long long* p_in = (const long long*)perm;
  const float* v_in = (const float*)vals;
  long long* k_out[2] = {(long long*)ka, (long long*)kb};
  float* v_out[2] = {(float*)va, (float*)vb};
  for (int m = n, level = 0; m > 0; ++level) {
    const int n_chunks = chunks_of(m);
    const bool top = n_chunks == 1;
    long long* pk = top ? nullptr : k_out[level & 1];
    float* pv = top ? nullptr : v_out[level & 1];
    const unsigned grid = (unsigned)((n_chunks + kWarps - 1) / kWarps);
    if (w <= kNarrow)
      rows_sum_scan_kernel<<<grid, 32 * kWarps, 0, s>>>(k_in, p_in, v_in, m, w, n_chunks,
                                                        (float*)out, pk, pv);
    else
      rows_sum_cols_kernel<<<grid, 32 * kWarps, 0, s>>>(k_in, p_in, v_in, m, w, n_chunks,
                                                        (float*)out, pk, pv);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    if (top) break;
    m = 2 * n_chunks;
    k_in = pk;
    p_in = nullptr;
    v_in = pv;
  }
  return 0;
}

}  // extern "C"
