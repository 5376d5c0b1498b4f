// The two-stage front-to-back cull (bvh/cull.py cull_clusters_sorted2) for
// Hopper (sm_90a): one kernel a stage, one block a tile.
//
// Replaces no TPU kernel: the JAX package's cull (tracer/bvh/cull.py) is XLA
// code. It was added because the port's eager cull ran each stage as about a
// hundred broadcast ATen ops, each writing a whole (tiles x boxes) tensor to
// device memory and reading one or two back: 62.3 M (tile, box) pairs a
// stage-1 pass at pod-1m (32,400 tiles x 1,923 superclusters), and about 270
// launches, each with its Python dispatch, a pass in the small scenes.
//
// What it computes. cull_stage1_kernel: a tile's interval bounds on its
// rays' origins and directions (tile_bounds) and its t_max (_tile_tmax), then
// every supercluster box against them (frustum_aabb_entry), each survivor
// packed into a word (pack_candidates); the survivors, sorted, are the
// prefix of the tile's row of words_s1, their number sup_counts[t], and the
// bounds and t_max go to `tiles` for stage 2. cull_stage2_kernel: the 16
// member clusters (SUPER_FACTOR) of the tile's first sup_counts[t] words,
// each box read by its id (ids >= n_cl do not exist: infeasible), the
// survivors sorted, then WORD_INVALID to the row's end, and their number in
// counts[t]. The arithmetic is the plain version's float32 operations in its
// order, with the IEEE divide (the build's -fmad=false, no fast math), so the
// words are the plain version's bits. The sort is on the words alone: equal
// words are equal ints, so the order is the plain version's.
//
// What bounds it on the card. Operations: 24 a (tile, box) pair (per axis two
// subtractions, two divides and four min/max; compares and selects not
// counted), about 1.5 G a stage-1 pass at pod-1m, 22 us at 67 TFLOP/s. Bytes:
// the rays read once (24 B a ray, 4 more for a per-ray t_max) and the words
// written once: some 50 MB at pod-1m's 2,073,600 rays, 15 us at 3.35 TB/s.
// The boxes (46 KB of superclusters, 738 KB of clusters) stay in L2.
//
// What the design does about it. Nothing of the (tile, box) work reaches
// device memory: a thread tests one box at a time in registers, a survivor
// takes its place in the block's list in shared memory through one atomic a
// warp, and the list is sorted there (a bitonic sort over the next power of
// two of the survivors, so a tile's sort costs what its survivors need) and
// written once. A tile with more survivors than `cap` words (SORT_CAP of
// bvh/cull.py, at most kSortCap) writes them unsorted and the pass sorts its
// words with torch.sort. Threads a block follow the widest list a block can
// meet (the wrapper's choice, from the number of superclusters or S).
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kSuperFactor = 16;      // SUPER_FACTOR of bvh/cluster.py
constexpr int kSortCap = 8192;        // SORT_CAP of bvh/cull.py: words a block sorts
constexpr int kCullThreads = 256;     // the most threads a block
constexpr int kTileFloats = 16;       // TILE_FLOATS of bvh/cull.py
constexpr int kWordInvalid = 0x7FFFFFFF;
constexpr float kEps = 1e-12f;        // _EPS of bvh/cull.py
constexpr unsigned kFull = 0xffffffffu;

// A tile's bounds (tile_bounds) and t_max (_tile_tmax); in `tiles` as
// o_lo, o_hi, d_lo, d_hi (3 floats each), t_max, 3 unused.
struct Tile {
  float o_lo[3], o_hi[3], d_lo[3], d_hi[3], t_max;
};

// The rays of the tiles, by element strides: o, d (Nt, TR, 3); t_max per ray
// (Nt, tm_cols) where tm is not null, else tm_scalar for every tile.
struct Rays {
  const float* o;
  const float* d;
  const float* tm;
  long long so[3], sd[3], st[2];
  int tr, tm_cols;
  float tm_scalar;
};

// _upper_lower of bvh/cull.py: bounds on t from a + t*b <= c (ge false) or
// >= c (ge true).
__device__ __forceinline__ void upper_lower(float a, float b, float c, bool ge, float& lo,
                                            float& hi, bool& ok) {
  const bool pos = b > kEps;
  const bool neg = b < -kEps;
  const float r = (c - a) / (fabsf(b) > kEps ? b : 1.0f);
  if (ge) {
    lo = pos ? r : 0.0f;
    hi = neg ? r : kTFar;
    ok = pos || neg || (a >= c);
  } else {
    lo = neg ? r : 0.0f;
    hi = pos ? r : kTFar;
    ok = pos || neg || (a <= c);
  }
}

// frustum_aabb_entry of bvh/cull.py for one box: feasible, and the entry
// distance in t_lo. A box stops at the first axis that rules it out: ok only
// falls, t_lo only rises and t_hi only falls from one axis to the next, so
// the answer is the plain version's, which tests all three.
__device__ __forceinline__ bool box_entry(const Tile& tl, const float* __restrict__ lo,
                                          const float* __restrict__ hi, float& t_lo) {
  float t_hi = tl.t_max;
  t_lo = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float lo1, hi1, lo2, hi2;
    bool ok1, ok2;
    upper_lower(tl.o_lo[k], tl.d_lo[k], hi[k], false, lo1, hi1, ok1);
    upper_lower(tl.o_hi[k], tl.d_hi[k], lo[k], true, lo2, hi2, ok2);
    t_lo = fmaxf(t_lo, fmaxf(lo1, lo2));
    t_hi = fminf(t_hi, fminf(hi1, hi2));
    if (!(ok1 && ok2 && t_lo <= t_hi)) return false;
  }
  return true;
}

// pack_candidates: the bits of max(t, 0) with -0.0 read as +0.0 (the plain
// version's clamp and + 0.0), the low kClusterBits replaced by the id.
__device__ __forceinline__ int pack_word(float t_lo, int id) {
  const float t = t_lo > 0.0f ? t_lo : 0.0f;
  return (__float_as_int(t) & ~kClMask) | id;
}

// tile_bounds and _tile_tmax of tile `tile` over the block, into *out (every
// thread reads it after the block's next barrier). s_red holds 14 floats a
// warp.
__device__ void reduce_tile(const Rays& r, int tile, Tile* out, float* s_red) {
  float v[13];  // o_lo, d_lo (min); o_hi, d_hi, t_max (max)
#pragma unroll
  for (int c = 0; c < 6; ++c) v[c] = kTFar;
#pragma unroll
  for (int c = 6; c < 12; ++c) v[c] = -kTFar;
  v[12] = __int_as_float(0xff800000);  // -inf
  bool any = false;
  for (int i = threadIdx.x; i < r.tr; i += blockDim.x) {
    const long long po = tile * r.so[0] + i * r.so[1];
    const long long pd = tile * r.sd[0] + i * r.sd[1];
    float o[3], d[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      o[c] = r.o[po + c * r.so[2]];
      d[c] = r.d[pd + c * r.sd[2]];
    }
    if (d[0] != 0.0f || d[1] != 0.0f || d[2] != 0.0f) {  // a live ray
      any = true;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        v[c] = fminf(v[c], o[c]);
        v[3 + c] = fminf(v[3 + c], d[c]);
        v[6 + c] = fmaxf(v[6 + c], o[c]);
        v[9 + c] = fmaxf(v[9 + c], d[c]);
      }
    }
  }
  if (r.tm != nullptr) {
    for (int j = threadIdx.x; j < r.tm_cols; j += blockDim.x)
      v[12] = fmaxf(v[12], r.tm[tile * r.st[0] + j * r.st[1]]);
  } else {
    v[12] = r.tm_scalar;
  }
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int c = 0; c < 13; ++c) {
      const float x = __shfl_xor_sync(kFull, v[c], off);
      v[c] = c < 6 ? fminf(v[c], x) : fmaxf(v[c], x);
    }
  }
  any = __any_sync(kFull, any);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int c = 0; c < 13; ++c) s_red[warp * 14 + c] = v[c];
    s_red[warp * 14 + 13] = any ? 1.0f : 0.0f;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) {
#pragma unroll
      for (int c = 0; c < 13; ++c)
        v[c] = c < 6 ? fminf(v[c], s_red[w * 14 + c]) : fmaxf(v[c], s_red[w * 14 + c]);
      any = any || s_red[w * 14 + 13] != 0.0f;
    }
    // A tile with no live ray: a structurally infeasible frustum.
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      out->o_lo[c] = any ? v[c] : kTFar;
      out->o_hi[c] = any ? v[6 + c] : -kTFar;
      out->d_lo[c] = any ? v[3 + c] : 0.0f;
      out->d_hi[c] = any ? v[9 + c] : 0.0f;
    }
    out->t_max = v[12];
  }
}

// Adds this thread's word w (where keep) to the block's list: at its place
// in the shared buffer below cap, in the tile's row of device memory past it.
// Every thread of the block calls it, the same number of times.
__device__ __forceinline__ void append(bool keep, int w, int* s_count, int* s_buf, int cap,
                                       int* __restrict__ row) {
  const unsigned m = __ballot_sync(kFull, keep);
  if (m == 0) return;
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(m) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(s_count, __popc(m));
  base = __shfl_sync(kFull, base, leader);
  if (keep) {
    const int pos = base + __popc(m & ((1u << lane) - 1u));
    if (pos < cap) {
      s_buf[pos] = w;
    } else {
      row[pos] = w;
    }
  }
}

// Ascending bitonic sort of s[0 .. n), n a power of two, over the block.
__device__ void bitonic_sort(int* s, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = threadIdx.x; p < (n >> 1); p += blockDim.x) {
        const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));  // bit j of i clear
        const int a = s[i], b = s[i | j];
        if ((a > b) == ((i & k) == 0)) {
          s[i] = b;
          s[i | j] = a;
        }
      }
      __syncthreads();
    }
  }
}

// The block's n words (after a barrier that follows the last append) to the
// tile's row: sorted where they fit the buffer, else the buffer's share
// unsorted beside the rest; then WORD_INVALID from n to pad_to.
__device__ void finish(int n, int* s_buf, int cap, int* __restrict__ row, int pad_to) {
  if (n <= cap) {
    int p2 = 1;
    while (p2 < n) p2 <<= 1;
    for (int i = n + threadIdx.x; i < p2; i += blockDim.x) s_buf[i] = kWordInvalid;
    __syncthreads();
    bitonic_sort(s_buf, p2);
    for (int i = threadIdx.x; i < n; i += blockDim.x) row[i] = s_buf[i];
  } else {
    for (int i = threadIdx.x; i < cap; i += blockDim.x) row[i] = s_buf[i];
  }
  for (int i = n + threadIdx.x; i < pad_to; i += blockDim.x) row[i] = kWordInvalid;
}

__global__ void __launch_bounds__(kCullThreads)
cull_stage1_kernel(Rays r, const float* __restrict__ box_lo, const float* __restrict__ box_hi,
                   int n_box, int cap, int* __restrict__ words, int* __restrict__ counts,
                   float* __restrict__ tiles) {
  extern __shared__ int s_buf[];
  __shared__ float s_red[(kCullThreads / 32) * 14];
  __shared__ Tile s_tile;
  __shared__ int s_count;
  const int tile = blockIdx.x;
  if (threadIdx.x == 0) s_count = 0;
  reduce_tile(r, tile, &s_tile, s_red);
  __syncthreads();
  const Tile tl = s_tile;
  int* row = words + (long long)tile * n_box;
  for (int base = 0; base < n_box; base += blockDim.x) {
    const int j = base + threadIdx.x;
    float t_lo = 0.0f;
    const bool keep = j < n_box && box_entry(tl, box_lo + 3 * j, box_hi + 3 * j, t_lo);
    append(keep, keep ? pack_word(t_lo, j) : 0, &s_count, s_buf, cap, row);
  }
  __syncthreads();
  const int n = s_count;
  finish(n, s_buf, cap, row, n);
  if (threadIdx.x == 0) {
    counts[tile] = n;
    float* out = tiles + (long long)tile * kTileFloats;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      out[c] = tl.o_lo[c];
      out[3 + c] = tl.o_hi[c];
      out[6 + c] = tl.d_lo[c];
      out[9 + c] = tl.d_hi[c];
    }
    out[12] = tl.t_max;
  }
}

__global__ void __launch_bounds__(kCullThreads)
cull_stage2_kernel(const float* __restrict__ tiles, const int* __restrict__ words_s1,
                   int s1_stride, const int* __restrict__ sup_counts,
                   const float* __restrict__ cl_lo, const float* __restrict__ cl_hi, int n_cl,
                   int width, int cap, int* __restrict__ words, int* __restrict__ counts) {
  extern __shared__ int s_buf[];
  __shared__ int s_count;
  const int tile = blockIdx.x;
  const float* in = tiles + (long long)tile * kTileFloats;
  Tile tl;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    tl.o_lo[c] = in[c];
    tl.o_hi[c] = in[3 + c];
    tl.d_lo[c] = in[6 + c];
    tl.d_hi[c] = in[9 + c];
  }
  tl.t_max = in[12];
  if (threadIdx.x == 0) s_count = 0;
  __syncthreads();
  const int* sup = words_s1 + (long long)tile * s1_stride;
  const int n_cand = sup_counts[tile] * kSuperFactor;
  int* row = words + (long long)tile * width;
  for (int base = 0; base < n_cand; base += blockDim.x) {
    const int j = base + threadIdx.x;
    const int cl = j < n_cand ? (sup[j / kSuperFactor] & kClMask) * kSuperFactor +
                                    j % kSuperFactor
                              : n_cl;
    float t_lo = 0.0f;
    const bool keep = cl < n_cl && box_entry(tl, cl_lo + 3LL * cl, cl_hi + 3LL * cl, t_lo);
    append(keep, keep ? pack_word(t_lo, cl) : 0, &s_count, s_buf, cap, row);
  }
  __syncthreads();
  const int n = s_count;
  finish(n, s_buf, cap, row, width);
  if (threadIdx.x == 0) counts[tile] = n;
}

// threads a multiple of 32 up to kCullThreads; cap a power of two up to
// kSortCap (the shared buffer's words).
inline bool bad_shape(int threads, int cap) {
  return threads < 32 || threads > kCullThreads || threads % 32 || cap < 1 ||
         cap > kSortCap || (cap & (cap - 1));
}

}  // namespace

extern "C" {

// o, d (float, n_tiles x tr x 3) and the per-ray t_max tm (float, n_tiles x
// tm_cols; null: tm_scalar) by element strides; box_lo, box_hi (float, n_box
// x 3). Writes words (int, n_tiles x n_box: each row's sorted prefix),
// counts (int, n_tiles) and tiles (float, n_tiles x 16).
int cu_stage1(const void* o, const void* d, long long so0, long long so1, long long so2,
              long long sd0, long long sd1, long long sd2, const void* tm, long long st0,
              long long st1, int tm_cols, float tm_scalar, int n_tiles, int tr,
              const void* box_lo, const void* box_hi, int n_box, int threads, int cap,
              void* words, void* counts, void* tiles, void* stream) {
  if (bad_shape(threads, cap) || n_tiles < 0 || tr < 1) return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return 0;
  const Rays r{(const float*)o, (const float*)d, (const float*)tm, {so0, so1, so2},
               {sd0, sd1, sd2}, {st0, st1}, tr, tm_cols, tm_scalar};
  const size_t smem = (size_t)cap * sizeof(int);
  cudaError_t e = launch_prep(cull_stage1_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  cull_stage1_kernel<<<n_tiles, threads, smem, (cudaStream_t)stream>>>(
      r, (const float*)box_lo, (const float*)box_hi, n_box, cap, (int*)words, (int*)counts,
      (float*)tiles);
  return (int)cudaGetLastError();
}

// tiles from cu_stage1; words_s1 (int, rows of s1_stride) and sup_counts
// (int, n_tiles) its survivors; cl_lo, cl_hi (float, n_cl x 3). Writes
// words (int, n_tiles x width, width >= 16 x every sup_counts) and counts.
int cu_stage2(const void* tiles, const void* words_s1, int s1_stride, const void* sup_counts,
              int n_tiles, const void* cl_lo, const void* cl_hi, int n_cl, int width,
              int threads, int cap, void* words, void* counts, void* stream) {
  if (bad_shape(threads, cap) || n_tiles < 0) return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return 0;
  const size_t smem = (size_t)cap * sizeof(int);
  cudaError_t e = launch_prep(cull_stage2_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  cull_stage2_kernel<<<n_tiles, threads, smem, (cudaStream_t)stream>>>(
      (const float*)tiles, (const int*)words_s1, s1_stride, (const int*)sup_counts,
      (const float*)cl_lo, (const float*)cl_hi, n_cl, width, cap, (int*)words, (int*)counts);
  return (int)cudaGetLastError();
}

}  // extern "C"
