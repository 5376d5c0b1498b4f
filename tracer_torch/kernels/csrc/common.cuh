// What the traversal kernels of this directory share: the packed-word
// constants, the (ray, triangle) test of the tri_t family, the block-wide max,
// the segmented kernels' claim of a segment and the launch preparation. Every
// function is inline, so each source keeps its own copy of what it uses.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kClusterBits = 17;  // CLUSTER_BITS of bvh/cull.py
constexpr int kClMask = (1 << kClusterBits) - 1;
constexpr float kTFar = 1e30f;
constexpr int kIntMax = 2147483647;
constexpr float kTMin = 1e-4f;  // T_MIN of kernels/traversal.py

// The sorted any-hit kernels (anyhit_kernel, anyhit_stream_kernel) cut a
// tile's candidate run into segments of kSeg words, and serve each ray of a
// segment with kSlices threads, one per slice of a cluster's triangles: SEG
// and SLICES of kernels/traversal2.py.
constexpr int kSeg = 8;
constexpr int kSlices = 4;
constexpr int kMaxRays = 1024 / kSlices;  // a block is kSlices threads a ray

// t of one (ray, triangle) pair, or kTFar when the pair does not hit; n, a, b
// are the triangle's plane, bary-u and bary-v coefficients. The operation
// order is _cluster_t's (kernels/traversal2.py).
__device__ __forceinline__ float tri_t(float4 n, float4 a, float4 b, float4 o, float4 d,
                                       float t_max) {
  const float so_n = ((n.w + o.x * n.x) + o.y * n.y) + o.z * n.z;
  const float so_u = ((a.w + o.x * a.x) + o.y * a.y) + o.z * a.z;
  const float so_v = ((b.w + o.x * b.x) + o.y * b.y) + o.z * b.z;
  const float sd_n = (d.x * n.x + d.y * n.y) + d.z * n.z;
  const float sd_u = (d.x * a.x + d.y * a.y) + d.z * a.z;
  const float sd_v = (d.x * b.x + d.y * b.y) + d.z * b.z;
  const float t = -so_n / sd_n;
  const float u = so_u + t * sd_u;
  const float v = so_v + t * sd_v;
  const bool ok = (u >= 0.0f) && (v >= 0.0f) && ((1.0f - u - v) >= 0.0f) &&
                  (t > kTMin) && (t < t_max) && (fabsf(sd_n) > 1e-12f);
  return ok ? t : kTFar;
}

// The same for a triangle staged as three consecutive float4s.
__device__ __forceinline__ float tri_t(const float4* p, float4 o, float4 d, float t_max) {
  return tri_t(p[0], p[1], p[2], o, d, t_max);
}

// Max of v over the block (blockDim.x a multiple of 32); every thread gets it.
// Its first __syncthreads also orders every earlier shared-memory access of
// the block before what follows the call.
__device__ __forceinline__ int block_max(int v, int* s_red) {
  for (int off = 16; off > 0; off >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, off));
  __syncthreads();  // earlier readers of s_red are done
  if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = s_red[0];
  for (int i = 1; i < (int)(blockDim.x >> 5); ++i) v = max(v, s_red[i]);
  return v;
}

// The early-out bound a ray contributes to its tile: the bits of its t_max
// while it is unoccluded, 0 once it is (t >= 0, so the bits order as the
// floats do).
__device__ __forceinline__ int open_bits(bool occ, float t_max) {
  return __float_as_int(occ ? 0.0f : t_max);
}

// Words (or items of the run) k0 .. k1-1 of tile `tile`; tile < 0 when no
// segment is left.
struct Segment {
  int tile, k0, k1;
};

// One thread's claim of the next segment of kSegLen words from the counter
// *next_seg, into the three ints `out` of shared memory. The table
// (kernels/_launch.py run_segments) is `order`, the tiles by descending count,
// and `ends`, the running number of segments after each of the n_ranks ranks:
// segment s of rank r (ends[r-1] <= s < ends[r]) is the words from r * kSegLen
// on of tile order[s - ends[r-1]]. `rank` is the claiming thread's cursor into
// ends: the counter only rises, so the cursor never moves back.
template <int kSegLen>
__device__ __forceinline__ void claim_segment(int* out, int* next_seg, int& rank,
                                              const long long* __restrict__ order,
                                              const int* __restrict__ ends, int n_ranks,
                                              const int* __restrict__ counts) {
  const int s = atomicAdd(next_seg, 1);
  while (rank < n_ranks && s >= ends[rank]) ++rank;
  if (rank < n_ranks) {
    const int tile = (int)order[s - (rank ? ends[rank - 1] : 0)];
    out[0] = tile;
    out[1] = rank * kSegLen;
    out[2] = min(rank * kSegLen + kSegLen, counts[tile]);
  } else {
    out[0] = -1;
    out[1] = out[2] = 0;
  }
}

__device__ __forceinline__ Segment read_segment(const int* s) {
  return Segment{s[0], s[1], s[2]};
}

template <typename K>
inline cudaError_t launch_prep(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}
