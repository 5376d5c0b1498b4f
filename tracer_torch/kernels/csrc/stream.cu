// Streamed closest-hit and any-hit traversal kernels for Hopper (sm_90a): the
// big-scene tier, whose accel does not fit in L2.
//
// Replaces the Pallas TPU kernels of tracer/kernels/stream.py:
//   closest_stream_kernel  <- _closest_stream_kernel  (via trace_tiles_streamed)
//   anyhit_stream_kernel   <- _anyhit_stream_kernel   (via any_hit_tiles_streamed)
//
// What they compute: what closest_hit_kernel and anyhit_kernel of
// traversal2.cu compute, at kBatch = 2 candidate clusters a step (STREAM_BATCH
// of kernels/stream.py), with the same arithmetic in the same operation
// order (tri_t below), built with -fmad=false and without fast math, so that
// they agree bit for bit with the plain PyTorch versions
// (kernels/traversal2.py closest_hit_plain / anyhit_plain at batch=2). A tile
// is one block, one thread per ray; each block stops on its own early-out
// bound. The TPU kernels' lockstep group of 8 tiles, packed cluster pairs
// (_pad_w) and SMEM word chunks are not carried over.
//
// What bounds them on the card. At pod-1m (3.94M triangles, 30,757 clusters)
// the accel's tri_w is 189 MB, almost four times the 50 MB L2, so a
// candidate cluster is in general a miss to device memory: a synchronous
// fetch would stall the block for the memory latency (~1 us) at every
// candidate. Once that latency is hidden, the work per candidate is fp32
// issue: 64 rays x 128 triangles x (~45 flops and an IEEE divide) against
// 6 KB of coefficients, an order of magnitude more issue time than the
// bandwidth time of the 6 KB.
//
// What the design does about it. Each block keeps a ring of kNBuf = 4
// cluster stages in shared memory (4 x 6 KB at C = 128), filled with
// cp.async 16-byte copies, one commit group per candidate. A cluster's
// (4, 3C) matrix is contiguous in tri_w and copies as it is. The copies of
// candidates k+2 and k+3 are in flight while the block intersects k and
// k+1; once a step's fold is done, its two stages are refilled with k+4 and
// k+5 (the reference's ring: the fetch of candidate k+NBUF overlaps the
// intersections in between). Slots past the tile's count replay its last
// word, a harmless re-fetch of a line just read, and every copy issued is
// waited for before the block exits (the drain of stream.py:109-113).
// Layout: the block reads the (4, 3C) stage as it landed, as 16-byte
// broadcast loads that each cover one coefficient of 4 consecutive
// triangles, so 4 triangles cost 12 loads, 3 a triangle (as traversal2.cu's
// transposed stage), with no triangle-major copy of the accel.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kClusterBits = 17;
constexpr int kClMask = (1 << kClusterBits) - 1;
constexpr float kTFar = 1e30f;
constexpr int kIntMax = 2147483647;
constexpr float kTMin = 1e-4f;  // T_MIN of kernels/traversal.py
constexpr int kNBuf = 4;        // NBUF of kernels/stream.py
constexpr int kBatch = 2;       // STREAM_BATCH of kernels/stream.py
constexpr int kLanes = 4;       // triangles per 16-byte coefficient load

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's commit groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ int word_cluster(const int* wt, int k, int n, int n_cl) {
  return min(wt[min(k, n - 1)] & kClMask, n_cl - 1);
}

// Issue the copy of candidate k's cluster (k past the count replays the
// tile's last word) into ring stage k % kNBuf: `per4` 16-byte chunks, as one
// commit group.
__device__ __forceinline__ void fetch(float4* ring, const float4* __restrict__ w, const int* wt,
                                      int k, int n, int n_cl, int per4) {
  const float4* src = w + (size_t)word_cluster(wt, k, n, n_cl) * per4;
  float4* dst = ring + (k % kNBuf) * per4;
  for (int i = threadIdx.x; i < per4; i += blockDim.x) cp_async16(dst + i, src + i);
  cp_async_commit();
}

// The coefficients of triangles lane0 .. lane0+3 of a (4, 3C) stage:
// q[r][f] holds row r of field f (plane, bary-u, bary-v) for the 4 lanes.
struct Quad {
  float4 q[4][3];
};

__device__ __forceinline__ void load_quad(Quad& a, const float4* stage, int c4, int lane4) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int f = 0; f < 3; ++f) a.q[r][f] = stage[(r * 3 + f) * c4 + lane4];
}

__device__ __forceinline__ float comp(float4 v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Field f of triangle i of the quad as (x, y, z, w) coefficients.
__device__ __forceinline__ float4 field(const Quad& a, int f, int i) {
  return make_float4(comp(a.q[0][f], i), comp(a.q[1][f], i), comp(a.q[2][f], i),
                     comp(a.q[3][f], i));
}

// t of one (ray, triangle) pair, or kTFar when the pair does not hit:
// traversal2.cu's tri_t, operation for operation.
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

__device__ __forceinline__ float quad_t(const Quad& a, int i, float4 o, float4 d, float t_max) {
  return tri_t(field(a, 0, i), field(a, 1, i), field(a, 2, i), o, d, t_max);
}

// Max of v over the block (blockDim.x a multiple of 32); every thread gets it.
// Its first __syncthreads also orders every earlier shared-memory read of
// the block before what follows the call.
__device__ __forceinline__ int block_max(int v, int* s_red) {
  for (int off = 16; off > 0; off >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, off));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = s_red[0];
  for (int i = 1; i < (int)(blockDim.x >> 5); ++i) v = max(v, s_red[i]);
  return v;
}

// Closest hit over a tile's sorted candidates, kBatch clusters a step. Per
// ray: within a step the earliest candidate j wins a lane (strict <), across
// lanes the smallest t and on equal t the smaller slot cl*C + lane, and a
// step replaces the running best only on a strict < (traversal2.py:_batch_best).
// Stops once the next word's entry bits reach the block max of the best t.
__global__ void closest_stream_kernel(const int* __restrict__ words,
                                      const int* __restrict__ counts, int k_cap,
                                      const float4* __restrict__ o4,
                                      const float4* __restrict__ d4,
                                      const float4* __restrict__ w, int n_cl, int c,
                                      float* __restrict__ bt_out, int* __restrict__ bid_out) {
  extern __shared__ float4 ring[];
  __shared__ int s_red[32];
  const int tile = blockIdx.x;
  const size_t ray = (size_t)tile * blockDim.x + threadIdx.x;
  const int n = counts[tile];
  const int* wt = words + (size_t)tile * k_cap;
  const int per4 = 3 * c;  // 16-byte chunks of one (4, 3C) cluster
  const int c4 = c / kLanes;
  const float4 o = o4[ray], d = d4[ray];
  float bt = kTFar;
  int bid = -1;
  if (n > 0) {  // block-uniform
    for (int b = 0; b < kNBuf; ++b) fetch(ring, w, wt, b, n, n_cl, per4);
    int bound = __float_as_int(kTFar);
    for (int k = 0; k < n; k += kBatch) {
      if ((wt[k] & ~kClMask) >= bound) break;  // block-uniform
      cp_async_wait<kNBuf - kBatch>();          // this thread's part of k .. k+kBatch-1
      __syncthreads();                          // everyone's part
      int cl[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) cl[j] = word_cluster(wt, k + j, n, n_cl);
      float tb = kTFar;
      int tbid = kIntMax;
      for (int l4 = 0; l4 < c4; ++l4) {
        float m[kLanes];
        int mb[kLanes];
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          if (j > 0 && k + j >= n) break;  // candidate k is live inside the loop
          Quad a;
          load_quad(a, ring + ((k + j) % kNBuf) * per4, c4, l4);
#pragma unroll
          for (int i = 0; i < kLanes; ++i) {
            const float tv = quad_t(a, i, o, d, kTFar);
            if (j == 0 || tv < m[i]) {
              m[i] = tv;
              mb[i] = cl[j] * c + l4 * kLanes + i;
            }
          }
        }
#pragma unroll
        for (int i = 0; i < kLanes; ++i) {
          if (m[i] < tb || (m[i] == tb && mb[i] < tbid)) {
            tb = m[i];
            tbid = mb[i];
          }
        }
      }
      if (tb < bt) {
        bt = tb;
        bid = tbid;
      }
      bound = block_max(__float_as_int(bt), s_red);  // the two stages are read
      for (int j = 0; j < kBatch; ++j) fetch(ring, w, wt, k + j + kNBuf, n, n_cl, per4);
    }
    cp_async_wait<0>();  // drain the copies still in flight
  }
  bt_out[ray] = bt;
  bid_out[ray] = bid;
}

// Occlusion: a ray is occluded iff some candidate triangle has t in
// (kTMin, tmax[ray]), kBatch clusters a step. Stops once the next word's
// entry bits reach the block max of tmax over the rays still unoccluded
// (0 once all are).
__global__ void anyhit_stream_kernel(const int* __restrict__ words,
                                     const int* __restrict__ counts, int k_cap,
                                     const float4* __restrict__ o4,
                                     const float4* __restrict__ d4,
                                     const float* __restrict__ tmax,
                                     const float4* __restrict__ w, int n_cl, int c,
                                     uint8_t* __restrict__ occ_out) {
  extern __shared__ float4 ring[];
  __shared__ int s_red[32];
  const int tile = blockIdx.x;
  const size_t ray = (size_t)tile * blockDim.x + threadIdx.x;
  const int n = counts[tile];
  const int* wt = words + (size_t)tile * k_cap;
  const int per4 = 3 * c;
  const int c4 = c / kLanes;
  const float4 o = o4[ray], d = d4[ray];
  const float tm = tmax[ray];
  bool occ = false;
  if (n > 0) {  // block-uniform
    for (int b = 0; b < kNBuf; ++b) fetch(ring, w, wt, b, n, n_cl, per4);
    int bound = block_max(__float_as_int(tm), s_red);
    for (int k = 0; k < n; k += kBatch) {
      if ((wt[k] & ~kClMask) >= bound) break;  // block-uniform
      cp_async_wait<kNBuf - kBatch>();
      __syncthreads();
      const int n_live = min(kBatch, n - k);
      for (int l4 = 0; l4 < c4 && !occ; ++l4) {
        for (int j = 0; j < n_live && !occ; ++j) {
          Quad a;
          load_quad(a, ring + ((k + j) % kNBuf) * per4, c4, l4);
#pragma unroll
          for (int i = 0; i < kLanes; ++i) occ = occ || quad_t(a, i, o, d, tm) < kTFar;
        }
      }
      bound = block_max(__float_as_int(occ ? 0.0f : tm), s_red);  // the two stages are read
      for (int j = 0; j < kBatch; ++j) fetch(ring, w, wt, k + j + kNBuf, n, n_cl, per4);
    }
    cp_async_wait<0>();
  }
  occ_out[ray] = occ ? 1 : 0;
}

template <typename K>
cudaError_t launch_prep(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

size_t ring_bytes(int c) { return (size_t)kNBuf * 3 * c * sizeof(float4); }

}  // namespace

// C entry points: pointers and the stream as void*, one launch each on the
// given stream; each returns cudaGetLastError() (0 on success). The caller
// guarantees c % 4 == 0 and 16-byte aligned w, o4 and d4.
extern "C" {

int st_closest(const void* words, const void* counts, int n_tiles, int k_cap, int tr,
               const void* o4, const void* d4, const void* w, int n_cl, int c, void* bt,
               void* bid, void* stream) {
  const size_t smem = ring_bytes(c);
  cudaError_t e = launch_prep(closest_stream_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  closest_stream_kernel<<<n_tiles, tr, smem, (cudaStream_t)stream>>>(
      (const int*)words, (const int*)counts, k_cap, (const float4*)o4, (const float4*)d4,
      (const float4*)w, n_cl, c, (float*)bt, (int*)bid);
  return (int)cudaGetLastError();
}

int st_anyhit(const void* words, const void* counts, int n_tiles, int k_cap, int tr,
              const void* o4, const void* d4, const void* tmax, const void* w, int n_cl, int c,
              void* occ, void* stream) {
  const size_t smem = ring_bytes(c);
  cudaError_t e = launch_prep(anyhit_stream_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  anyhit_stream_kernel<<<n_tiles, tr, smem, (cudaStream_t)stream>>>(
      (const int*)words, (const int*)counts, k_cap, (const float4*)o4, (const float4*)d4,
      (const float*)tmax, (const float4*)w, n_cl, c, (uint8_t*)occ);
  return (int)cudaGetLastError();
}

}  // extern "C"
