// Closest-hit and any-hit traversal kernels for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of tracer/kernels/traversal2.py:
//   closest_hit_kernel   <- _closest_kernel       (generic while-loop region)
//   closest_fast_kernel  <- _closest_fast_kernel  (tiles with count <= 1)
//   anyhit_kernel        <- _anyhit_kernel        (light-origin shadow segments)
//
// What they compute. A tile is TR rays (one block, one thread per ray) plus
// the tile's candidate clusters: packed int32 words (entry-t bits | cluster
// id), sorted front to back by the cull. A cluster is C triangles stored as
// a (4, 3C) matrix of affine maps (bvh/cluster.py): for a homogeneous ray
// (o, 1) + t (d, 0), column f*C + lane gives the plane value (f = 0) and the
// two barycentrics (f = 1, 2) of triangle `lane`. Per ray and triangle:
//   so = ((w3 + o0*w0) + o1*w1) + o2*w2,  sd = (d0*w0 + d1*w1) + d2*w2
//   t = -so_n / sd_n,  u = so_u + t*sd_u,  v = so_v + t*sd_v
//   hit iff u >= 0, v >= 0, 1-u-v >= 0, kTMin < t < t_max, |sd_n| > 1e-12
// in exactly that operation order. Built with -fmad=false and without fast
// math, the products and the IEEE divide round as the plain PyTorch version
// (kernels/traversal2.py) rounds them, so the two agree bit for bit.
//
// What bounds them on the card. The work is fp32 arithmetic with one IEEE
// divide per (ray, triangle): ~45 flops plus the divide's instruction
// sequence for 12 floats of coefficients, which every ray of the tile
// shares. Device-memory traffic is small (a cluster is 6 KB at C = 128 and
// the whole bench100k accel, 4.9 MB, stays in the 50 MB L2), so the kernels
// are bound by issue of fp32 instructions, and, at the tails, by tiles with
// long candidate lists that keep one block busy while the rest of the grid
// has drained.
//
// What the design does about it. The block stages kBatch candidate clusters at a
// time in shared memory, transposed so that one triangle's 12 coefficients
// are three float4s: every thread of the block reads the same address, a
// broadcast, and the loop body is three 16-byte shared loads and the
// arithmetic above. Candidates past the tile's early-out bound are skipped:
// the closest-hit bound is the block max of the rays' best t (compared as
// IEEE bits, order-isomorphic for t >= 0), the any-hit bound the block max
// of t_max over the rays still unoccluded. The TPU's lockstep group of 8
// tiles is dropped: blocks are independent here and each stops on its own.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kClusterBits = 17;
constexpr int kClMask = (1 << kClusterBits) - 1;
constexpr float kTFar = 1e30f;
constexpr int kIntMax = 2147483647;
constexpr float kTMin = 1e-4f;  // T_MIN of kernels/traversal.py
// Candidate clusters staged per step of the closest-hit and any-hit loops
// (kBatch * 6 KB of shared memory at C = 128); BATCH of kernels/traversal2.py.
constexpr int kBatch = 4;

// Stage the clusters of candidate slots k .. k+n_load-1 into shared memory:
// s[(j*C + lane)*3 + f] = column f*C + lane of cluster j's (4, 3C) matrix.
// Slots past the word list replay its last word, as the reference does.
__device__ __forceinline__ void stage_clusters(float4* s, const float* __restrict__ w,
                                               const int* __restrict__ wt, int k,
                                               int n_load, int k_cap, int n_cl, int c) {
  const int per = 3 * c;
  for (int idx = threadIdx.x; idx < n_load * per; idx += blockDim.x) {
    const int j = idx / per;
    const int col = idx - j * per;
    const int cl = min(wt[min(k + j, k_cap - 1)] & kClMask, n_cl - 1);
    const float* wc = w + (size_t)cl * 4 * per;
    const int f = col / c;
    const int lane = col - f * c;
    s[(j * c + lane) * 3 + f] =
        make_float4(wc[col], wc[per + col], wc[2 * per + col], wc[3 * per + col]);
  }
}

// t of one (ray, triangle) pair, or kTFar when the pair does not hit.
__device__ __forceinline__ float tri_t(const float4* p, float4 o, float4 d, float t_max) {
  const float4 n = p[0], a = p[1], b = p[2];
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

// Max of v over the block (blockDim.x a multiple of 32); every thread gets it.
__device__ __forceinline__ int block_max(int v, int* s_red) {
  for (int off = 16; off > 0; off >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, off));
  __syncthreads();  // earlier readers of s_red are done
  if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = s_red[0];
  for (int i = 1; i < (int)(blockDim.x >> 5); ++i) v = max(v, s_red[i]);
  return v;
}

// Closest hit over a tile's sorted candidates, kBatch clusters per step. Per ray:
// within a step the earliest candidate j wins a lane (strict <), across lanes
// the smallest t and on equal t the smaller slot cl*C + lane, and a step
// replaces the running best only on a strict < (traversal2.py:_batch_best).
__global__ void closest_hit_kernel(const int* __restrict__ words, const int* __restrict__ counts,
                                   int k_cap, const float4* __restrict__ o4,
                                   const float4* __restrict__ d4, const float* __restrict__ w,
                                   int n_cl, int c, float* __restrict__ bt_out,
                                   int* __restrict__ bid_out) {
  extern __shared__ float4 s_w[];
  __shared__ int s_red[32];
  const int tile = blockIdx.x;
  const size_t ray = (size_t)tile * blockDim.x + threadIdx.x;
  const int n = counts[tile];
  const int* wt = words + (size_t)tile * k_cap;
  const float4 o = o4[ray], d = d4[ray];
  float bt = kTFar;
  int bid = -1;
  int bound = __float_as_int(kTFar);
  for (int k = 0; k < n; k += kBatch) {
    if ((wt[k] & ~kClMask) >= bound) break;  // block-uniform
    __syncthreads();                          // the last step's readers are done
    stage_clusters(s_w, w, wt, k, kBatch, k_cap, n_cl, c);
    __syncthreads();
    int cl[kBatch];
    bool live[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      cl[j] = min(wt[min(k + j, k_cap - 1)] & kClMask, n_cl - 1);
      live[j] = k + j < n;
    }
    float tb = kTFar;
    int tbid = kIntMax;
    for (int lane = 0; lane < c; ++lane) {
      float m = kTFar;
      int mb = 0;
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const float tv = live[j] ? tri_t(s_w + (j * c + lane) * 3, o, d, kTFar) : kTFar;
        if (j == 0 || tv < m) {
          m = tv;
          mb = cl[j] * c + lane;
        }
      }
      if (m < tb || (m == tb && mb < tbid)) {
        tb = m;
        tbid = mb;
      }
    }
    if (tb < bt) {
      bt = tb;
      bid = tbid;
    }
    bound = block_max(__float_as_int(bt), s_red);
  }
  bt_out[ray] = bt;
  bid_out[ray] = bid;
}

// Closest hit for tiles with at most one candidate: one unconditional
// cluster, no loop and no bound.
__global__ void closest_fast_kernel(const int* __restrict__ words, const int* __restrict__ counts,
                                    int k_cap, const float4* __restrict__ o4,
                                    const float4* __restrict__ d4, const float* __restrict__ w,
                                    int n_cl, int c, float* __restrict__ bt_out,
                                    int* __restrict__ bid_out) {
  extern __shared__ float4 s_w[];
  const int tile = blockIdx.x;
  const size_t ray = (size_t)tile * blockDim.x + threadIdx.x;
  const bool live = 0 < counts[tile];
  const int* wt = words + (size_t)tile * k_cap;
  const float4 o = o4[ray], d = d4[ray];
  stage_clusters(s_w, w, wt, 0, 1, k_cap, n_cl, c);
  __syncthreads();
  const int cl = min(wt[0] & kClMask, n_cl - 1);
  float tb = kTFar;
  int tbid = kIntMax;
  for (int lane = 0; lane < c; ++lane) {
    const float tv = live ? tri_t(s_w + lane * 3, o, d, kTFar) : kTFar;
    const int b = cl * c + lane;
    if (tv < tb || (tv == tb && b < tbid)) {
      tb = tv;
      tbid = b;
    }
  }
  const bool hit = tb < kTFar;
  bt_out[ray] = hit ? tb : kTFar;
  bid_out[ray] = hit ? tbid : -1;
}

// Occlusion: a ray is occluded iff some candidate triangle has t in
// (kTMin, t_max[ray]). Stops once every ray is occluded, or once the next
// word's entry bits reach the max t_max of the rays still unoccluded.
__global__ void anyhit_kernel(const int* __restrict__ words, const int* __restrict__ counts,
                              int k_cap, const float4* __restrict__ o4,
                              const float4* __restrict__ d4, const float* __restrict__ tmax,
                              const float* __restrict__ w, int n_cl, int c,
                              uint8_t* __restrict__ occ_out) {
  extern __shared__ float4 s_w[];
  __shared__ int s_red[32];
  const int tile = blockIdx.x;
  const size_t ray = (size_t)tile * blockDim.x + threadIdx.x;
  const int n = counts[tile];
  const int* wt = words + (size_t)tile * k_cap;
  const float4 o = o4[ray], d = d4[ray];
  const float tm = tmax[ray];
  bool occ = false;
  int bound = block_max(__float_as_int(tm), s_red);
  for (int k = 0; k < n; k += kBatch) {
    if ((wt[k] & ~kClMask) >= bound) break;  // block-uniform; all occluded -> bound 0
    __syncthreads();
    stage_clusters(s_w, w, wt, k, kBatch, k_cap, n_cl, c);
    __syncthreads();
    if (!occ) {
      int n_live = min(kBatch, n - k);
      for (int lane = 0; lane < c && !occ; ++lane) {
        for (int j = 0; j < n_live; ++j) {
          if (tri_t(s_w + (j * c + lane) * 3, o, d, tm) < kTFar) {
            occ = true;
            break;
          }
        }
      }
    }
    bound = block_max(__float_as_int(occ ? 0.0f : tm), s_red);
  }
  occ_out[ray] = occ ? 1 : 0;
}

template <typename K>
cudaError_t launch_prep(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

size_t stage_bytes(int batch, int c) { return (size_t)batch * c * 3 * sizeof(float4); }

}  // namespace

// C entry points: pointers and the stream as void*, one launch each on the
// given stream; each returns cudaGetLastError() (0 on success).
extern "C" {

int tt_closest(const void* words, const void* counts, int n_tiles, int k_cap, int tr,
               const void* o4, const void* d4, const void* w, int n_cl, int c, void* bt,
               void* bid, void* stream) {
  const size_t smem = stage_bytes(kBatch, c);
  cudaError_t e = launch_prep(closest_hit_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  closest_hit_kernel<<<n_tiles, tr, smem, (cudaStream_t)stream>>>(
      (const int*)words, (const int*)counts, k_cap, (const float4*)o4, (const float4*)d4,
      (const float*)w, n_cl, c, (float*)bt, (int*)bid);
  return (int)cudaGetLastError();
}

int tt_closest_fast(const void* words, const void* counts, int n_tiles, int k_cap, int tr,
                    const void* o4, const void* d4, const void* w, int n_cl, int c, void* bt,
                    void* bid, void* stream) {
  const size_t smem = stage_bytes(1, c);
  cudaError_t e = launch_prep(closest_fast_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  closest_fast_kernel<<<n_tiles, tr, smem, (cudaStream_t)stream>>>(
      (const int*)words, (const int*)counts, k_cap, (const float4*)o4, (const float4*)d4,
      (const float*)w, n_cl, c, (float*)bt, (int*)bid);
  return (int)cudaGetLastError();
}

int tt_anyhit(const void* words, const void* counts, int n_tiles, int k_cap, int tr,
              const void* o4, const void* d4, const void* tmax, const void* w, int n_cl, int c,
              void* occ, void* stream) {
  const size_t smem = stage_bytes(kBatch, c);
  cudaError_t e = launch_prep(anyhit_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  anyhit_kernel<<<n_tiles, tr, smem, (cudaStream_t)stream>>>(
      (const int*)words, (const int*)counts, k_cap, (const float4*)o4, (const float4*)d4,
      (const float*)tmax, (const float*)w, n_cl, c, (uint8_t*)occ);
  return (int)cudaGetLastError();
}

}  // extern "C"
