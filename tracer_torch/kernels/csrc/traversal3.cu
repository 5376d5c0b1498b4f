// Pair-stream closest-hit and any-hit kernels for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of tracer/kernels/traversal3.py:
//   pair_closest_kernel <- _pair_closest_kernel (via trace_tiles_pairs)
//   pair_anyhit_kernel  <- _pair_anyhit_kernel  (via any_hit_tiles_pairs)
//
// What they compute. A tile is TR rays (one block, one thread per ray). Its
// pairs are the packed words (entry-t bits | cluster id) offs[tile] ..
// offs[tile+1] of one global stream, sorted front to back within the tile.
// The block walks its run one pair a step:
//   * it stops at the first word whose entry bits reach the tile's bound:
//     the block max of the rays' best t (closest hit), or of t_max over the
//     rays not yet occluded (any-hit), compared as IEEE bits (order-
//     isomorphic for t >= 0). The run is sorted, so every later word would
//     be skipped too;
//   * every ray slab-tests the cluster's box (kernels/traversal3.py:
//     _slab_enter) and the cluster is skipped unless some ray enters it
//     before its own best t (any-hit: before its t_max, and is unoccluded);
//   * a tested cluster is intersected by EVERY ray of the tile, pruned or
//     not, with tri_t, the arithmetic of traversal2.cu:
//       so = ((w3 + o0*w0) + o1*w1) + o2*w2,  sd = (d0*w0 + d1*w1) + d2*w2
//       t = -so_n / sd_n,  u = so_u + t*sd_u,  v = so_v + t*sd_v
//       hit iff u >= 0, v >= 0, 1-u-v >= 0, kTMin < t < t_max, |sd_n| > 1e-12
//     Closest hit takes the first lane that attains the cluster's minimum
//     and replaces the running best only on a strict <.
// Built with -fmad=false and without fast math, the slab products, the
// triangle products and the divides round as the plain PyTorch version
// (kernels/traversal3.py) rounds them, so both take the same stop and skip
// decisions and agree bit for bit.
//
// What bounds them on the card. The fp32 pipes, as for traversal2.cu: the
// bench100k accel (4.9 MB) stays in L2, a tested cluster costs TR x C
// triangle tests of ~40 flops and a divide, a pruned one ~30 flops a ray.
// The tile with the longest tested run finishes last.
//
// What the design does about it. One cluster per step (B = 1), staged in
// shared memory transposed so that a triangle's 12 coefficients are three
// float4 broadcast loads; the prune votes with __syncthreads_or, which is
// also the barrier that frees the stage. A tile's state (best t, slot,
// occlusion, bound) lives in registers for the whole run: the stream is a
// flat list in device memory, so a heavy tile's run could later be split
// across blocks without changing the list.
#include "common.cuh"

namespace {

// s[lane*3 + f] = column f*C + lane of cluster cl's (4, 3C) matrix.
__device__ __forceinline__ void stage_cluster(float4* s, const float* __restrict__ w, int cl,
                                              int c) {
  const int per = 3 * c;
  const float* wc = w + (size_t)cl * 4 * per;
  for (int col = threadIdx.x; col < per; col += blockDim.x) {
    const int f = col / c;
    const int lane = col - f * c;
    s[lane * 3 + f] = make_float4(wc[col], wc[per + col], wc[2 * per + col], wc[3 * per + col]);
  }
}

// min and max that hand on a NaN, as torch.minimum and torch.maximum do.
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fminf(a, b));
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}

// A ray as the slab test reads it: origin, 1/d (0 on a degenerate axis) and
// whether the ray is real (some d != 0).
struct SlabRay {
  float o[3], inv[3];
  bool live;
};

__device__ __forceinline__ SlabRay slab_ray(float4 o, float4 d) {
  SlabRay r;
  const float dd[3] = {d.x, d.y, d.z};
  r.o[0] = o.x;
  r.o[1] = o.y;
  r.o[2] = o.z;
#pragma unroll
  for (int k = 0; k < 3; ++k) r.inv[k] = dd[k] == 0.0f ? 0.0f : 1.0f / dd[k];
  r.live = d.x != 0.0f || d.y != 0.0f || d.z != 0.0f;
  return r;
}

// Entry distance of the ray into the box: max(t_enter, 0) where its line
// crosses the box, kTFar where it cannot or the ray is padding.
__device__ __forceinline__ float slab_enter(const SlabRay& r, const float* __restrict__ lo,
                                            const float* __restrict__ hi) {
  float enter = 0.0f, exit_ = kTFar;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float l = lo[k], h = hi[k];
    const bool deg = r.inv[k] == 0.0f;
    const float t1 = (l - r.o[k]) * r.inv[k];
    const float t2 = (h - r.o[k]) * r.inv[k];
    const bool inside = r.o[k] >= l && r.o[k] <= h;
    const float tn = deg ? (inside ? 0.0f : kTFar) : nan_min(t1, t2);
    const float tf = deg ? (inside ? kTFar : -kTFar) : nan_max(t1, t2);
    enter = nan_max(enter, tn);
    exit_ = nan_min(exit_, tf);
  }
  const bool ok = r.live && (enter <= exit_) && (exit_ > 0.0f);
  return ok ? enter : kTFar;
}

__global__ void pair_closest_kernel(const int* __restrict__ offs, const int* __restrict__ pwords,
                                    const float4* __restrict__ o4,
                                    const float4* __restrict__ d4,
                                    const float* __restrict__ box_lo,
                                    const float* __restrict__ box_hi,
                                    const float* __restrict__ w, int n_cl, int c,
                                    float* __restrict__ bt_out, int* __restrict__ bid_out) {
  extern __shared__ float4 s_w[];
  __shared__ int s_red[32];
  const int tile = blockIdx.x;
  const size_t ray = (size_t)tile * blockDim.x + threadIdx.x;
  const float4 o = o4[ray], d = d4[ray];
  const SlabRay sr = slab_ray(o, d);
  float bt = kTFar;
  int bid = -1;
  int bound = __float_as_int(kTFar);
  const int end = offs[tile + 1];
  for (int i = offs[tile]; i < end; ++i) {
    const int word = pwords[i];
    if ((word & ~kClMask) >= bound) break;  // block-uniform
    const int cl = min(word & kClMask, n_cl - 1);
    const float enter = slab_enter(sr, box_lo + 3 * cl, box_hi + 3 * cl);
    // The vote is also the barrier after which the stage may be rewritten.
    if (!__syncthreads_or(enter < bt)) continue;
    stage_cluster(s_w, w, cl, c);
    __syncthreads();
    float tmin = kTFar;
    int lm = 0;
    for (int lane = 0; lane < c; ++lane) {
      const float tv = tri_t(s_w + lane * 3, o, d, kTFar);
      if (tv < tmin) {  // the first lane that attains the minimum
        tmin = tv;
        lm = lane;
      }
    }
    if (tmin < bt) {
      bt = tmin;
      bid = cl * c + lm;
    }
    bound = block_max(__float_as_int(bt), s_red);
  }
  bt_out[ray] = bt;
  bid_out[ray] = bid;
}

__global__ void pair_anyhit_kernel(const int* __restrict__ offs, const int* __restrict__ pwords,
                                   const float4* __restrict__ o4, const float4* __restrict__ d4,
                                   const float* __restrict__ tmax,
                                   const float* __restrict__ box_lo,
                                   const float* __restrict__ box_hi,
                                   const float* __restrict__ w, int n_cl, int c,
                                   uint8_t* __restrict__ occ_out) {
  extern __shared__ float4 s_w[];
  __shared__ int s_red[32];
  const int tile = blockIdx.x;
  const size_t ray = (size_t)tile * blockDim.x + threadIdx.x;
  const float4 o = o4[ray], d = d4[ray];
  const SlabRay sr = slab_ray(o, d);
  const float tm = tmax[ray];
  bool occ = false;
  int bound = block_max(__float_as_int(tm), s_red);
  const int end = offs[tile + 1];
  for (int i = offs[tile]; i < end; ++i) {
    const int word = pwords[i];
    if ((word & ~kClMask) >= bound) break;  // block-uniform; all occluded -> bound 0
    const int cl = min(word & kClMask, n_cl - 1);
    const float enter = slab_enter(sr, box_lo + 3 * cl, box_hi + 3 * cl);
    if (!__syncthreads_or((enter < tm) && !occ)) continue;
    stage_cluster(s_w, w, cl, c);
    __syncthreads();
    for (int lane = 0; lane < c && !occ; ++lane) occ = tri_t(s_w + lane * 3, o, d, tm) < kTFar;
    bound = block_max(__float_as_int(occ ? 0.0f : tm), s_red);
  }
  occ_out[ray] = occ ? 1 : 0;
}

}  // namespace

// C entry points: pointers and the stream as void*, one launch each on the
// given stream; each returns cudaGetLastError() (0 on success).
extern "C" {

int pr_closest(const void* offs, const void* pwords, int n_tiles, int tr, const void* o4,
               const void* d4, const void* lo, const void* hi, const void* w, int n_cl, int c,
               void* bt, void* bid, void* stream) {
  const size_t smem = (size_t)c * 3 * sizeof(float4);
  cudaError_t e = launch_prep(pair_closest_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  pair_closest_kernel<<<n_tiles, tr, smem, (cudaStream_t)stream>>>(
      (const int*)offs, (const int*)pwords, (const float4*)o4, (const float4*)d4,
      (const float*)lo, (const float*)hi, (const float*)w, n_cl, c, (float*)bt, (int*)bid);
  return (int)cudaGetLastError();
}

int pr_anyhit(const void* offs, const void* pwords, int n_tiles, int tr, const void* o4,
              const void* d4, const void* tmax, const void* lo, const void* hi, const void* w,
              int n_cl, int c, void* occ, void* stream) {
  const size_t smem = (size_t)c * 3 * sizeof(float4);
  cudaError_t e = launch_prep(pair_anyhit_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  pair_anyhit_kernel<<<n_tiles, tr, smem, (cudaStream_t)stream>>>(
      (const int*)offs, (const int*)pwords, (const float4*)o4, (const float4*)d4,
      (const float*)tmax, (const float*)lo, (const float*)hi, (const float*)w, n_cl, c,
      (uint8_t*)occ);
  return (int)cudaGetLastError();
}

}  // extern "C"
