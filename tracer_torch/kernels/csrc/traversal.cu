// Work-list closest-hit and any-hit kernels for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of tracer/kernels/traversal.py:
//   worklist_closest_kernel <- _closest_kernel (via _trace_chunk_pallas)
//   worklist_anyhit_kernel  <- _anyhit_kernel  (via _anyhit_chunk_pallas)
//
// What they compute. A tile is TR rays (one block, one thread per ray). Its
// work items are the clusters offs[tile] .. offs[tile+1] of one flat,
// tile-ordered list, in ascending cluster id: unsorted in depth, so every
// item is walked, with no early-out. A cluster is C triangles stored as a
// (4, 3C) matrix of affine maps (bvh/cluster.py). Per ray (o, d) in
// homogeneous form and triangle, with the four products summed left to right
// (kernels/traversal.py: _affine_products, _field_epilogue):
//   so = ((o0*w0 + o1*w1) + o2*w2) + o3*w3,  sd likewise from d
//   t = -so_n / (|sd_n| > 1e-12 ? sd_n : 1),  u = so_u + t*sd_u,  v likewise
//   hit iff |sd_n| > 1e-12, u >= 0, v >= 0, u + v <= 1, kTMin < t < t_max
// Closest hit keeps, per cluster, the first lane that attains the minimum t
// with that lane's u, v and triangle id, and replaces the running best only
// on a strict <. Any-hit ORs "some triangle hits" over the items. This is
// not tri_t of traversal2.cu: the divide is guarded and the inside test is
// u + v <= 1, so the two pick different lanes on grazing hits. Built with
// -fmad=false and without fast math, every product and the divide round as
// the plain PyTorch version rounds them, and the two agree bit for bit.
//
// What bounds them on the card. As for traversal2.cu, the fp32 pipes: ~50 flops
// and one IEEE divide per (ray, triangle) against 12 floats of coefficients
// shared by the whole tile, with the bench100k accel (4.9 MB) resident in
// L2. With no early-out the work is the sum of the candidate counts, and the
// tile with the longest run finishes last.
//
// What the design does about it. One cluster is staged per step in shared
// memory, transposed so that a triangle's 12 coefficients are three float4s
// every thread reads as a broadcast. Nothing else: this is the simple, right
// version of the tier.
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

__device__ __forceinline__ float affine(float4 r, float4 m) {
  return ((r.x * m.x + r.y * m.y) + r.z * m.z) + r.w * m.w;
}

// _field_epilogue for one (ray, triangle): t (kTFar on a miss), u and v.
__device__ __forceinline__ float field_t(const float4* p, float4 o, float4 d, float t_max,
                                         float* u_out, float* v_out) {
  const float4 n = p[0], a = p[1], b = p[2];
  const float den = affine(d, n);
  const bool safe = fabsf(den) > 1e-12f;
  const float t = -affine(o, n) / (safe ? den : 1.0f);
  const float u = affine(o, a) + t * affine(d, a);
  const float v = affine(o, b) + t * affine(d, b);
  const bool hit = safe && (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f) && (t > kTMin) &&
                   (t < t_max);
  *u_out = u;
  *v_out = v;
  return hit ? t : kTFar;
}

__global__ void worklist_closest_kernel(const int* __restrict__ offs,
                                        const int* __restrict__ clusters,
                                        const float4* __restrict__ o4,
                                        const float4* __restrict__ d4,
                                        const float* __restrict__ w,
                                        const int* __restrict__ tri_ids, int c,
                                        float* __restrict__ bt_out, int* __restrict__ btri_out,
                                        float* __restrict__ bu_out, float* __restrict__ bv_out) {
  extern __shared__ float4 s_w[];
  const int tile = blockIdx.x;
  const size_t ray = (size_t)tile * blockDim.x + threadIdx.x;
  const float4 o = o4[ray], d = d4[ray];
  float bt = kTFar, bu = 0.0f, bv = 0.0f;
  int btri = -1;
  const int end = offs[tile + 1];
  for (int i = offs[tile]; i < end; ++i) {
    const int cl = clusters[i];
    __syncthreads();  // the last step's readers are done
    stage_cluster(s_w, w, cl, c);
    __syncthreads();
    float tmin = kTFar, um = 0.0f, vm = 0.0f;
    int lm = 0;
    for (int lane = 0; lane < c; ++lane) {
      float u, v;
      const float t = field_t(s_w + lane * 3, o, d, kTFar, &u, &v);
      if (lane == 0 || t < tmin) {  // the first lane that attains the minimum
        tmin = t;
        um = u;
        vm = v;
        lm = lane;
      }
    }
    if (tmin < bt) {
      bt = tmin;
      bu = um;
      bv = vm;
      btri = tri_ids[(size_t)cl * c + lm];
    }
  }
  bt_out[ray] = bt;
  btri_out[ray] = btri;
  bu_out[ray] = bu;
  bv_out[ray] = bv;
}

__global__ void worklist_anyhit_kernel(const int* __restrict__ offs,
                                       const int* __restrict__ clusters,
                                       const float4* __restrict__ o4,
                                       const float4* __restrict__ d4,
                                       const float* __restrict__ tmax,
                                       const float* __restrict__ w, int c,
                                       uint8_t* __restrict__ occ_out) {
  extern __shared__ float4 s_w[];
  const int tile = blockIdx.x;
  const size_t ray = (size_t)tile * blockDim.x + threadIdx.x;
  const float4 o = o4[ray], d = d4[ray];
  const float tm = tmax[ray];
  bool occ = false;
  const int end = offs[tile + 1];
  for (int i = offs[tile]; i < end; ++i) {
    __syncthreads();
    stage_cluster(s_w, w, clusters[i], c);
    __syncthreads();
    for (int lane = 0; lane < c && !occ; ++lane) {
      float u, v;
      occ = field_t(s_w + lane * 3, o, d, tm, &u, &v) < kTFar;
    }
  }
  occ_out[ray] = occ ? 1 : 0;
}

}  // namespace

// C entry points: pointers and the stream as void*, one launch each on the
// given stream; each returns cudaGetLastError() (0 on success).
extern "C" {

int wl_closest(const void* offs, const void* clusters, int n_tiles, int tr, const void* o4,
               const void* d4, const void* w, const void* tri_ids, int c, void* bt, void* btri,
               void* bu, void* bv, void* stream) {
  const size_t smem = (size_t)c * 3 * sizeof(float4);
  cudaError_t e = launch_prep(worklist_closest_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  worklist_closest_kernel<<<n_tiles, tr, smem, (cudaStream_t)stream>>>(
      (const int*)offs, (const int*)clusters, (const float4*)o4, (const float4*)d4,
      (const float*)w, (const int*)tri_ids, c, (float*)bt, (int*)btri, (float*)bu, (float*)bv);
  return (int)cudaGetLastError();
}

int wl_anyhit(const void* offs, const void* clusters, int n_tiles, int tr, const void* o4,
              const void* d4, const void* tmax, const void* w, int c, void* occ, void* stream) {
  const size_t smem = (size_t)c * 3 * sizeof(float4);
  cudaError_t e = launch_prep(worklist_anyhit_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  worklist_anyhit_kernel<<<n_tiles, tr, smem, (cudaStream_t)stream>>>(
      (const int*)offs, (const int*)clusters, (const float4*)o4, (const float4*)d4,
      (const float*)tmax, (const float*)w, c, (uint8_t*)occ);
  return (int)cudaGetLastError();
}

}  // extern "C"
