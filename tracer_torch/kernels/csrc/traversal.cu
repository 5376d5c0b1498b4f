// Work-list closest-hit and any-hit kernels for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of tracer/kernels/traversal.py:
//   worklist_closest_kernel + worklist_finish_kernel
//                           <- _closest_kernel (via _trace_chunk_pallas)
//   worklist_anyhit_kernel  <- _anyhit_kernel  (via _anyhit_chunk_pallas)
//
// What they compute. A tile is TR rays. Its work items are the clusters
// offs[tile] .. offs[tile+1] of one flat, tile-ordered list, in ascending
// cluster id: unsorted in depth, so every item is walked, with no early-out.
// A cluster is C triangles stored as a (4, 3C) matrix of affine maps
// (bvh/cluster.py). Per ray (o, d) in homogeneous form and triangle, with the
// four products summed left to right (kernels/traversal.py: _affine_products,
// _field_epilogue):
//   so = ((o0*w0 + o1*w1) + o2*w2) + o3*w3,  sd likewise from d
//   t = -so_n / (|sd_n| > 1e-12 ? sd_n : 1),  u = so_u + t*sd_u,  v likewise
//   hit iff |sd_n| > 1e-12, u >= 0, v >= 0, u + v <= 1, kTMin < t < t_max
// Closest hit keeps, per cluster, the first lane that attains the minimum t
// with that lane's u, v and triangle id, and replaces the running best only
// on a strict <: per ray the winner is the lexicographic minimum of (t,
// position of the item in the tile's run, lane). Any-hit ORs "some triangle
// hits" over the items. This is not tri_t of traversal2.cu: the divide is
// guarded and the inside test is u + v <= 1, so the two pick different lanes
// on grazing hits. Built with -fmad=false and without fast math, every
// product and the divide round as the plain PyTorch version rounds them, and
// the two agree bit for bit.
//
// What bounds them on the card. Issue of fp32 instructions, without
// contraction: 12 floats of coefficients, shared by the whole tile and
// resident in L2 (the bench100k accel is 4.9 MB), feed 49 operations and one
// IEEE divide per (ray, triangle). With -fmad=false an operation is an
// instruction, so the issue floor is twice the bound that counts a fused
// multiply-add as two operations, plus what the count leaves out: the
// divide's sequence, the compares and selects, the shared-memory loads. As
// built here a test executes 61 (any-hit) to 63.5 (closest hit) instructions:
// 20 FMUL and 18 FADD, 10 for the divide (5 FFMA, MUFU.RCP, FCHK, a branch
// and its convergence barriers), 7 compares, 3 LDS.128, selects and loop
// work; on an H100 at 700 W the kernels issue at 83-88 % of the card's rate
// (PERF.md). The tensor cores do not serve these kernels (products of depth 4 that must
// round one at a time in fp32). With no early-out the work is the sum of the
// runs' lengths; the runs are long (up to some 500 items) and uneven.
//
// What the design does about it.
//   * Balance. The unit of work is a segment, kSegWL consecutive items of one
//     tile's run (the table of kernels/_launch.py run_segments: every tile's
//     first segment, then every second one, heaviest tile first), and a fixed
//     grid of persistent blocks pulls segments from a device counter
//     (claim_segment, common.cuh). Occlusion is an OR, so any-hit segments
//     only ever set the tile's flags in occ, start from the flags as they
//     stand (possibly stale: that costs work, never a result) and skip a
//     segment none of whose rays is still open. Closest hits merge across
//     segments exactly, because the tie rule is a total order: a hit has
//     t > kTMin > 0, so t's bits order as the floats do, and a segment issues
//     one 64-bit atomicMin a ray that it hits, of
//     bits(t) << 32 | item << kLaneBits | lane, on a key the wrapper filled
//     with the miss key. The atomics' order varies from run to run, the
//     minimum does not. worklist_finish_kernel, one thread a ray, decodes the
//     key and recomputes u, v of the winner with all four products.
//   * Rate. One thread a ray, a block of TR threads, and kGroupWL triangles
//     in flight a thread before they fold (a test is a chain of some 50
//     dependent instructions). C is a template parameter (128, the only
//     cluster size the presets build; the entry points refuse any other).
//     The loops carry t and the lane only. The fourth components are
//     constants of the homogeneous form, o3 = 1 and d3 = 0: the loops add w3
//     instead of 1*w3, which is the same float, and drop 0*w3, a signed zero
//     that can change a sum only in the sign of a zero: no compare of the
//     test sees that, t of a hit has a non-zero divisor, and u, v are written
//     by the finishing pass, which keeps the four products.
//   * Staging. The next cluster of the segment is copied into the other of
//     two 6 KB buffers before this one is tested: one barrier a step.
#include "common.cuh"

namespace {

constexpr int kSegWL = 4;    // items of a run in a segment; SEG_WL of kernels/traversal.py
constexpr int kGroupWL = 4;  // triangles a thread keeps in flight before it folds
constexpr int kLaneBits = 15;  // KEY_LANE_BITS: the key is bits(t) | item | lane, 32 + 17 + 15
constexpr int kClusterWL = 128;  // the cluster size the kernels are built for; CLUSTER_WL

// s[f*C + lane] = column f*C + lane of cluster cl's (4, 3C) matrix.
template <int C>
__device__ __forceinline__ void stage_cluster(float4* s, const float* __restrict__ w, int cl) {
  constexpr int kPer = 3 * C;
  const float* wc = w + (size_t)cl * 4 * kPer;
  for (int col = threadIdx.x; col < kPer; col += blockDim.x)
    s[col] = make_float4(wc[col], wc[kPer + col], wc[2 * kPer + col], wc[3 * kPer + col]);
}

__device__ __forceinline__ float affine(float4 r, float4 m) {
  return ((r.x * m.x + r.y * m.y) + r.z * m.z) + r.w * m.w;
}

// u and v of _field_epilogue for one (ray, triangle).
__device__ __forceinline__ void field_uv(float4 n, float4 a, float4 b, float4 o, float4 d,
                                         float* u_out, float* v_out) {
  const float den = affine(d, n);
  const float t = -affine(o, n) / (fabsf(den) > 1e-12f ? den : 1.0f);
  *u_out = affine(o, a) + t * affine(d, a);
  *v_out = affine(o, b) + t * affine(d, b);
}

// A ray of the homogeneous form (o, 1), (d, 0).
struct Ray3 {
  float ox, oy, oz, dx, dy, dz;
};

__device__ __forceinline__ Ray3 load_ray(const float4* __restrict__ o4,
                                         const float4* __restrict__ d4, size_t ray) {
  const float4 o = o4[ray], d = d4[ray];
  return Ray3{o.x, o.y, o.z, d.x, d.y, d.z};
}

// affine((o, 1), m): 1 * m.w is m.w.
__device__ __forceinline__ float affine_o(const Ray3& r, float4 m) {
  return ((r.ox * m.x + r.oy * m.y) + r.oz * m.z) + m.w;
}

// affine((d, 0), m) up to the sign of a zero: 0 * m.w is a signed zero.
__device__ __forceinline__ float affine_d(const Ray3& r, float4 m) {
  return (r.dx * m.x + r.dy * m.y) + r.dz * m.z;
}

// _field_epilogue's hit and its t (meaningful on a hit) for a ray of the
// homogeneous form: the same bits (see the header), without u and v.
__device__ __forceinline__ bool field_hit(float4 n, float4 a, float4 b, const Ray3& r,
                                          float t_max, float* t_out) {
  const float den = affine_d(r, n);
  const bool safe = fabsf(den) > 1e-12f;
  const float t = -affine_o(r, n) / (safe ? den : 1.0f);
  const float u = affine_o(r, a) + t * affine_d(r, a);
  const float v = affine_o(r, b) + t * affine_d(r, b);
  *t_out = t;
  return safe && (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f) && (t > kTMin) && (t < t_max);
}

// The staged cluster's triangles lane .. lane + kGroupWL - 1 against the ray:
// kGroupWL tests with no branch between them.
template <int C>
__device__ __forceinline__ void test_group(bool (&hit)[kGroupWL], float (&t)[kGroupWL],
                                           const float4* s, int lane, const Ray3& r,
                                           float t_max) {
#pragma unroll
  for (int g = 0; g < kGroupWL; ++g)
    hit[g] = field_hit(s[lane + g], s[C + lane + g], s[2 * C + lane + g], r, t_max, &t[g]);
}

// Closest hit, the segments' part: key[ray] = min(key[ray], bits(t) << 32 |
// item << kLaneBits | lane) over the hits of the ray in the block's segments;
// key holds the miss key at launch. Thread tid serves ray tid of the
// segment's tile.
template <int C>
__global__ void worklist_closest_kernel(const int* __restrict__ offs,
                                        const int* __restrict__ clusters,
                                        const int* __restrict__ counts,
                                        const float4* __restrict__ o4,
                                        const float4* __restrict__ d4,
                                        const float* __restrict__ w,
                                        const long long* __restrict__ order,
                                        const int* __restrict__ ends, int n_ranks, int* next_seg,
                                        unsigned long long* key) {
  __shared__ float4 s_w[2][3 * C];
  __shared__ int s_claim[3];
  int rank = 0;  // thread 0's cursor into ends
  for (;;) {
    if (threadIdx.x == 0)
      claim_segment<kSegWL>(s_claim, next_seg, rank, order, ends, n_ranks, counts);
    __syncthreads();
    const Segment seg = read_segment(s_claim);  // claimed into again only after a step's barrier
    if (seg.tile < 0) break;                    // block-uniform
    const size_t ray = (size_t)seg.tile * blockDim.x + threadIdx.x;
    const Ray3 r = load_ray(o4, d4, ray);
    float bt = kTFar;
    unsigned code = 0;
    const int* run = clusters + offs[seg.tile];
    stage_cluster<C>(s_w[0], w, run[seg.k0]);
    __syncthreads();
    for (int k = seg.k0; k < seg.k1; ++k) {
      const float4* s = s_w[(k - seg.k0) & 1];
      if (k + 1 < seg.k1) stage_cluster<C>(s_w[(k + 1 - seg.k0) & 1], w, run[k + 1]);
      const unsigned item = (unsigned)k << kLaneBits;
      for (int lane = 0; lane < C; lane += kGroupWL) {
        bool hit[kGroupWL];
        float t[kGroupWL];
        test_group<C>(hit, t, s, lane, r, bt);  // a t that is not under the best cannot win
#pragma unroll
        for (int g = 0; g < kGroupWL; ++g) {  // in lane order: the first lane keeps a tie
          // hit holds t < bt as it stood before this group's folds
          if (hit[g] && (g == 0 || t[g] < bt)) {
            bt = t[g];
            code = item | (unsigned)(lane + g);
          }
        }
      }
      __syncthreads();  // the next cluster is staged, and this one's readers are done
    }
    if (bt < kTFar)
      atomicMin(key + ray, ((unsigned long long)__float_as_uint(bt) << 32) | code);
  }
}

// Closest hit, the finishing pass, one thread a ray: the key's t, and for a
// hit the triangle id and u, v of the winning (item, lane) by field_uv, for a
// miss (kTFar, -1, 0, 0).
__global__ void worklist_finish_kernel(const int* __restrict__ offs,
                                       const int* __restrict__ clusters, int tr, size_t n_rays,
                                       const float4* __restrict__ o4,
                                       const float4* __restrict__ d4,
                                       const float* __restrict__ w,
                                       const int* __restrict__ tri_ids, int c,
                                       const unsigned long long* __restrict__ key,
                                       float* __restrict__ bt_out, int* __restrict__ btri_out,
                                       float* __restrict__ bu_out, float* __restrict__ bv_out) {
  const size_t ray = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (ray >= n_rays) return;
  const unsigned long long best = key[ray];
  const float t = __uint_as_float((unsigned)(best >> 32));
  float u = 0.0f, v = 0.0f;
  int tri = -1;
  if (t < kTFar) {
    const unsigned code = (unsigned)best;
    const int lane = (int)(code & ((1u << kLaneBits) - 1));
    const int cl = clusters[offs[ray / tr] + (int)(code >> kLaneBits)];
    const int per = 3 * c;
    const float* wc = w + (size_t)cl * 4 * per + lane;
    float4 m[3];
#pragma unroll
    for (int f = 0; f < 3; ++f)
      m[f] = make_float4(wc[f * c], wc[per + f * c], wc[2 * per + f * c], wc[3 * per + f * c]);
    field_uv(m[0], m[1], m[2], o4[ray], d4[ray], &u, &v);
    tri = tri_ids[(size_t)cl * c + lane];
  }
  bt_out[ray] = t;
  btri_out[ray] = tri;
  bu_out[ray] = u;
  bv_out[ray] = v;
}

// Occlusion: a ray is occluded iff some triangle of its tile's run has t in
// (kTMin, t_max[ray]); occ_out holds zeros at launch and a ray's flag is set
// by whichever segment finds it a hit. A ray that is occluded already, or
// whose interval is empty (padding, d == 0), is closed: its t_max is taken as
// 0, so no test of it hits. A warp leaves a cluster once all its rays are
// closed, a block skips a segment whose rays all are.
template <int C>
__global__ void worklist_anyhit_kernel(const int* __restrict__ offs,
                                       const int* __restrict__ clusters,
                                       const int* __restrict__ counts,
                                       const float4* __restrict__ o4,
                                       const float4* __restrict__ d4,
                                       const float* __restrict__ tmax,
                                       const float* __restrict__ w,
                                       const long long* __restrict__ order,
                                       const int* __restrict__ ends, int n_ranks, int* next_seg,
                                       uint8_t* occ_out) {
  __shared__ float4 s_w[2][3 * C];
  __shared__ int s_claim[3];
  int rank = 0;  // thread 0's cursor into ends
  for (;;) {
    if (threadIdx.x == 0)
      claim_segment<kSegWL>(s_claim, next_seg, rank, order, ends, n_ranks, counts);
    __syncthreads();
    const Segment seg = read_segment(s_claim);  // claimed into again only after a later barrier
    if (seg.tile < 0) break;                    // block-uniform
    const size_t ray = (size_t)seg.tile * blockDim.x + threadIdx.x;
    const Ray3 r = load_ray(o4, d4, ray);
    float tm = ((const volatile uint8_t*)occ_out)[ray] ? 0.0f : tmax[ray];
    bool found = false;
    if (!__syncthreads_or(tm > kTMin)) continue;  // block-uniform
    const int* run = clusters + offs[seg.tile];
    stage_cluster<C>(s_w[0], w, run[seg.k0]);
    __syncthreads();
    for (int k = seg.k0; k < seg.k1; ++k) {
      const float4* s = s_w[(k - seg.k0) & 1];
      if (k + 1 < seg.k1) stage_cluster<C>(s_w[(k + 1 - seg.k0) & 1], w, run[k + 1]);
      for (int lane = 0; lane < C && __any_sync(0xffffffffu, tm > kTMin); lane += kGroupWL) {
        bool hit[kGroupWL];
        float t[kGroupWL];
        test_group<C>(hit, t, s, lane, r, tm);
#pragma unroll
        for (int g = 0; g < kGroupWL; ++g) found |= hit[g];
        if (found) tm = 0.0f;
      }
      __syncthreads();  // the next cluster is staged, and this one's readers are done
    }
    if (found) occ_out[ray] = 1;
  }
}

// A block is tr threads in whole warps, and C is kClusterWL.
bool takes(int tr, int c) { return c == kClusterWL && tr > 0 && tr <= 1024 && tr % 32 == 0; }

}  // namespace

// C entry points: pointers and the stream as void*, launched on the given
// stream; each returns the first CUDA error (0 on success). grid persistent
// blocks; order (int64) and the n_ranks entries of ends are the segment table
// over counts (the runs' lengths), *next_seg is 0 at launch.
extern "C" {

// key holds the miss key at launch; the finishing pass follows on the stream.
int wl_closest(const void* offs, const void* clusters, const void* counts, int n_tiles, int tr,
               const void* o4, const void* d4, const void* w, const void* tri_ids, int c,
               const void* order, const void* ends, int n_ranks, void* next_seg, int grid,
               void* key, void* bt, void* btri, void* bu, void* bv, void* stream) {
  if (!takes(tr, c)) return (int)cudaErrorInvalidValue;
  worklist_closest_kernel<kClusterWL><<<grid, tr, 0, (cudaStream_t)stream>>>(
      (const int*)offs, (const int*)clusters, (const int*)counts, (const float4*)o4,
      (const float4*)d4, (const float*)w, (const long long*)order, (const int*)ends, n_ranks,
      (int*)next_seg, (unsigned long long*)key);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t n_rays = (size_t)n_tiles * tr;
  worklist_finish_kernel<<<(unsigned)((n_rays + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      (const int*)offs, (const int*)clusters, tr, n_rays, (const float4*)o4, (const float4*)d4,
      (const float*)w, (const int*)tri_ids, c, (const unsigned long long*)key, (float*)bt,
      (int*)btri, (float*)bu, (float*)bv);
  return (int)cudaGetLastError();
}

// occ holds zeros at launch.
int wl_anyhit(const void* offs, const void* clusters, const void* counts, int tr, const void* o4,
              const void* d4, const void* tmax, const void* w, int c, const void* order,
              const void* ends, int n_ranks, void* next_seg, int grid, void* occ,
              void* stream) {
  if (!takes(tr, c)) return (int)cudaErrorInvalidValue;
  worklist_anyhit_kernel<kClusterWL><<<grid, tr, 0, (cudaStream_t)stream>>>(
      (const int*)offs, (const int*)clusters, (const int*)counts, (const float4*)o4,
      (const float4*)d4, (const float*)tmax, (const float*)w, (const long long*)order,
      (const int*)ends, n_ranks, (int*)next_seg, (uint8_t*)occ);
  return (int)cudaGetLastError();
}

}  // extern "C"
