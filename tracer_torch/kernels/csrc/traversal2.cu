// Closest-hit and any-hit traversal kernels for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of tracer/kernels/traversal2.py:
//   closest_hit_kernel   <- _closest_kernel       (generic while-loop region)
//   closest_fast_kernel  <- _closest_fast_kernel  (tiles with count <= 1)
//   anyhit_kernel        <- _anyhit_kernel        (light-origin shadow segments)
//
// What they compute. A tile is TR rays plus the tile's candidate clusters:
// packed int32 words (entry-t bits | cluster id), sorted front to back by the
// cull. A cluster is C triangles stored as a (4, 3C) matrix of affine maps
// (bvh/cluster.py): for a homogeneous ray (o, 1) + t (d, 0), column f*C +
// lane gives the plane value (f = 0) and the two barycentrics (f = 1, 2) of
// triangle `lane`. Per ray and triangle (tri_t, common.cuh):
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
// are bound by issue of fp32 instructions. A test is a chain of some 60
// dependent instructions, so what a kernel reaches of that bound is set by
// how many tests it keeps in flight on every SM. The tensor cores do not
// serve these kernels: the products have depth 4 (a homogeneous ray times a
// (4, 3C) matrix), the frame's exactness rests on fp32 products rounded one
// at a time, and TF32 keeps 10 mantissa bits and would flip hits.
//
// What the design does about it. Every kernel stages kBatch candidate
// clusters at a time in shared memory, transposed so that one triangle's 12
// coefficients are three float4s that every thread of a warp reads from the
// same address, a broadcast. Candidates past the early-out bound are
// skipped: the closest-hit bound is the block max of the rays' best t
// (compared as IEEE bits, order-isomorphic for t >= 0), the any-hit bound the
// block max of t_max over the rays still unoccluded. The TPU's lockstep
// group of 8 tiles is dropped: blocks are independent here.
//
// The closest-hit kernels run one block a tile, one thread a ray (their tie
// rule depends on the order of the walk). anyhit_kernel does not: occlusion
// is an OR over a tile's candidates, whatever the order and whoever visits
// them, and the candidate lists have a long tail (a mean of 4 words a tile, a
// maximum of some 300), which one block a tile would walk alone while the
// card has drained. So its unit of work is a segment, kSeg consecutive words
// of one tile (the table of kernels/traversal2.py anyhit_segments: every
// tile's first segment, then every second one, heaviest tile first), and a
// fixed grid of persistent blocks pulls segments from a device counter
// (claim_segment, common.cuh). A block is kSlices * TR threads: kSlices
// threads serve one ray, each testing every kSlices-th triangle of a staged
// cluster, kGroup tests at a time without a branch between them. A segment
// starts from the tile's occlusion flags as they stand in device memory
// (possibly stale; flags are only ever set, so a stale read costs work, never
// a result) and sets the flags of the rays it occludes.
#include "common.cuh"

namespace {

// Candidate clusters staged per step of the closest-hit and any-hit loops
// (kBatch * 6 KB of shared memory at C = 128); BATCH of kernels/traversal2.py.
constexpr int kBatch = 4;
// Triangle tests a thread of anyhit_kernel keeps in flight before it folds.
constexpr int kGroup = 4;

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
// (kTMin, t_max[ray]); occ_out holds zeros at launch and a ray's flag is set
// by whichever segment finds it a hit. The block pulls segments of the table
// (order, ends) until the counter has passed them all. Thread tid serves ray
// tid % tr with the triangles lane % kSlices == tid / tr of each staged
// cluster. A segment stops once the next word's entry bits reach the max
// t_max of the tile's rays still unoccluded (0 once all are), which it may do
// at once.
__global__ void anyhit_kernel(const int* __restrict__ words, const int* __restrict__ counts,
                              int k_cap, int tr, const float4* __restrict__ o4,
                              const float4* __restrict__ d4, const float* __restrict__ tmax,
                              const float* __restrict__ w, int n_cl, int c,
                              const long long* __restrict__ order,
                              const int* __restrict__ ends, int n_ranks, int* next_seg,
                              uint8_t* occ_out) {
  extern __shared__ float4 s_w[];
  __shared__ int s_red[32];
  __shared__ int s_claim[3];
  __shared__ uint8_t s_occ[kMaxRays];
  const int r = threadIdx.x % tr;
  const int slice = threadIdx.x / tr;
  int rank = 0;  // thread 0's cursor into ends
  for (;;) {
    if (threadIdx.x == 0) claim_segment(s_claim, next_seg, rank, order, ends, n_ranks, counts);
    __syncthreads();
    const Segment seg = read_segment(s_claim);  // claimed into again only after block_max below
    if (seg.tile < 0) break;                    // block-uniform
    const int k1 = seg.k1;
    const int* wt = words + (size_t)seg.tile * k_cap;
    const size_t ray = (size_t)seg.tile * tr + r;
    const float4 o = o4[ray], d = d4[ray];
    const float tm = tmax[ray];
    bool occ = ((const volatile uint8_t*)occ_out)[ray] != 0;
    if (slice == 0) s_occ[r] = occ ? 1 : 0;
    const bool dead = !(tm > kTMin);  // an empty interval: padding, or a ray with d == 0
    bool hit = false;
    // The barriers of block_max publish s_occ, and order the last segment's
    // reads of the stage before this one's writes.
    int bound = block_max(open_bits(occ, tm), s_red);
    for (int k = seg.k0; k < k1; k += kBatch) {
      if ((wt[k] & ~kClMask) >= bound) break;  // block-uniform; all occluded -> bound 0
      const int n_live = min(kBatch, k1 - k);
      stage_clusters(s_w, w, wt, k, n_live, k_cap, n_cl, c);
      __syncthreads();
      if (!occ && !dead) {
        for (int j = 0; j < n_live && !hit; ++j) {
          const float4* sj = s_w + j * c * 3;
          for (int lane = slice; lane < c && !hit; lane += kSlices * kGroup) {
            float t[kGroup];
#pragma unroll
            for (int g = 0; g < kGroup; ++g) {
              const int l = lane + g * kSlices;
              const float tv = tri_t(sj + min(l, c - 1) * 3, o, d, tm);
              t[g] = l < c ? tv : kTFar;
            }
#pragma unroll
            for (int g = 0; g < kGroup; ++g) hit |= t[g] < kTFar;
          }
        }
      }
      if (hit) s_occ[r] = 1;  // the slices of a ray OR here
      __syncthreads();
      occ = s_occ[r] != 0;
      bound = block_max(open_bits(occ, tm), s_red);  // its barriers free the stage
    }
    if (hit) occ_out[ray] = 1;
  }
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

// grid persistent blocks of kSlices * tr threads; order (int64) and the n_ranks
// entries of ends are the segment table, *next_seg is 0 and occ holds zeros at
// launch.
int tt_anyhit(const void* words, const void* counts, int k_cap, int tr, const void* o4,
              const void* d4, const void* tmax, const void* w, int n_cl, int c,
              const void* order, const void* ends, int n_ranks, void* next_seg, int grid,
              void* occ, void* stream) {
  if (tr > kMaxRays) return (int)cudaErrorInvalidValue;
  const size_t smem = stage_bytes(kBatch, c);
  cudaError_t e = launch_prep(anyhit_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  anyhit_kernel<<<grid, kSlices * tr, smem, (cudaStream_t)stream>>>(
      (const int*)words, (const int*)counts, k_cap, tr, (const float4*)o4, (const float4*)d4,
      (const float*)tmax, (const float*)w, n_cl, c, (const long long*)order, (const int*)ends,
      n_ranks, (int*)next_seg, (uint8_t*)occ);
  return (int)cudaGetLastError();
}

}  // extern "C"
