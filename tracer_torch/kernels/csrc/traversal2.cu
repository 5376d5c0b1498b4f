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
// What the design does about it. Candidates past the early-out bound are
// skipped: the closest-hit bound is the block max of the rays' best t
// (compared as IEEE bits, order-isomorphic for t >= 0), the any-hit bound the
// block max of t_max over the rays still unoccluded. The TPU's lockstep group
// of 8 tiles is dropped: blocks are independent here. The candidate lists
// have a long tail (bench100k's primary pass: a mean of 4 words a tile, a
// maximum of some 100; its shadow pass a maximum of some 300), which one
// block a tile would walk alone while the card has drained. So the unit of
// work of closest_hit_kernel and anyhit_kernel is a segment, kSeg consecutive
// words of one tile (the table of kernels/_launch.py run_segments: every
// tile's first segment, then every second one, heaviest tile first), and a
// fixed grid of persistent blocks pulls segments from a device counter
// (claim_segment, common.cuh). Several threads serve one ray, each with its
// share of the lanes (or quads of lanes) of a staged cluster: kSlicesClosest
// = 2 in closest_hit_kernel, kSlices = 4 in anyhit_kernel.
//
// closest_hit_kernel walks a tile's sorted words in steps of kBatch words;
// the reference's rule (kernels/traversal2.py _batch_best): per ray and lane
// the earliest word j of the step wins (strict <), across lanes the least t
// and on equal t the least slot cl*C + lane, and a step replaces the running
// best only on a strict <. So the winner over a tile's list is the
// lexicographic minimum of (t, step, slot), taken over each step's per-lane
// winners; within a step the slot orders as (rank, lane), rank the place of
// the lane's cluster among the step's live clusters by id (lane < C). Every
// hit has kTMin < t < kTFar, so t's bits order as the floats do, and the key
//     bits(t) << 32 | step << (kBatchBits + lane_bits) | rank << lane_bits | lane
// orders as the rule does; the low word fits for any list the cull emits
// (kernels/traversal2.py check_closest_key). The walk is split across blocks,
// so keys merge by a 64-bit atomicMin: exact, and the same minimum whatever
// order the atomics land in. closest_hit_finish_kernel, one thread a ray,
// decodes a key into (bt, bid); the miss key leaves (kTFar, -1), as a walk
// with no hit does.
//
// Its segments are walked by blocks of kSlicesClosest * TR threads:
// kSlicesClosest threads serve one ray, each taking every kSlicesClosest-th
// quad of 4 lanes of a staged cluster and, for each of its lanes, every word
// of the step (a thread holds all of a lane's j, so "earliest j wins its
// lane" is its own to apply). kSeg is a multiple of kBatch, so no step
// straddles two segments. A ray's slices fold their keys into one key a ray
// in shared memory after every step (an atomicMin there), and the segment
// ends with one atomicMin a ray into the key in device memory, which the
// caller fills with the miss key. The step's clusters come through a ring of
// 2 * kBatch stages that TMA's bulk copies fill (a cluster's (4, 3C) matrix as
// it lies in tri_w, read as sorted.cuh's quads), so the next step is in
// flight while this one is tested, with no integer divide in the staging. The
// ring runs on across the segments a block walks: the block copies the next
// segment's first clusters while this one finishes, and a step's first word
// at or past the bound is not copied.
//
// Early out across blocks. A segment starts from the tile's keys as they
// stand in device memory (possibly stale: other segments may still lower
// them) and stops once the next step's first word has entry bits strictly
// above the block max of its rays' best t. The cull's entry bits are a lower
// bound of the t of every triangle of the word's cluster for every ray of the
// tile (the entry distance, truncated down), and the words are sorted, so a
// step not walked holds only hits with t strictly above every ray's best as
// it stood, hence above its final best: it can neither win nor tie. A stale
// bound is larger and costs work, never a result.
//
// anyhit_kernel stages kBatch clusters at a time in shared memory, transposed
// so that one triangle's 12 coefficients are three float4s that every thread
// of a warp reads from the same address, a broadcast, and tests kGroup
// triangles a thread without a branch between them. Occlusion is an OR over
// a tile's candidates, whatever the order and whoever visits them: a segment
// starts from the tile's occlusion flags as they stand in device memory
// (possibly stale; flags are only ever set, so a stale read costs work, never
// a result) and sets the flags of the rays it occludes.
//
// closest_fast_kernel takes the tiles with one candidate: one cluster, no
// walk, so no tail to balance. A tile of 64 rays and 128 lanes is 8,192
// tests, which one thread a ray would run 128 deep in series; kSlicesFast
// threads a ray cut that depth, and a block holds as many tiles as fit in
// kFastThreads threads. Each tile's cluster comes by one bulk copy into a
// stage of its own, issued before the rays are read.
#include "common.cuh"
#include "sorted.cuh"

namespace {

// Candidate clusters a step of the closest-hit and any-hit loops (kBatch * 6
// KB of shared memory at C = 128); BATCH of kernels/traversal2.py.
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

// Ring stages of closest_hit_kernel: two steps, the one it tests and the next.
constexpr int kNBufClosest = 2 * kBatch;
// Bits of a step's word index j < kBatch in the closest-hit key.
constexpr int kBatchBits = 2;
static_assert(1 << kBatchBits == kBatch, "kBatchBits is log2 kBatch");
static_assert(kSeg % kBatch == 0, "a segment is a whole number of steps");
// Threads a ray of closest_hit_kernel (SLICES_CLOSEST of
// kernels/traversal2.py). At 106 registers a thread, blocks of 2 * 64 threads
// fit 4 an SM (the shared memory of their 2-step rings allows 4 too); 4
// threads a ray, in blocks of 256, fit 2. Measured on all tiles of
// bench100k's generic region, 2 threads a ray took 6 % less time than 4
// (PERF.md).
constexpr int kSlicesClosest = 2;

// Threads a ray of closest_fast_kernel (SLICES_FAST of kernels/traversal2.py),
// and the threads a block holds when a tile takes fewer (FAST_THREADS): at a
// tile of 64 rays, two tiles a block. Over all of bench100k's count-1 tiles 2
// threads a ray took 7 % less time than 4, and 39 % less than 8 (PERF.md).
constexpr int kSlicesFast = 2;
constexpr int kFastThreads = 256;
constexpr int kMaxTilesFast = kFastThreads / (kSlicesFast * 32);
static_assert(kSlicesFast <= 32 && 32 % kSlicesFast == 0, "a ray's slices share a warp");

// The miss key: kTFar's bits over all ones, above every hit's key.
__device__ __forceinline__ unsigned long long miss_key() {
  return ((unsigned long long)__float_as_uint(kTFar) << 32) | 0xFFFFFFFFull;
}

// rank[j]: how many of the step's n_live clusters have an id below cl[j].
__device__ __forceinline__ void cluster_ranks(unsigned (&rank)[kBatch], const int (&cl)[kBatch],
                                              int n_live) {
#pragma unroll
  for (int j = 0; j < kBatch; ++j) {
    rank[j] = 0;
#pragma unroll
    for (int i = 0; i < kBatch; ++i) rank[j] += (i < n_live && cl[i] < cl[j]) ? 1u : 0u;
  }
}

// Max of v over the block (blockDim.x a multiple of 32), for a caller that
// has passed a __syncthreads since the block last read s_red; every thread
// gets it. block_max (common.cuh) without its first barrier.
__device__ __forceinline__ int block_max_after_barrier(int v, int* s_red) {
  for (int off = 16; off > 0; off >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, off));
  if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = s_red[0];
  for (int i = 1; i < (int)(blockDim.x >> 5); ++i) v = max(v, s_red[i]);
  return v;
}

// Closest hit: key[ray] = min(key[ray], the key of every hit a step of the
// block's segments finds for the ray); key holds the miss key at launch.
// Thread tid serves ray tid % tr with the quads l4 % kSlicesClosest == tid /
// tr of each cluster. The block holds `cur`, the segment it works on (kc: the
// next word to intersect, kf: the next to copy) and, claimed when it starts
// on cur, `nxt` (kfn: its next word to copy); the copies in flight are cur's
// words kc .. kf-1, then nxt's nxt.k0 .. kfn-1. cur's words are read from
// device memory once, into shared memory; a step then waits on device memory
// only for its stages, and has two barriers.
__global__ void closest_hit_kernel(const int* __restrict__ words, const int* __restrict__ counts,
                                   int k_cap, int tr, const float4* __restrict__ o4,
                                   const float4* __restrict__ d4, const float4* __restrict__ w,
                                   int n_cl, int c, int lane_bits,
                                   const long long* __restrict__ order,
                                   const int* __restrict__ ends, int n_ranks, int* next_seg,
                                   unsigned long long* key) {
  extern __shared__ __align__(128) float4 ring_mem[];
  __shared__ __align__(8) uint64_t s_bar[kNBufClosest];
  __shared__ int s_red[32];
  __shared__ int s_claim[2][3];
  __shared__ int s_words[2][kSeg];
  __shared__ unsigned long long s_key[kMaxRays];
  const int per4 = 3 * c;
  const int c4 = c / kLanes;
  const int r = threadIdx.x % tr;
  const int slice = threadIdx.x / tr;
  const int step_shift = kBatchBits + lane_bits;
  int rank = 0;  // thread 0's cursor into ends
  Ring<kNBufClosest> ring{ring_mem, s_bar, per4, 0};
  ring.init();
  if (threadIdx.x == 0)
    claim_segment<kSeg>(s_claim[1], next_seg, rank, order, ends, n_ranks, counts);
  __syncthreads();  // the barriers and the claim are published
  Segment cur = read_segment(s_claim[1]);
  int consumed = 0;
  int kf = cur.k0;
  for (int it = 0; cur.tile >= 0; ++it) {  // block-uniform
    // The segment after this one: claimed here, read after the barriers of
    // block_max, its slot of s_claim claimed into again two segments on; the
    // same for the slot of s_words that holds cur's words.
    if (threadIdx.x == 0)
      claim_segment<kSeg>(s_claim[it & 1], next_seg, rank, order, ends, n_ranks, counts);
    int* s_cur = s_words[it & 1];
    if (threadIdx.x < cur.k1 - cur.k0)
      s_cur[threadIdx.x] = words[(size_t)cur.tile * k_cap + cur.k0 + threadIdx.x];
    const size_t ray = (size_t)cur.tile * tr + r;
    const float4 o = o4[ray], d = d4[ray];
    const unsigned long long key_in = ((const volatile unsigned long long*)key)[ray];
    if (slice == 0) s_key[r] = key_in;
    // The barriers of block_max publish s_key, s_cur and s_claim, and order
    // the last segment's reads of the ring and of s_key before this one's
    // writes.
    int bound = block_max(slice == 0 ? (int)(key_in >> 32) : 0, s_red);
    const Segment nxt = read_segment(s_claim[it & 1]);
    const int* wtn = words + (size_t)max(nxt.tile, 0) * k_cap;
    int kc = cur.k0, k1 = cur.k1, kfn = nxt.k0;
    auto word = [&](int k) { return s_cur[k - cur.k0]; };

    // Fill the ring: cur's words first, as far as the bound lets the walk go
    // (a step whose first word is past the bound ends the segment there: the
    // bound only falls), then nxt's, whose words only the issuing thread reads.
    auto top_up = [&]() {
      while (ring.issued - consumed < kNBufClosest) {
        if (kf < k1) {
          if (kf % kBatch == 0 && (word(kf) & ~kClMask) > bound) {
            k1 = kf;
            continue;
          }
          ring.issue(w + (size_t)word_cluster(word(kf), n_cl) * per4);
          ++kf;
        } else if (nxt.tile >= 0 && kfn < nxt.k1) {
          ring.issue(threadIdx.x == 0 ? w + (size_t)word_cluster(wtn[kfn], n_cl) * per4 : w);
          ++kfn;
        } else {
          break;
        }
      }
    };

    top_up();
    unsigned long long best = miss_key();  // this thread's least key in the segment
    while (kc < k1) {
      if ((word(kc) & ~kClMask) > bound) break;  // block-uniform
      const int n_live = min(kBatch, k1 - kc);   // all copied or in flight: kf >= kc + n_live
      for (int j = 0; j < n_live; ++j) ring.wait(consumed + j);
      int cl[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) cl[j] = word_cluster(word(kc + min(j, n_live - 1)), n_cl);
      unsigned rk[kBatch];
      cluster_ranks(rk, cl, n_live);
      float tb = kTFar;           // this thread's best of the step: t,
      unsigned tp = 0xFFFFFFFFu;  // and rank << lane_bits | lane
      for (int l4 = slice; l4 < c4; l4 += kSlicesClosest) {
        float m[kLanes];
        unsigned mr[kLanes];
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          if (j > 0 && j >= n_live) break;  // word kc is live inside the loop
          Quad a;
          load_quad(a, ring.stage(consumed + j), c4, l4);
#pragma unroll
          for (int i = 0; i < kLanes; ++i) {
            const float tv = quad_tri_t(a, i, o, d, kTFar);
            if (j == 0 || tv < m[i]) {
              m[i] = tv;
              mr[i] = rk[j];
            }
          }
        }
#pragma unroll
        for (int i = 0; i < kLanes; ++i) {
          const unsigned p = mr[i] << lane_bits | (unsigned)(l4 * kLanes + i);
          if (m[i] < tb || (m[i] == tb && p < tp)) {
            tb = m[i];
            tp = p;
          }
        }
      }
      if (tb < kTFar) {
        const unsigned long long k = ((unsigned long long)__float_as_uint(tb) << 32) |
                                     ((unsigned)(kc / kBatch) << step_shift | tp);
        if (k < best) best = k;
      }
      consumed += n_live;
      kc += n_live;
      if (best < key_in) atomicMin(s_key + r, best);  // the slices of a ray fold here
      // The slices' keys are in, the step's stages are read (top_up may issue
      // to them), and the last fold's reads of s_red are done.
      __syncthreads();
      bound = block_max_after_barrier(slice == 0 ? (int)(s_key[r] >> 32) : 0, s_red);
      top_up();
    }
    // The segment stopped early: its copies still in flight are waited for,
    // unread, so that their stages can be issued to again.
    for (; kc < kf; ++kc) ring.wait(consumed++);
    if (slice == 0 && s_key[r] < key_in) atomicMin(key + ray, s_key[r]);
    cur = nxt;
    kf = kfn;
  }
}

// The keys -> (bt, bid), one thread a ray: bt the key's t, bid the slot cl*C
// + lane of the key's (step, rank, lane), or (kTFar, -1) for the miss key.
__global__ void closest_hit_finish_kernel(const int* __restrict__ words,
                                          const int* __restrict__ counts, int k_cap, int tr,
                                          size_t n_rays, int n_cl, int c, int lane_bits,
                                          const unsigned long long* __restrict__ key,
                                          float* __restrict__ bt_out, int* __restrict__ bid_out) {
  const size_t ray = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (ray >= n_rays) return;
  const unsigned long long best = key[ray];
  const float t = __uint_as_float((unsigned)(best >> 32));
  int bid = -1;
  if (t < kTFar) {
    const unsigned low = (unsigned)best;
    const int lane = (int)(low & ((1u << lane_bits) - 1));
    const unsigned want = (low >> lane_bits) & (kBatch - 1);
    const int k = (int)(low >> (kBatchBits + lane_bits)) * kBatch;
    const size_t tile = ray / tr;
    const int* wt = words + tile * k_cap;
    const int n_live = min(kBatch, counts[tile] - k);
    int cl[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) cl[j] = word_cluster(wt[k + min(j, n_live - 1)], n_cl);
    unsigned rk[kBatch];
    cluster_ranks(rk, cl, n_live);
    int hit = cl[0];
#pragma unroll
    for (int j = kBatch - 1; j >= 0; --j)
      if (j < n_live && rk[j] == want) hit = cl[j];
    bid = hit * c + lane;
  }
  bt_out[ray] = t;
  bid_out[ray] = bid;
}

// Closest hit for tiles with at most one candidate: one unconditional
// cluster, no loop over words and no bound. A block holds
// kFastThreads / (kSlicesFast * tr) tiles (at least one), each served by
// kSlicesFast * tr threads: thread u of a tile's group serves ray u /
// kSlicesFast with the quads l4 % kSlicesFast == u % kSlicesFast of the
// tile's cluster, so the slices of a ray are neighbouring lanes of one warp.
// Thread 0 issues the bulk copy of each tile's (4, 3C) matrix into a stage
// of its own before the rays are read. A thread keeps the first lane of the
// least t over its quads, walked in ascending lane order; the slices fold
// the least (t, lane) by shuffles, an order that is total, so the result is
// the serial loop's: least t, then least slot cl*C + lane.
__global__ void closest_fast_kernel(const int* __restrict__ words, const int* __restrict__ counts,
                                    int n_tiles, int k_cap, int tr,
                                    const float4* __restrict__ o4,
                                    const float4* __restrict__ d4, const float4* __restrict__ w,
                                    int n_cl, int c, float* __restrict__ bt_out,
                                    int* __restrict__ bid_out) {
  extern __shared__ __align__(128) float4 ring_mem[];
  __shared__ __align__(8) uint64_t s_bar[kMaxTilesFast];
  const int per4 = 3 * c;
  const int c4 = c / kLanes;
  const int group = kSlicesFast * tr;
  const int tiles = blockDim.x / group;
  const int g = threadIdx.x / group;
  const int r = threadIdx.x % group / kSlicesFast;
  const int slice = threadIdx.x % kSlicesFast;
  const int tile0 = blockIdx.x * tiles;
  Ring<kMaxTilesFast> ring{ring_mem, s_bar, per4, 0};
  ring.init();
  for (int i = 0; i < tiles; ++i) {  // a tile past the last copies the last one's cluster
    const size_t tile = min(tile0 + i, n_tiles - 1);
    ring.issue(threadIdx.x == 0 ? w + (size_t)word_cluster(words[tile * k_cap], n_cl) * per4 : w);
  }
  const int tile = min(tile0 + g, n_tiles - 1);
  const bool own = tile0 + g < n_tiles;
  const bool live = own && 0 < counts[tile];
  const size_t ray = (size_t)tile * tr + r;
  const float4 o = o4[ray], d = d4[ray];
  const int cl = word_cluster(words[(size_t)tile * k_cap], n_cl);
  __syncthreads();  // the stages' barriers are initialised
  ring.wait(g);     // every stage is waited for before the block ends
  float tb = kTFar;
  int lb = 0;
  if (live) {
    const float4* stage = ring.stage(g);
    for (int l4 = slice; l4 < c4; l4 += kSlicesFast) {
      Quad a;
      load_quad(a, stage, c4, l4);
#pragma unroll
      for (int i = 0; i < kLanes; ++i) {
        const float tv = quad_tri_t(a, i, o, d, kTFar);
        if (tv < tb) {
          tb = tv;
          lb = l4 * kLanes + i;
        }
      }
    }
  }
#pragma unroll
  for (int off = kSlicesFast / 2; off > 0; off >>= 1) {
    const float t2 = __shfl_xor_sync(0xffffffffu, tb, off);
    const int l2 = __shfl_xor_sync(0xffffffffu, lb, off);
    if (t2 < tb || (t2 == tb && l2 < lb)) {
      tb = t2;
      lb = l2;
    }
  }
  if (own && slice == 0) {
    const bool hit = tb < kTFar;
    bt_out[ray] = hit ? tb : kTFar;
    bid_out[ray] = hit ? cl * c + lb : -1;
  }
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
    if (threadIdx.x == 0) claim_segment<kSeg>(s_claim, next_seg, rank, order, ends, n_ranks, counts);
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

// grid persistent blocks of kSlicesClosest * tr threads; order (int64) and
// the n_ranks entries of ends are the segment table, *next_seg is 0 and key
// holds the miss key at launch; the finishing pass follows on the stream. The
// caller guarantees 16-byte aligned w.
int tt_closest(const void* words, const void* counts, int n_tiles, int k_cap, int tr,
               const void* o4, const void* d4, const void* w, int n_cl, int c, const void* order,
               const void* ends, int n_ranks, void* next_seg, int grid, void* key, void* bt,
               void* bid, void* stream) {
  if (tr > kMaxRays || c % kLanes) return (int)cudaErrorInvalidValue;
  int lane_bits = 0;
  while ((1 << lane_bits) < c) ++lane_bits;
  const size_t smem = stage_bytes(kNBufClosest, c);
  cudaError_t e = launch_prep(closest_hit_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t s = (cudaStream_t)stream;
  closest_hit_kernel<<<grid, kSlicesClosest * tr, smem, s>>>(
      (const int*)words, (const int*)counts, k_cap, tr, (const float4*)o4, (const float4*)d4,
      (const float4*)w, n_cl, c, lane_bits, (const long long*)order, (const int*)ends, n_ranks,
      (int*)next_seg, (unsigned long long*)key);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t n_rays = (size_t)n_tiles * tr;
  closest_hit_finish_kernel<<<(unsigned)((n_rays + 255) / 256), 256, 0, s>>>(
      (const int*)words, (const int*)counts, k_cap, tr, n_rays, n_cl, c, lane_bits,
      (const unsigned long long*)key, (float*)bt, (int*)bid);
  return (int)cudaGetLastError();
}

// Blocks of max(1, kFastThreads / (kSlicesFast * tr)) tiles of kSlicesFast *
// tr threads each; the caller guarantees C % 4 == 0 and 16-byte aligned w.
int tt_closest_fast(const void* words, const void* counts, int n_tiles, int k_cap, int tr,
                    const void* o4, const void* d4, const void* w, int n_cl, int c, void* bt,
                    void* bid, void* stream) {
  if (kSlicesFast * tr > 1024 || c % kLanes) return (int)cudaErrorInvalidValue;
  const int tiles = max(1, kFastThreads / (kSlicesFast * tr));
  const size_t smem = stage_bytes(tiles, c);
  cudaError_t e = launch_prep(closest_fast_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  closest_fast_kernel<<<(n_tiles + tiles - 1) / tiles, tiles * kSlicesFast * tr, smem,
                        (cudaStream_t)stream>>>(
      (const int*)words, (const int*)counts, n_tiles, k_cap, tr, (const float4*)o4,
      (const float4*)d4, (const float4*)w, n_cl, c, (float*)bt, (int*)bid);
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
