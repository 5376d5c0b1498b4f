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
// order (tri_t, common.cuh), built with -fmad=false and without fast math, so
// that they agree bit for bit with the plain PyTorch versions
// (kernels/traversal2.py closest_hit_plain / anyhit_plain at batch=2). The TPU
// kernels' lockstep group of 8 tiles, packed cluster pairs (_pad_w) and SMEM
// word chunks are not carried over.
//
// What bounds them on the card. At pod-1m (3.94M triangles, 30,757 clusters)
// the accel's tri_w is 189 MB, almost four times the 50 MB L2, so a
// candidate cluster is in general a miss to device memory: a synchronous
// fetch would stall the block for the memory latency (~1 us) at every
// candidate. Once that latency is hidden, the work per candidate is fp32
// issue: 64 rays x 128 triangles x (~45 flops and an IEEE divide) against
// 6 KB of coefficients, an order of magnitude more issue time than the
// bandwidth time of the 6 KB. A test is a chain of some 60 dependent
// instructions, so what a kernel reaches of that bound is set by how many
// tests it keeps in flight on every SM. The tensor cores do not serve these
// kernels: the products have depth 4 (a homogeneous ray times a (4, 3C)
// matrix), the frame's exactness rests on fp32 products rounded one at a
// time, and TF32 keeps 10 mantissa bits and would flip hits.
//
// What the design does about it. Each block keeps a ring of kNBuf = 4
// cluster stages in shared memory (4 x 6 KB at C = 128). A cluster's (4, 3C)
// matrix is contiguous in tri_w and copies as it is; the block reads the
// stage as it landed, as 16-byte broadcast loads that each cover one
// coefficient of 4 consecutive triangles, so 4 triangles cost 12 loads, 3 a
// triangle (as traversal2.cu's transposed stage), with no triangle-major copy
// of the accel (the quad reads of sorted.cuh).
//
// closest_stream_kernel runs one block a tile, one thread a ray, and fills
// its ring with TMA's bulk copies, one a candidate (the Ring of sorted.cuh):
// the copies of candidates k+2 and k+3 are in flight while the block
// intersects k and k+1, and a step's two stages are refilled with k+4 and k+5
// once its fold is done. The segmented walk of closest_hit_kernel
// (traversal2.cu) was measured in its place at this B and was not faster
// on all of the pod-1m primary pass: the heaviest tile alone is 2 % of that
// pass, so there is no tail to win, and the walk's per-step folds cost what
// its extra warps gain (PERF.md).
//
// anyhit_stream_kernel does not: occlusion is an OR over a tile's candidates,
// whatever the order and whoever visits them, and the lists have a long tail
// (a mean of 3 words a tile, a maximum of some 400), which one block a tile
// would walk alone while the card has drained. Its unit of work is a segment,
// kSeg consecutive words of one tile (the table of kernels/_launch.py
// run_segments), pulled from a device counter by a fixed grid of
// persistent blocks of kSlices * TR threads: kSlices threads serve one ray,
// each testing every kSlices-th quad of 4 triangles of a cluster, the 4 tests
// without a branch between them. A segment starts from the tile's occlusion
// flags as they stand in device memory (possibly stale; flags are only ever
// set, so a stale read costs work, never a result). The ring runs on across
// the segments a block walks: a block holds the segment it works on and the
// next one it will, and copies the next one's first clusters while this one
// finishes; a word whose entry bits already reach the tile's bound is not
// copied at all. One thread issues one cp.async.bulk (TMA's 1-D bulk copy) a
// cluster, which completes on the stage's mbarrier (the Ring of sorted.cuh).
// The same ring filled by every thread's cp.async copies was measured beside
// it and took 2 to 3 % longer on the pod-1m shadow pass: it needs one more block barrier a step (a thread
// can wait for its own chunks only) and 90 registers a thread against 80,
// which leaves room for 2 blocks an SM, not 3.
#include "common.cuh"
#include "sorted.cuh"

namespace {

constexpr int kNBuf = 4;        // NBUF of kernels/stream.py
constexpr int kBatch = 2;       // STREAM_BATCH of kernels/stream.py

// Closest hit over a tile's sorted candidates, kBatch clusters a step. Per
// ray: within a step the earliest candidate j wins a lane (strict <), across
// lanes the smallest t and on equal t the smaller slot cl*C + lane, and a
// step replaces the running best only on a strict < (traversal2.py:_batch_best).
// Stops once the next word's entry bits reach the block max of the best t.
// Ring item k is candidate k: the first kNBuf are issued before the walk, a
// step's stages are issued to again, with candidates k + kNBuf on, once its
// fold is done.
__global__ void closest_stream_kernel(const int* __restrict__ words,
                                      const int* __restrict__ counts, int k_cap,
                                      const float4* __restrict__ o4,
                                      const float4* __restrict__ d4,
                                      const float4* __restrict__ w, int n_cl, int c,
                                      float* __restrict__ bt_out, int* __restrict__ bid_out) {
  extern __shared__ __align__(128) float4 ring_mem[];
  __shared__ __align__(8) uint64_t s_bar[kNBuf];
  __shared__ int s_red[32];
  const int tile = blockIdx.x;
  const size_t ray = (size_t)tile * blockDim.x + threadIdx.x;
  const int n = counts[tile];
  const int* wt = words + (size_t)tile * k_cap;
  const int per4 = 3 * c;  // 16-byte chunks of one (4, 3C) cluster
  const int c4 = c / kLanes;
  const float4 o = o4[ray], d = d4[ray];
  Ring<kNBuf> ring{ring_mem, s_bar, per4, 0};
  ring.init();
  __syncthreads();  // the barriers are published
  float bt = kTFar;
  int bid = -1;
  // Only the issuing thread reads the word of a copy.
  auto issue = [&](int item) {
    ring.issue(threadIdx.x == 0 ? w + (size_t)word_cluster(wt[item], n_cl) * per4 : w);
  };
  for (int k = 0; k < min(kNBuf, n); ++k) issue(k);
  int bound = __float_as_int(kTFar);
  int k = 0;
  for (; k < n; k += kBatch) {
    if ((wt[k] & ~kClMask) >= bound) break;  // block-uniform
    const int n_live = min(kBatch, n - k);
    for (int j = 0; j < n_live; ++j) ring.wait(k + j);
    int cl[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) cl[j] = word_cluster(wt[k + min(j, n_live - 1)], n_cl);
    float tb = kTFar;
    int tbid = kIntMax;
    for (int l4 = 0; l4 < c4; ++l4) {
      float m[kLanes];
      int mb[kLanes];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (j > 0 && j >= n_live) break;  // candidate k is live inside the loop
        Quad a;
        load_quad(a, ring.stage(k + j), c4, l4);
#pragma unroll
        for (int i = 0; i < kLanes; ++i) {
          const float tv = quad_tri_t(a, i, o, d, kTFar);
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
    bound = block_max(__float_as_int(bt), s_red);  // the step's stages are read
    for (int j = 0; j < n_live && k + j + kNBuf < n; ++j) issue(k + j + kNBuf);
  }
  // The walk stopped early: the copies still in flight are waited for, unread.
  for (; k < ring.issued; ++k) ring.wait(k);
  bt_out[ray] = bt;
  bid_out[ray] = bid;
}

// Occlusion: a ray is occluded iff some candidate triangle has t in
// (kTMin, tmax[ray]); occ_out holds zeros at launch and a ray's flag is set by
// whichever segment finds it a hit. The block pulls segments of the table
// (order, ends; claim_segment, common.cuh) until the counter has passed them
// all, kBatch clusters a step. Thread tid serves ray tid % tr with the quads
// l4 % kSlices == tid / tr of each cluster. A segment stops once the next
// word's entry bits reach the max tmax of the tile's rays still unoccluded (0
// once all are), which it may do at once.
//
// The block holds `cur`, the segment it works on (kc: the next word to
// intersect, kf: the next to copy) and, claimed when it starts on cur, `nxt`,
// the one it will work on next (kfn: the next word to copy). The copies in
// flight are cur's words kc .. kf-1, then nxt's words nxt.k0 .. kfn-1: the
// ring's items `consumed` .. issued-1.
__global__ void anyhit_stream_kernel(const int* __restrict__ words,
                                     const int* __restrict__ counts, int k_cap, int tr,
                                     const float4* __restrict__ o4,
                                     const float4* __restrict__ d4,
                                     const float* __restrict__ tmax,
                                     const float4* __restrict__ w, int n_cl, int c,
                                     const long long* __restrict__ order,
                                     const int* __restrict__ ends, int n_ranks,
                                     int* next_seg, uint8_t* occ_out) {
  extern __shared__ __align__(128) float4 ring_mem[];
  __shared__ __align__(8) uint64_t s_bar[kNBuf];
  __shared__ int s_red[32];
  __shared__ int s_claim[2][3];
  __shared__ uint8_t s_occ[kMaxRays];
  const int per4 = 3 * c;
  const int c4 = c / kLanes;
  const int r = threadIdx.x % tr;
  const int slice = threadIdx.x / tr;
  int rank = 0;  // thread 0's cursor into ends
  Ring<kNBuf> ring{ring_mem, s_bar, per4, 0};
  ring.init();
  if (threadIdx.x == 0)
    claim_segment<kSeg>(s_claim[1], next_seg, rank, order, ends, n_ranks, counts);
  __syncthreads();  // the barriers and the claim are published
  Segment cur = read_segment(s_claim[1]);
  int consumed = 0;
  int kf = cur.k0;
  for (int it = 0; cur.tile >= 0; ++it) {  // block-uniform
    // The segment after this one: claimed here, read after the barriers of
    // block_max, its slot of s_claim claimed into again two segments on.
    if (threadIdx.x == 0)
      claim_segment<kSeg>(s_claim[it & 1], next_seg, rank, order, ends, n_ranks, counts);
    const int* wt = words + (size_t)cur.tile * k_cap;
    const size_t ray = (size_t)cur.tile * tr + r;
    const float4 o = o4[ray], d = d4[ray];
    const float tm = tmax[ray];
    bool occ = ((const volatile uint8_t*)occ_out)[ray] != 0;
    if (slice == 0) s_occ[r] = occ ? 1 : 0;
    const bool dead = !(tm > kTMin);  // an empty interval: padding, or a ray with d == 0
    bool hit = false;
    // The barriers of block_max publish s_occ and s_claim, and order the last
    // segment's reads of the ring before this one's copies into it.
    int bound = block_max(open_bits(occ, tm), s_red);
    const Segment nxt = read_segment(s_claim[it & 1]);
    const int* wtn = words + (size_t)max(nxt.tile, 0) * k_cap;
    int kc = cur.k0, k1 = cur.k1, kfn = nxt.k0;

    // Fill the ring: cur's words first, as far as the bound lets the walk go
    // (a word at or past the bound ends the segment there: the bound only
    // falls), then nxt's.
    auto top_up = [&]() {
      while (ring.issued - consumed < kNBuf) {
        if (kf < k1) {
          if ((wt[kf] & ~kClMask) >= bound) {
            k1 = kf;
            continue;
          }
          ring.issue(w + (size_t)min(wt[kf] & kClMask, n_cl - 1) * per4);
          ++kf;
        } else if (nxt.tile >= 0 && kfn < nxt.k1) {
          ring.issue(w + (size_t)min(wtn[kfn] & kClMask, n_cl - 1) * per4);
          ++kfn;
        } else {
          break;
        }
      }
    };

    top_up();
    while (kc < k1) {
      if ((wt[kc] & ~kClMask) >= bound) break;  // block-uniform; all occluded -> bound 0
      const int n_live = min(kBatch, k1 - kc);  // all copied or in flight: kf >= kc + n_live
      for (int j = 0; j < n_live; ++j) ring.wait(consumed + j);
      if (!occ && !dead) {
        for (int j = 0; j < n_live && !hit; ++j) {
          const float4* stage = ring.stage(consumed + j);
          for (int l4 = slice; l4 < c4 && !hit; l4 += kSlices) {
            Quad a;
            load_quad(a, stage, c4, l4);
            bool h = false;
#pragma unroll
            for (int i = 0; i < kLanes; ++i) h |= quad_tri_t(a, i, o, d, tm) < kTFar;
            hit = h;
          }
        }
      }
      consumed += n_live;
      kc += n_live;
      if (hit) s_occ[r] = 1;  // the slices of a ray OR here
      __syncthreads();
      occ = s_occ[r] != 0;
      bound = block_max(open_bits(occ, tm), s_red);  // its barriers free the step's stages
      top_up();
    }
    // The segment stopped early: its copies still in flight are waited for,
    // unread, so that their stages can be issued to again.
    for (; kc < kf; ++kc) ring.wait(consumed++);
    if (hit) occ_out[ray] = 1;
    cur = nxt;
    kf = kfn;
  }
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

// grid persistent blocks of kSlices * tr threads; order (int64) and the n_ranks
// entries of ends are the segment table, *next_seg is 0 and occ holds zeros at
// launch.
int st_anyhit(const void* words, const void* counts, int k_cap, int tr, const void* o4,
              const void* d4, const void* tmax, const void* w, int n_cl, int c,
              const void* order, const void* ends, int n_ranks, void* next_seg, int grid,
              void* occ, void* stream) {
  if (tr > kMaxRays) return (int)cudaErrorInvalidValue;
  const size_t smem = ring_bytes(c);
  cudaError_t e = launch_prep(anyhit_stream_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  anyhit_stream_kernel<<<grid, kSlices * tr, smem, (cudaStream_t)stream>>>(
      (const int*)words, (const int*)counts, k_cap, tr, (const float4*)o4, (const float4*)d4,
      (const float*)tmax, (const float4*)w, n_cl, c, (const long long*)order, (const int*)ends,
      n_ranks, (int*)next_seg, (uint8_t*)occ);
  return (int)cudaGetLastError();
}

}  // extern "C"
