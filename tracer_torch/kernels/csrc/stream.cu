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
// triangle (as traversal2.cu's transposed stage), with no triangle-major
// copy of the accel.
//
// closest_stream_kernel runs one block a tile, one thread a ray (its tie rule
// depends on the order of the walk), and fills its ring with cp.async
// 16-byte copies, one commit group per candidate: the copies of candidates
// k+2 and k+3 are in flight while the block intersects k and k+1, and a
// step's two stages are refilled with k+4 and k+5 once its fold is done.
//
// anyhit_stream_kernel does not: occlusion is an OR over a tile's candidates,
// whatever the order and whoever visits them, and the lists have a long tail
// (a mean of 3 words a tile, a maximum of some 400), which one block a tile
// would walk alone while the card has drained. Its unit of work is a segment,
// kSeg consecutive words of one tile (the table of kernels/traversal2.py
// anyhit_segments), pulled from a device counter by a fixed grid of
// persistent blocks of kSlices * TR threads: kSlices threads serve one ray,
// each testing every kSlices-th quad of 4 triangles of a cluster, the 4 tests
// without a branch between them. A segment starts from the tile's occlusion
// flags as they stand in device memory (possibly stale; flags are only ever
// set, so a stale read costs work, never a result). The ring runs on across
// the segments a block walks: a block holds the segment it works on and the
// next one it will, and copies the next one's first clusters while this one
// finishes; a word whose entry bits already reach the tile's bound is not
// copied at all. One thread issues one cp.async.bulk (TMA's 1-D bulk copy) a
// cluster, which completes on the stage's mbarrier. The same ring filled by
// every thread's cp.async copies, as closest_stream_kernel's is, was measured
// beside it and took 2 to 3 % longer on the pod-1m shadow pass: it needs one more
// block barrier a step (a thread can wait for its own chunks only) and 90
// registers a thread against 80, which leaves room for 2 blocks an SM, not 3.
#include "common.cuh"

namespace {

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

__device__ __forceinline__ float quad_t(const Quad& a, int i, float4 o, float4 d, float t_max) {
  return tri_t(field(a, 0, i), field(a, 1, i), field(a, 2, i), o, d, t_max);
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

// ---------------------------------------------------------------------------
// The ring of anyhit_stream_kernel: a block's copies, numbered in the order
// of issue; copy i lands in stage i % kNBuf. Every thread calls issue() and
// wait() with the same arguments, and waits for every copy once, in order,
// before the stage is issued to again.
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// A barrier that one arrival and the bytes it announces complete.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}

// The phase's one arrival, which announces `bytes` of copies to come.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// TMA's 1-D bulk copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from device memory into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Wait until the barrier's phase of this parity is complete. A copy lands in
// microseconds: a wait of many thousand times that is a fault of the kernel,
// and traps instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned addr = smem_u32(bar);
  for (int spins = 0;; ++spins) {
    unsigned done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2, %3;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity), "r"(1000)  // a try may sleep for about a microsecond
        : "memory");
    if (done) return;
    if (spins > (1 << 20)) __trap();
  }
}

// A stage is filled by one bulk copy, issued by thread 0, which completes on
// the stage's mbarrier; a thread that has waited for it may read the stage.
struct Ring {
  float4* stages;
  uint64_t* bars;
  int per4;    // 16-byte chunks of one (4, 3C) cluster
  int issued;  // copies issued so far

  __device__ __forceinline__ void init() {
    if (threadIdx.x == 0) {
      for (int b = 0; b < kNBuf; ++b) mbar_init(bars + b);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
  }

  __device__ __forceinline__ void issue(const float4* src) {
    if (threadIdx.x == 0) {
      uint64_t* bar = bars + issued % kNBuf;
      mbar_expect(bar, per4 * sizeof(float4));
      bulk_copy(stages + (issued % kNBuf) * per4, src, per4 * sizeof(float4), bar);
    }
    ++issued;
  }

  __device__ __forceinline__ void wait(int item) {
    mbar_wait(bars + item % kNBuf, (item / kNBuf) & 1);
  }

  __device__ __forceinline__ const float4* stage(int item) const {
    return stages + (item % kNBuf) * per4;
  }
};

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
  Ring ring{ring_mem, s_bar, per4, 0};
  ring.init();
  if (threadIdx.x == 0)
    claim_segment(s_claim[1], next_seg, rank, order, ends, n_ranks, counts);
  __syncthreads();  // the barriers and the claim are published
  Segment cur = read_segment(s_claim[1]);
  int consumed = 0;
  int kf = cur.k0;
  for (int it = 0; cur.tile >= 0; ++it) {  // block-uniform
    // The segment after this one: claimed here, read after the barriers of
    // block_max, its slot of s_claim claimed into again two segments on.
    if (threadIdx.x == 0)
      claim_segment(s_claim[it & 1], next_seg, rank, order, ends, n_ranks, counts);
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
            for (int i = 0; i < kLanes; ++i) h |= quad_t(a, i, o, d, tm) < kTFar;
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
