// Pair-stream closest-hit and any-hit kernels for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of tracer/kernels/traversal3.py:
//   pair_closest_kernel <- _pair_closest_kernel (via trace_tiles_pairs)
//   pair_anyhit_kernel  <- _pair_anyhit_kernel  (via any_hit_tiles_pairs)
//
// What they compute. A tile is TR rays (one block). Its
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
// A walk is a chain of dependent steps: a word's vote needs the state the
// tests before it left.
//
// What the design does about it. Both kernels keep one block a tile, so
// every vote sees the state the reference's walk has there: a run cut into
// segments would start from a state as it stands, and a ray whose hit lies
// under its bound (best t, or t_max) in a cluster whose rounded slab entry
// does not (an edge pair) gets it only if another ray votes, which would then
// depend on timing. What they shorten is the step: a ray is served by
// kSlicesPair (kSlicesPairClosest) threads, each with every slices-th quad of
// 4 triangles of a tested cluster; the run is read in windows of 32 words
// whose slab entries are taken at once, a ray's votes over a window being one
// 32-bit mask, so a skipped word costs no barrier and a tested cluster one;
// the next voted clusters are copied ahead by TMA's bulk copies (sorted.cuh's
// ring and quad reads). pair_closest_kernel recomputes a ray's mask from the
// window's entries, which it keeps in shared memory, whenever its best t
// falls, folds its slices' (t, lane) bests by shuffles, and on a tile whose
// rays share one origin (the primary rays) computes the origin's side of a
// tested cluster's products once a block, not once a ray. A tile's other
// state lives in registers for the whole run.
#include "common.cuh"
#include "sorted.cuh"

namespace {

// Threads a ray of pair_anyhit_kernel (SLICES_PAIR of kernels/traversal3.py):
// a block of 128 for a tile of 64 rays. Over the whole pair shadow pass of
// bench100k, 2 threads a ray took 18 % less time than 4 (more blocks fit an
// SM; 4 is 27 % faster at the heavy comparison tiles) and 13 % less than 1
// (PERF.md).
constexpr int kSlicesPair = 2;
static_assert(kSlicesPair <= 32 && 32 % kSlicesPair == 0, "a ray's slices share a warp");
// Words of a run whose slab votes pair_anyhit_kernel takes at once: one a
// lane of a warp, one bit of a mask.
constexpr int kWindow = 32;
// Ring stages of pair_anyhit_kernel: the clusters of the next voted words.
constexpr int kNBufPair = 4;
// Threads a ray of pair_closest_kernel (SLICES_PAIR_CLOSEST of
// kernels/traversal3.py): a block of 128 for a tile of 64 rays. Over the
// whole primary pass of bench100k, 2 took 9 % less time than 1 and 20 % less
// than 4 (4 is 19 % faster at the heavy comparison tiles; PERF.md).
constexpr int kSlicesPairClosest = 2;
static_assert(kSlicesPairClosest <= 32 && 32 % kSlicesPairClosest == 0,
              "a ray's slices share a warp");
// Ring stages of pair_closest_kernel (NBUF_PAIR_CLOSEST): 2 were up to 0.7 %
// faster than 4 over the pass, in half the shared memory.
constexpr int kNBufPairClosest = 2;
// Registers a thread of pair_closest_kernel: six blocks of 128 an SM, where
// the 96 it takes uncapped fit five (1 % faster over the pass; 72 and 88 were
// slower). A window's slab entries wait in shared memory: in registers under
// the same cap they were 3 % slower.
constexpr int kRegsPairClosest = 80;

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

// The votes and the bound of a block: the OR of every thread's `votes` and
// the max of its `bits`, into every thread. One barrier; the two slots of
// s_or and s_max take turns (`turn`), so a slot is written again only after
// every thread has passed the next call's barrier, and so has read it.
__device__ __forceinline__ void block_or_max(unsigned votes, int bits, unsigned& votes_out,
                                             int& bits_out, unsigned (*s_or)[32],
                                             int (*s_max)[32], int& turn) {
  votes = __reduce_or_sync(0xffffffffu, votes);
  bits = __reduce_max_sync(0xffffffffu, bits);
  if ((threadIdx.x & 31) == 0) {
    s_or[turn][threadIdx.x >> 5] = votes;
    s_max[turn][threadIdx.x >> 5] = bits;
  }
  __syncthreads();
  votes_out = s_or[turn][0];
  bits_out = s_max[turn][0];
  for (int i = 1; i < (int)(blockDim.x >> 5); ++i) {
    votes_out |= s_or[turn][i];
    bits_out = max(bits_out, s_max[turn][i]);
  }
  turn ^= 1;
}

// The copies of a window's voted clusters, as both pair kernels walk a
// window: the walk tests the voted words under the bound in order, and the
// votes only lose bits, so the clusters of the next voted words are copied
// ahead into the ring; a copy whose word is passed unvoted is waited for,
// unread. Every thread of the block holds the same state.
template <int kN>
struct WindowCopies {
  Ring<kN> ring;
  int consumed;       // copies waited for and done with
  unsigned inflight;  // window words whose copies are issued and not yet consumed
  int f;              // the next window word that may be copied

  // Word j's cluster in the ring, j the first word of `cand` (the voted
  // words under the bound past the last one tested). The stages are free
  // here (none is in flight at a window's start, and the last test consumed
  // one), so the next voted words' copies go out first, j's among them.
  __device__ __forceinline__ const float4* ready(unsigned cand, int j,
                                                 const int* __restrict__ window,
                                                 const float4* __restrict__ w, int n_cl) {
    unsigned next = cand & (f < 32 ? ~0u << f : 0u);
    while (next && __popc(inflight) < kN) {
      const int b = __ffs(next) - 1;
      ring.issue(threadIdx.x == 0 ? w + (size_t)word_cluster(window[b], n_cl) * ring.per4 : w);
      inflight |= 1u << b;
      next &= next - 1;
      f = b + 1;
    }
    while (inflight && __ffs(inflight) - 1 < j) {  // copies of words skipped since
      ring.wait(consumed++);
      inflight &= inflight - 1;
    }
    ring.wait(consumed);
    return ring.stage(consumed);
  }

  // After the test of the word ready() returned, the lowest in flight; the
  // barrier that follows frees its stage.
  __device__ __forceinline__ void done() {
    ++consumed;
    inflight &= inflight - 1;
  }

  // At a window's end: the copies of words not tested, then a fresh window.
  __device__ __forceinline__ void next_window() {
    for (; inflight; inflight &= inflight - 1) ring.wait(consumed++);
    f = 0;
  }
};

// Occlusion over a tile's run, one block a tile, the reference's walk step
// for step. Thread u serves ray u / kSlicesPair with the quads l4 %
// kSlicesPair == u % kSlicesPair of a tested cluster, so the slices of a ray
// are neighbouring lanes of one warp. The run is read in windows of kWindow
// words, one word a lane of every warp. A ray's slab votes over the window
// are one mask, bit j set iff the ray enters word j's box before its t_max;
// the block's votes are the OR of the masks of the rays not yet occluded, and
// its bound the max t_max bits of those rays. The words under the bound are
// a prefix of the window (the run is sorted and the bound only falls), and
// the next tested word is the first voted word under the bound past the last
// one tested: the words between them are skipped with the same state the
// reference skips them with, for occlusion and bound change only when a
// cluster is tested. Every unoccluded ray tests a tested cluster, voter or
// not. The votes only lose bits as rays are occluded, so the clusters of
// the next voted words are copied ahead into a ring of kNBufPair stages; a
// copy whose word is no longer voted when the walk passes it is waited for,
// unread.
__global__ void pair_anyhit_kernel(const int* __restrict__ offs, const int* __restrict__ pwords,
                                   const float4* __restrict__ o4, const float4* __restrict__ d4,
                                   const float* __restrict__ tmax,
                                   const float* __restrict__ box_lo,
                                   const float* __restrict__ box_hi,
                                   const float4* __restrict__ w, int n_cl, int c,
                                   uint8_t* __restrict__ occ_out) {
  extern __shared__ __align__(128) float4 ring_mem[];
  __shared__ __align__(8) uint64_t s_bar[kNBufPair];
  __shared__ unsigned s_or[2][32];
  __shared__ int s_max[2][32];
  const int tr = blockDim.x / kSlicesPair;
  const int tile = blockIdx.x;
  const int slice = threadIdx.x % kSlicesPair;
  const int lane = threadIdx.x & 31;
  const int per4 = 3 * c;
  const int c4 = c / kLanes;
  const size_t ray = (size_t)tile * tr + threadIdx.x / kSlicesPair;
  const int k_begin = offs[tile], k_end = offs[tile + 1];
  if (k_begin == k_end) {  // block-uniform: an empty run leaves every ray unoccluded
    if (slice == 0) occ_out[ray] = 0;
    return;
  }
  WindowCopies<kNBufPair> copies{{ring_mem, s_bar, per4, 0}, 0, 0u, 0};
  copies.ring.init();  // published by the first barrier below, before any wait
  const float4 o = o4[ray], d = d4[ray];
  const SlabRay sr = slab_ray(o, d);
  const float tm = tmax[ray];
  const bool dead = !(tm > kTMin);  // no t lies in (kTMin, tm): nothing to test
  bool occ = false;
  int turn = 0, bound;
  unsigned votes;
  bool walking = true;
  for (int k0 = k_begin; walking && k0 < k_end; k0 += kWindow) {  // block-uniform
    const int n = min(kWindow, k_end - k0);
    const unsigned in_window = n == 32 ? 0xffffffffu : (1u << n) - 1;
    const int word = lane < n ? pwords[k0 + lane] : 0;
    unsigned mask = 0;
#pragma unroll
    for (int jj = 0; jj < kWindow / kSlicesPair; ++jj) {
      const int j = jj * kSlicesPair + slice;
      const int wj = __shfl_sync(0xffffffffu, word, j);
      if (j < n) {
        const int cl = word_cluster(wj, n_cl);
        if (slab_enter(sr, box_lo + 3 * cl, box_hi + 3 * cl) < tm) mask |= 1u << j;
      }
    }
#pragma unroll
    for (int off = kSlicesPair / 2; off > 0; off >>= 1)
      mask |= __shfl_xor_sync(0xffffffffu, mask, off);
    block_or_max(occ ? 0u : mask, open_bits(occ, tm), votes, bound, s_or, s_max, turn);
    int pos = 0;  // the next word that may be tested
    for (;;) {
      const unsigned under = __ballot_sync(0xffffffffu, lane < n && (word & ~kClMask) < bound);
      if (under != in_window) walking = false;  // the walk stops in this window
      const unsigned cand = votes & under & (pos < 32 ? ~0u << pos : 0u);
      if (!cand) break;
      const int j = __ffs(cand) - 1;
      const float4* stage = copies.ready(cand, j, pwords + k0, w, n_cl);
      if (!occ && !dead) {
        for (int l4 = slice; l4 < c4 && !occ; l4 += kSlicesPair) {
          Quad a;
          load_quad(a, stage, c4, l4);
#pragma unroll
          for (int i = 0; i < kLanes; ++i) occ |= quad_tri_t(a, i, o, d, tm) < kTFar;
        }
      }
#pragma unroll
      for (int off = kSlicesPair / 2; off > 0; off >>= 1)
        occ |= __shfl_xor_sync(0xffffffffu, occ ? 1 : 0, off) != 0;
      copies.done();
      pos = j + 1;
      // Its barrier also frees the stage just read.
      block_or_max(occ ? 0u : mask, open_bits(occ, tm), votes, bound, s_or, s_max, turn);
    }
    copies.next_window();
  }
  if (slice == 0) occ_out[ray] = occ ? 1 : 0;
}

// The origin's sides of a staged cluster for the origin o, computed by the
// block's threads in turn: so[f * c4 + l4] holds field f's of triangles
// 4*l4 .. 4*l4+3, lane by lane (origin_dot: tri_t's order).
__device__ __forceinline__ void stage_origin(float4* so, const float4* stage, float4 o, int c4) {
  for (int q = threadIdx.x; q < 3 * c4; q += blockDim.x) {
    const int f = q < c4 ? 0 : q < 2 * c4 ? 1 : 2;
    const int l4 = q - f * c4;
    const float4 x = stage[f * c4 + l4], y = stage[(3 + f) * c4 + l4],
                 z = stage[(6 + f) * c4 + l4], w = stage[(9 + f) * c4 + l4];
    so[q] = make_float4(origin_dot(make_float4(x.x, y.x, z.x, w.x), o),
                        origin_dot(make_float4(x.y, y.y, z.y, w.y), o),
                        origin_dot(make_float4(x.z, y.z, z.z, w.z), o),
                        origin_dot(make_float4(x.w, y.w, z.w, w.w), o));
  }
}

// A quad whose row 3 holds its triangles' origin sides (stage_origin) where
// the stage holds the coefficients' w row, which tri_t_so does not read.
__device__ __forceinline__ void load_quad_so(Quad& a, const float4* stage, const float4* so,
                                             int c4, int lane4) {
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int f = 0; f < 3; ++f) a.q[r][f] = stage[(r * 3 + f) * c4 + lane4];
#pragma unroll
  for (int f = 0; f < 3; ++f) a.q[3][f] = so[f * c4 + lane4];
}

__device__ __forceinline__ float quad_tri_t_so(const Quad& a, int i, float4 d, float t_max) {
  return tri_t_so(comp(a.q[3][0], i), comp(a.q[3][1], i), comp(a.q[3][2], i), field(a, 0, i),
                  field(a, 1, i), field(a, 2, i), d, t_max);
}

// A ray's slab votes over a window: bit j set iff it enters word j's box
// before its best t bt, for the words j = jj * kSlicesPairClosest + slice
// whose entries this thread holds at enter[jj * blockDim.x] (the other slices
// of the ray hold the rest; the block's OR takes them all).
__device__ __forceinline__ unsigned closest_votes(const float* enter, float bt, int slice) {
  unsigned mask = 0;
#pragma unroll
  for (int jj = 0; jj < kWindow / kSlicesPairClosest; ++jj)
    mask |= (enter[jj * blockDim.x] < bt ? 1u : 0u) << (jj * kSlicesPairClosest + slice);
  return mask;
}

// Closest hit over a tile's run, one block a tile, the reference's walk step
// for step, in the shape of pair_anyhit_kernel. Thread u serves ray u /
// kSlicesPairClosest with the quads l4 % kSlicesPairClosest == u %
// kSlicesPairClosest of a tested cluster. The run is read in windows of
// kWindow words; a thread computes the slab entries of its share of a window
// once, into shared memory of its own, and a ray's votes are the bits of the
// entries below its best t, recomputed after each tested cluster (bt only
// falls, so a vote is only ever lost). The block's votes are the OR of all of them and its
// bound the max bt bits, both from one barrier; the next tested word is the
// first voted word under the bound past the last one tested, and the words
// between are skipped with the state the reference skips them with. Every ray
// tests a tested cluster: each thread keeps the first lane of its least t
// over its quads, walked in ascending lane order; the slices fold the least
// (t, lane) by shuffles, an order that is total, so the result is the serial
// loop's first lane of the minimum; the running best is replaced on a strict
// <. The next voted clusters are copied ahead into a ring of
// kNBufPairClosest stages; a copy whose word lost its vote is waited for,
// unread. When every live ray of the tile starts at ray 0's origin, bit for
// bit (primary rays; a padding ray never hits, whatever its origin), the
// block computes a tested cluster's origin sides once into shared memory (one
// more barrier) and a ray computes only its direction's side: the same
// operations on the same bits, so the same t. The block decides this from the
// data, once.
__global__ void __maxnreg__(kRegsPairClosest) pair_closest_kernel(
    const int* __restrict__ offs, const int* __restrict__ pwords, const float4* __restrict__ o4,
    const float4* __restrict__ d4, const float* __restrict__ box_lo,
    const float* __restrict__ box_hi, const float4* __restrict__ w, int n_cl, int c,
    float* __restrict__ bt_out, int* __restrict__ bid_out) {
  extern __shared__ __align__(128) float4 ring_mem[];  // the ring's stages, so, the entries
  __shared__ __align__(8) uint64_t s_bar[kNBufPairClosest];
  __shared__ unsigned s_or[2][32];
  __shared__ int s_max[2][32];
  const int tr = blockDim.x / kSlicesPairClosest;
  const int tile = blockIdx.x;
  const int slice = threadIdx.x % kSlicesPairClosest;
  const int lane = threadIdx.x & 31;
  const int per4 = 3 * c;
  const int c4 = c / kLanes;
  const size_t ray0 = (size_t)tile * tr;
  const size_t ray = ray0 + threadIdx.x / kSlicesPairClosest;
  const int k_begin = offs[tile], k_end = offs[tile + 1];
  if (k_begin == k_end) {  // block-uniform: an empty run leaves every ray without a hit
    if (slice == 0) {
      bt_out[ray] = kTFar;
      bid_out[ray] = -1;
    }
    return;
  }
  WindowCopies<kNBufPairClosest> copies{{ring_mem, s_bar, per4, 0}, 0, 0u, 0};
  copies.ring.init();  // published by the barrier below, before any wait
  float4* so = ring_mem + kNBufPairClosest * per4;
  float* enter = reinterpret_cast<float*>(so + 3 * c4) + threadIdx.x;
  const float4 o = o4[ray], d = d4[ray], o0 = o4[ray0];
  const SlabRay sr = slab_ray(o, d);
  const bool one_origin = !sr.live || (__float_as_int(o.x) == __float_as_int(o0.x) &&
                                       __float_as_int(o.y) == __float_as_int(o0.y) &&
                                       __float_as_int(o.z) == __float_as_int(o0.z));
  const bool shared = __syncthreads_and(one_origin) != 0;
  float bt = kTFar;
  int bid = -1;
  int turn = 0, bound;
  unsigned votes;
  bool walking = true;
  for (int k0 = k_begin; walking && k0 < k_end; k0 += kWindow) {  // block-uniform
    const int n = min(kWindow, k_end - k0);
    const unsigned in_window = n == 32 ? 0xffffffffu : (1u << n) - 1;
    const int word = lane < n ? pwords[k0 + lane] : 0;
#pragma unroll
    for (int jj = 0; jj < kWindow / kSlicesPairClosest; ++jj) enter[jj * blockDim.x] = kTFar;
#pragma unroll
    for (int jj = 0; jj < kWindow / kSlicesPairClosest && jj * kSlicesPairClosest < n; ++jj) {
      const int j = jj * kSlicesPairClosest + slice;
      const int cl = word_cluster(__shfl_sync(0xffffffffu, word, j), n_cl);
      if (j < n) enter[jj * blockDim.x] = slab_enter(sr, box_lo + 3 * cl, box_hi + 3 * cl);
    }
    block_or_max(closest_votes(enter, bt, slice), __float_as_int(bt), votes, bound, s_or, s_max,
                 turn);
    int pos = 0;  // the next word that may be tested
    for (;;) {
      const unsigned under = __ballot_sync(0xffffffffu, lane < n && (word & ~kClMask) < bound);
      if (under != in_window) walking = false;  // the walk stops in this window
      const unsigned cand = votes & under & (pos < 32 ? ~0u << pos : 0u);
      if (!cand) break;
      const int j = __ffs(cand) - 1;
      const float4* stage = copies.ready(cand, j, pwords + k0, w, n_cl);
      const int cl = word_cluster(__shfl_sync(0xffffffffu, word, j), n_cl);
      float tb = kTFar;
      int lb = 0;
      if (shared) {  // block-uniform
        stage_origin(so, stage, o0, c4);  // the last reads of so preceded the last barrier
        __syncthreads();
        for (int l4 = slice; l4 < c4; l4 += kSlicesPairClosest) {
          Quad a;
          load_quad_so(a, stage, so, c4, l4);
#pragma unroll
          for (int i = 0; i < kLanes; ++i) {
            const float tv = quad_tri_t_so(a, i, d, kTFar);
            if (tv < tb) {
              tb = tv;
              lb = l4 * kLanes + i;
            }
          }
        }
      } else {
        for (int l4 = slice; l4 < c4; l4 += kSlicesPairClosest) {
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
      for (int off = kSlicesPairClosest / 2; off > 0; off >>= 1) {
        const float t2 = __shfl_xor_sync(0xffffffffu, tb, off);
        const int l2 = __shfl_xor_sync(0xffffffffu, lb, off);
        if (t2 < tb || (t2 == tb && l2 < lb)) {
          tb = t2;
          lb = l2;
        }
      }
      if (tb < bt) {
        bt = tb;
        bid = cl * c + lb;
      }
      copies.done();
      pos = j + 1;
      // Its barrier also frees the stage just read.
      block_or_max(closest_votes(enter, bt, slice), __float_as_int(bt), votes, bound, s_or,
                   s_max, turn);
    }
    copies.next_window();
  }
  if (slice == 0) {
    bt_out[ray] = bt;
    bid_out[ray] = bid;
  }
}

}  // namespace

// C entry points: pointers and the stream as void*, one launch each on the
// given stream; each returns cudaGetLastError() (0 on success).
extern "C" {

// One block of kSlicesPairClosest * tr threads a tile; returns
// cudaErrorInvalidValue unless C % 4 == 0 and the block fits. The caller
// guarantees 16-byte aligned w.
int pr_closest(const void* offs, const void* pwords, int n_tiles, int tr, const void* o4,
               const void* d4, const void* lo, const void* hi, const void* w, int n_cl, int c,
               void* bt, void* bid, void* stream) {
  if (kSlicesPairClosest * tr > 1024 || c % kLanes) return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)kNBufPairClosest * 3 * c + 3 * (c / kLanes)) * sizeof(float4) +
                      (size_t)kWindow * tr * sizeof(float);
  cudaError_t e = launch_prep(pair_closest_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  pair_closest_kernel<<<n_tiles, kSlicesPairClosest * tr, smem, (cudaStream_t)stream>>>(
      (const int*)offs, (const int*)pwords, (const float4*)o4, (const float4*)d4,
      (const float*)lo, (const float*)hi, (const float4*)w, n_cl, c, (float*)bt, (int*)bid);
  return (int)cudaGetLastError();
}

// One block of kSlicesPair * tr threads a tile; the caller guarantees C % 4
// == 0 and 16-byte aligned w.
int pr_anyhit(const void* offs, const void* pwords, int n_tiles, int tr, const void* o4,
              const void* d4, const void* tmax, const void* lo, const void* hi, const void* w,
              int n_cl, int c, void* occ, void* stream) {
  if (kSlicesPair * tr > 1024 || c % kLanes) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kNBufPair * c * 3 * sizeof(float4);
  cudaError_t e = launch_prep(pair_anyhit_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  pair_anyhit_kernel<<<n_tiles, kSlicesPair * tr, smem, (cudaStream_t)stream>>>(
      (const int*)offs, (const int*)pwords, (const float4*)o4, (const float4*)d4,
      (const float*)tmax, (const float*)lo, (const float*)hi, (const float4*)w, n_cl, c,
      (uint8_t*)occ);
  return (int)cudaGetLastError();
}

}  // extern "C"
