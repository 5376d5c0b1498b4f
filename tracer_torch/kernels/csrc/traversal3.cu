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
// What the design does about it. pair_closest_kernel: one cluster per step
// (B = 1), staged in shared memory transposed so that a triangle's 12
// coefficients are three float4 broadcast loads; the prune votes with
// __syncthreads_or, which is also the barrier that frees the stage.
// pair_anyhit_kernel keeps one block a tile, so every vote sees the state
// the reference's walk has there: a run cut into segments would start from
// flags as they stand, and a ray whose hit lies under t_max in a cluster
// whose rounded slab entry does not (an edge pair) is occluded only if
// another ray votes, which then depends on timing. What it shortens is the
// step: kSlicesPair threads a ray, the slab votes of a window of 32 words
// taken at once, so a skipped word costs no barrier, one barrier a tested
// cluster, and the next voted clusters copied ahead by TMA's bulk copies
// (sorted.cuh's ring and quad reads). A tile's state lives in registers for
// the whole run.
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
  Ring<kNBufPair> ring{ring_mem, s_bar, per4, 0};
  ring.init();  // published by the first barrier below, before any wait
  const float4 o = o4[ray], d = d4[ray];
  const SlabRay sr = slab_ray(o, d);
  const float tm = tmax[ray];
  const bool dead = !(tm > kTMin);  // no t lies in (kTMin, tm): nothing to test
  bool occ = false;
  int turn = 0, consumed = 0, bound;
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
    unsigned inflight = 0;  // window words whose copies are issued and not yet consumed
    int pos = 0;            // the next word that may be tested
    int f = 0;              // the next word that may be copied
    for (;;) {
      const unsigned under = __ballot_sync(0xffffffffu, lane < n && (word & ~kClMask) < bound);
      if (under != in_window) walking = false;  // the walk stops in this window
      const unsigned cand = votes & under & (pos < 32 ? ~0u << pos : 0u);
      if (!cand) break;
      const int j = __ffs(cand) - 1;
      // Copy the next voted words into the free stages (freed by the last
      // barrier). A stage is free here (none is in flight at a window's start,
      // and the last test consumed one), so j's copy is in flight after this:
      // it is the first voted word past those copied, or was copied before.
      unsigned next = cand & (f < 32 ? ~0u << f : 0u);
      while (next && __popc(inflight) < kNBufPair) {
        const int b = __ffs(next) - 1;
        ring.issue(threadIdx.x == 0 ? w + (size_t)word_cluster(pwords[k0 + b], n_cl) * per4 : w);
        inflight |= 1u << b;
        next &= next - 1;
        f = b + 1;
      }
      while (inflight && __ffs(inflight) - 1 < j) {  // copies of words skipped since
        ring.wait(consumed++);
        inflight &= inflight - 1;
      }
      ring.wait(consumed);
      if (!occ && !dead) {
        const float4* stage = ring.stage(consumed);
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
      ++consumed;
      inflight &= inflight - 1;  // j was the lowest
      pos = j + 1;
      // Its barrier also frees the stage just read.
      block_or_max(occ ? 0u : mask, open_bits(occ, tm), votes, bound, s_or, s_max, turn);
    }
    while (inflight) {  // copies of words not tested
      ring.wait(consumed++);
      inflight &= inflight - 1;
    }
  }
  if (slice == 0) occ_out[ray] = occ ? 1 : 0;
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
