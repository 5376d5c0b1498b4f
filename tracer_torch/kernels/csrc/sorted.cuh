// What the sorted-list kernels of traversal2.cu, stream.cu and traversal3.cu
// share: the ring of cluster stages that TMA's bulk copies fill, and the
// reads of a stage as quads of 4 triangles (closest_hit_kernel,
// closest_fast_kernel, closest_stream_kernel, anyhit_stream_kernel and the
// two pair kernels use both).
#pragma once
#include "common.cuh"

constexpr int kLanes = 4;  // triangles per 16-byte coefficient load

// ---------------------------------------------------------------------------
// The ring: a block's copies, numbered in the order of issue; copy i lands in
// stage i % kN. Every thread calls issue() with the same arguments; a
// thread waits for a copy at most once, in order, and before the stage is
// issued to again (closest_fast_kernel's threads wait for their own tile's
// copy only, and no stage is issued to twice there).
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
template <int kN>
struct Ring {
  float4* stages;
  uint64_t* bars;
  int per4;    // 16-byte chunks of one (4, 3C) cluster
  int issued;  // copies issued so far

  __device__ __forceinline__ void init() {
    if (threadIdx.x == 0) {
      for (int b = 0; b < kN; ++b) mbar_init(bars + b);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
  }

  __device__ __forceinline__ void issue(const float4* src) {
    if (threadIdx.x == 0) {
      uint64_t* bar = bars + issued % kN;
      mbar_expect(bar, per4 * sizeof(float4));
      bulk_copy(stages + (issued % kN) * per4, src, per4 * sizeof(float4), bar);
    }
    ++issued;
  }

  __device__ __forceinline__ void wait(int item) {
    mbar_wait(bars + item % kN, (item / kN) & 1);
  }

  __device__ __forceinline__ const float4* stage(int item) const {
    return stages + (item % kN) * per4;
  }
};

// ---------------------------------------------------------------------------
// A stage as it landed: the cluster's (4, 3C) matrix, read as 16-byte
// broadcast loads that each cover one coefficient of 4 consecutive
// triangles, so 4 triangles cost 12 loads, 3 a triangle.
// ---------------------------------------------------------------------------

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

__device__ __forceinline__ float quad_tri_t(const Quad& a, int i, float4 o, float4 d, float t_max) {
  return tri_t(field(a, 0, i), field(a, 1, i), field(a, 2, i), o, d, t_max);
}

__device__ __forceinline__ int word_cluster(int word, int n_cl) {
  return min(word & kClMask, n_cl - 1);
}
