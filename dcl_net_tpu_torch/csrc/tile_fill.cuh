// Device code shared by the kernels that write a dense, nearly empty grid a
// tile per block: K1 (voxelize.cu), K5 (compact.cu) and K7 (fused.cu). Each
// block stores zeros over the contiguous run of floats its tile owns, then,
// after __syncthreads(), writes the few occupied cells over them. K5 and K7
// find the compaction slots of their tile with first_slot_at.

#pragma once

#include <cuda_runtime.h>

namespace tile_fill {

// Zeros over p[0, n) by the block's threads: a scalar head up to the next
// 16-byte boundary, float4 streaming stores (st.global.cs: evict first,
// as nothing reads them back soon) with neighbouring threads on
// neighbouring addresses, then a scalar tail. Needs blockDim.x >= 4.
__device__ __forceinline__ void zero(float* __restrict__ p, long long n) {
  const long long to_align =
      (long long)((16u - (unsigned)(reinterpret_cast<unsigned long long>(p) & 15u)) & 15u) >> 2;
  const long long head = to_align < n ? to_align : n;
  if (threadIdx.x < head) p[threadIdx.x] = 0.f;
  float4* q = reinterpret_cast<float4*>(p + head);
  const long long n4 = (n - head) >> 2;
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  for (long long i = threadIdx.x; i < n4; i += blockDim.x) __stcs(q + i, z);
  const long long done = head + 4 * n4;
  if (threadIdx.x < n - done) p[done + threadIdx.x] = 0.f;
}

// The first slot s of [0, cap) whose key reaches target, where key(s) is
// the linear index of a valid slot and +inf past the valid prefix (cap if
// none does). Precondition, which the compaction K2 guarantees: the valid
// slots (vmask > 0) are a prefix and their linear indices rise strictly.
// A warp-wide search: each round the 32 lanes probe evenly spaced slots and
// keep the gap where the key first reaches the target.
__device__ __forceinline__ int first_slot_at(const int* __restrict__ coords,
                                             const float* __restrict__ vmask,
                                             int cap, int d1, int d2,
                                             long long target) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = cap;  // keys below lo are < target, keys from hi >= target
  while (lo < hi) {
    const int step = (hi - lo + 31) / 32;
    const int s = lo + lane * step;
    bool reached = false;
    if (s < hi) {  // the mask and the coords loaded together: one wait a round
      const float valid = vmask[s];
      const int* xyz = coords + 3 * (long long)s;
      const int x0 = xyz[0], x1 = xyz[1], x2 = xyz[2];
      reached = !(valid > 0.f)  // past the valid prefix
                || ((long long)x0 * d1 + x1) * d2 + x2 >= target;
    }
    const unsigned ball = __ballot_sync(0xffffffffu, reached);
    if (ball == 0u) {
      const int last = min(31, (hi - 1 - lo) / step);  // the last lane probed
      lo += last * step + 1;
    } else {
      const int f = __ffs(ball) - 1;
      if (f == 0) {
        hi = lo;
      } else {
        hi = lo + f * step;
        lo += (f - 1) * step + 1;
      }
    }
  }
  return lo;
}

}  // namespace tile_fill
