// Device code shared by the two kernels that write a dense, nearly empty
// grid a tile per block: K1 (voxelize.cu) and K5 (compact.cu). Each block
// stores zeros over the contiguous run of floats its tile owns, then, after
// __syncthreads(), writes the few occupied cells over them.

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

}  // namespace tile_fill
