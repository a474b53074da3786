// The two element types of the kernels' feature tensors: float (f32, the
// port's default) and __nv_bfloat16 (model.compute_dtype: bfloat16). A bf16
// kernel loads bf16, computes in f32 and rounds its result to bf16 once,
// round-to-nearest-even, as the JAX package's bf16 Pallas kernels do (they
// cast their blocks to f32 and their output back to the feature dtype).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace elem {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <class T>
__device__ __forceinline__ T from_float(float x);

template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}

template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and back: the value a T tensor holds for x.
template <class T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// Elements of T in one 16-byte vector access: 4 floats or 8 bf16.
template <class T>
__host__ __device__ constexpr int per_vec() {
  return 16 / static_cast<int>(sizeof(T));
}

}  // namespace elem
