// K1: point -> voxel scatter (sum / mean) with exact per-voxel counts.
//
// Replaces the Pallas kernel dcl_net_tpu/ops/pallas_voxelize.py
// (_make_kernel, launched by _run_fwd / pallas_voxelize), which rewrote the
// scatter as factorised one-hot matmuls because the TPU has no fast scatter.
// Hopper has fast global atomics, so the port is a plain scatter.
//
// Bound on an H100: bytes. The function writes a dense [B, G, C] grid plus
// [B, G] counts (G = 64^3, about 270 MB at B = 32, C = 7) and reads a few
// hundred KB of points. The zero fill of the outputs (done by the wrapper
// with torch.zeros) is nearly all of the traffic. The design touches each
// grid cell once more only where a mean is needed: the scatter pass writes
// only occupied cells, and the mean pass reads the counts and rewrites only
// cells that hold more than one point.
//
// Semantics:
//  - one thread per (b, point); masked points (mask <= 0) add nothing;
//  - points whose index falls outside the grid on any axis are dropped
//    (the Pallas one-hot never matches them), never written out of bounds;
//  - counts are exact integers in f32; the f32 feature sums depend on the
//    order the atomics land in, so they match a serial scatter only to
//    f32 rounding (a few ulp of the per-voxel sum).

#include <cuda_runtime.h>

namespace {

__global__ void scatter_points(const float* __restrict__ feats,
                               const int* __restrict__ vidx,
                               const float* __restrict__ pmask,
                               float* __restrict__ sum,
                               float* __restrict__ count,
                               long long n_points, int n, int c,
                               int d0, int d1, int d2) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_points) return;
  if (pmask != nullptr && !(pmask[t] > 0.f)) return;
  const int* v = vidx + t * 3;
  const int i0 = v[0], i1 = v[1], i2 = v[2];
  if (i0 < 0 || i0 >= d0 || i1 < 0 || i1 >= d1 || i2 < 0 || i2 >= d2) return;
  const long long g = (long long)d0 * d1 * d2;
  const long long cell = (t / n) * g + ((long long)i0 * d1 + i1) * d2 + i2;
  atomicAdd(count + cell, 1.f);
  const float* f = feats + t * c;
  float* s = sum + cell * c;
  for (int k = 0; k < c; ++k) atomicAdd(s + k, f[k]);
}

// Mean mode: sum / max(count, 1). Cells with count <= 1 are already equal
// to their mean, so only cells with more than one point are rewritten.
__global__ void divide_by_count(float* __restrict__ sum,
                                const float* __restrict__ count,
                                long long cells, int c) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= cells) return;
  const float n = count[t];
  if (n > 1.f) {
    float* s = sum + t * c;
    for (int k = 0; k < c; ++k) s[k] = s[k] / n;
  }
}

}  // namespace

// feats [B,N,C] f32, vidx [B,N,3] i32, pmask [B,N] f32 or null,
// sum [B,G,C] f32 and count [B,G] f32, both zero-filled by the caller.
extern "C" int dclx_voxelize(const void* feats, const void* vidx,
                             const void* pmask, void* sum, void* count,
                             int b, int n, int c, int d0, int d1, int d2,
                             int mean, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  const long long n_points = (long long)b * n;
  if (n_points > 0) {
    scatter_points<<<(unsigned)((n_points + threads - 1) / threads), threads, 0, s>>>(
        static_cast<const float*>(feats), static_cast<const int*>(vidx),
        static_cast<const float*>(pmask), static_cast<float*>(sum),
        static_cast<float*>(count), n_points, n, c, d0, d1, d2);
  }
  const long long cells = (long long)b * d0 * d1 * d2;
  if (mean && cells > 0) {
    divide_by_count<<<(unsigned)((cells + threads - 1) / threads), threads, 0, s>>>(
        static_cast<float*>(sum), static_cast<const float*>(count), cells, c);
  }
  return (int)cudaGetLastError();
}
