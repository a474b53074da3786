// Device code shared by the two masked 3-NN interpolation kernels: K3
// (interp.cu), which reads the voxel centers from device memory, and K6
// (fused.cu), which decodes them from the compaction's voxel coordinates.
//
// Both run one thread per query with its top 3 in registers, the centers
// streamed through a shared-memory tile of float4 (x, y, z, mask), and
// both write w, idx and the output rows the same way, so that K6 is
// bit-equal to K3 on the centers K3 would be given.

#pragma once

#include <cuda_runtime.h>

namespace three_nn {

constexpr int kQueries = 128;  // queries per block, one thread each
constexpr int kTile = 512;     // centers per shared-memory tile
constexpr float kBig = 1e10f;

// The three smallest squared distances seen so far and their indices.
// Strict < keeps the lowest index among equal distances.
struct Top3 {
  float d0, d1, d2;
  int j0, j1, j2;

  __device__ __forceinline__ Top3() {
    d0 = d1 = d2 = __int_as_float(0x7f800000);  // +inf
    j0 = j1 = j2 = -1;
  }

  __device__ __forceinline__ void push(float d, int j) {
    if (d < d2) {
      if (d < d1) {
        d2 = d1;
        j2 = j1;
        if (d < d0) {
          d1 = d0;
          j1 = j0;
          d0 = d;
          j0 = j;
        } else {
          d1 = d;
          j1 = j;
        }
      } else {
        d2 = d;
        j2 = j;
      }
    }
  }

  // Missing slots: the reference's argmin over an all-1e10 row is index 0.
  __device__ __forceinline__ void fill_missing() {
    if (j0 < 0) { j0 = 0; d0 = kBig; }
    if (j1 < 0) { j1 = 0; d1 = kBig; }
    if (j2 < 0) { j2 = 0; d2 = kBig; }
  }
};

// Squared distance by direct differences summed over axes 0, 1, 2 in that
// order, without FMA contraction, as the plain version computes it.
__device__ __forceinline__ float sq_dist(float px, float py, float pz, float4 c) {
  const float e0 = px - c.x, e1 = py - c.y, e2 = pz - c.z;
  float d = __fmul_rn(e0, e0);
  d = __fadd_rn(d, __fmul_rn(e1, e1));
  return __fadd_rn(d, __fmul_rn(e2, e2));
}

// Scan one shared-memory tile of `len` centers (those with mask <= 0 are
// never selected) whose first center has index `base`.
__device__ __forceinline__ void scan_tile(Top3& top, const float4* ctr, int len, int base,
                                          float px, float py, float pz) {
  for (int t = 0; t < len; ++t) {
    const float4 cc = ctr[t];
    if (!(cc.w > 0.f)) continue;
    top.push(sq_dist(px, py, pz, cc), base + t);
  }
}

// The block's epilogue, called by every thread of the block: the weights
// w_k = (1 / (d_k + 1e-8)) * (1 / sum_j 1 / (d_j + 1e-8)) and the indices of
// each active query, written as [B, 3, N], then the output rows
// out = sum_k w_k * feats[idx_k], written by the whole block channel-fastest
// so that feature reads and output writes are coalesced.
// fb: the sample's [V, C] features; q0: the block's first query.
__device__ __forceinline__ void write_block(Top3 top, bool active, int b, int q0, int n,
                                            int c, const float* __restrict__ fb,
                                            float* __restrict__ out, float* __restrict__ w_out,
                                            int* __restrict__ idx_out) {
  __shared__ int s_idx[3][kQueries];
  __shared__ float s_w[3][kQueries];
  if (active) {
    top.fill_missing();
    const float r0 = 1.f / (top.d0 + 1e-8f);
    const float r1 = 1.f / (top.d1 + 1e-8f);
    const float r2 = 1.f / (top.d2 + 1e-8f);
    const float inv = 1.f / __fadd_rn(__fadd_rn(r0, r1), r2);
    const float w0 = __fmul_rn(r0, inv), w1 = __fmul_rn(r1, inv), w2 = __fmul_rn(r2, inv);
    s_idx[0][threadIdx.x] = top.j0;
    s_idx[1][threadIdx.x] = top.j1;
    s_idx[2][threadIdx.x] = top.j2;
    s_w[0][threadIdx.x] = w0;
    s_w[1][threadIdx.x] = w1;
    s_w[2][threadIdx.x] = w2;
    const long long wb = (long long)b * 3 * n + q0 + threadIdx.x;
    w_out[wb] = w0;
    w_out[wb + n] = w1;
    w_out[wb + 2LL * n] = w2;
    idx_out[wb] = top.j0;
    idx_out[wb + n] = top.j1;
    idx_out[wb + 2LL * n] = top.j2;
  }
  __syncthreads();
  const int nq = min(kQueries, n - q0);
  float* ob = out + ((long long)b * n + q0) * c;
  for (int e = threadIdx.x; e < nq * c; e += kQueries) {
    const int qi = e / c;
    const int ch = e - qi * c;
    const float a0 = __fmul_rn(s_w[0][qi], fb[(long long)s_idx[0][qi] * c + ch]);
    const float a1 = __fmul_rn(s_w[1][qi], fb[(long long)s_idx[1][qi] * c + ch]);
    const float a2 = __fmul_rn(s_w[2][qi], fb[(long long)s_idx[2][qi] * c + ch]);
    ob[e] = __fadd_rn(__fadd_rn(a0, a1), a2);
  }
}

}  // namespace three_nn
