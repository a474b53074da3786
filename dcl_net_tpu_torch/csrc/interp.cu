// K3: masked 3-NN inverse-squared-distance interpolation.
//
// Replaces the Pallas kernel dcl_net_tpu/ops/pallas_interp.py (_fwd_kernel,
// launched by _run_fwd / pallas_nn_interpolate), which kept a [T, V]
// distance tile in VMEM, ran three masked argmin passes over it and
// gathered the neighbour features with one-hot matmuls.
//
// Bound on an H100: operations at the finest level (N x V distances of 8
// f32 operations each, against a few MB of features in and out), bytes at
// the coarse ones. The design never forms the [N, V] distance matrix: one
// thread per query streams the sample's centers through shared memory in
// tiles and keeps its top 3 in registers, so the distances cost registers
// and shared-memory reads only. The output rows are then written by the
// whole block, channel-fastest, so feature reads and output writes are
// coalesced.
//
// Semantics, held against the plain version (ops/cuda_interp.py):
//  - d^2 = sum over axes 0, 1, 2 of (p_a - c_a)^2, by direct differences in
//    that order, with no FMA contraction (__fmul_rn / __fadd_rn), so the
//    distances are bit-equal to the plain version's;
//  - masked centers (mask <= 0) are never selected; among valid ones the
//    top 3 is kept with strict <, so ties go to the lowest index;
//  - with fewer than 3 valid centers the iterated argmin of the reference
//    (valid entries, then index 0 at distance 1e10 for each missing slot)
//    is reproduced exactly;
//  - w_k = (1 / (d_k + 1e-8)) * (1 / sum_j 1 / (d_j + 1e-8)), and
//    out = sum_k w_k * feats[idx_k]; w and idx are also written as [B, 3, N]
//    for the backward.

#include <cuda_runtime.h>

namespace {

constexpr int kQueries = 128;  // queries per block, one thread each
constexpr int kTile = 512;     // centers per shared-memory tile
constexpr float kBig = 1e10f;

__global__ void __launch_bounds__(kQueries)
interp_three_nn(const float* __restrict__ points, const float* __restrict__ centers,
                const float* __restrict__ feats, const float* __restrict__ mask,
                float* __restrict__ out, float* __restrict__ w_out,
                int* __restrict__ idx_out, int n, int v, int c) {
  __shared__ float4 ctr[kTile];
  __shared__ int s_idx[3][kQueries];
  __shared__ float s_w[3][kQueries];
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kQueries;
  const int q = q0 + threadIdx.x;
  const bool active = q < n;
  float px = 0.f, py = 0.f, pz = 0.f;
  if (active) {
    const float* p = points + ((long long)b * n + q) * 3;
    px = p[0];
    py = p[1];
    pz = p[2];
  }
  float d0 = __int_as_float(0x7f800000), d1 = d0, d2 = d0;  // +inf
  int j0 = -1, j1 = -1, j2 = -1;
  const float* cb = centers + (long long)b * v * 3;
  const float* mb = mask + (long long)b * v;
  for (int base = 0; base < v; base += kTile) {
    const int len = min(kTile, v - base);
    for (int t = threadIdx.x; t < len; t += kQueries) {
      const float* cc = cb + (long long)(base + t) * 3;
      ctr[t] = make_float4(cc[0], cc[1], cc[2], mb[base + t]);
    }
    __syncthreads();
    if (active) {
      for (int t = 0; t < len; ++t) {
        const float4 cc = ctr[t];
        if (!(cc.w > 0.f)) continue;
        const float e0 = px - cc.x, e1 = py - cc.y, e2 = pz - cc.z;
        float d = __fmul_rn(e0, e0);
        d = __fadd_rn(d, __fmul_rn(e1, e1));
        d = __fadd_rn(d, __fmul_rn(e2, e2));
        if (d < d2) {
          const int j = base + t;
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
    }
    __syncthreads();  // the tile is overwritten next
  }
  if (active) {
    // missing slots: the reference's argmin over an all-1e10 row is index 0
    if (j0 < 0) { j0 = 0; d0 = kBig; }
    if (j1 < 0) { j1 = 0; d1 = kBig; }
    if (j2 < 0) { j2 = 0; d2 = kBig; }
    const float r0 = 1.f / (d0 + 1e-8f);
    const float r1 = 1.f / (d1 + 1e-8f);
    const float r2 = 1.f / (d2 + 1e-8f);
    const float inv = 1.f / __fadd_rn(__fadd_rn(r0, r1), r2);
    const float w0 = __fmul_rn(r0, inv), w1 = __fmul_rn(r1, inv), w2 = __fmul_rn(r2, inv);
    s_idx[0][threadIdx.x] = j0;
    s_idx[1][threadIdx.x] = j1;
    s_idx[2][threadIdx.x] = j2;
    s_w[0][threadIdx.x] = w0;
    s_w[1][threadIdx.x] = w1;
    s_w[2][threadIdx.x] = w2;
    const long long wb = (long long)b * 3 * n + q;
    w_out[wb] = w0;
    w_out[wb + n] = w1;
    w_out[wb + 2LL * n] = w2;
    idx_out[wb] = j0;
    idx_out[wb + n] = j1;
    idx_out[wb + 2LL * n] = j2;
  }
  __syncthreads();
  const int nq = min(kQueries, n - q0);
  const float* fb = feats + (long long)b * v * c;
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

}  // namespace

// points [B,N,3], centers [B,V,3], feats [B,V,C], mask [B,V] (all f32);
// out [B,N,C] f32, w [B,3,N] f32, idx [B,3,N] i32.
extern "C" int dclx_interp(const void* points, const void* centers,
                           const void* feats, const void* mask, void* out,
                           void* w, void* idx, int b, int n, int v, int c,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b > 0 && n > 0) {
    dim3 grid((n + kQueries - 1) / kQueries, b);
    interp_three_nn<<<grid, kQueries, 0, s>>>(
        static_cast<const float*>(points), static_cast<const float*>(centers),
        static_cast<const float*>(feats), static_cast<const float*>(mask),
        static_cast<float*>(out), static_cast<float*>(w),
        static_cast<int*>(idx), n, v, c);
  }
  return (int)cudaGetLastError();
}
