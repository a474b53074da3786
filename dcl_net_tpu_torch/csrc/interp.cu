// K3: masked 3-NN inverse-squared-distance interpolation, and K4, its
// backward.
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
// The selection and the epilogue are in three_nn.cuh, shared with K6
// (fused.cu).
//
// K4 replaces the Pallas kernel dcl_net_tpu/ops/pallas_interp.py
// (_bwd_kernel, launched by _vjp_bwd), which rebuilt a [T, V] weighted
// one-hot matrix per query tile and contracted it with the cotangent on
// the MXU, carrying the [V, C] sum across the sequential grid: no atomics,
// every output row written by the one step that held it.
//
// K4 computes dfeats[b, idx[k,t], c] += w[k,t] * g[b,t,c] into [B, V, C].
// Bound on an H100: bytes (it reads g once, w and idx once, and writes
// dfeats once; 6 operations per g element). Hopper has no sequential grid,
// and float atomics into V rows serialise where many queries share a
// center (3 * 1024 contributions on 64 rows at the coarsest level), add in
// an order that changes from run to run, and need a zero fill first. So
// the design gives every output row an owner, as K1 and K5 do, and sums
// in a fixed order (inverse_index.cuh), in one entry point of two kernels:
//  1. build_csr: per sample, the contributions grouped by row in ascending
//     e = k * N + t (a block radix sort; B blocks);
//  2. interp_rows_bwd: the grid of blocks is (row tiles, B), 256 / C rows a
//     block, one thread a (row, channel), which sums the row's
//     contributions in that order from 0.f (inverse_index::write_rows) and
//     writes it once, zeros included. The rows' (t, w) go through shared
//     memory, the g reads coalesce across channels, and each thread issues
//     the loads of 32 positions before their adds: a hot row's serial sum,
//     up to a thousand terms on the main path, and not the bytes, sets the
//     time.
// The result is bit-equal to the plain version (index_add_ on the CPU) and
// the same from run to run.

#include <cuda_runtime.h>

#include "inverse_index.cuh"
#include "three_nn.cuh"

namespace {

using three_nn::kQueries;
using three_nn::kTile;

__global__ void __launch_bounds__(kQueries)
interp_three_nn(const float* __restrict__ points, const float* __restrict__ centers,
                const float* __restrict__ feats, const float* __restrict__ mask,
                float* __restrict__ out, float* __restrict__ w_out,
                int* __restrict__ idx_out, int n, int v, int c) {
  __shared__ float4 ctr[kTile];
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
  three_nn::Top3 top;
  const float* cb = centers + (long long)b * v * 3;
  const float* mb = mask + (long long)b * v;
  for (int base = 0; base < v; base += kTile) {
    const int len = min(kTile, v - base);
    for (int t = threadIdx.x; t < len; t += kQueries) {
      const float* cc = cb + (long long)(base + t) * 3;
      ctr[t] = make_float4(cc[0], cc[1], cc[2], mb[base + t]);
    }
    __syncthreads();
    if (active) three_nn::scan_tile(top, ctr, len, base, px, py, pz);
    __syncthreads();  // the tile is overwritten next
  }
  three_nn::write_block(top, active, b, q0, n, c, feats + (long long)b * v * c, out,
                        w_out, idx_out);
}

using inverse_index::kWriterThreads;

__global__ void __launch_bounds__(kWriterThreads)
interp_rows_bwd(const float* __restrict__ g, const float* __restrict__ w,
                const int* __restrict__ start, const int* __restrict__ ent,
                float* __restrict__ dfeats, int n, int v, int c, int rows) {
  __shared__ inverse_index::Stage stage;
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * rows;
  const long long m = 3LL * n;
  float* out = dfeats + ((long long)b * v + r0) * c;
  inverse_index::write_rows(stage, start + (long long)b * (v + 1) + r0, min(rows, v - r0),
                            ent + b * m, w + b * m, g + (long long)b * n * c, n, c,
                            [&](int r, int ch, float x) { out[(long long)r * c + ch] = x; });
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

// idx [B,3,N] i32 (each in [0, V)); scratch [B, V + 1 + 3N] i32: the CSR
// of the contributions by slot (start, then ent), written here.
extern "C" int dclx_inverse_index(const void* idx, void* scratch, int b, int n, int v,
                                  void* stream) {
  int* start = static_cast<int*>(scratch);
  return inverse_index::launch_csr(static_cast<const int*>(idx), start,
                                   start + (long long)b * (v + 1), b, 3 * n, v,
                                   static_cast<cudaStream_t>(stream));
}

// g [B,N,C] f32, w [B,3,N] f32, idx [B,3,N] i32 (each in [0, V)); writes
// every float of dfeats [B,V,C] f32 (no zero fill needed); scratch as
// dclx_inverse_index's. rows: rows per block.
extern "C" int dclx_interp_bwd(const void* g, const void* w, const void* idx,
                               void* dfeats, void* scratch, int b, int n, int v, int c,
                               int rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b <= 0 || v <= 0 || c <= 0) return (int)cudaGetLastError();
  int* start = static_cast<int*>(scratch);
  int* ent = start + (long long)b * (v + 1);
  const int err = inverse_index::launch_csr(static_cast<const int*>(idx), start, ent, b,
                                            3 * n, v, s);
  if (err != (int)cudaSuccess) return err;
  const dim3 blocks((unsigned)((v + rows - 1) / rows), (unsigned)b);
  interp_rows_bwd<<<blocks, kWriterThreads, 0, s>>>(
      static_cast<const float*>(g), static_cast<const float*>(w), start, ent,
      static_cast<float*>(dfeats), n, v, c, rows);
  return (int)cudaGetLastError();
}
