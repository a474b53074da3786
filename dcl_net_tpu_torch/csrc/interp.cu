// K3: masked 3-NN inverse-squared-distance interpolation, and K4, its
// backward.
//
// Replaces the Pallas kernel dcl_net_tpu/ops/pallas_interp.py (_fwd_kernel,
// launched by _run_fwd / pallas_nn_interpolate), which kept a [T, V]
// distance tile in VMEM, ran three masked argmin passes over it and
// gathered the neighbour features with one-hot matmuls.
//
// Bound on an H100: operations at the finest level (N x valid-centers
// distances of 8 f32 operations each), bytes at the coarse ones (the
// [B, N, C] output, 32 MB of the main path's 63 MB at C = 256). The design
// never forms the [N, V] distance matrix, and is laid out for the card. Its
// kernel body is three_nn_lanes.cuh's, shared with K6 (fused.cu), which
// differs only in decoding its rows from voxel coordinates:
//  - the scan stops at the occupancy: with n_valid (K2's occupancy) only
//    rows [0, min(n_valid[b], V)) are read and scanned, the valid prefix
//    that K2 writes; without it all V rows;
//  - the sample's rows go into shared memory by the copy engine, one bulk
//    copy of the centers and one of the mask (cp.async.bulk, completion on
//    an mbarrier), up to kTileRows = 2048 rows (32 KB) at once: one tile per
//    block at every main-path level, a tile loop only past that. A bulk
//    copy needs 16-byte-aligned addresses and lengths: where a sample's
//    rows do not start on a multiple of 4 (V % 4 != 0) or the length
//    rounded up to 4 rows would pass V, the tile is loaded by plain loads;
//  - each query's scan is split over S adjacent lanes of a warp, each with
//    its own top 3 in registers, merged by warp shuffles in (d, j) order:
//    S times the warps in flight of one thread per query;
//  - every thread of the block writes output, float4 along channels, with
//    the three gathers of kGatherRows rows issued before their adds.
// Block: Q queries x S lanes (cuda_interp.QUERIES, SCAN_LANES, swept by
// scripts/sweep_interp_compact.py); dynamic shared memory 16 B a row.
//
// Semantics, held against the plain version (ops/cuda_interp.py):
//  - d^2 = sum over axes 0, 1, 2 of (p_a - c_a)^2, by direct differences in
//    that order, with no FMA contraction (__fmul_rn / __fadd_rn), so the
//    distances are bit-equal to the plain version's. No tensor cores: the
//    expansion form |p|^2 + |c|^2 - 2 p.c of a wgmma product rounds
//    differently and would change idx on near-ties (the 1.2e-5 gap of the
//    JAX exact path);
//  - masked centers (mask <= 0) are never selected; among valid ones the
//    top 3 is the three smallest (d, j), so ties go to the lowest index, as
//    a sequential strict-< scan gives;
//  - with fewer than 3 valid centers the iterated argmin of the reference
//    (valid entries, then index 0 at distance 1e10 for each missing slot)
//    is reproduced exactly;
//  - w_k = (1 / (d_k + 1e-8)) * (1 / sum_j 1 / (d_j + 1e-8)), and
//    out = (w_0 f_0 + w_1 f_1) + w_2 f_2 with f_k = feats[idx_k]; w and idx
//    are also written as [B, 3, N] for the backward.
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
//  1. the inverse index: per sample, the contributions grouped by row in
//     ascending e = k * N + t (a block radix sort, B blocks, up to N =
//     2048; beyond, a stable counting sort over chunks of 6144 entries,
//     inverse_index.cuh);
//  2. interp_rows_bwd: the grid of blocks is (row tiles, B), 256 / C rows a
//     block (one row, C in slices of 256, above C = 256), one thread a
//     (row, channel), which sums the row's
//     contributions in that order from 0.f (inverse_index::write_rows) and
//     writes it once, zeros included. The rows' (t, w) go through shared
//     memory, the g reads coalesce across channels, and each thread issues
//     the loads of 32 positions before their adds: a hot row's serial sum,
//     up to a thousand terms on the main path, and not the bytes, sets the
//     time.
// The result is bit-equal to the plain version (index_add_ on the CPU) and
// the same from run to run.
//
// K3's bf16 variant (dclx_interp_bf16; model.compute_dtype: bfloat16) is the
// same kernel body with bf16 features and output: f32 points, centers,
// distances and weights, so idx and w are the f32 variant's; the weighted
// sum is taken in f32 and rounded to bf16 once (three_nn_lanes.cuh).
//
// K4's bf16 variant (dclx_interp_bwd_bf16; bf16 training) replaces the same
// Pallas backward under bf16, which widened the bf16 cotangent to f32, summed
// in f32 and cast the [V, C] rows to bf16 once. It is K4 with g and dfeats
// bf16: each g is widened to f32 as it is loaded, the products, the order of
// the sums and the sums are the f32 variant's, and each (row, channel) is
// rounded to bf16 once, at its store. It is bit-equal to the f32 variant's
// result on the widened g, rounded once.

#include <cuda_runtime.h>
#include <stdint.h>

#include "inverse_index.cuh"
#include "three_nn_lanes.cuh"

namespace {

namespace tl = three_nn_lanes;

using inverse_index::kWriterThreads;

template <class T, bool kSliced>
__global__ void __launch_bounds__(kWriterThreads)
interp_rows_bwd(const T* __restrict__ g, const float* __restrict__ w,
                const int* __restrict__ start, const int* __restrict__ ent,
                T* __restrict__ dfeats, int n, int v, int c, int rows) {
  __shared__ inverse_index::Stage stage;
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * rows;
  const long long m = 3LL * n;
  T* out = dfeats + ((long long)b * v + r0) * c;
  inverse_index::write_rows<kSliced>(
      stage, start + (long long)b * (v + 1) + r0, min(rows, v - r0), ent + b * m, w + b * m,
      g + (long long)b * n * c, n, c, [&](int r, int ch, float x) {
        out[(long long)r * c + ch] = elem::from_float<T>(x);
      });
}

template <class T>
int interp_bwd(const void* g, const void* w, const void* idx, void* dfeats, void* scratch,
               int b, int n, int v, int c, int rows, cudaStream_t s) {
  if (b <= 0 || v <= 0 || c <= 0) return (int)cudaGetLastError();
  int* start = static_cast<int*>(scratch);
  int* ent = start + (long long)b * (v + 1);
  const int err = inverse_index::launch_csr(static_cast<const int*>(idx), start, ent,
                                            ent + 3LL * b * n, b, 3 * n, v, s);
  if (err != (int)cudaSuccess) return err;
  const dim3 blocks((unsigned)((v + rows - 1) / rows), (unsigned)b);
  const auto kernel = c <= kWriterThreads ? interp_rows_bwd<T, false> : interp_rows_bwd<T, true>;
  kernel<<<blocks, kWriterThreads, 0, s>>>(static_cast<const T*>(g),
                                           static_cast<const float*>(w), start, ent,
                                           static_cast<T*>(dfeats), n, v, c, rows);
  return (int)cudaGetLastError();
}

}  // namespace

// points [B,N,3], centers [B,V,3], feats [B,V,C], mask [B,V] (all f32);
// n_valid [B] i32 or null; out, w, idx and the block shape (lanes, queries)
// as three_nn_lanes::launch takes them.
extern "C" int dclx_interp(const void* points, const void* centers, const void* feats,
                           const void* mask, const void* n_valid, void* out, void* w,
                           void* idx, int b, int n, int v, int c, int lanes, int queries,
                           void* stream) {
  return tl::launch(static_cast<const float*>(points),
                    tl::CenterRows{static_cast<const float*>(centers)},
                    static_cast<const float*>(feats), static_cast<const float*>(mask),
                    static_cast<const int*>(n_valid), static_cast<float*>(out),
                    static_cast<float*>(w), static_cast<int*>(idx), b, n, v, c, lanes,
                    queries, static_cast<cudaStream_t>(stream));
}

// K3's bf16 variant: as dclx_interp, with feats [B,V,C] and out [B,N,C] bf16
// (points, centers, mask, w and idx as there).
extern "C" int dclx_interp_bf16(const void* points, const void* centers, const void* feats,
                                const void* mask, const void* n_valid, void* out, void* w,
                                void* idx, int b, int n, int v, int c, int lanes,
                                int queries, void* stream) {
  return tl::launch(static_cast<const float*>(points),
                    tl::CenterRows{static_cast<const float*>(centers)},
                    static_cast<const __nv_bfloat16*>(feats), static_cast<const float*>(mask),
                    static_cast<const int*>(n_valid), static_cast<__nv_bfloat16*>(out),
                    static_cast<float*>(w), static_cast<int*>(idx), b, n, v, c, lanes,
                    queries, static_cast<cudaStream_t>(stream));
}

// idx [B,3,N] i32 (each in [0, V)); scratch: the CSR of the contributions
// by slot (start [B, V + 1], then ent [B, 3N]), written here, then for
// N > 2048 the chunks' counts [B, V + 1, chunks] (cuda_interp.
// index_scratch_words).
extern "C" int dclx_inverse_index(const void* idx, void* scratch, int b, int n, int v,
                                  void* stream) {
  int* start = static_cast<int*>(scratch);
  int* ent = start + (long long)b * (v + 1);
  return inverse_index::launch_csr(static_cast<const int*>(idx), start, ent,
                                   ent + 3LL * b * n, b, 3 * n, v,
                                   static_cast<cudaStream_t>(stream));
}

// g [B,N,C] f32, w [B,3,N] f32, idx [B,3,N] i32 (each in [0, V)); writes
// every float of dfeats [B,V,C] f32 (no zero fill needed); scratch as
// dclx_inverse_index's. rows: rows per block.
extern "C" int dclx_interp_bwd(const void* g, const void* w, const void* idx,
                               void* dfeats, void* scratch, int b, int n, int v, int c,
                               int rows, void* stream) {
  return interp_bwd<float>(g, w, idx, dfeats, scratch, b, n, v, c, rows,
                           static_cast<cudaStream_t>(stream));
}

// K4's bf16 variant: as dclx_interp_bwd, with g [B,N,C] and dfeats [B,V,C]
// bf16 (w, idx and scratch as there).
extern "C" int dclx_interp_bwd_bf16(const void* g, const void* w, const void* idx,
                                    void* dfeats, void* scratch, int b, int n, int v,
                                    int c, int rows, void* stream) {
  return interp_bwd<__nv_bfloat16>(g, w, idx, dfeats, scratch, b, n, v, c, rows,
                                   static_cast<cudaStream_t>(stream));
}
