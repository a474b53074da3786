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
// never forms the [N, V] distance matrix, and is laid out for the card
// (three_nn_lanes.cuh):
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
//    the three gathers of kUnroll rows issued before their adds.
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
//    a sequential strict-< scan gives: out, w and idx are bit-equal to the
//    one-thread-per-query scan of three_nn.cuh that K6 (fused.cu) runs;
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
#include <stdint.h>

#include "inverse_index.cuh"
#include "three_nn_lanes.cuh"

namespace {

namespace tl = three_nn_lanes;

constexpr int kTileRows = 2048;  // rows of centers in shared memory at once
constexpr int kUnroll = 2;       // output rows whose gathers are in flight together

template <int S, int Q>
__global__ void __launch_bounds__(S * Q)
interp_three_nn(const float* __restrict__ points, const float* __restrict__ centers,
                const float* __restrict__ feats, const float* __restrict__ mask,
                const int* __restrict__ n_valid, float* __restrict__ out,
                float* __restrict__ w_out, int* __restrict__ idx_out, int n, int v, int c,
                int tile_rows, int bulk_ok, int vec) {
  extern __shared__ __align__(128) float tile[];  // xyz [tile_rows, 3], then mask
  __shared__ __align__(8) uint64_t bar;
  __shared__ int s_idx[3][Q];
  __shared__ float s_w[3][Q];
  float* ctr = tile;
  float* msk = tile + 3 * tile_rows;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * Q;
  const int lq = threadIdx.x / S;
  const int share = threadIdx.x % S;
  const bool active = q0 + lq < n;
  float px = 0.f, py = 0.f, pz = 0.f;
  if (active) {
    const float* p = points + ((long long)b * n + q0 + lq) * 3;
    px = p[0];
    py = p[1];
    pz = p[2];
  }
  const int nv = n_valid == nullptr ? v : max(0, min(n_valid[b], v));
  if (threadIdx.x == 0) tl::mbar_init(&bar, 1);
  __syncthreads();
  const long long row0 = (long long)b * v;
  tl::Top3 top;
  uint32_t phase = 0;
  for (int base = 0; base < nv; base += tile_rows) {
    const int len = min(tile_rows, nv - base);
    const int len4 = (len + 3) & ~3;
    if (base > 0) __syncthreads();  // every lane is done with the last tile
    if (bulk_ok && ((row0 + base) & 3) == 0 && base + len4 <= v) {
      if (threadIdx.x == 0) {
        if (base > 0) tl::fence_async_shared();
        tl::mbar_expect_bytes(&bar, 16u * len4);
        tl::bulk_load(ctr, centers + (row0 + base) * 3, 12u * len4, &bar);
        tl::bulk_load(msk, mask + row0 + base, 4u * len4, &bar);
      }
      tl::mbar_wait(&bar, phase);
      phase ^= 1u;
    } else {
      const float* cs = centers + (row0 + base) * 3;
      for (int i = threadIdx.x; i < 3 * len; i += S * Q) ctr[i] = cs[i];
      for (int i = threadIdx.x; i < len; i += S * Q) msk[i] = mask[row0 + base + i];
      __syncthreads();
    }
    tl::scan_share<S>(top, ctr, msk, len, base, share, px, py, pz);
  }
  tl::merge_lanes<S>(top);
  if (active && share == 0) {
    top.fill_missing();
    float w0, w1, w2;
    tl::weights(top, w0, w1, w2);
    s_idx[0][lq] = top.j0;
    s_idx[1][lq] = top.j1;
    s_idx[2][lq] = top.j2;
    s_w[0][lq] = w0;
    s_w[1][lq] = w1;
    s_w[2][lq] = w2;
    const long long wb = (long long)b * 3 * n + q0 + lq;
    w_out[wb] = w0;
    w_out[wb + n] = w1;
    w_out[wb + 2LL * n] = w2;
    idx_out[wb] = top.j0;
    idx_out[wb + n] = top.j1;
    idx_out[wb + 2LL * n] = top.j2;
  }
  __syncthreads();
  tl::write_rows<Q, S * Q, kUnroll>(s_idx, s_w, min(Q, n - q0), c, vec,
                                    feats + row0 * c, out + ((long long)b * n + q0) * c);
}

template <int S, int Q>
int launch_interp(const float* points, const float* centers, const float* feats,
                  const float* mask, const int* n_valid, float* out, float* w, int* idx,
                  int b, int n, int v, int c, cudaStream_t s) {
  constexpr int kThreads = S * Q;
  const int tile_rows = min(kTileRows, (v + 3) & ~3);
  const auto aligned = [](const void* p) {
    return reinterpret_cast<unsigned long long>(p) % 16 == 0;
  };
  const int bulk_ok = aligned(centers) && aligned(mask);
  const int vec = c > 0 && c % 4 == 0 && kThreads % (c / 4) == 0 && aligned(feats) &&
                  aligned(out);
  const dim3 grid((unsigned)((n + Q - 1) / Q), (unsigned)b);
  interp_three_nn<S, Q><<<grid, kThreads, (size_t)16 * tile_rows, s>>>(
      points, centers, feats, mask, n_valid, out, w, idx, n, v, c, tile_rows, bulk_ok, vec);
  return (int)cudaGetLastError();
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
// n_valid [B] i32 or null (scan rows [0, min(n_valid[b], V)), which must
// hold every row with mask > 0; null: all V rows); out [B,N,C] f32,
// w [B,3,N] f32, idx [B,3,N] i32. lanes (S) in {2, 4, 8} and queries (Q)
// in {32, 64, 128}: the block's shape; another pair returns
// cudaErrorInvalidValue.
extern "C" int dclx_interp(const void* points, const void* centers, const void* feats,
                           const void* mask, const void* n_valid, void* out, void* w,
                           void* idx, int b, int n, int v, int c, int lanes, int queries,
                           void* stream) {
  if (b <= 0 || n <= 0) return (int)cudaGetLastError();
  const auto* p = static_cast<const float*>(points);
  const auto* ce = static_cast<const float*>(centers);
  const auto* f = static_cast<const float*>(feats);
  const auto* m = static_cast<const float*>(mask);
  const auto* nv = static_cast<const int*>(n_valid);
  auto* o = static_cast<float*>(out);
  auto* wo = static_cast<float*>(w);
  auto* io = static_cast<int*>(idx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DCLX_INTERP_CASE(S, Q)                                                   \
  if (lanes == S && queries == Q)                                                \
    return launch_interp<S, Q>(p, ce, f, m, nv, o, wo, io, b, n, v, c, s);
  DCLX_INTERP_CASE(2, 32) DCLX_INTERP_CASE(2, 64) DCLX_INTERP_CASE(2, 128)
  DCLX_INTERP_CASE(4, 32) DCLX_INTERP_CASE(4, 64) DCLX_INTERP_CASE(4, 128)
  DCLX_INTERP_CASE(8, 32) DCLX_INTERP_CASE(8, 64) DCLX_INTERP_CASE(8, 128)
#undef DCLX_INTERP_CASE
  return (int)cudaErrorInvalidValue;
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
