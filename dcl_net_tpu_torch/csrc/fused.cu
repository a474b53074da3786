// K6: masked 3-NN inverse-squared-distance interpolation over the
// compaction's output, with the voxel centers decoded in the kernel, and
// K7, its backward straight onto the dense grid.
//
// Replaces the Pallas kernel dcl_net_tpu/ops/pallas_fused.py
// (_make_fused_kernel, launched by _run_fused_fwd /
// pallas_compact_interpolate), which read the compaction's raw
// [cap + chunk, C + 8] buffer: it decoded the centers from the
// linear-index channels, took validity from the ones channel, masked the
// rows >= capacity, and ran the same [T, V] argmin passes and one-hot
// matmul as the interpolation kernel. The port's compaction (K2) has no
// alignment gaps and writes coords [B, cap, 3] int32 directly, so K6 takes
// K2's outputs as they are: coords, vfeats, vmask and the occupancy.
//
// What the fusion keeps out of device memory is the [B, cap, 3] f32
// centers tensor and the elementwise pass that writes it. Bound on an
// H100: as K3's (interp.cu), operations at the finest level (N x
// valid-centers distances of 8 f32 operations each), bytes at the coarse
// ones. K6 runs K3's kernel body (three_nn_lanes.cuh) with the coords as
// its row source (three_nn_lanes::CoordRows):
//  - the scan stops at the occupancy: the valid slots are exactly
//    [0, max(0, min(occupancy, cap))), passed as K3's n_valid;
//  - a coords row is 12 bytes, as a centers row is, so the same bulk copies
//    (cp.async.bulk, completion on an mbarrier) bring the valid prefix of
//    coords and of the mask into the same shared-memory layout, 16 B a row,
//    up to 2048 rows at once; plain loads where the sample's rows are not
//    16-byte aligned or a rounded-up copy would pass cap, as K3's;
//  - after the copy the block decodes the tile in place, each word
//    c_a = __fadd_rn(__fmul_rn((float)i_a, unit_s[a]), off_c[a]), one
//    rounded product then one rounded sum, which is what the two-stage
//    path's `coords * unit + shift` computes in two passes. Those are
//    generic-proxy writes to shared memory, so a later tile's bulk copy
//    into the same buffer is fenced after them (fence.proxy.async);
//  - then K3's split scan over S lanes of a warp, the (d, j) merge, the
//    weights and the float4 epilogue, unchanged.
// With the constants of sparse_conv.voxel_center_affine the centers, and so
// out, w and idx, are bit-equal to K2 -> voxel_centers -> K3. A query with
// fewer than 3 valid centers gets index 0 at distance 1e10 for each missing
// slot, as K3 and the reference give.
//
// K7 replaces the Pallas backward of dcl_net_tpu/ops/pallas_fused.py
// (_vjp_bwd), which ran the interpolation's backward kernel (a weighted
// one-hot contraction per query tile, summed across the sequential grid)
// into the compacted rows, then the compaction's backward (each grid step
// writing its chunk of the grid whole, once). It computes, for every valid
// slot s (vmask > 0) of sample b,
//   dgrid[b, lin(coords[b, s]), c] = sum over k, t with idx[k, t] == s of
//                                    w[k, t] * g[b, t, c],
// zeros elsewhere, into a [B, G, C] grid: contributions to an invalid slot
// (slot 0 of a sample with no valid slot, which its queries' missing
// neighbours point to) are dropped, as the compaction's backward drops them.
//
// Bound on an H100: bytes, nearly all of them the grid's zeros (178 MB over
// the four levels of one branch on the main path, where the grid is ~2 %
// occupied), then g. Design: one entry point of two kernels, no [B, cap, C]
// intermediate, no atomics, no zero fill by the caller:
//  1. the inverse index (inverse_index.cuh, shared with K4): per sample,
//     the contributions grouped by slot in ascending e = k * N + t (one
//     block a sample up to N = 2048, a counting sort over chunks of 6144
//     entries beyond);
//  2. compact_interp_grid_bwd: the grid of blocks is (cell tiles, B), as
//     K5's. Two warps find the tile's slot range [s0, s1) by K5's search of
//     the valid prefix (tile_fill::first_slot_at), the block stores zeros
//     over the tile, and after __syncthreads() writes each slot's ordered
//     sums (inverse_index::write_rows, as K4's) at its cell. A tile that
//     holds no slot costs its zero stores only.
// Precondition, as K5's: the valid slots are the prefix [0, min(occupancy,
// cap)) and their linear indices rise strictly, which K2 guarantees. The
// wrapper sizes the tiles as K5's (16 KB) but small enough for a few
// thousand blocks: at the coarse levels, where nearly every cell is a
// slot, a slot's serial sum and not the zeros sets the time. The result is
// bit-equal to the plain version (the plain K4 then the plain K5, on the
// CPU) and the same from run to run.
//
// K6's bf16 variant (dclx_compact_interp_bf16; model.compute_dtype:
// bfloat16) is the same kernel body over K2's bf16 rows: coords, mask,
// decoded centers, distances and weights stay f32, so idx and w are the f32
// variant's, and the weighted sum is taken in f32 and rounded to bf16 once;
// it is torch.equal to K2 -> centers -> K3 in bf16.
//
// K7's bf16 variant (dclx_compact_interp_bwd_bf16; bf16 training) replaces the
// same Pallas backward under bf16, which summed the widened bf16 cotangent
// into f32 rows, cast them to bf16 once and copied them onto a bf16 grid. It
// is K7 with g and dgrid bf16: the f32 ordered sum of each (slot, channel),
// as K4's bf16 variant takes it, rounded to bf16 once and stored at its cell
// over the bf16 zeros. The wrapper sizes the tiles in bytes, as K5's bf16
// variant.

#include <cuda_runtime.h>

#include "inverse_index.cuh"
#include "three_nn_lanes.cuh"
#include "tile_fill.cuh"

namespace {

using inverse_index::kWriterThreads;

template <class T, bool kSliced>
__global__ void __launch_bounds__(kWriterThreads)
compact_interp_grid_bwd(const T* __restrict__ g, const float* __restrict__ w,
                        const int* __restrict__ start, const int* __restrict__ ent,
                        const int* __restrict__ coords, const float* __restrict__ vmask,
                        T* __restrict__ dgrid, int n, int cap, int cells, int c,
                        int d1, int d2, int tile) {
  __shared__ int slot_range[2];
  __shared__ inverse_index::Stage stage;
  const int b = blockIdx.y;
  const long long lo = (long long)blockIdx.x * tile;
  const long long hi = min(lo + tile, (long long)cells);
  T* out = dgrid + ((long long)b * cells + lo) * c;
  const int* xyz_b = coords + (long long)b * cap * 3;
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {  // the search's chain of loads first: the zeros need no wait
    const int s = tile_fill::first_slot_at(xyz_b, vmask + (long long)b * cap, cap, d1,
                                           d2, warp == 0 ? lo : hi);
    if ((threadIdx.x & 31) == 0) slot_range[warp] = s;
  }
  tile_fill::zero(out, (hi - lo) * c);
  __syncthreads();  // also orders the zeros before the slots' sums below
  const int s0 = slot_range[0];
  const long long m = 3LL * n;
  const int* xyz = xyz_b + 3 * (long long)s0;
  inverse_index::write_rows<kSliced>(
      stage, start + (long long)b * (cap + 1) + s0, slot_range[1] - s0, ent + b * m,
      w + b * m, g + (long long)b * n * c, n, c, [&](int r, int ch, float x) {
        const long long cell =
            ((long long)xyz[3 * r] * d1 + xyz[3 * r + 1]) * d2 + xyz[3 * r + 2] - lo;
        out[cell * c + ch] = elem::from_float<T>(x);
      });
}

template <class T>
int compact_interp_bwd(const void* g, const void* w, const void* idx, const void* coords,
                       const void* vmask, void* dgrid, void* scratch, int b, int n, int cap,
                       int cells, int c, int d1, int d2, int tile, cudaStream_t s) {
  if (b <= 0 || cells <= 0 || c <= 0) return (int)cudaGetLastError();
  int* start = static_cast<int*>(scratch);
  int* ent = start + (long long)b * (cap + 1);
  const int err = inverse_index::launch_csr(static_cast<const int*>(idx), start, ent,
                                            ent + 3LL * b * n, b, 3 * n, cap, s);
  if (err != (int)cudaSuccess) return err;
  const dim3 blocks((unsigned)((cells + tile - 1) / tile), (unsigned)b);
  const auto kernel = c <= kWriterThreads ? compact_interp_grid_bwd<T, false>
                                          : compact_interp_grid_bwd<T, true>;
  kernel<<<blocks, kWriterThreads, 0, s>>>(
      static_cast<const T*>(g), static_cast<const float*>(w), start, ent,
      static_cast<const int*>(coords), static_cast<const float*>(vmask),
      static_cast<T*>(dgrid), n, cap, cells, c, d1, d2, tile);
  return (int)cudaGetLastError();
}

}  // namespace

// points [B,N,3] f32; coords [B,cap,3] i32, vfeats [B,cap,C] f32,
// vmask [B,cap] f32, occupancy [B] i32 as K2 writes them; out [B,N,C] f32,
// w [B,3,N] f32, idx [B,3,N] i32; lanes and queries as dclx_interp's; unit_s
// and off_c the per-axis affine map from voxel coordinates to metric centers.
extern "C" int dclx_compact_interp(const void* points, const void* coords,
                                   const void* vfeats, const void* vmask,
                                   const void* occupancy, void* out, void* w, void* idx,
                                   int b, int n, int cap, int c, int lanes, int queries,
                                   float us0, float us1, float us2, float oc0, float oc1,
                                   float oc2, void* stream) {
  const three_nn_lanes::CoordRows rows{static_cast<const int*>(coords), us0, us1, us2,
                                       oc0, oc1, oc2};
  return three_nn_lanes::launch(static_cast<const float*>(points), rows,
                                static_cast<const float*>(vfeats),
                                static_cast<const float*>(vmask),
                                static_cast<const int*>(occupancy), static_cast<float*>(out),
                                static_cast<float*>(w), static_cast<int*>(idx), b, n, cap, c,
                                lanes, queries, static_cast<cudaStream_t>(stream));
}

// K6's bf16 variant: as dclx_compact_interp, with vfeats [B,cap,C] (K2's
// bf16 rows) and out [B,N,C] bf16.
extern "C" int dclx_compact_interp_bf16(const void* points, const void* coords,
                                        const void* vfeats, const void* vmask,
                                        const void* occupancy, void* out, void* w,
                                        void* idx, int b, int n, int cap, int c, int lanes,
                                        int queries, float us0, float us1, float us2,
                                        float oc0, float oc1, float oc2, void* stream) {
  const three_nn_lanes::CoordRows rows{static_cast<const int*>(coords), us0, us1, us2,
                                       oc0, oc1, oc2};
  return three_nn_lanes::launch(static_cast<const float*>(points), rows,
                                static_cast<const __nv_bfloat16*>(vfeats),
                                static_cast<const float*>(vmask),
                                static_cast<const int*>(occupancy),
                                static_cast<__nv_bfloat16*>(out), static_cast<float*>(w),
                                static_cast<int*>(idx), b, n, cap, c, lanes, queries,
                                static_cast<cudaStream_t>(stream));
}

// g [B,N,C] f32, w [B,3,N] f32 and idx [B,3,N] i32 (each in [0, cap)) as K6
// writes them; coords [B,cap,3] i32 and vmask [B,cap] f32 as K2 writes
// them, under the precondition above; writes every float of dgrid [B,G,C]
// f32 (no zero fill needed). scratch: the CSR, as dclx_inverse_index's
// with V = cap (cuda_interp.index_scratch_words); tile: cells per block.
extern "C" int dclx_compact_interp_bwd(const void* g, const void* w, const void* idx,
                                       const void* coords, const void* vmask, void* dgrid,
                                       void* scratch, int b, int n, int cap, int cells,
                                       int c, int d1, int d2, int tile, void* stream) {
  return compact_interp_bwd<float>(g, w, idx, coords, vmask, dgrid, scratch, b, n, cap,
                                   cells, c, d1, d2, tile, static_cast<cudaStream_t>(stream));
}

// K7's bf16 variant: as dclx_compact_interp_bwd, with g [B,N,C] and dgrid
// [B,G,C] bf16.
extern "C" int dclx_compact_interp_bwd_bf16(const void* g, const void* w, const void* idx,
                                            const void* coords, const void* vmask,
                                            void* dgrid, void* scratch, int b, int n,
                                            int cap, int cells, int c, int d1, int d2,
                                            int tile, void* stream) {
  return compact_interp_bwd<__nv_bfloat16>(g, w, idx, coords, vmask, dgrid, scratch, b, n,
                                           cap, cells, c, d1, d2, tile,
                                           static_cast<cudaStream_t>(stream));
}
