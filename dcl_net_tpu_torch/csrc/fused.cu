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
// centers tensor and the elementwise pass that writes it: each tile of
// centers is decoded on its way into shared memory as
//   c_a = __fadd_rn(__fmul_rn((float)i_a, unit_s[a]), off_c[a]),
// one rounded product then one rounded sum, which is what the two-stage
// path's `coords * unit + shift` computes in two passes. With the
// constants of sparse_conv.voxel_center_affine the centers, and so out, w
// and idx, are bit-equal to K2 -> voxel_centers -> K3.
//
// Bound on an H100: as K3's (interp.cu), operations at the finest level
// (N x valid-centers distances of 8 f32 operations each), bytes at the
// coarse ones. The design is K3's (three_nn.cuh): one thread per query, a
// shared-memory tile of centers, the top 3 in registers, strict < so ties
// go to the lowest index, and a coalesced block-wide output write. The
// valid slots are exactly [0, min(occupancy, cap)), so the scan stops
// there instead of reading the masked tail of the buffer; a query with
// fewer than 3 valid centers gets index 0 at distance 1e10 for each
// missing slot, as K3 and the reference give.
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
//  1. build_csr (inverse_index.cuh, shared with K4): per sample, the
//     contributions grouped by slot in ascending e = k * N + t;
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

#include <cuda_runtime.h>

#include "inverse_index.cuh"
#include "three_nn.cuh"
#include "tile_fill.cuh"

namespace {

using three_nn::kQueries;
using three_nn::kTile;

__global__ void __launch_bounds__(kQueries)
compact_interp_three_nn(const float* __restrict__ points, const int* __restrict__ coords,
                        const float* __restrict__ vfeats, const float* __restrict__ vmask,
                        const int* __restrict__ occupancy, float* __restrict__ out,
                        float* __restrict__ w_out, int* __restrict__ idx_out, int n,
                        int cap, int c, float us0, float us1, float us2, float oc0,
                        float oc1, float oc2) {
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
  const int* cb = coords + (long long)b * cap * 3;
  const float* mb = vmask + (long long)b * cap;
  const int nv = min(occupancy[b], cap);  // the same for the whole block
  for (int base = 0; base < nv; base += kTile) {
    const int len = min(kTile, nv - base);
    for (int t = threadIdx.x; t < len; t += kQueries) {
      const int* ci = cb + (long long)(base + t) * 3;
      ctr[t] = make_float4(__fadd_rn(__fmul_rn(__int2float_rn(ci[0]), us0), oc0),
                           __fadd_rn(__fmul_rn(__int2float_rn(ci[1]), us1), oc1),
                           __fadd_rn(__fmul_rn(__int2float_rn(ci[2]), us2), oc2),
                           mb[base + t]);
    }
    __syncthreads();
    if (active) three_nn::scan_tile(top, ctr, len, base, px, py, pz);
    __syncthreads();  // the tile is overwritten next
  }
  three_nn::write_block(top, active, b, q0, n, c, vfeats + (long long)b * cap * c, out,
                        w_out, idx_out);
}

using inverse_index::kWriterThreads;

__global__ void __launch_bounds__(kWriterThreads)
compact_interp_grid_bwd(const float* __restrict__ g, const float* __restrict__ w,
                        const int* __restrict__ start, const int* __restrict__ ent,
                        const int* __restrict__ coords, const float* __restrict__ vmask,
                        float* __restrict__ dgrid, int n, int cap, int cells, int c,
                        int d1, int d2, int tile) {
  __shared__ int slot_range[2];
  __shared__ inverse_index::Stage stage;
  const int b = blockIdx.y;
  const long long lo = (long long)blockIdx.x * tile;
  const long long hi = min(lo + tile, (long long)cells);
  float* out = dgrid + ((long long)b * cells + lo) * c;
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
  inverse_index::write_rows(
      stage, start + (long long)b * (cap + 1) + s0, slot_range[1] - s0, ent + b * m,
      w + b * m, g + (long long)b * n * c, n, c, [&](int r, int ch, float x) {
        const long long cell =
            ((long long)xyz[3 * r] * d1 + xyz[3 * r + 1]) * d2 + xyz[3 * r + 2] - lo;
        out[cell * c + ch] = x;
      });
}

}  // namespace

// points [B,N,3] f32; coords [B,cap,3] i32, vfeats [B,cap,C] f32,
// vmask [B,cap] f32, occupancy [B] i32 as K2 writes them;
// out [B,N,C] f32, w [B,3,N] f32, idx [B,3,N] i32; unit_s and off_c the
// per-axis affine map from voxel coordinates to metric centers.
extern "C" int dclx_compact_interp(const void* points, const void* coords,
                                   const void* vfeats, const void* vmask,
                                   const void* occupancy, void* out, void* w, void* idx,
                                   int b, int n, int cap, int c, float us0, float us1,
                                   float us2, float oc0, float oc1, float oc2,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b > 0 && n > 0) {
    dim3 grid((n + kQueries - 1) / kQueries, b);
    compact_interp_three_nn<<<grid, kQueries, 0, s>>>(
        static_cast<const float*>(points), static_cast<const int*>(coords),
        static_cast<const float*>(vfeats), static_cast<const float*>(vmask),
        static_cast<const int*>(occupancy), static_cast<float*>(out),
        static_cast<float*>(w), static_cast<int*>(idx), n, cap, c, us0, us1, us2, oc0,
        oc1, oc2);
  }
  return (int)cudaGetLastError();
}

// g [B,N,C] f32, w [B,3,N] f32 and idx [B,3,N] i32 (each in [0, cap)) as K6
// writes them; coords [B,cap,3] i32 and vmask [B,cap] f32 as K2 writes
// them, under the precondition above; writes every float of dgrid [B,G,C]
// f32 (no zero fill needed). scratch [B, cap + 1 + 3N] i32 for the CSR;
// tile: cells per block.
extern "C" int dclx_compact_interp_bwd(const void* g, const void* w, const void* idx,
                                       const void* coords, const void* vmask, void* dgrid,
                                       void* scratch, int b, int n, int cap, int cells,
                                       int c, int d1, int d2, int tile, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b <= 0 || cells <= 0 || c <= 0) return (int)cudaGetLastError();
  int* start = static_cast<int*>(scratch);
  int* ent = start + (long long)b * (cap + 1);
  const int err = inverse_index::launch_csr(static_cast<const int*>(idx), start, ent, b,
                                            3 * n, cap, s);
  if (err != (int)cudaSuccess) return err;
  const dim3 blocks((unsigned)((cells + tile - 1) / tile), (unsigned)b);
  compact_interp_grid_bwd<<<blocks, kWriterThreads, 0, s>>>(
      static_cast<const float*>(g), static_cast<const float*>(w), start, ent,
      static_cast<const int*>(coords), static_cast<const float*>(vmask),
      static_cast<float*>(dgrid), n, cap, cells, c, d1, d2, tile);
  return (int)cudaGetLastError();
}
