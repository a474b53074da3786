// K2: stream compaction of the occupied voxels of a dense grid.
//
// Replaces the Pallas kernel dcl_net_tpu/ops/pallas_compact.py
// (_make_kernel, launched by compact_raw / pallas_dense_to_sparse), which
// copied occupied rows through one-hot matmuls into 8-aligned chunk slots.
// Here the output has no gaps: row r holds the r-th occupied cell in
// linear-index order, exactly as the top_k extraction of
// ops/sparse_conv.dense_to_sparse, and the result is bit-equal to it.
//
// Bound on an H100: bytes. The function reads the [B, G] occupancy once and
// the feature rows of the occupied cells only (about 2% of the grid on the
// main path), and writes the [B, cap, C] list. The design reads the mask
// once, coalesced, and touches a feature row only when it is selected.
//
// Design: one block per sample walks G in tiles of kThreads cells. A
// block-wide exclusive scan of the tile's occupancy (warp shuffles, then a
// scan of the warp totals) gives each occupied cell its rank; the running
// offset carries across tiles. A cell of rank < cap writes its coords, its
// feature row and vmask = 1. Rows past the occupancy stay as the caller's
// zero fill. The per-sample occupancy is written out so the caller can flag
// an overflow (occupancy > cap). Only B blocks run (32 at the main path's
// batch on 132 SMs): simple first, a split of G across blocks is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
compact_occupied(const float* __restrict__ feats, const float* __restrict__ mask,
                 int* __restrict__ coords, float* __restrict__ vfeats,
                 float* __restrict__ vmask, int* __restrict__ occupancy,
                 int g, int c, int d1, int d2, int cap) {
  __shared__ int warp_incl[kWarps];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* m = mask + (long long)b * g;
  const float* f = feats + (long long)b * g * c;
  int running = 0;
  for (int base = 0; base < g; base += kThreads) {
    const int cell = base + threadIdx.x;
    const int occ = (cell < g && m[cell] > 0.f) ? 1 : 0;
    int x = occ;  // inclusive scan within the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_incl[warp] = x;
    __syncthreads();
    if (warp == 0) {  // inclusive scan of the warp totals
      int w = warp_incl[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w += y;
      }
      warp_incl[lane] = w;
    }
    __syncthreads();
    const int rank = running + (warp > 0 ? warp_incl[warp - 1] : 0) + x - occ;
    if (occ && rank < cap) {
      const int i0 = cell / (d1 * d2);
      const int rem = cell - i0 * d1 * d2;
      const int i1 = rem / d2;
      const long long row = (long long)b * cap + rank;
      coords[row * 3 + 0] = i0;
      coords[row * 3 + 1] = i1;
      coords[row * 3 + 2] = rem - i1 * d2;
      vmask[row] = 1.f;
      const float* src = f + (long long)cell * c;
      float* dst = vfeats + row * c;
      for (int k = 0; k < c; ++k) dst[k] = src[k];
    }
    running += warp_incl[kWarps - 1];
    __syncthreads();  // warp_incl is rewritten by the next tile
  }
  if (threadIdx.x == 0) occupancy[b] = running;
}

}  // namespace

// feats [B,G,C] f32, mask [B,G] f32; coords [B,cap,3] i32, vfeats [B,cap,C]
// f32 and vmask [B,cap] f32 zero-filled by the caller; occupancy [B] i32.
extern "C" int dclx_compact(const void* feats, const void* mask, void* coords,
                            void* vfeats, void* vmask, void* occupancy,
                            int b, int g, int c, int d1, int d2, int cap,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b > 0) {
    compact_occupied<<<b, kThreads, 0, s>>>(
        static_cast<const float*>(feats), static_cast<const float*>(mask),
        static_cast<int*>(coords), static_cast<float*>(vfeats),
        static_cast<float*>(vmask), static_cast<int*>(occupancy),
        g, c, d1, d2, cap);
  }
  return (int)cudaGetLastError();
}
