// K2: stream compaction of the occupied voxels of a dense grid, and K5,
// its backward.
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
//
// K5 replaces the Pallas kernel dcl_net_tpu/ops/pallas_compact.py
// (_make_bwd_kernel, launched by _run_bwd), in which each grid step owned
// one chunk of the grid gradient and wrote it whole, once, from prefetched
// chunk offsets, through transposed one-hot matmuls. It computes
// dgrid[b, lin(coords[b, s]), c] = dv[b, s, c] for every valid slot s
// (vmask > 0), zeros elsewhere, into a [B, G, C] grid.
//
// Precondition, which K2 above and the plain sparse_conv.dense_to_sparse
// both guarantee: the valid slots of a sample are the prefix
// [0, min(occupancy, cap)) and their linear indices rise strictly. The
// forward's coords and vmask are kept, so no scan runs again.
//
// Bound on an H100: bytes, and nearly all of them are the grid's zeros
// (178 MB over the four levels of one branch on the main path, where the
// grid is ~2 % occupied). Design: one launch writes every byte once. The
// grid of blocks is (tiles, B); block (t, b) owns cells [lo, hi) of sample
// b, about 16 KB of output. Two warps find its slot range [s0, s1) by a
// 32-way search of the valid prefix (the first slot whose linear index
// reaches lo, then hi), as the TPU kernel took its range from the
// prefetched offsets, and then, with the other warps, store zeros over the
// tile (float4, streaming).
// After __syncthreads() the block copies rows dv[b, s0:s1] into their
// cells, float4 where C % 4 == 0 and the rows are 16-byte aligned, else
// float by float. Each cell holds at most one slot and nothing is added,
// so the result is bit-equal to the plain version.

#include <cuda_runtime.h>

#include "tile_fill.cuh"

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

constexpr int kBwdThreads = 256;

// The first slot s of [0, cap) whose key reaches target, where key(s) is
// the linear index of a valid slot and +inf past the valid prefix (cap if
// none does). A warp-wide search: each round the 32 lanes probe evenly
// spaced slots and keep the gap where the key first reaches the target.
__device__ __forceinline__ int first_slot_at(const int* __restrict__ coords,
                                             const float* __restrict__ vmask,
                                             int cap, int d1, int d2,
                                             long long target) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = cap;  // keys below lo are < target, keys from hi >= target
  while (lo < hi) {
    const int step = (hi - lo + 31) / 32;
    const int s = lo + lane * step;
    bool reached = false;
    if (s < hi) {  // the mask and the coords loaded together: one wait a round
      const float valid = vmask[s];
      const int* xyz = coords + 3 * (long long)s;
      const int x0 = xyz[0], x1 = xyz[1], x2 = xyz[2];
      reached = !(valid > 0.f)  // past the valid prefix
                || ((long long)x0 * d1 + x1) * d2 + x2 >= target;
    }
    const unsigned ball = __ballot_sync(0xffffffffu, reached);
    if (ball == 0u) {
      const int last = min(31, (hi - 1 - lo) / step);  // the last lane probed
      lo += last * step + 1;
    } else {
      const int f = __ffs(ball) - 1;
      if (f == 0) {
        hi = lo;
      } else {
        hi = lo + f * step;
        lo += (f - 1) * step + 1;
      }
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kBwdThreads)
compact_occupied_bwd(const float* __restrict__ dv, const int* __restrict__ coords,
                     const float* __restrict__ vmask, float* __restrict__ dgrid,
                     int cap, int g, int c, int d1, int d2, int tile, int vec) {
  __shared__ int slot_range[2];
  const int b = blockIdx.y;
  const long long lo = (long long)blockIdx.x * tile;
  const long long hi = min(lo + tile, (long long)g);
  float* out = dgrid + ((long long)b * g + lo) * c;
  const int* xyz_b = coords + (long long)b * cap * 3;
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {  // the search's chain of loads first: the zeros need no wait
    const int s = first_slot_at(xyz_b, vmask + (long long)b * cap, cap, d1, d2,
                                warp == 0 ? lo : hi);
    if ((threadIdx.x & 31) == 0) slot_range[warp] = s;
  }
  tile_fill::zero(out, (hi - lo) * c);
  __syncthreads();  // also orders the zeros before the rows below
  const int s0 = slot_range[0];
  const long long rows = slot_range[1] - s0;
  const float* src = dv + ((long long)b * cap + s0) * c;
  const int* xyz = xyz_b + 3 * (long long)s0;
  if (vec) {
    const int c4 = c >> 2;
    for (long long e = threadIdx.x; e < rows * c4; e += kBwdThreads) {
      const long long r = e / c4;
      const int k = (int)(e - r * c4);
      const long long cell =
          ((long long)xyz[3 * r] * d1 + xyz[3 * r + 1]) * d2 + xyz[3 * r + 2] - lo;
      reinterpret_cast<float4*>(out + cell * c)[k] =
          reinterpret_cast<const float4*>(src + r * c)[k];
    }
  } else {
    for (long long e = threadIdx.x; e < rows * c; e += kBwdThreads) {
      const long long r = e / c;
      const int k = (int)(e - r * c);
      const long long cell =
          ((long long)xyz[3 * r] * d1 + xyz[3 * r + 1]) * d2 + xyz[3 * r + 2] - lo;
      out[cell * c + k] = src[r * c + k];
    }
  }
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

// dv [B,cap,C] f32, coords [B,cap,3] i32 and vmask [B,cap] f32 from the
// forward, under the precondition above; writes every float of dgrid
// [B,G,C] f32 (no zero fill needed). tile: cells per block.
extern "C" int dclx_compact_bwd(const void* dv, const void* coords,
                                const void* vmask, void* dgrid, int b, int g,
                                int c, int d1, int d2, int cap, int tile,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b > 0 && g > 0 && c > 0) {
    const int vec = c % 4 == 0 && reinterpret_cast<unsigned long long>(dv) % 16 == 0 &&
                    reinterpret_cast<unsigned long long>(dgrid) % 16 == 0;
    const dim3 blocks((unsigned)((g + tile - 1) / tile), (unsigned)b);
    compact_occupied_bwd<<<blocks, kBwdThreads, 0, s>>>(
        static_cast<const float*>(dv), static_cast<const int*>(coords),
        static_cast<const float*>(vmask), static_cast<float*>(dgrid),
        cap, g, c, d1, d2, tile, vec);
  }
  return (int)cudaGetLastError();
}
