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
// twice (the second time mostly from L2), coalesced, as float4, and touches
// a feature row only when it is selected.
//
// Design: one entry point, two kernels on the same grid of (cell tiles, B)
// blocks, kTileCells / 4 threads a block, 4 cells a thread
// (cuda_compact.TILE_CELLS: 256, 512 or 1024 cells, swept by
// scripts/sweep_interp_compact.py):
//  1. compact_count: each block counts the occupied cells of its tile and
//     writes one count;
//  2. compact_write: each block sums the counts of the tiles before its
//     own in its sample (one warp, 32 tiles a round: one round at level 0
//     with 1024-cell tiles) and the sample's total, then ranks its occupied cells by a block-wide exclusive scan
//     (warp shuffles, then a scan of the warp totals). A cell of rank < cap
//     writes its coords and vmask = 1 and lists itself in shared memory;
//     the block then copies the listed feature rows, threads across
//     channels, float4 where C % 4 == 0, the loads of kCopyUnroll rows in
//     flight. The tail [min(occupancy, cap), cap) of coords, vfeats and
//     vmask is zeroed by the same blocks, shared out over the sample's
//     tiles, so the caller allocates the outputs empty; the first tile's
//     block writes the occupancy, so the caller can flag an overflow
//     (occupancy > cap).
// No atomics: the output is the same from run to run, and bit-equal to the
// plain version.
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
// reaches lo, then hi; tile_fill::first_slot_at, shared with K7), as the
// TPU kernel took its range from the prefetched offsets, and then, with the
// other warps, store zeros over the tile (float4, streaming).
// After __syncthreads() the block copies rows dv[b, s0:s1] into their
// cells, float4 where C % 4 == 0 and the rows are 16-byte aligned, else
// float by float. Each cell holds at most one slot and nothing is added,
// so the result is bit-equal to the plain version.
//
// K2's bf16 variant (dclx_compact_bf16; model.compute_dtype: bfloat16) is
// the same two kernels with the writer templated on the feature type: it
// copies bf16 rows as they are (bit for bit; the mask, coords, vmask and
// occupancy are the f32 variant's), 16 bytes a thread, which are 8 bf16
// channels instead of 4 floats.
//
// K5's bf16 variant (dclx_compact_bwd_bf16; bf16 training) replaces the same
// Pallas backward under bf16 (exact=False), whose one-hot product of bf16
// rows, cast back to bf16, copies each row bit for bit. It is K5 with dv and
// dgrid bf16: the zeros and the rows are stored as their bits, 16 bytes a
// thread (8 bf16 channels) where C % 8 == 0 and the rows are 16-byte
// aligned. The wrapper gives its blocks twice the cells of the f32 variant,
// so a tile stays about 16 KB.

#include <cuda_runtime.h>

#include "elem.cuh"
#include "tile_fill.cuh"

namespace {

constexpr int kCopyUnroll = 4;  // rows whose loads K2's writer issues together

// The occupancy bits of cells cell0 .. cell0 + 3 of m[0, g) (bit k: cell0 +
// k, mask > 0): one float4 load where vec (g % 4 == 0, m 16-byte aligned).
__device__ __forceinline__ unsigned occupied4(const float* __restrict__ m, long long cell0,
                                              int g, int vec) {
  if (cell0 >= g) return 0u;
  if (vec) {
    const float4 x = reinterpret_cast<const float4*>(m + cell0)[0];
    return (x.x > 0.f ? 1u : 0u) | (x.y > 0.f ? 2u : 0u) | (x.z > 0.f ? 4u : 0u) |
           (x.w > 0.f ? 8u : 0u);
  }
  unsigned bits = 0u;
  for (int k = 0; k < 4 && cell0 + k < g; ++k) bits |= (m[cell0 + k] > 0.f ? 1u : 0u) << k;
  return bits;
}

__device__ __forceinline__ int warp_sum(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int kTileCells>
__global__ void __launch_bounds__(kTileCells / 4)
compact_count(const float* __restrict__ mask, int* __restrict__ tile_counts, int g,
              int tiles, int vec) {
  constexpr int kWarps = kTileCells / 4 / 32;
  __shared__ int warp_total[kWarps];
  const int b = blockIdx.y;
  const long long cell0 = (long long)blockIdx.x * kTileCells + 4 * threadIdx.x;
  const int x = warp_sum(__popc(occupied4(mask + (long long)b * g, cell0, g, vec)));
  if ((threadIdx.x & 31) == 0) warp_total[threadIdx.x >> 5] = x;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += warp_total[w];
    tile_counts[(long long)b * tiles + blockIdx.x] = total;
  }
}

template <int kTileCells, class T>
__global__ void __launch_bounds__(kTileCells / 4)
compact_write(const T* __restrict__ feats, const float* __restrict__ mask,
              const int* __restrict__ tile_counts, int* __restrict__ coords,
              T* __restrict__ vfeats, float* __restrict__ vmask,
              int* __restrict__ occupancy, int g, int c, int d1, int d2, int cap, int tiles,
              int vec_mask, int vec_rows) {
  constexpr int kThreads = kTileCells / 4;
  constexpr int kWarps = kThreads / 32;
  __shared__ int warp_incl[kWarps];
  __shared__ int sample[2];       // occupied cells before this tile, in the sample
  __shared__ int sel[kTileCells];  // the cells of this tile's written rows, in rank order
  const int b = blockIdx.y;
  const int t = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (warp == 0) {
    const int* counts = tile_counts + (long long)b * tiles;
    int before = 0, total = 0;
    for (int i = lane; i < tiles; i += 32) {
      const int x = counts[i];
      total += x;
      before += i < t ? x : 0;
    }
    before = warp_sum(before);
    total = warp_sum(total);
    if (lane == 0) {
      sample[0] = before;
      sample[1] = total;
    }
  }
  const long long cell0 = (long long)t * kTileCells + 4 * threadIdx.x;
  const unsigned bits = occupied4(mask + (long long)b * g, cell0, g, vec_mask);
  const int own = __popc(bits);
  int x = own;  // inclusive scan within the warp
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_incl[warp] = x;
  __syncthreads();
  if (warp == 0) {  // inclusive scan of the warp totals
    int w = lane < kWarps ? warp_incl[lane] : 0;
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kWarps) warp_incl[lane] = w;
  }
  __syncthreads();
  const int before = sample[0];
  const int total = sample[1];
  const long long row0 = (long long)b * cap;
  int rank = before + (warp > 0 ? warp_incl[warp - 1] : 0) + x - own;
  for (int k = 0; k < 4; ++k) {
    if (!((bits >> k) & 1u)) continue;
    if (rank < cap) {
      const int cell = (int)cell0 + k;
      const int i0 = cell / (d1 * d2);
      const int rem = cell - i0 * d1 * d2;
      const int i1 = rem / d2;
      int* xyz = coords + (row0 + rank) * 3;
      xyz[0] = i0;
      xyz[1] = i1;
      xyz[2] = rem - i1 * d2;
      vmask[row0 + rank] = 1.f;
      sel[rank - before] = cell;
    }
    ++rank;
  }
  __syncthreads();
  // the listed rows: vfeats[row0 + before + r] = feats[b, sel[r]]
  const int rows = max(0, min(cap - before, warp_incl[kWarps - 1]));
  const T* fb = feats + (long long)b * g * c;
  T* dst = vfeats + (row0 + before) * c;
  if (vec_rows) {  // 16 bytes a thread: per_vec<T>() channels
    const int c4 = c / elem::per_vec<T>();
    const int k = threadIdx.x % c4;
    const int step = kThreads / c4;
    const uint4* src4 = reinterpret_cast<const uint4*>(fb) + k;
    uint4* dst4 = reinterpret_cast<uint4*>(dst) + k;
    int r = threadIdx.x / c4;
    for (; r + (kCopyUnroll - 1) * step < rows; r += kCopyUnroll * step) {
      uint4 f[kCopyUnroll];
#pragma unroll
      for (int u = 0; u < kCopyUnroll; ++u) f[u] = src4[(long long)sel[r + u * step] * c4];
#pragma unroll
      for (int u = 0; u < kCopyUnroll; ++u) dst4[(long long)(r + u * step) * c4] = f[u];
    }
    for (; r < rows; r += step) dst4[(long long)r * c4] = src4[(long long)sel[r] * c4];
  } else {
    for (long long e = threadIdx.x; e < (long long)rows * c; e += kThreads) {
      const int r = (int)(e / c);
      dst[e] = fb[(long long)sel[r] * c + (e - (long long)r * c)];
    }
  }
  // the tail [min(total, cap), cap), a share of it per tile of the sample
  const int nv = min(total, cap);
  const int share = (cap - nv + tiles - 1) / tiles;
  const long long lo = min((long long)cap, nv + (long long)t * share);
  const long long hi = min((long long)cap, lo + share);
  if (lo < hi) {
    tile_fill::zero(vfeats + (row0 + lo) * c, (hi - lo) * c);
    tile_fill::zero(reinterpret_cast<float*>(coords + (row0 + lo) * 3), (hi - lo) * 3);
    tile_fill::zero(vmask + row0 + lo, hi - lo);
  }
  if (t == 0 && threadIdx.x == 0) occupancy[b] = total;
}

template <int kTileCells, class T>
int launch_compact(const T* feats, const float* mask, int* coords, T* vfeats,
                   float* vmask, int* counts, int b, int g, int c, int d1, int d2, int cap,
                   cudaStream_t s) {
  constexpr int kThreads = kTileCells / 4;
  const int tiles = (g + kTileCells - 1) / kTileCells;
  const auto aligned = [](const void* p) {
    return reinterpret_cast<unsigned long long>(p) % 16 == 0;
  };
  const int vec_mask = g % 4 == 0 && aligned(mask);
  constexpr int kPer = elem::per_vec<T>();
  const int vec_rows = c > 0 && c % kPer == 0 && kThreads % (c / kPer) == 0 &&
                       aligned(feats) && aligned(vfeats);
  int* tile_counts = counts + b;
  const dim3 blocks((unsigned)tiles, (unsigned)b);
  compact_count<kTileCells><<<blocks, kThreads, 0, s>>>(mask, tile_counts, g, tiles, vec_mask);
  compact_write<kTileCells, T><<<blocks, kThreads, 0, s>>>(
      feats, mask, tile_counts, coords, vfeats, vmask, counts, g, c, d1, d2, cap, tiles,
      vec_mask, vec_rows);
  return (int)cudaGetLastError();
}

constexpr int kBwdThreads = 256;

template <class T>
__global__ void __launch_bounds__(kBwdThreads)
compact_occupied_bwd(const T* __restrict__ dv, const int* __restrict__ coords,
                     const float* __restrict__ vmask, T* __restrict__ dgrid,
                     int cap, int g, int c, int d1, int d2, int tile, int vec) {
  __shared__ int slot_range[2];
  const int b = blockIdx.y;
  const long long lo = (long long)blockIdx.x * tile;
  const long long hi = min(lo + tile, (long long)g);
  T* out = dgrid + ((long long)b * g + lo) * c;
  const int* xyz_b = coords + (long long)b * cap * 3;
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {  // the search's chain of loads first: the zeros need no wait
    const int s = tile_fill::first_slot_at(xyz_b, vmask + (long long)b * cap, cap, d1,
                                           d2, warp == 0 ? lo : hi);
    if ((threadIdx.x & 31) == 0) slot_range[warp] = s;
  }
  tile_fill::zero(out, (hi - lo) * c);
  __syncthreads();  // also orders the zeros before the rows below
  const int s0 = slot_range[0];
  const long long rows = slot_range[1] - s0;
  const T* src = dv + ((long long)b * cap + s0) * c;
  const int* xyz = xyz_b + 3 * (long long)s0;
  if (vec) {  // 16 bytes a thread: per_vec<T>() channels
    const int cv = c / elem::per_vec<T>();
    for (long long e = threadIdx.x; e < rows * cv; e += kBwdThreads) {
      const long long r = e / cv;
      const int k = (int)(e - r * cv);
      const long long cell =
          ((long long)xyz[3 * r] * d1 + xyz[3 * r + 1]) * d2 + xyz[3 * r + 2] - lo;
      reinterpret_cast<uint4*>(out + cell * c)[k] =
          reinterpret_cast<const uint4*>(src + r * c)[k];
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

template <class T>
int compact_bwd(const void* dv, const void* coords, const void* vmask, void* dgrid, int b,
                int g, int c, int d1, int d2, int cap, int tile, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b > 0 && g > 0 && c > 0) {
    const int vec = c % elem::per_vec<T>() == 0 &&
                    reinterpret_cast<unsigned long long>(dv) % 16 == 0 &&
                    reinterpret_cast<unsigned long long>(dgrid) % 16 == 0;
    const dim3 blocks((unsigned)((g + tile - 1) / tile), (unsigned)b);
    compact_occupied_bwd<T><<<blocks, kBwdThreads, 0, s>>>(
        static_cast<const T*>(dv), static_cast<const int*>(coords),
        static_cast<const float*>(vmask), static_cast<T*>(dgrid), cap, g, c, d1, d2, tile,
        vec);
  }
  return (int)cudaGetLastError();
}

template <class T>
int compact_tiles(const void* feats, const void* mask, void* coords, void* vfeats,
                  void* vmask, void* counts, int b, int g, int c, int d1, int d2, int cap,
                  int tile_cells, void* stream) {
  if (b <= 0 || g <= 0) return (int)cudaGetLastError();
  const auto* f = static_cast<const T*>(feats);
  const auto* m = static_cast<const float*>(mask);
  auto* xyz = static_cast<int*>(coords);
  auto* vf = static_cast<T*>(vfeats);
  auto* vm = static_cast<float*>(vmask);
  auto* n = static_cast<int*>(counts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile_cells) {
    case 256: return launch_compact<256>(f, m, xyz, vf, vm, n, b, g, c, d1, d2, cap, s);
    case 512: return launch_compact<512>(f, m, xyz, vf, vm, n, b, g, c, d1, d2, cap, s);
    case 1024: return launch_compact<1024>(f, m, xyz, vf, vm, n, b, g, c, d1, d2, cap, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// feats [B,G,C] f32, mask [B,G] f32; writes every element of coords
// [B,cap,3] i32, vfeats [B,cap,C] f32 and vmask [B,cap] f32 (allocated
// empty) and of counts [B + B * ceil(G / tile_cells)] i32: the occupancy
// [B], then the per-tile counts. tile_cells in {256, 512, 1024}; another
// value returns cudaErrorInvalidValue.
extern "C" int dclx_compact(const void* feats, const void* mask, void* coords,
                            void* vfeats, void* vmask, void* counts,
                            int b, int g, int c, int d1, int d2, int cap, int tile_cells,
                            void* stream) {
  return compact_tiles<float>(feats, mask, coords, vfeats, vmask, counts, b, g, c, d1, d2,
                              cap, tile_cells, stream);
}

// As dclx_compact, with feats [B,G,C] and vfeats [B,cap,C] bf16.
extern "C" int dclx_compact_bf16(const void* feats, const void* mask, void* coords,
                                 void* vfeats, void* vmask, void* counts,
                                 int b, int g, int c, int d1, int d2, int cap,
                                 int tile_cells, void* stream) {
  return compact_tiles<__nv_bfloat16>(feats, mask, coords, vfeats, vmask, counts, b, g, c,
                                      d1, d2, cap, tile_cells, stream);
}

// dv [B,cap,C] f32, coords [B,cap,3] i32 and vmask [B,cap] f32 from the
// forward, under the precondition above; writes every float of dgrid
// [B,G,C] f32 (no zero fill needed). tile: cells per block.
extern "C" int dclx_compact_bwd(const void* dv, const void* coords,
                                const void* vmask, void* dgrid, int b, int g,
                                int c, int d1, int d2, int cap, int tile,
                                void* stream) {
  return compact_bwd<float>(dv, coords, vmask, dgrid, b, g, c, d1, d2, cap, tile, stream);
}

// K5's bf16 variant: as dclx_compact_bwd, with dv [B,cap,C] and dgrid
// [B,G,C] bf16.
extern "C" int dclx_compact_bwd_bf16(const void* dv, const void* coords,
                                     const void* vmask, void* dgrid, int b, int g,
                                     int c, int d1, int d2, int cap, int tile,
                                     void* stream) {
  return compact_bwd<__nv_bfloat16>(dv, coords, vmask, dgrid, b, g, c, d1, d2, cap, tile,
                                    stream);
}
