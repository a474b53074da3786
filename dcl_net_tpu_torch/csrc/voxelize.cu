// K1: point -> voxel scatter (sum / mean) with exact per-voxel counts.
//
// Replaces the Pallas kernel dcl_net_tpu/ops/pallas_voxelize.py
// (_make_kernel, launched by _run_fwd / pallas_voxelize), in which each
// grid step owned one [TILE, D2 * CP] block of the output and wrote it
// whole, once, zeros included, through factorised one-hot matmuls. The
// port keeps that ownership: one launch, every byte of the grid and of the
// counts written by the block that owns it, no separate zero fill.
//
// Bound on an H100: bytes. The function writes a dense [B, G, C] grid plus
// [B, G] counts (G = 64^3, C = 7: 268 MB at B = 32) and reads a few hundred
// KB of points. About 2 % of the cells hold a point on the main path, so
// nearly all of those bytes are zeros. The design stores them once, 16
// bytes a thread, from enough blocks to fill the card, and writes an
// occupied cell a second time with its mean only.
//
// Design: the grid of blocks is (tiles, B); block (t, b) owns the cells
// [t * tile, t * tile + tile) of sample b.
//  1. It stores zeros over its tile of the grid and of the counts.
//  2. It reads the sample's N point indices (they stay in L2) and keeps the
//     points that are unmasked (mask > 0), inside the grid on every axis and
//     inside its tile, in ascending point order: a block-wide scan gives
//     each kept point its place in a list in shared memory (an atomic append
//     would lose the order), where its cell and its C features go.
//  3. One warp walks the list in order, 32 entries at a time, and links
//     each entry to the next entry of the same cell (__match_any_sync
//     groups a chunk's entries by cell; a per-cell tail carries the chain
//     across chunks). The first entry of a cell is its owner.
//  4. After __syncthreads(), each owner follows its cell's chain in shared
//     memory, one thread per (owner, channel), adding the points in point
//     order from 0.f, and writes sum / max(count, 1) (mode 4) or the sum
//     (mode 3), and the count, once. The chain visits only the cell's own
//     points: a walk over the whole list from the owner on, or loads of the
//     features from device memory inside the walk, made this step the
//     slowest of the kernel.
// That is the order and the rounding of the plain ops/voxelize.voxelize_dense
// (a serial scatter in point order, then grid / clamp(count, 1)), so the
// result is bit-equal to it and deterministic: IEEE division (no fast
// math), and a sum without products, which nothing contracts into an FMA.
//
// Zeros go out with streaming stores (st.global.cs): nothing reads them
// back, so they need not stay in L2.
//
// Shared memory, dynamic: 2 + C words per list entry (N at most) and one
// per tile cell; ops/cuda_voxelize.py (plan) sizes it.
//
// Where that list does not fit (N above about 6,200 at C = 7, or a wide C),
// voxelize_rounds takes the tile's points in rounds of at most round_len
// list entries, in point order: each round is steps 2-4 over the points
// after the last round's, and each owner continues its cell's f32 sum and
// count, carried from round to round in shared memory (tile x cw words and
// a count a cell), instead of starting them from 0. The channels go cw at
// a time (cw = C up to 256), each slice over all the rounds. The cells are
// written once, after the last round of their slice, over the zeros: a
// cell's sum is still taken from 0.f in point order, and mode 4 divides
// once, so the result is the list kernel's, bit for bit. The planner
// shrinks the tile for a wide C so that the carried sums take at most half
// of the shared memory.
//
// The bf16 variant (dclx_voxelize_bf16; model.compute_dtype: bfloat16)
// writes a bf16 grid with the semantics of the JAX package's
// pallas_voxelize(out_dtype=bfloat16): each point's features are rounded
// to bf16 as they enter the list, each cell's sum of those values is taken
// in f32 (in point order here) and stored as bf16; mode 4 then divides the
// bf16 sum, taken back to f32, by the count and rounds to bf16 again. The
// counts stay exact f32. It is the same kernel, templated on the grid's
// element type: the list, the chains and the sums are f32 in both, and only
// the grid's bytes (2 a value instead of 4) differ.

#include <cuda_runtime.h>

#include "elem.cuh"
#include "tile_fill.cuh"

namespace {

constexpr int kThreads = 1024;  // one point per thread per scan step
constexpr int kWarps = kThreads / 32;

// 3. of both kernels: one warp links each of the len list entries to the
// next entry of the same cell, in list (= point) order; the first entry of
// a cell keeps its cell in list_cell, the others get -1. __match_any_sync
// groups a chunk of 32 entries by cell; a per-cell tail carries the chain
// across chunks.
__device__ __forceinline__ void link_chains(int* __restrict__ list_cell,
                                            int* __restrict__ next, int* __restrict__ tail,
                                            int len, int lane) {
  for (int base = 0; base < len; base += 32) {
    const int i = base + lane;
    const bool on = i < len;
    const int cell = on ? list_cell[i] : -1 - lane;  // lanes past the end group alone
    const unsigned peers = __match_any_sync(0xffffffffu, cell);
    const unsigned above = lane == 31 ? 0u : peers & (0xffffffffu << (lane + 1));
    const unsigned below = peers & ((1u << lane) - 1u);
    if (on) {
      next[i] = above != 0u ? base + __ffs(above) - 1 : -1;
      if (below == 0u) {  // the chunk's first entry of the cell
        const int t = tail[cell];
        if (t >= 0) {
          next[t] = i;
          list_cell[i] = -1;  // not the owner
        }
      } else {
        list_cell[i] = -1;
      }
    }
    __syncwarp();
    if (on && above == 0u) tail[cell] = i;  // the chunk's last entry of the cell
    __syncwarp();
  }
}

template <class T>
__global__ void __launch_bounds__(kThreads)
voxelize_tiles(const float* __restrict__ feats, const int* __restrict__ vidx,
               const float* __restrict__ pmask, T* __restrict__ grid,
               float* __restrict__ count, int n, int c, int d0, int d1, int d2,
               int tile, int mean) {
  extern __shared__ int smem[];
  int* tail = smem;                  // [tile] last list entry of a cell so far
  int* list_cell = smem + tile;      // [n] cell of each kept point, in the tile; -1 past the owner
  int* next = list_cell + n;         // [n] next entry of the same cell, -1 at the last
  float* list_feat = reinterpret_cast<float*>(next + n);  // [n, c] features
  __shared__ int warp_incl[kWarps];

  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long g = (long long)d0 * d1 * d2;
  const long long lo = (long long)blockIdx.x * tile;
  const int cells = (int)min((long long)tile, g - lo);
  T* grid_t = grid + ((long long)b * g + lo) * c;
  float* count_t = count + (long long)b * g + lo;

  // 1. zeros over the tile
  tile_fill::zero(grid_t, (long long)cells * c);
  tile_fill::zero(count_t, cells);

  // 2. the tile's points, in ascending point order
  const int* v = vidx + (long long)b * n * 3;
  const float* m = pmask != nullptr ? pmask + (long long)b * n : nullptr;
  const float* f = feats + (long long)b * n * c;
  int len = 0;  // the same in every thread
  for (int base = 0; base < n; base += kThreads) {
    const int p = base + threadIdx.x;
    int rel = -1;  // the point's cell in the tile, or -1 if it is not kept
    if (p < n && (m == nullptr || m[p] > 0.f)) {
      const int i0 = v[3 * p], i1 = v[3 * p + 1], i2 = v[3 * p + 2];
      if (i0 >= 0 && i0 < d0 && i1 >= 0 && i1 < d1 && i2 >= 0 && i2 < d2) {
        const long long lin = ((long long)i0 * d1 + i1) * d2 + i2 - lo;
        if (lin >= 0 && lin < cells) rel = (int)lin;
      }
    }
    const int mine = rel >= 0 ? 1 : 0;
    int x = mine;  // inclusive scan within the warp
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
    if (mine) {
      const int pos = len + (warp > 0 ? warp_incl[warp - 1] : 0) + x - 1;
      list_cell[pos] = rel;
      tail[rel] = -1;
      const float* src = f + (long long)p * c;
      for (int ch = 0; ch < c; ++ch) list_feat[pos * c + ch] = elem::round_to<T>(src[ch]);
    }
    len += warp_incl[kWarps - 1];
    __syncthreads();  // warp_incl is rewritten by the next step
  }
  if (len == 0) return;  // an empty tile: the zeros are the result

  // 3. chains of the entries of each cell, in list (= point) order
  if (warp == 0) link_chains(list_cell, next, tail, len, lane);
  __syncthreads();  // also orders the zeros of step 1 before the writes below

  // 4. each owner's sums, one thread per (owner, channel), in point order
  for (int e = threadIdx.x; e < len * c; e += kThreads) {
    const int i = e / c;
    const int cell = list_cell[i];
    if (cell < 0) continue;
    const int ch = e - i * c;
    float s = 0.f;
    int k_n = 0;
    for (int j = i; j >= 0; j = next[j]) {
      s += list_feat[j * c + ch];
      ++k_n;
    }
    const float nf = (float)k_n;  // exact: k_n <= N < 2^24
    // the sum as the grid's type holds it, then (mode 4) over the count, nf >= 1
    const float sum = elem::round_to<T>(s);
    grid_t[(long long)cell * c + ch] = elem::from_float<T>(mean ? sum / nf : sum);
    if (ch == 0) count_t[cell] = nf;
  }
}

// The list kernel's steps in rounds, for an N whose list does not fit (see
// the note above). Block (t, b) owns the cells [t * tile, t * tile + tile)
// of sample b. Shared memory, dynamic: tail [tile], cnt [tile], acc [tile,
// cw], then the round's list: list_cell, next [round_len], list_feat
// [round_len, cw].
template <class T>
__global__ void __launch_bounds__(kThreads)
voxelize_rounds(const float* __restrict__ feats, const int* __restrict__ vidx,
                const float* __restrict__ pmask, T* __restrict__ grid,
                float* __restrict__ count, int n, int c, int d0, int d1, int d2, int tile,
                int cw, int round_len, int mean) {
  extern __shared__ int smem[];
  int* tail = smem;                                      // [tile] last entry of a cell
  int* cnt = tail + tile;                                // [tile] points so far
  float* acc = reinterpret_cast<float*>(cnt + tile);     // [tile, cw] sums so far
  int* list_cell = reinterpret_cast<int*>(acc + (long long)tile * cw);  // [round_len]
  int* next = list_cell + round_len;                     // [round_len]
  float* list_feat = reinterpret_cast<float*>(next + round_len);  // [round_len, cw]
  __shared__ int warp_incl[kWarps];
  __shared__ int stop_at;

  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long g = (long long)d0 * d1 * d2;
  const long long lo = (long long)blockIdx.x * tile;
  const int cells = (int)min((long long)tile, g - lo);
  T* grid_t = grid + ((long long)b * g + lo) * c;
  float* count_t = count + (long long)b * g + lo;

  // 1. zeros over the tile
  tile_fill::zero(grid_t, (long long)cells * c);
  tile_fill::zero(count_t, cells);

  const int* v = vidx + (long long)b * n * 3;
  const float* m = pmask != nullptr ? pmask + (long long)b * n : nullptr;
  const float* f = feats + (long long)b * n * c;
  for (int c0 = 0; c0 < c; c0 += cw) {  // a slice of cw channels
    const int w = min(cw, c - c0);
    for (int i = threadIdx.x; i < cells * cw; i += kThreads) acc[i] = 0.f;
    for (int i = threadIdx.x; i < cells; i += kThreads) cnt[i] = 0;
    __syncthreads();
    for (int from = 0; from < n;) {  // a round, from point `from` on; uniform
      // 2. the next round_len of the tile's points, in ascending point order
      int len = 0;
      int next_from = n;
      for (int base = from; base < n; base += kThreads) {
        const int p = base + threadIdx.x;
        int rel = -1;  // the point's cell in the tile, or -1 if it is not kept
        if (p < n && (m == nullptr || m[p] > 0.f)) {
          const int i0 = v[3 * p], i1 = v[3 * p + 1], i2 = v[3 * p + 2];
          if (i0 >= 0 && i0 < d0 && i1 >= 0 && i1 < d1 && i2 >= 0 && i2 < d2) {
            const long long lin = ((long long)i0 * d1 + i1) * d2 + i2 - lo;
            if (lin >= 0 && lin < cells) rel = (int)lin;
          }
        }
        const int mine = rel >= 0 ? 1 : 0;
        int x = mine;  // inclusive scan within the warp
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(0xffffffffu, x, o);
          if (lane >= o) x += y;
        }
        if (lane == 31) warp_incl[warp] = x;
        __syncthreads();
        if (warp == 0) {  // inclusive scan of the warp totals
          int t = lane < kWarps ? warp_incl[lane] : 0;
#pragma unroll
          for (int o = 1; o < kWarps; o <<= 1) {
            const int y = __shfl_up_sync(0xffffffffu, t, o);
            if (lane >= o) t += y;
          }
          if (lane < kWarps) warp_incl[lane] = t;
        }
        __syncthreads();
        if (mine) {
          const int pos = len + (warp > 0 ? warp_incl[warp - 1] : 0) + x - 1;
          if (pos < round_len) {
            list_cell[pos] = rel;
            tail[rel] = -1;
            const float* src = f + (long long)p * c + c0;
            for (int ch = 0; ch < w; ++ch) list_feat[pos * cw + ch] = elem::round_to<T>(src[ch]);
          } else if (pos == round_len) {
            stop_at = p;  // the first point of the next round
          }
        }
        const int total = warp_incl[kWarps - 1];
        __syncthreads();  // warp_incl is rewritten by the next step; stop_at is set
        if (len + total > round_len) {  // the round is full inside this step
          len = round_len;
          next_from = stop_at;
          break;
        }
        len += total;
        if (len == round_len) {  // full at the step's end
          next_from = base + kThreads;
          break;
        }
      }
      if (len == 0) break;  // no more of the tile's points
      // 3. chains of the round's entries of each cell, in point order
      if (warp == 0) link_chains(list_cell, next, tail, len, lane);
      __syncthreads();
      // 4. each owner continues its cell's sums, one thread per (owner, channel)
      for (int e = threadIdx.x; e < len * w; e += kThreads) {
        const int i = e / w;
        const int cell = list_cell[i];
        if (cell < 0) continue;
        const int ch = e - i * w;
        float s = acc[cell * cw + ch];
        int k_n = 0;
        for (int j = i; j >= 0; j = next[j]) {
          s += list_feat[j * cw + ch];
          ++k_n;
        }
        acc[cell * cw + ch] = s;
        if (ch == 0) cnt[cell] += k_n;
      }
      __syncthreads();  // the next round rewrites the list, the chains and stop_at
      from = next_from;
    }
    // 5. the slice's occupied cells, once: also ordered after the zeros of step 1
    for (int e = threadIdx.x; e < cells * w; e += kThreads) {
      const int cell = e / w;
      const int k_n = cnt[cell];
      if (k_n == 0) continue;
      const int ch = e - cell * w;
      const float nf = (float)k_n;  // exact: k_n <= N < 2^24
      const float sum = elem::round_to<T>(acc[cell * cw + ch]);
      grid_t[(long long)cell * c + c0 + ch] = elem::from_float<T>(mean ? sum / nf : sum);
      if (c0 == 0 && ch == 0) count_t[cell] = nf;
    }
    __syncthreads();  // acc and cnt are reset by the next slice
  }
}

template <class T>
int launch_voxelize(const void* feats, const void* vidx, const void* pmask, void* sum,
                    void* count, int b, int n, int c, int d0, int d1, int d2, int mean,
                    int tile, int smem, int cw, int round_len, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long g = (long long)d0 * d1 * d2;
  if (b <= 0 || g <= 0) return (int)cudaGetLastError();
  const dim3 blocks((unsigned)((g + tile - 1) / tile), (unsigned)b);
  if (round_len > 0) {
    if (smem > 47 * 1024) {  // with the static shared memory, above the default 48 KB
      const cudaError_t e = cudaFuncSetAttribute(
          voxelize_rounds<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
    }
    voxelize_rounds<T><<<blocks, kThreads, smem, s>>>(
        static_cast<const float*>(feats), static_cast<const int*>(vidx),
        static_cast<const float*>(pmask), static_cast<T*>(sum), static_cast<float*>(count),
        n, c, d0, d1, d2, tile, cw, round_len, mean);
    return (int)cudaGetLastError();
  }
  if (smem > 47 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        voxelize_tiles<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  voxelize_tiles<T><<<blocks, kThreads, smem, s>>>(
      static_cast<const float*>(feats), static_cast<const int*>(vidx),
      static_cast<const float*>(pmask), static_cast<T*>(sum),
      static_cast<float*>(count), n, c, d0, d1, d2, tile, mean);
  return (int)cudaGetLastError();
}

}  // namespace

// feats [B,N,C] f32, vidx [B,N,3] i32, pmask [B,N] f32 or null; writes every
// float of sum [B,G,C] f32 and count [B,G] f32 (no zero fill needed).
// tile: cells per block; smem: the dynamic shared memory the wrapper sized;
// round_len 0: the list kernel, (N (2 + C) + tile) words; else the rounds
// kernel, round_len list entries a round and cw channels a slice
// (ops/cuda_voxelize.py plan).
extern "C" int dclx_voxelize(const void* feats, const void* vidx,
                             const void* pmask, void* sum, void* count,
                             int b, int n, int c, int d0, int d1, int d2,
                             int mean, int tile, int smem, int cw, int round_len,
                             void* stream) {
  return launch_voxelize<float>(feats, vidx, pmask, sum, count, b, n, c, d0, d1, d2, mean,
                                tile, smem, cw, round_len, stream);
}

// As dclx_voxelize, with sum [B,G,C] bf16 (the bf16 semantics above).
extern "C" int dclx_voxelize_bf16(const void* feats, const void* vidx,
                                  const void* pmask, void* sum, void* count,
                                  int b, int n, int c, int d0, int d1, int d2,
                                  int mean, int tile, int smem, int cw, int round_len,
                                  void* stream) {
  return launch_voxelize<__nv_bfloat16>(feats, vidx, pmask, sum, count, b, n, c, d0, d1, d2,
                                        mean, tile, smem, cw, round_len, stream);
}
