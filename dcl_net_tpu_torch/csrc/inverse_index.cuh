// Device code shared by the two backward kernels of the masked 3-NN
// interpolation: K4 (interp.cu), which writes the gradient of the compacted
// rows [B, V, C], and K7 (fused.cu), which writes it straight onto the
// dense grid. Both compute
//   d[b, idx[b, k, t], :] += w[b, k, t] * g[b, t, :]
// with no atomics: each output row is written once by the thread block that
// owns it, as the ordered sum of its own contributions.
//
// 1. The inverse index: a stable CSR of each sample's m = 3N contributions
//    by slot. An entry is e = k * N + t, its place in the [3, N] idx and w
//    of the sample. start[b, 0..V] holds the offsets and ent[b, 0..3N) the
//    entry ids, ascending e within each slot. A block radix sort (CUB's
//    block-level primitives) sorts kChunkEntries entries by slot; LSD radix
//    sorting is stable, and the entries go in in e order, so each slot's
//    entries come out in e order. An idx outside [0, V) sorts past every
//    slot and is dropped.
//    - m <= kChunkEntries (N <= 2048, the configs' N): build_csr, one block
//      per sample, sorts the whole sample; the offsets are a binary search
//      of the sorted slots for each s in [0, V].
//    - Beyond that, a stable counting sort by slot over the sample's chunks
//      of kChunkEntries entries, three kernels: chunk_counts (a block per
//      (chunk, sample)) sorts its chunk and counts its entries per slot
//      into cnt[b, s, chunk], the dropped ones as slot V; scan_counts (a
//      block per sample) turns cnt, slot-major, into each (slot, chunk)'s
//      exclusive base, and start[b, s] = base(s, chunk 0) for s in [0, V];
//      place_chunk sorts its chunk again (the same sort, the same order)
//      and puts the entry at position p of the sorted chunk, of slot s, at
//      base(s, chunk) + (p - the chunk's first position of s). Within a
//      slot the chunks follow each other in e order and each chunk's
//      entries are in e order, so start and ent are the one-block CSR's,
//      the dropped entries included. cnt lives in the scratch after ent
//      ([B, V + 1, chunks] int32).
// 2. write_rows, called by each writer block for the rows it owns: for
//    each (row, channel), the contributions of the row in CSR order, from
//    0.f, each product and each sum rounded once (__fmul_rn / __fadd_rn:
//    nothing is contracted into an FMA). That is the order and the rounding
//    of the plain version (index_add_ over the [B * 3 * N] terms on the CPU
//    adds them serially in e order), so both writers are bit-equal to it
//    and deterministic. A row's sum is a serial chain, hundreds of terms
//    long on a hot row of the coarse levels, so its time is the latency of
//    its loads: the block stages the rows' (t, w) in shared memory, a few
//    loads per thread, and each thread keeps 32 loads of g for its row in
//    flight (4 channels, 8 positions). Channels go kWriterThreads at a time:
//    C <= kWriterThreads (every configured level) is one pass over them, a
//    wider C takes ceil(C / kWriterThreads), each with the same sums.
//    g may be f32 or bf16 (elem.cuh): a bf16 cotangent is widened to f32 as
//    it is loaded, so the products and the sums are the f32 ones, and the
//    caller's store rounds the f32 sum to its output type once.
// The CSR lives in a scratch buffer that the wrapper allocates:
// start [B, V + 1], then ent [B, 3N], then (past kChunkEntries entries)
// cnt [B, V + 1, chunks], int32.

#pragma once

#include <cuda_runtime.h>

#include <cub/block/block_radix_sort.cuh>
#include <cub/block/block_scan.cuh>

#include "elem.cuh"

namespace inverse_index {
namespace {  // each source that includes this gets its own copy of the kernels

constexpr int kSortThreads = 1024;
constexpr int kSortItems = 6;  // entries per thread of a chunk's sort
// The entries one block sorts: a whole sample up to here, a chunk beyond.
constexpr int kChunkEntries = kSortThreads * kSortItems;

template <int kItems>
using ChunkSort = cub::BlockRadixSort<unsigned, kSortThreads, kItems, int>;

// Sorts the entries [e0, e0 + kSortThreads * kItems) of a sample (ib: its
// idx [m]) by slot, stably: key[i], val[i] of thread x are the sorted
// position x * kItems + i (a blocked arrangement), val the entry e. Past
// the entries, and for an idx outside [0, v), the key is v, after every
// slot.
template <int kItems>
__device__ __forceinline__ void sort_entries(typename ChunkSort<kItems>::TempStorage& tmp,
                                             const int* __restrict__ ib, int e0, int m,
                                             int v, int end_bit, unsigned (&key)[kItems],
                                             int (&val)[kItems]) {
#pragma unroll
  for (int i = 0; i < kItems; ++i) {  // a blocked arrangement: e rises with the thread
    const int e = e0 + threadIdx.x * kItems + i;
    key[i] = e < m ? min((unsigned)ib[e], (unsigned)v) : (unsigned)v;
    val[i] = e;
  }
  ChunkSort<kItems>(tmp).Sort(key, val, 0, end_bit);
}

// The first position of keys[0, len) whose key reaches s (keys ascending).
__device__ __forceinline__ int lower_bound(const unsigned* keys, int len, unsigned s) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (keys[mid] < s) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

template <int kItems>  // entries per thread of the sort
__global__ void __launch_bounds__(kSortThreads)
build_csr(const int* __restrict__ idx, int* __restrict__ start, int* __restrict__ ent,
          int m, int v, int end_bit) {
  __shared__ union {
    typename ChunkSort<kItems>::TempStorage sort;
    unsigned keys[kSortThreads * kItems];
  } smem;
  const int b = blockIdx.x;
  unsigned key[kItems];
  int val[kItems];
  sort_entries<kItems>(smem.sort, idx + (long long)b * m, 0, m, v, end_bit, key, val);
  int* eb = ent + (long long)b * m;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int p = threadIdx.x * kItems + i;
    if (p < m) eb[p] = val[i];
  }
  __syncthreads();  // the sort's storage becomes the sorted keys
#pragma unroll
  for (int i = 0; i < kItems; ++i) smem.keys[threadIdx.x * kItems + i] = key[i];
  __syncthreads();
  int* sb = start + (long long)b * (v + 1);
  for (int s = threadIdx.x; s <= v; s += kSortThreads) sb[s] = lower_bound(smem.keys, m, s);
}

// Past kChunkEntries entries: a block per (chunk, sample). Sorts its chunk
// and writes cnt[b, s, chunk], its entries of slot s, for s in [0, v]
// (slot v: the dropped entries).
__global__ void __launch_bounds__(kSortThreads)
chunk_counts(const int* __restrict__ idx, int* __restrict__ cnt, int m, int v,
             int end_bit) {
  __shared__ union {
    typename ChunkSort<kSortItems>::TempStorage sort;
    unsigned keys[kChunkEntries];
  } smem;
  const int chunk = blockIdx.x, chunks = gridDim.x, b = blockIdx.y;
  unsigned key[kSortItems];
  int val[kSortItems];
  sort_entries<kSortItems>(smem.sort, idx + (long long)b * m, chunk * kChunkEntries, m, v,
                           end_bit, key, val);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kSortItems; ++i) smem.keys[threadIdx.x * kSortItems + i] = key[i];
  __syncthreads();
  int* cb = cnt + (long long)b * (v + 1) * chunks + chunk;
  // the chunk's entries; the padding past them sorts last, with key v
  const int len = min(kChunkEntries, m - chunk * kChunkEntries);
  for (int s = threadIdx.x; s <= v; s += kSortThreads) {
    const int hi = s < v ? lower_bound(smem.keys, kChunkEntries, s + 1) : len;
    cb[(long long)s * chunks] = hi - lower_bound(smem.keys, kChunkEntries, s);
  }
}

// A block per sample: the exclusive scan of cnt[b] ([v + 1, chunks],
// slot-major) in place, each (slot, chunk)'s base in ent; start[b, s] = the
// base of (s, chunk 0) for s in [0, v].
constexpr int kScanItems = 4;

__global__ void __launch_bounds__(kSortThreads)
scan_counts(int* __restrict__ cnt, int* __restrict__ start, int v, int chunks) {
  using Scan = cub::BlockScan<int, kSortThreads>;
  __shared__ typename Scan::TempStorage tmp;
  const int b = blockIdx.x;
  const long long len = (long long)(v + 1) * chunks;
  int* cb = cnt + (long long)b * len;
  int carry = 0;  // the same in every thread: the sum of the tiles before
  for (long long t0 = 0; t0 < len; t0 += kSortThreads * kScanItems) {
    int x[kScanItems];
#pragma unroll
    for (int i = 0; i < kScanItems; ++i) {
      const long long j = t0 + threadIdx.x * kScanItems + i;
      x[i] = j < len ? cb[j] : 0;
    }
    int total;
    Scan(tmp).ExclusiveSum(x, x, total);
#pragma unroll
    for (int i = 0; i < kScanItems; ++i) {
      const long long j = t0 + threadIdx.x * kScanItems + i;
      if (j < len) cb[j] = carry + x[i];
    }
    carry += total;
    __syncthreads();  // tmp is reused by the next tile; the bases are written
  }
  int* sb = start + (long long)b * (v + 1);
  for (int s = threadIdx.x; s <= v; s += kSortThreads) sb[s] = cb[(long long)s * chunks];
}

// A block per (chunk, sample): sorts its chunk as chunk_counts did and puts
// each of its entries at its place in ent.
__global__ void __launch_bounds__(kSortThreads)
place_chunk(const int* __restrict__ idx, const int* __restrict__ base, int* __restrict__ ent,
            int m, int v, int end_bit) {
  __shared__ union {
    typename ChunkSort<kSortItems>::TempStorage sort;
    unsigned keys[kChunkEntries];
  } smem;
  const int chunk = blockIdx.x, chunks = gridDim.x, b = blockIdx.y;
  unsigned key[kSortItems];
  int val[kSortItems];
  sort_entries<kSortItems>(smem.sort, idx + (long long)b * m, chunk * kChunkEntries, m, v,
                           end_bit, key, val);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kSortItems; ++i) smem.keys[threadIdx.x * kSortItems + i] = key[i];
  __syncthreads();
  const int* bb = base + (long long)b * (v + 1) * chunks + chunk;
  int* eb = ent + (long long)b * m;
#pragma unroll
  for (int i = 0; i < kSortItems; ++i) {
    const unsigned s = key[i];
    if (val[i] < m) {  // not the padding
      const int p = threadIdx.x * kSortItems + i;
      eb[bb[(long long)s * chunks] + p - lower_bound(smem.keys, p, s)] = val[i];
    }
  }
}

// Chunks of kChunkEntries entries in m; 1 where one block sorts the sample.
inline int csr_chunks(int m) {
  return m <= kChunkEntries ? 1 : (m + kChunkEntries - 1) / kChunkEntries;
}

// Launches the inverse index for b samples of m = 3N entries over v slots
// on stream s; start, ent and (past kChunkEntries entries) cnt [b, v + 1,
// csr_chunks(m)] as above. Returns a CUDA error code.
inline int launch_csr(const int* idx, int* start, int* ent, int* cnt, int b, int m, int v,
                      cudaStream_t s) {
  if (b <= 0 || v <= 0) return (int)cudaSuccess;
  int end_bit = 0;  // the bits of v: keys lie in [0, v]
  while ((v >> end_bit) != 0) ++end_bit;
  if (m <= kSortThreads * 3) {
    build_csr<3><<<b, kSortThreads, 0, s>>>(idx, start, ent, m, v, end_bit);
  } else if (m <= kChunkEntries) {
    build_csr<kSortItems><<<b, kSortThreads, 0, s>>>(idx, start, ent, m, v, end_bit);
  } else {
    const dim3 blocks((unsigned)csr_chunks(m), (unsigned)b);
    chunk_counts<<<blocks, kSortThreads, 0, s>>>(idx, cnt, m, v, end_bit);
    scan_counts<<<b, kSortThreads, 0, s>>>(cnt, start, v, (int)blocks.x);
    place_chunk<<<blocks, kSortThreads, 0, s>>>(idx, cnt, ent, m, v, end_bit);
  }
  return (int)cudaGetLastError();
}

// The writers' blocks: kWriterThreads threads, one channel of one row
// each, each with kUnroll loads of g in flight; a C above kWriterThreads
// goes kWriterThreads channels at a time (write_rows<true>).
constexpr int kWriterThreads = 256;
constexpr int kUnroll = 32;
constexpr int kChunk = 1024;  // CSR positions staged in shared memory at a time

// A chunk of the CSR payload in shared memory: for each position, the
// query t(e) and the weight w[e] of its entry e.
struct Stage {
  int t[kChunk];
  float w[kChunk];
};

// g[i] widened to f32, through the read-only cache.
__device__ __forceinline__ float load_g(const float* __restrict__ p) { return __ldg(p); }
__device__ __forceinline__ float load_g(const __nv_bfloat16* __restrict__ p) {
  return __bfloat162float(__ldg(p));
}

// Writes the channels [c0, c0 + cw) of rows [0, rows) of a writer block,
// row r holding the CSR positions [sb[r], sb[r + 1]) of the sample (eb: its
// ent; wb: its w [3N]; gb: its g [N, C] of type G, f32 or bf16; cw <=
// kWriterThreads): for each (row, channel), the f32 sum from 0.f over the
// row's positions in order of w[e] * g[t(e), ch], each product and each
// sum rounded once, handed to store(row, ch, sum). Called by every thread
// of the block (it synchronises it). In passes of kWriterThreads / cw
// rows, one thread a (row, channel): the pass's positions, contiguous in
// the CSR, go through shared memory a chunk at a time, loaded by the whole
// block; then each thread adds its row's positions kUnroll at a time, the
// loads of g first.
template <typename G, typename Store>
__device__ __forceinline__ void write_slice(Stage& st, const int* __restrict__ sb, int rows,
                                            const int* __restrict__ eb,
                                            const float* __restrict__ wb,
                                            const G* __restrict__ gb, int n, int c, int c0,
                                            int cw, Store store) {
  const int pass_rows = kWriterThreads / cw;
  const int my_row = threadIdx.x / cw;  // in the pass; idle from pass_rows on
  const int ch = c0 + threadIdx.x - my_row * cw;
  for (int r0 = 0; r0 < rows; r0 += pass_rows) {
    const int r = r0 + my_row;
    const bool on_row = my_row < pass_rows && r < rows;
    const int lo = on_row ? sb[r] : 0;
    const int hi = on_row ? sb[r + 1] : 0;
    const int p0 = sb[r0], p1 = sb[min(rows, r0 + pass_rows)];  // the pass's positions
    float acc = 0.f;
    for (int q = p0; q < p1; q += kChunk) {
      const int qe = min(q + kChunk, p1);
      __syncthreads();  // the previous chunk is read
      for (int i = threadIdx.x; i < qe - q; i += kWriterThreads) {
        const int e = __ldg(eb + q + i);
        st.t[i] = e >= 2 * n ? e - 2 * n : (e >= n ? e - n : e);
        st.w[i] = __ldg(wb + e);
      }
      __syncthreads();
      const int a = max(lo, q) - q;
      const int len = max(0, min(hi, qe) - q - a);
      int k = 0;
      for (; k + kUnroll <= len; k += kUnroll) {  // whole steps
        float gv[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) gv[u] = load_g(gb + (long long)st.t[a + k + u] * c + ch);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) acc = __fadd_rn(acc, __fmul_rn(st.w[a + k + u], gv[u]));
      }
      for (; k < len; ++k) {  // the tail
        acc = __fadd_rn(acc, __fmul_rn(st.w[a + k], load_g(gb + (long long)st.t[a + k] * c + ch)));
      }
    }
    if (on_row) store(r, ch, acc);
  }
}

// write_slice over every channel of [N, C] g. kSliced false (C <=
// kWriterThreads, every configured level): one slice, compiled on its own,
// as the writers were before C had slices; true: slices of kWriterThreads
// channels, one after the other. The launch picks by C.
template <bool kSliced, typename G, typename Store>
__device__ __forceinline__ void write_rows(Stage& st, const int* __restrict__ sb, int rows,
                                           const int* __restrict__ eb,
                                           const float* __restrict__ wb,
                                           const G* __restrict__ gb, int n, int c,
                                           Store store) {
  if (!kSliced) {
    write_slice(st, sb, rows, eb, wb, gb, n, c, 0, c, store);
    return;
  }
  for (int c0 = 0; c0 < c; c0 += kWriterThreads) {
    write_slice(st, sb, rows, eb, wb, gb, n, c, c0, min(c - c0, kWriterThreads), store);
  }
}

}  // namespace
}  // namespace inverse_index
