// Device code shared by the two backward kernels of the masked 3-NN
// interpolation: K4 (interp.cu), which writes the gradient of the compacted
// rows [B, V, C], and K7 (fused.cu), which writes it straight onto the
// dense grid. Both compute
//   d[b, idx[b, k, t], :] += w[b, k, t] * g[b, t, :]
// with no atomics: each output row is written once by the thread block that
// owns it, as the ordered sum of its own contributions.
//
// 1. The inverse index (build_csr, one block per sample): a stable CSR of
//    the sample's 3N contributions by slot. An entry is e = k * N + t, its
//    place in the [3, N] idx and w of the sample. start[b, 0..V] holds the
//    offsets and ent[b, 0..3N) the entry ids, ascending e within each slot.
//    A block radix sort (CUB's block-level primitives) sorts the entries by
//    slot; LSD radix sorting is stable, and the entries go in in e order,
//    so each slot's entries come out in e order. The offsets are then a
//    binary search of the sorted slots for each s in [0, V]. An idx outside
//    [0, V) sorts past start[V] and is dropped.
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
//    flight (4 channels, 8 positions).
// The CSR lives in a scratch buffer that the wrapper allocates:
// start [B, V + 1] then ent [B, 3N], int32.

#pragma once

#include <cuda_runtime.h>

#include <cub/block/block_radix_sort.cuh>

namespace inverse_index {
namespace {  // each source that includes this gets its own copy of the kernels

constexpr int kSortThreads = 1024;

template <int kItems>  // entries per thread of the sort
__global__ void __launch_bounds__(kSortThreads)
build_csr(const int* __restrict__ idx, int* __restrict__ start, int* __restrict__ ent,
          int m, int v, int end_bit) {
  using Sort = cub::BlockRadixSort<unsigned, kSortThreads, kItems, int>;
  __shared__ union {
    typename Sort::TempStorage sort;
    unsigned keys[kSortThreads * kItems];
  } smem;
  const int b = blockIdx.x;
  const int* ib = idx + (long long)b * m;
  unsigned key[kItems];
  int val[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {  // a blocked arrangement: e rises with the thread
    const int e = threadIdx.x * kItems + i;
    // past the entries, and for an idx outside [0, v): key v, after every slot
    key[i] = e < m ? min((unsigned)ib[e], (unsigned)v) : (unsigned)v;
    val[i] = e;
  }
  Sort(smem.sort).Sort(key, val, 0, end_bit);
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
  for (int s = threadIdx.x; s <= v; s += kSortThreads) {
    int lo = 0, hi = m;  // the first position whose slot reaches s
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (smem.keys[mid] < (unsigned)s) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    sb[s] = lo;
  }
}

// The most entries (3N) of one sample that build_csr sorts in one block.
constexpr int kMaxEntries = kSortThreads * 6;

// Launches build_csr for b samples of m = 3N entries over v slots on
// stream s; start and ent as above. Returns a CUDA error code.
inline int launch_csr(const int* idx, int* start, int* ent, int b, int m, int v,
                      cudaStream_t s) {
  if (b <= 0 || v <= 0) return (int)cudaSuccess;
  if (m > kMaxEntries) return (int)cudaErrorInvalidValue;
  int end_bit = 0;  // the bits of v: keys lie in [0, v]
  while ((v >> end_bit) != 0) ++end_bit;
  if (m <= kSortThreads * 3) {
    build_csr<3><<<b, kSortThreads, 0, s>>>(idx, start, ent, m, v, end_bit);
  } else {
    build_csr<6><<<b, kSortThreads, 0, s>>>(idx, start, ent, m, v, end_bit);
  }
  return (int)cudaGetLastError();
}

// The writers' blocks: kWriterThreads threads, one channel of one row
// each (so C <= kWriterThreads), each with kUnroll loads of g in flight.
constexpr int kWriterThreads = 256;
constexpr int kUnroll = 32;
constexpr int kChunk = 1024;  // CSR positions staged in shared memory at a time

// A chunk of the CSR payload in shared memory: for each position, the
// query t(e) and the weight w[e] of its entry e.
struct Stage {
  int t[kChunk];
  float w[kChunk];
};

// Writes rows [0, rows) of a writer block, row r holding the CSR positions
// [sb[r], sb[r + 1]) of the sample (eb: its ent; wb: its w [3N]; gb: its g
// [N, C], C <= kWriterThreads): for each (row, channel), the sum from 0.f
// over the row's positions in order of w[e] * g[t(e), ch], each product
// and each sum rounded once, handed to store(row, ch, sum). Called by every
// thread of the block (it synchronises it). In passes of kWriterThreads / C
// rows, one thread a (row, channel): the pass's positions, contiguous in
// the CSR, go through shared memory a chunk at a time, loaded by the whole
// block; then each thread adds its row's positions kUnroll at a time, the
// loads of g first.
template <typename Store>
__device__ __forceinline__ void write_rows(Stage& st, const int* __restrict__ sb, int rows,
                                           const int* __restrict__ eb,
                                           const float* __restrict__ wb,
                                           const float* __restrict__ gb, int n, int c,
                                           Store store) {
  const int pass_rows = kWriterThreads / c;
  const int my_row = threadIdx.x / c;  // in the pass; idle from pass_rows on
  const int ch = threadIdx.x - my_row * c;
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
        for (int u = 0; u < kUnroll; ++u) gv[u] = __ldg(gb + (long long)st.t[a + k + u] * c + ch);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) acc = __fadd_rn(acc, __fmul_rn(st.w[a + k + u], gv[u]));
      }
      for (; k < len; ++k) {  // the tail
        acc = __fadd_rn(acc, __fmul_rn(st.w[a + k], __ldg(gb + (long long)st.t[a + k] * c + ch)));
      }
    }
    if (on_row) store(r, ch, acc);
  }
}

}  // namespace
}  // namespace inverse_index
