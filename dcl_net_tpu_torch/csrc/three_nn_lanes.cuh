// Device code of K3 (interp.cu), the masked 3-NN interpolation: S lanes of
// one warp scan a query's centers together, from a shared-memory copy of
// the sample's valid prefix that the copy engine brings in, then merge
// their top 3 by warp shuffles; the whole block then writes the output
// rows, float4 along channels, with the gathers of several rows in flight.
//
// The selection is bit-equal to the one-thread-per-query scan of
// three_nn.cuh (which K6, fused.cu, still uses): lane s of a query scans
// the centers j = s, s + S, s + 2S, ... in ascending j with strict <, so it
// keeps the three smallest (d, j) of its share in lexicographic order; the
// merge keeps the three smallest (d, j) of the union in the same order, and
// a sequential strict-< scan in ascending j keeps exactly those. The
// distances are three_nn::sq_dist (no FMA contraction); tensor cores are
// not used: the expansion form |p|^2 + |c|^2 - 2 p.c that a wgmma product
// would need rounds differently and changes idx on near-ties.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "three_nn.cuh"

namespace three_nn_lanes {

using three_nn::Top3;

// (d, j) before (e, k) in lexicographic order. An empty slot is (+inf, -1)
// and never holds a real candidate's place: a scanned d is always < +inf.
__device__ __forceinline__ bool before(float d, int j, float e, int k) {
  return d < e || (d == e && j < k);
}

__device__ __forceinline__ void push_lex(Top3& t, float d, int j) {
  if (before(d, j, t.d2, t.j2)) {
    if (before(d, j, t.d1, t.j1)) {
      t.d2 = t.d1;
      t.j2 = t.j1;
      if (before(d, j, t.d0, t.j0)) {
        t.d1 = t.d0;
        t.j1 = t.j0;
        t.d0 = d;
        t.j0 = j;
      } else {
        t.d1 = d;
        t.j1 = j;
      }
    } else {
      t.d2 = d;
      t.j2 = j;
    }
  }
}

// Butterfly merge over the S adjacent lanes of a query (S a power of two
// <= 32): afterwards every lane of the group holds the group's top 3.
template <int S>
__device__ __forceinline__ void merge_lanes(Top3& t) {
#pragma unroll
  for (int off = S / 2; off > 0; off >>= 1) {
    const float e0 = __shfl_xor_sync(0xffffffffu, t.d0, off);
    const float e1 = __shfl_xor_sync(0xffffffffu, t.d1, off);
    const float e2 = __shfl_xor_sync(0xffffffffu, t.d2, off);
    const int k0 = __shfl_xor_sync(0xffffffffu, t.j0, off);
    const int k1 = __shfl_xor_sync(0xffffffffu, t.j1, off);
    const int k2 = __shfl_xor_sync(0xffffffffu, t.j2, off);
    push_lex(t, e0, k0);
    push_lex(t, e1, k1);
    push_lex(t, e2, k2);
  }
}

// Lane `share` of S scans centers share, share + S, ... of a shared-memory
// tile of `len` centers (xyz [len, 3], mask [len]; mask <= 0 is never
// selected) whose first center has index `base`. Four centers a round,
// their loads and distances before their pushes, in ascending j.
template <int S>
__device__ __forceinline__ void scan_share(Top3& top, const float* ctr, const float* msk,
                                           int len, int base, int share, float px,
                                           float py, float pz) {
  int t = share;
  for (; t + 3 * S < len; t += 4 * S) {
    float d[4];
    bool ok[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = t + u * S;
      d[u] = three_nn::sq_dist(px, py, pz,
                               make_float4(ctr[3 * j], ctr[3 * j + 1], ctr[3 * j + 2], 0.f));
      ok[u] = msk[j] > 0.f;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (ok[u]) top.push(d[u], base + t + u * S);
  }
  for (; t < len; t += S) {
    const float d = three_nn::sq_dist(
        px, py, pz, make_float4(ctr[3 * t], ctr[3 * t + 1], ctr[3 * t + 2], 0.f));
    if (msk[t] > 0.f) top.push(d, base + t);
  }
}

// The weights w_k = (1 / (d_k + 1e-8)) * (1 / sum_j 1 / (d_j + 1e-8)) of a
// merged top 3 after fill_missing, rounded as three_nn::write_block does.
__device__ __forceinline__ void weights(const Top3& top, float& w0, float& w1, float& w2) {
  const float r0 = 1.f / (top.d0 + 1e-8f);
  const float r1 = 1.f / (top.d1 + 1e-8f);
  const float r2 = 1.f / (top.d2 + 1e-8f);
  const float inv = 1.f / __fadd_rn(__fadd_rn(r0, r1), r2);
  w0 = __fmul_rn(r0, inv);
  w1 = __fmul_rn(r1, inv);
  w2 = __fmul_rn(r2, inv);
}

__device__ __forceinline__ float4 combine(float w0, float4 a, float w1, float4 b, float w2,
                                          float4 c) {
  float4 o;
  o.x = __fadd_rn(__fadd_rn(__fmul_rn(w0, a.x), __fmul_rn(w1, b.x)), __fmul_rn(w2, c.x));
  o.y = __fadd_rn(__fadd_rn(__fmul_rn(w0, a.y), __fmul_rn(w1, b.y)), __fmul_rn(w2, c.y));
  o.z = __fadd_rn(__fadd_rn(__fmul_rn(w0, a.z), __fmul_rn(w1, b.z)), __fmul_rn(w2, c.z));
  o.w = __fadd_rn(__fadd_rn(__fmul_rn(w0, a.w), __fmul_rn(w1, b.w)), __fmul_rn(w2, c.w));
  return o;
}

// The output rows out[q0 + qi] = sum_k w_k * feats[idx_k] of the block's nq
// queries, from their indices and weights in shared memory (Q entries a
// row), by all T threads of the block. vec (C % 4 == 0, 16-byte aligned
// rows, T % (C / 4) == 0): each thread keeps one float4 column k and walks the queries
// T / (C / 4) apart, kUnroll queries a step in whole unpredicated steps
// (their 3 * kUnroll gathers issued before any add), then a tail; else one
// float at a time. The sum is (w0 f0 + w1 f1) + w2 f2, rounded per product.
template <int Q, int T, int kUnroll>
__device__ __forceinline__ void write_rows(int (*s_idx)[Q], float (*s_w)[Q],
                                           int nq, int c, bool vec,
                                           const float* __restrict__ fb,
                                           float* __restrict__ ob) {
  if (vec) {
    const int c4 = c >> 2;
    const int k = threadIdx.x % c4;
    const int step = T / c4;
    const float4* f4 = reinterpret_cast<const float4*>(fb) + k;
    float4* o4 = reinterpret_cast<float4*>(ob) + k;
    int qi = threadIdx.x / c4;
    for (; qi + (kUnroll - 1) * step < nq; qi += kUnroll * step) {
      float4 f[kUnroll][3];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int m = 0; m < 3; ++m)
          f[u][m] = __ldg(f4 + (long long)s_idx[m][qi + u * step] * c4);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int q = qi + u * step;
        o4[(long long)q * c4] =
            combine(s_w[0][q], f[u][0], s_w[1][q], f[u][1], s_w[2][q], f[u][2]);
      }
    }
    for (; qi < nq; qi += step)
      o4[(long long)qi * c4] =
          combine(s_w[0][qi], __ldg(f4 + (long long)s_idx[0][qi] * c4), s_w[1][qi],
                  __ldg(f4 + (long long)s_idx[1][qi] * c4), s_w[2][qi],
                  __ldg(f4 + (long long)s_idx[2][qi] * c4));
    return;
  }
  for (int e = threadIdx.x; e < nq * c; e += T) {
    const int qi = e / c;
    const int ch = e - qi * c;
    const float a0 = __fmul_rn(s_w[0][qi], fb[(long long)s_idx[0][qi] * c + ch]);
    const float a1 = __fmul_rn(s_w[1][qi], fb[(long long)s_idx[1][qi] * c + ch]);
    const float a2 = __fmul_rn(s_w[2][qi], fb[(long long)s_idx[2][qi] * c + ch]);
    ob[e] = __fadd_rn(__fadd_rn(a0, a1), a2);
  }
}

// ---- the copy engine: one bulk copy global -> shared, completion on an mbarrier

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_bytes(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// bytes: a multiple of 16; dst and src 16-byte aligned.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Orders this thread's earlier generic-proxy accesses of shared memory
// before later async-proxy (bulk copy) writes to it.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

}  // namespace three_nn_lanes
