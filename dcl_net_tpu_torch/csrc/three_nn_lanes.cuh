// The one kernel body of the masked 3-NN interpolation, shared by K3
// (interp.cu), which reads f32 voxel centers, and K6 (fused.cu), which reads
// the compaction's int32 voxel coordinates and decodes them into centers in
// shared memory. The two differ only in their row source (CenterRows,
// CoordRows below): the scan, the merge, the weights and the epilogue are
// this file's, so K6 is bit-equal to K3 on the centers K3 would be given.
//
// Per block: the sample's valid prefix of rows is copied into shared memory
// by the copy engine (one bulk copy of the rows, one of the mask); S lanes of
// one warp scan a query's centers together and merge their top 3 by warp
// shuffles; the whole block then writes the output rows, float4 along
// channels, with the gathers of several rows in flight.
//
// The selection equals a sequential strict-< scan in ascending j: lane s of
// a query scans the centers j = s, s + S, s + 2S, ... in ascending j with
// strict <, so it keeps the three smallest (d, j) of its share in
// lexicographic order; the merge keeps the three smallest (d, j) of the
// union in the same order, and a sequential strict-< scan in ascending j
// keeps exactly those. The distances are sq_dist (no FMA contraction);
// tensor cores are not used: the expansion form |p|^2 + |c|^2 - 2 p.c that a
// wgmma product would need rounds differently and changes idx on near-ties.
//
// The features and the output have an element type T: float, or
// __nv_bfloat16 for the bf16 variants of K3 and K6 (model.compute_dtype:
// bfloat16). Points, rows, mask, distances and weights are f32 in both, so
// the bf16 variant selects the same idx and w as the f32 one; its epilogue
// loads bf16 features 8 to a 16-byte access, takes them to f32, sums the
// same f32 products in the same order and rounds the sum to bf16 once,
// which is what the JAX package's bf16 Pallas kernels compute (an f32
// product of the weights with the features, cast to the feature dtype).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "elem.cuh"

namespace three_nn_lanes {

constexpr float kBig = 1e10f;
constexpr int kTileRows = 2048;  // rows in shared memory at once (32 KB)
constexpr int kGatherRows = 2;   // output rows whose gathers are in flight together

// The three smallest squared distances seen so far and their indices.
// Strict < keeps the lowest index among equal distances.
struct Top3 {
  float d0, d1, d2;
  int j0, j1, j2;

  __device__ __forceinline__ Top3() {
    d0 = d1 = d2 = __int_as_float(0x7f800000);  // +inf
    j0 = j1 = j2 = -1;
  }

  __device__ __forceinline__ void push(float d, int j) {
    if (d < d2) {
      if (d < d1) {
        d2 = d1;
        j2 = j1;
        if (d < d0) {
          d1 = d0;
          j1 = j0;
          d0 = d;
          j0 = j;
        } else {
          d1 = d;
          j1 = j;
        }
      } else {
        d2 = d;
        j2 = j;
      }
    }
  }

  // Missing slots: the reference's argmin over an all-1e10 row is index 0.
  __device__ __forceinline__ void fill_missing() {
    if (j0 < 0) { j0 = 0; d0 = kBig; }
    if (j1 < 0) { j1 = 0; d1 = kBig; }
    if (j2 < 0) { j2 = 0; d2 = kBig; }
  }
};

// Squared distance by direct differences summed over axes 0, 1, 2 in that
// order, without FMA contraction, as the plain version computes it.
__device__ __forceinline__ float sq_dist(float px, float py, float pz, const float* c) {
  const float e0 = px - c[0], e1 = py - c[1], e2 = pz - c[2];
  float d = __fmul_rn(e0, e0);
  d = __fadd_rn(d, __fmul_rn(e1, e1));
  return __fadd_rn(d, __fmul_rn(e2, e2));
}

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
      d[u] = sq_dist(px, py, pz, ctr + 3 * j);
      ok[u] = msk[j] > 0.f;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (ok[u]) top.push(d[u], base + t + u * S);
  }
  for (; t < len; t += S) {
    const float d = sq_dist(px, py, pz, ctr + 3 * t);
    if (msk[t] > 0.f) top.push(d, base + t);
  }
}

// The weights w_k = (1 / (d_k + 1e-8)) * (1 / sum_j 1 / (d_j + 1e-8)) of a
// merged top 3 after fill_missing, each product and sum rounded once.
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

// combine over 8 bf16 channels packed in 16 bytes: each taken to f32,
// combined as above, and the result rounded to bf16 once.
__device__ __forceinline__ uint4 combine(float w0, uint4 a, float w1, uint4 b, float w2,
                                         uint4 c) {
  const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
  const __nv_bfloat162* c2 = reinterpret_cast<const __nv_bfloat162*>(&c);
  uint4 o;
  __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(a2[i]);
    const float2 y = __bfloat1622float2(b2[i]);
    const float2 z = __bfloat1622float2(c2[i]);
    const float4 r = combine(w0, make_float4(x.x, x.y, 0.f, 0.f), w1,
                             make_float4(y.x, y.y, 0.f, 0.f), w2,
                             make_float4(z.x, z.y, 0.f, 0.f));
    o2[i] = __floats2bfloat162_rn(r.x, r.y);
  }
  return o;
}

// The output rows out[q0 + qi] = sum_k w_k * feats[idx_k] of the block's nq
// queries, from their indices and weights in shared memory (Q entries a
// row), by all kThreads threads of the block. vec (C a multiple of E, the
// elements of T in 16 bytes, 16-byte aligned rows, kThreads % (C / E) == 0):
// each thread keeps one 16-byte column k and walks the queries
// kThreads / (C / E) apart, kUnroll queries a step in whole unpredicated
// steps (their 3 * kUnroll gathers issued before any add), then a tail;
// else one element at a time. The sum is (w0 f0 + w1 f1) + w2 f2 in f32,
// rounded per product, then rounded to T.
template <int Q, int kThreads, int kUnroll, class T>
__device__ __forceinline__ void write_rows(int (*s_idx)[Q], float (*s_w)[Q],
                                           int nq, int c, bool vec,
                                           const T* __restrict__ fb,
                                           T* __restrict__ ob) {
  // float4 for f32, uint4 (8 bf16) for bf16: one 16-byte access either way
  using V = typename std::conditional<std::is_same<T, float>::value, float4, uint4>::type;
  if (vec) {
    const int c4 = c / elem::per_vec<T>();
    const int k = threadIdx.x % c4;
    const int step = kThreads / c4;
    const V* f4 = reinterpret_cast<const V*>(fb) + k;
    V* o4 = reinterpret_cast<V*>(ob) + k;
    int qi = threadIdx.x / c4;
    for (; qi + (kUnroll - 1) * step < nq; qi += kUnroll * step) {
      V f[kUnroll][3];
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
  for (int e = threadIdx.x; e < nq * c; e += kThreads) {
    const int qi = e / c;
    const int ch = e - qi * c;
    const float a0 = __fmul_rn(s_w[0][qi], elem::to_float(fb[(long long)s_idx[0][qi] * c + ch]));
    const float a1 = __fmul_rn(s_w[1][qi], elem::to_float(fb[(long long)s_idx[1][qi] * c + ch]));
    const float a2 = __fmul_rn(s_w[2][qi], elem::to_float(fb[(long long)s_idx[2][qi] * c + ch]));
    ob[e] = elem::from_float<T>(__fadd_rn(__fadd_rn(a0, a1), a2));
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

// ---- the row sources: 3 words of 4 bytes a row, so one tile layout serves both

// K3's rows: f32 centers [B, V, 3], scanned as they are.
struct CenterRows {
  const float* src;
  static constexpr bool kDecode = false;
  __device__ __forceinline__ float word(long long i) const { return src[i]; }
};

// K6's rows: K2's int32 voxel coordinates [B, cap, 3]. The tile holds their
// bits until decode() turns each into its center in place,
//   c_a = __fadd_rn(__fmul_rn((float)i_a, unit_s[a]), off_c[a]),
// one rounded product then one rounded sum, which is what the two-stage
// path's `coords * unit + shift` computes in two passes.
struct CoordRows {
  const int* src;
  float us0, us1, us2, oc0, oc1, oc2;
  static constexpr bool kDecode = true;
  __device__ __forceinline__ float word(long long i) const { return __int_as_float(src[i]); }
  // Rows [0, len) of the tile, row r by thread r mod blockDim.x (a stride of
  // 3 words: no bank conflicts).
  __device__ __forceinline__ void decode(float* ctr, int len) const {
    for (int r = threadIdx.x; r < len; r += blockDim.x) {
      float* x = ctr + 3 * r;
      x[0] = __fadd_rn(__fmul_rn(__int2float_rn(__float_as_int(x[0])), us0), oc0);
      x[1] = __fadd_rn(__fmul_rn(__int2float_rn(__float_as_int(x[1])), us1), oc1);
      x[2] = __fadd_rn(__fmul_rn(__int2float_rn(__float_as_int(x[2])), us2), oc2);
    }
  }
};

// ---- the kernel: grid (query tiles of Q, B), S * Q threads, 16 B of dynamic
// shared memory a tile row

template <int S, int Q, class Rows, class T>
__global__ void __launch_bounds__(S * Q)
three_nn_rows(const float* __restrict__ points, Rows rows, const T* __restrict__ feats,
              const float* __restrict__ mask, const int* __restrict__ n_valid,
              T* __restrict__ out, float* __restrict__ w_out, int* __restrict__ idx_out,
              int n, int v, int c, int tile_rows, int bulk_ok, int vec) {
  extern __shared__ __align__(128) float tile[];  // rows [tile_rows, 3], then mask
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
  if (threadIdx.x == 0) mbar_init(&bar, 1);
  __syncthreads();
  const long long row0 = (long long)b * v;
  Top3 top;
  uint32_t phase = 0;
  for (int base = 0; base < nv; base += tile_rows) {
    const int len = min(tile_rows, nv - base);
    const int len4 = (len + 3) & ~3;
    if (base > 0) __syncthreads();  // every lane is done with the last tile
    if (bulk_ok && ((row0 + base) & 3) == 0 && base + len4 <= v) {
      if (threadIdx.x == 0) {
        if (base > 0) fence_async_shared();
        mbar_expect_bytes(&bar, 16u * len4);
        bulk_load(ctr, rows.src + (row0 + base) * 3, 12u * len4, &bar);
        bulk_load(msk, mask + row0 + base, 4u * len4, &bar);
      }
      mbar_wait(&bar, phase);
      phase ^= 1u;
    } else {
      const long long w0 = (row0 + base) * 3;
      for (int i = threadIdx.x; i < 3 * len; i += S * Q) ctr[i] = rows.word(w0 + i);
      for (int i = threadIdx.x; i < len; i += S * Q) msk[i] = mask[row0 + base + i];
      __syncthreads();
    }
    if constexpr (Rows::kDecode) {
      rows.decode(ctr, len);
      // the decode's generic-proxy writes before the next tile's bulk copy
      if (base + tile_rows < nv) fence_async_shared();
      __syncthreads();
    }
    scan_share<S>(top, ctr, msk, len, base, share, px, py, pz);
  }
  merge_lanes<S>(top);
  if (active && share == 0) {
    top.fill_missing();
    float w0, w1, w2;
    weights(top, w0, w1, w2);
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
  write_rows<Q, S * Q, kGatherRows>(s_idx, s_w, min(Q, n - q0), c, vec, feats + row0 * c,
                                out + ((long long)b * n + q0) * c);
}

template <int S, int Q, class Rows, class T>
int launch_shape(const float* points, Rows rows, const T* feats, const float* mask,
                 const int* n_valid, T* out, float* w, int* idx, int b, int n, int v,
                 int c, cudaStream_t s) {
  constexpr int kThreads = S * Q;
  const int tile_rows = min(kTileRows, (v + 3) & ~3);
  const auto aligned = [](const void* p) {
    return reinterpret_cast<unsigned long long>(p) % 16 == 0;
  };
  const int bulk_ok = aligned(rows.src) && aligned(mask);
  constexpr int kPer = elem::per_vec<T>();
  const int vec = c > 0 && c % kPer == 0 && kThreads % (c / kPer) == 0 && aligned(feats) &&
                  aligned(out);
  const dim3 grid((unsigned)((n + Q - 1) / Q), (unsigned)b);
  three_nn_rows<S, Q, Rows, T><<<grid, kThreads, (size_t)16 * tile_rows, s>>>(
      points, rows, feats, mask, n_valid, out, w, idx, n, v, c, tile_rows, bulk_ok, vec);
  return (int)cudaGetLastError();
}

// points [B,N,3] f32, rows [B,V,3] (the source's type), feats [B,V,C] T,
// mask [B,V] f32; n_valid [B] i32 or null (scan rows [0, min(n_valid[b], V)),
// which must hold every row with mask > 0; null: all V rows); out [B,N,C]
// T, w [B,3,N] f32, idx [B,3,N] i32. lanes (S) in {2, 4, 8} and queries
// (Q) in {32, 64, 128}: the block's shape; another pair returns
// cudaErrorInvalidValue.
template <class Rows, class T>
int launch(const float* points, Rows rows, const T* feats, const float* mask,
           const int* n_valid, T* out, float* w, int* idx, int b, int n, int v, int c,
           int lanes, int queries, cudaStream_t s) {
  if (b <= 0 || n <= 0) return (int)cudaGetLastError();
#define DCLX_THREE_NN_CASE(S, Q)                                                        \
  if (lanes == S && queries == Q)                                                       \
    return launch_shape<S, Q>(points, rows, feats, mask, n_valid, out, w, idx, b, n, v, \
                              c, s);
  DCLX_THREE_NN_CASE(2, 32) DCLX_THREE_NN_CASE(2, 64) DCLX_THREE_NN_CASE(2, 128)
  DCLX_THREE_NN_CASE(4, 32) DCLX_THREE_NN_CASE(4, 64) DCLX_THREE_NN_CASE(4, 128)
  DCLX_THREE_NN_CASE(8, 32) DCLX_THREE_NN_CASE(8, 64) DCLX_THREE_NN_CASE(8, 128)
#undef DCLX_THREE_NN_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace three_nn_lanes
