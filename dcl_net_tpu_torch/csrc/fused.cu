// K6: masked 3-NN inverse-squared-distance interpolation over the
// compaction's output, with the voxel centers decoded in the kernel.
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

#include <cuda_runtime.h>

#include "three_nn.cuh"

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
