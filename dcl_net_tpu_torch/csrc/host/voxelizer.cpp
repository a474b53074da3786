// Host-side voxelizer: C++ twin of the reference's CPU hash-map voxelization
// (reference libs/pointgroup_ops/src/voxelize/voxelize.cpp:10-152).
//
// The port's own copy of the root csrc/voxelizer.cpp, built by
// dcl_net_tpu_torch/ops/cpu_voxelizer.py at first use. The model voxelizes
// on the device (kernel K1, dcl_net_tpu_torch/ops/cuda_voxelize.py); this
// library is the native equivalent of the reference's collate-time path.
//
// Exposed via a C ABI for ctypes (no pybind11).

#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct Key {
  int64_t b, x, y, z;
  bool operator==(const Key& o) const {
    return b == o.b && x == o.x && y == o.y && z == o.z;
  }
};

struct KeyHash {
  size_t operator()(const Key& k) const {
    // 64-bit mix of the four coordinates (grids are small, collisions rare)
    uint64_t h = (uint64_t)k.b;
    h = h * 0x9E3779B97F4A7C15ull + (uint64_t)k.x;
    h = h * 0x9E3779B97F4A7C15ull + (uint64_t)k.y;
    h = h * 0x9E3779B97F4A7C15ull + (uint64_t)k.z;
    h ^= h >> 29;
    h *= 0xBF58476D1CE4E5B9ull;
    h ^= h >> 32;
    return (size_t)h;
  }
};

}  // namespace

extern "C" {

// Build the point->voxel map over (b,x,y,z) coords.
//   coords:        [n, 4] int64 (batch id + 3 voxel indices)
//   input_map:     [n] int32 out: point -> voxel slot (first-seen order,
//                  matching the reference's insertion-order slot ids)
//   output_coords: [capacity, 4] int64 out: slot -> coords
//   output_counts: [capacity] int32 out: points per voxel
// Returns the number of unique voxels M (clamped to capacity; extra unique
// voxels map to slot -1 in input_map, never happens when capacity >= n).
int voxelize_idx(const int64_t* coords, int n, int32_t* input_map,
                 int64_t* output_coords, int32_t* output_counts,
                 int capacity) {
  std::unordered_map<Key, int, KeyHash> grid;
  grid.reserve((size_t)n * 2);
  int m = 0;
  for (int i = 0; i < n; ++i) {
    Key k{coords[i * 4 + 0], coords[i * 4 + 1], coords[i * 4 + 2],
          coords[i * 4 + 3]};
    auto it = grid.find(k);
    int slot;
    if (it == grid.end()) {
      if (m < capacity) {
        slot = m++;
        grid.emplace(k, slot);
        std::memcpy(output_coords + (int64_t)slot * 4, coords + (int64_t)i * 4,
                    4 * sizeof(int64_t));
        output_counts[slot] = 0;
      } else {
        input_map[i] = -1;
        continue;
      }
    } else {
      slot = it->second;
    }
    input_map[i] = slot;
    output_counts[slot] += 1;
  }
  return m;
}

// Scatter point features into voxel slots.
//   feats: [n, c] float32; input_map: [n] int32 (from voxelize_idx)
//   out:   [m, c] float32 (zero-initialized by caller)
//   mode: 3 = sum, 4 = mean (reference voxelize.cpp:119-152; NOTE its :51
//   comment swaps modes 1/2 vs the code — see tests/test_golden_voxelize.py)
void voxelize_feats(const float* feats, const int32_t* input_map, int n, int c,
                    float* out, const int32_t* counts, int m, int mode) {
  for (int i = 0; i < n; ++i) {
    int slot = input_map[i];
    if (slot < 0) continue;
    const float* src = feats + (int64_t)i * c;
    float* dst = out + (int64_t)slot * c;
    for (int j = 0; j < c; ++j) dst[j] += src[j];
  }
  if (mode == 4) {
    for (int s = 0; s < m; ++s) {
      float inv = counts[s] > 0 ? 1.0f / (float)counts[s] : 0.0f;
      float* dst = out + (int64_t)s * c;
      for (int j = 0; j < c; ++j) dst[j] *= inv;
    }
  }
}

// Map voxel features back to points (reference point_recover,
// libs/pointgroup_ops/functions/pointgroup_ops.py:78-112).
void point_recover(const float* voxel_feats, const int32_t* input_map, int n,
                   int c, float* out) {
  for (int i = 0; i < n; ++i) {
    int slot = input_map[i];
    float* dst = out + (int64_t)i * c;
    if (slot < 0) {
      std::memset(dst, 0, sizeof(float) * c);
      continue;
    }
    std::memcpy(dst, voxel_feats + (int64_t)slot * c, sizeof(float) * c);
  }
}

}  // extern "C"
