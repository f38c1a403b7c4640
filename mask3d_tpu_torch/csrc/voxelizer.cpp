// Native host-side voxelizer: truncate -> shift -> sort -> unique.
//
// A copy of cpp/voxelizer.cpp, built by mask3d_tpu_torch/native.py with
// g++ and bound with ctypes (plain C interface). The port binds all of it:
// voxelize_f32, downsample_f64 and the two u8 encoders; and one function
// of its own, png_unfilter (the depth PNG reader's unfilter step,
// mask3d_tpu_torch/preprocess/png.py), at the end of this file.
//
// Semantics (must match mask3d_tpu_torch/data/collate.py::voxelize_item):
// - float -> int32 truncation toward zero (torch .int() semantics)
// - per-item shift so coords are non-negative
// - duplicates removed keeping the row with the smallest ORIGINAL index
//   among equal voxels (np.unique(..., return_index=True) semantics)
// - output sorted ascending by key = (x*Dy + y)*Dz + z

#include <algorithm>
#include <array>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>
#include <cmath>

namespace {

// Stable LSD radix sort over the low `total_bits` bits of packed u64
// values. With values packed as (key << idx_bits) | idx this sorts by
// (key, idx) — identical order to the comparison sort it replaces, at
// O(passes * n) instead of O(n log n) with branchy 16-byte-struct swaps
// (~3x faster on the 40k-point items of the hot collation path).
void radix_sort_u64(std::vector<uint64_t>& a, int total_bits) {
  std::vector<uint64_t> tmp(a.size());
  const int passes = (total_bits + 7) / 8;
  for (int p = 0; p < passes; ++p) {
    const int shift = p * 8;
    size_t cnt[257] = {0};
    for (uint64_t v : a) ++cnt[((v >> shift) & 0xFF) + 1];
    for (int i = 0; i < 256; ++i) cnt[i + 1] += cnt[i];
    for (uint64_t v : a) tmp[cnt[(v >> shift) & 0xFF]++] = v;
    a.swap(tmp);
  }
}

int bits_for(uint64_t max_value) {
  int b = 0;
  while (max_value >> b) ++b;
  return b < 1 ? 1 : b;
}

}  // namespace

extern "C" {

// Returns the number of unique voxels written. out_coords: [n*3] i32 buffer,
// keep_idx: [n] i32 buffer (original row index per unique voxel),
// dims_out: [3] i32.
int voxelize_f32(const float* coords, int64_t n, int32_t* out_coords,
                 int32_t* keep_idx, int32_t* dims_out) {
  if (n <= 0) {
    dims_out[0] = dims_out[1] = dims_out[2] = 1;
    return 0;
  }
  std::vector<int32_t> q(static_cast<size_t>(n) * 3);
  int32_t mn[3] = {INT32_MAX, INT32_MAX, INT32_MAX};
  for (int64_t i = 0; i < n; ++i) {
    for (int d = 0; d < 3; ++d) {
      int32_t v = static_cast<int32_t>(coords[i * 3 + d]);  // trunc
      q[i * 3 + d] = v;
      mn[d] = std::min(mn[d], v);
    }
  }
  int32_t mx[3] = {0, 0, 0};
  for (int64_t i = 0; i < n; ++i) {
    for (int d = 0; d < 3; ++d) {
      q[i * 3 + d] -= mn[d];
      mx[d] = std::max(mx[d], q[i * 3 + d]);
    }
  }
  dims_out[0] = mx[0] + 1;
  dims_out[1] = mx[1] + 1;
  dims_out[2] = mx[2] + 1;

  // 64-bit keys (grid may exceed 2^31 before downsampling). Key and row
  // index pack into one u64 (idx in the low bits keeps radix order ==
  // (key, idx) lexicographic == np.unique's first-occurrence rule).
  const int64_t dy = dims_out[1], dz = dims_out[2];
  const uint64_t max_key = static_cast<uint64_t>(dims_out[0]) * dy * dz - 1;
  const int idx_bits = bits_for(static_cast<uint64_t>(n - 1));
  const int key_bits = bits_for(max_key);
  if (key_bits + idx_bits > 64) {
    // Key+index do not fit one u64 (astronomically sparse i32 grid):
    // packing would TRUNCATE keys, so branch BEFORE packing and sort row
    // indices by (x, y, z, idx) directly — key order is exactly
    // lexicographic (x, y, z) since key = (x*Dy + y)*Dz + z with
    // 0 <= y < Dy, 0 <= z < Dz. No key arithmetic, so no overflow at all.
    std::vector<int64_t> order(static_cast<size_t>(n));
    for (int64_t i = 0; i < n; ++i) order[i] = i;
    std::sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
      for (int d = 0; d < 3; ++d) {
        if (q[a * 3 + d] != q[b * 3 + d]) return q[a * 3 + d] < q[b * 3 + d];
      }
      return a < b;
    });
    int out_n = 0;
    for (int64_t i = 0; i < n; ++i) {
      const int64_t src = order[i];
      if (out_n > 0 &&
          q[src * 3] == out_coords[(out_n - 1) * 3] &&
          q[src * 3 + 1] == out_coords[(out_n - 1) * 3 + 1] &&
          q[src * 3 + 2] == out_coords[(out_n - 1) * 3 + 2]) {
        continue;
      }
      out_coords[out_n * 3 + 0] = q[src * 3 + 0];
      out_coords[out_n * 3 + 1] = q[src * 3 + 1];
      out_coords[out_n * 3 + 2] = q[src * 3 + 2];
      keep_idx[out_n] = static_cast<int32_t>(src);
      ++out_n;
    }
    return out_n;
  }
  std::vector<uint64_t> packed(static_cast<size_t>(n));
  for (int64_t i = 0; i < n; ++i) {
    const uint64_t key =
        (static_cast<uint64_t>(q[i * 3]) * dy + q[i * 3 + 1]) * dz +
        q[i * 3 + 2];
    packed[i] = (key << idx_bits) | static_cast<uint64_t>(i);
  }
  radix_sort_u64(packed, key_bits + idx_bits);

  int out_n = 0;
  uint64_t prev_key = ~uint64_t{0};
  const uint64_t idx_mask = (uint64_t{1} << idx_bits) - 1;
  for (int64_t i = 0; i < n; ++i) {
    const uint64_t key = packed[i] >> idx_bits;
    if (key != prev_key) {
      prev_key = key;
      const int64_t src = static_cast<int64_t>(packed[i] & idx_mask);
      out_coords[out_n * 3 + 0] = q[src * 3 + 0];
      out_coords[out_n * 3 + 1] = q[src * 3 + 1];
      out_coords[out_n * 3 + 2] = q[src * 3 + 2];
      keep_idx[out_n] = static_cast<int32_t>(src);
      ++out_n;
    }
  }
  return out_n;
}

// Voxel-grid downsampling key computation for the offline pipeline
// (reference downsample_ply.py:74-75): floor((p - min)/voxel) with the same
// smallest-original-index unique rule. Returns number of kept points.
int downsample_f64(const double* coords, int64_t n, double voxel_size,
                   int32_t* out_vox, int32_t* keep_idx) {
  if (n <= 0) return 0;
  double mn[3] = {coords[0], coords[1], coords[2]};
  for (int64_t i = 1; i < n; ++i)
    for (int d = 0; d < 3; ++d) mn[d] = std::min(mn[d], coords[i * 3 + d]);

  std::vector<int64_t> v(static_cast<size_t>(n) * 3);
  int64_t mx[3] = {0, 0, 0};
  for (int64_t i = 0; i < n; ++i)
    for (int d = 0; d < 3; ++d) {
      int64_t x = static_cast<int64_t>(
          std::floor((coords[i * 3 + d] - mn[d]) / voxel_size));
      v[i * 3 + d] = x;
      mx[d] = std::max(mx[d], x);
    }
  const int64_t dy = mx[1] + 1, dz = mx[2] + 1;
  struct Entry {
    int64_t key;
    int64_t idx;
  };
  std::vector<Entry> entries(static_cast<size_t>(n));
  for (int64_t i = 0; i < n; ++i) {
    entries[i].key = (v[i * 3] * dy + v[i * 3 + 1]) * dz + v[i * 3 + 2];
    entries[i].idx = i;
  }
  std::sort(entries.begin(), entries.end(), [](const Entry& a, const Entry& b) {
    return a.key != b.key ? a.key < b.key : a.idx < b.idx;
  });
  int out_n = 0;
  int64_t prev = -1;
  for (int64_t i = 0; i < n; ++i) {
    if (entries[i].key != prev) {
      prev = entries[i].key;
      const int64_t src = entries[i].idx;
      out_vox[out_n * 3 + 0] = static_cast<int32_t>(v[src * 3 + 0]);
      out_vox[out_n * 3 + 1] = static_cast<int32_t>(v[src * 3 + 1]);
      out_vox[out_n * 3 + 2] = static_cast<int32_t>(v[src * 3 + 2]);
      keep_idx[out_n] = static_cast<int32_t>(src);
      ++out_n;
    }
  }
  return out_n;
}

// Fused pack_keys + u8-delta transfer encoding (mask3d_tpu/data/transfer.py
// ::encode_keys_u8 semantics, byte-identical output buffer):
//   out = [B*N u8 deltas][esc_cap (item,pos,value) i32 records][B i32 counts
//         | B*3 i32 dims]
// coords: i32[B*N*3] sorted ascending by key within the first counts[b] rows
// of each item (the voxelizer's output order). Returns the number of escape
// records used, -1 if they exceed esc_cap, -2 if keys are not sorted.
int pack_encode_u8(const int32_t* coords, const int32_t* counts,
                   const int32_t* dims, int64_t b, int64_t n,
                   int64_t esc_cap, uint8_t* out) {
  uint8_t* deltas = out;
  int32_t* records = reinterpret_cast<int32_t*>(out + b * n);
  int32_t* tail = records + esc_cap * 3;
  int64_t n_esc = 0;
  for (int64_t i = 0; i < b; ++i) {
    const int64_t dy = dims[i * 3 + 1], dz = dims[i * 3 + 2];
    const int64_t cnt = counts[i];
    int64_t prev = 0;
    for (int64_t j = 0; j < n; ++j) {
      int64_t d = 0;
      if (j < cnt) {
        const int32_t* c = coords + (i * n + j) * 3;
        const int64_t key = (static_cast<int64_t>(c[0]) * dy + c[1]) * dz +
                            c[2];
        d = key - prev;
        prev = key;
        if (d < 0) return -2;
      }
      if (d >= 255) {
        if (n_esc >= esc_cap) return -1;
        records[n_esc * 3 + 0] = static_cast<int32_t>(i);
        records[n_esc * 3 + 1] = static_cast<int32_t>(j);
        records[n_esc * 3 + 2] = static_cast<int32_t>(d);
        ++n_esc;
        deltas[i * n + j] = 255;
      } else {
        deltas[i * n + j] = static_cast<uint8_t>(d);
      }
    }
  }
  for (int64_t e = n_esc; e < esc_cap; ++e) {
    records[e * 3 + 0] = 0;
    records[e * 3 + 1] = static_cast<int32_t>(n);  // dropped by the scatter
    records[e * 3 + 2] = 0;
  }
  for (int64_t i = 0; i < b; ++i) {
    tail[i * 4 + 0] = counts[i];
    tail[i * 4 + 1] = dims[i * 3 + 0];
    tail[i * 4 + 2] = dims[i * 3 + 1];
    tail[i * 4 + 3] = dims[i * 3 + 2];
  }
  return static_cast<int>(n_esc);
}

// Host coarse-pyramid build + u8-delta encode of every coarse level
// (mask3d_tpu/data/transfer.py::coarse_pyramid_host + encode_keys_u8
// semantics; byte-identical concatenated sections — differential test in
// tests/test_data_io.py). Per item and level: sorted unique of
// (coords >> 1) packed in the halved per-item dims. The SHIPPED key list
// truncates at the level capacity (the raw count is still shipped for
// the device overflow flag) while the next level derives from the FULL
// cell set, mirroring the device's untruncated occupancy-pool chain.
// out layout per level: [b*cap u8 deltas][esc_cap*3 i32][b*4 i32 tail].
// Returns 0, or -1 on escape-table overflow.
int coarse_pyramid_encode_u8(const int32_t* coords, const int32_t* counts,
                             const int32_t* dims, int64_t b, int64_t n,
                             const int64_t* caps, int64_t n_levels,
                             int64_t esc_cap, uint8_t* out) {
  std::vector<std::vector<uint64_t>> keys(b);
  std::vector<std::array<int64_t, 3>> d(b);
  // level-0 state: keys of coords>>1 are built per level from the
  // previous level's (x, y, z); keep coordinates to avoid re-dividing.
  std::vector<std::vector<std::array<int32_t, 3>>> cur(b);
  for (int64_t i = 0; i < b; ++i) {
    d[i] = {dims[i * 3], dims[i * 3 + 1], dims[i * 3 + 2]};
    cur[i].resize(counts[i]);
    for (int64_t j = 0; j < counts[i]; ++j) {
      const int32_t* c = coords + (i * n + j) * 3;
      cur[i][j] = {c[0], c[1], c[2]};
    }
  }
  uint8_t* p = out;
  for (int64_t l = 0; l < n_levels; ++l) {
    const int64_t cap = caps[l];
    uint8_t* deltas = p;
    int32_t* records = reinterpret_cast<int32_t*>(p + b * cap);
    int32_t* tail = records + esc_cap * 3;
    int64_t n_esc = 0;
    for (int64_t i = 0; i < b; ++i) {
      const std::array<int64_t, 3> dn = {
          ((d[i][0] - 1) >> 1) + 1, ((d[i][1] - 1) >> 1) + 1,
          ((d[i][2] - 1) >> 1) + 1};
      std::vector<uint64_t>& k = keys[i];
      k.resize(cur[i].size());
      for (size_t j = 0; j < cur[i].size(); ++j) {
        const auto& c = cur[i][j];
        k[j] = (static_cast<uint64_t>(c[0] >> 1) * dn[1] + (c[1] >> 1)) *
                   dn[2] +
               (c[2] >> 1);
      }
      uint64_t maxv = 0;
      for (uint64_t v : k) maxv = v > maxv ? v : maxv;
      radix_sort_u64(k, bits_for(maxv));
      k.erase(std::unique(k.begin(), k.end()), k.end());
      const int64_t raw = static_cast<int64_t>(k.size());
      const int64_t m = raw < cap ? raw : cap;
      int64_t prev = 0;
      for (int64_t j = 0; j < cap; ++j) {
        int64_t dd = 0;
        if (j < m) {
          dd = static_cast<int64_t>(k[j]) - prev;
          prev = static_cast<int64_t>(k[j]);
        }
        if (dd >= 255) {
          if (n_esc >= esc_cap) return -1;
          records[n_esc * 3 + 0] = static_cast<int32_t>(i);
          records[n_esc * 3 + 1] = static_cast<int32_t>(j);
          records[n_esc * 3 + 2] = static_cast<int32_t>(dd);
          ++n_esc;
          deltas[i * cap + j] = 255;
        } else {
          deltas[i * cap + j] = static_cast<uint8_t>(dd);
        }
      }
      tail[i * 4 + 0] = static_cast<int32_t>(raw);
      tail[i * 4 + 1] = static_cast<int32_t>(dn[0]);
      tail[i * 4 + 2] = static_cast<int32_t>(dn[1]);
      tail[i * 4 + 3] = static_cast<int32_t>(dn[2]);
      // next level derives from the FULL (untruncated) cell set
      cur[i].resize(raw);
      for (int64_t j = 0; j < raw; ++j) {
        const uint64_t key = k[j];
        cur[i][j] = {static_cast<int32_t>(key / (dn[1] * dn[2])),
                     static_cast<int32_t>((key / dn[2]) % dn[1]),
                     static_cast<int32_t>(key % dn[2])};
      }
      d[i] = dn;
    }
    for (int64_t e = n_esc; e < esc_cap; ++e) {
      records[e * 3 + 0] = 0;
      records[e * 3 + 1] = static_cast<int32_t>(cap);  // dropped by scatter
      records[e * 3 + 2] = 0;
    }
    p += b * cap + esc_cap * 12 + b * 16;
  }
  return 0;
}

// PNG row unfiltering (PNG spec, section 9): `in` holds h rows of
// 1 + row_bytes bytes (the filter type, then the filtered bytes); `out`
// gets the h x row_bytes reconstructed bytes. bpp is the bytes per pixel
// (the left neighbour's distance). Returns 0, or -(y + 1) where row y has
// an unknown filter type. Average and Paeth depend on the byte just
// reconstructed to their left, so each row is one sequential pass.
int png_unfilter(const uint8_t* in, int64_t h, int64_t row_bytes, int bpp,
                 uint8_t* out) {
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* f = in + y * (row_bytes + 1) + 1;
    uint8_t* r = out + y * row_bytes;
    const uint8_t* up = y > 0 ? out + (y - 1) * row_bytes : nullptr;
    const int ftype = in[y * (row_bytes + 1)];
    switch (ftype) {
      case 0:
        std::memcpy(r, f, static_cast<size_t>(row_bytes));
        break;
      case 1:
        for (int64_t x = 0; x < row_bytes; ++x)
          r[x] = static_cast<uint8_t>(f[x] + (x >= bpp ? r[x - bpp] : 0));
        break;
      case 2:
        for (int64_t x = 0; x < row_bytes; ++x)
          r[x] = static_cast<uint8_t>(f[x] + (up ? up[x] : 0));
        break;
      case 3:
        for (int64_t x = 0; x < row_bytes; ++x) {
          const int a = x >= bpp ? r[x - bpp] : 0;
          const int b = up ? up[x] : 0;
          r[x] = static_cast<uint8_t>(f[x] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int64_t x = 0; x < row_bytes; ++x) {
          const int a = x >= bpp ? r[x - bpp] : 0;
          const int b = up ? up[x] : 0;
          const int c = (up && x >= bpp) ? up[x - bpp] : 0;
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b),
                    pc = std::abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          r[x] = static_cast<uint8_t>(f[x] + pred);
        }
        break;
      default:
        return static_cast<int>(-(y + 1));
    }
  }
  return 0;
}

}  // extern "C"
