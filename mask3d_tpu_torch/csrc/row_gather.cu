// Row gather: out[b, t, :] = src[b, clamp(idx[b, t], 0, N-1), :] where
// ok[b, t], else 0. f32 or bf16 rows, a copy, so exact.
//
// Replaces the TPU kernel mask3d_tpu/sparse/pallas_gather.py:198
// (monotone_gather). That kernel DMAs a window of sorted source rows into
// VMEM and selects rows with a one-hot MXU matmul, because the TPU has no
// fast row gather; the window premise and the one-hot select are TPU
// workarounds, so this kernel needs no ascending indices.
//
// Bound on the H100: bytes. It reads B*M*5 bytes of idx/ok and the ok rows
// (C*E bytes each, E = 4 for f32, 2 for bf16) and writes B*M*C*E bytes; the
// level-0 tap of the flagship (B=8, M=49152, C=96) moves about 272 MB in
// f32, about 81 us at 3.35 TB/s.
//
// Design: work is assigned per row. A group of G lanes (a power of two up
// to 32) copies one row as 16-byte vectors (float4, or 8 bf16 as a uint4),
// each lane a few vectors with its loads issued before its stores; rows
// narrower than 16 bytes (the 3-wide coordinate taps) take one thread per
// row and copy scalars. The group's first lane reads idx[r] and ok[r] once
// and hands them to the others by shuffle. Index arithmetic is 32-bit when
// B*N*C and B*M*C fit (as index_select does), 64-bit otherwise, and the
// grid has a block for every 256 / G rows, so no launch loops over it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// V: the unit a lane copies; U: units per row; G lanes per row; I: index
// type; PER: units a lane loads before it stores.
template <typename V, int G, typename I>
__global__ void __launch_bounds__(kThreads)
    row_gather_kernel(const V* __restrict__ src,
                      const int32_t* __restrict__ idx,
                      const uint8_t* __restrict__ ok, V* __restrict__ out,
                      I rows, I M, I N, I U) {
  constexpr int PER = G == 1 ? 8 : 4;
  const int lane = threadIdx.x % G;
  const I r = (I)blockIdx.x * (kThreads / G) + threadIdx.x / G;
  const I rr = r < rows ? r : rows - 1;
  int j = 0, o = 0;
  if (lane == 0) {
    o = ok[rr];
    j = idx[rr];
  }
  if (G > 1) {
    o = __shfl_sync(0xffffffffu, o, 0, G);
    j = __shfl_sync(0xffffffffu, j, 0, G);
  }
  if (r >= rows) return;
  V* dst = out + r * U;
  if (!o) {
    for (I c = lane; c < U; c += G) dst[c] = V{};
    return;
  }
  const I jj = j < 0 ? 0 : ((I)j >= N ? N - 1 : (I)j);
  const V* s = src + ((r / M) * N + jj) * U;
  for (I c0 = lane; c0 < U; c0 += (I)G * PER) {
    V v[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i)
      if (c0 + (I)(i * G) < U) v[i] = s[c0 + i * G];
#pragma unroll
    for (int i = 0; i < PER; ++i)
      if (c0 + (I)(i * G) < U) dst[c0 + i * G] = v[i];
  }
}

template <typename V, typename I>
int launch_g(int g, const void* src, const void* idx, const void* ok,
             void* out, I rows, I M, I N, I U, cudaStream_t s) {
#define ROW_GATHER_CASE(G)                                                 \
  case G:                                                                  \
    row_gather_kernel<V, G, I>                                             \
        <<<(unsigned)((rows + kThreads / G - 1) / (kThreads / G)),         \
           kThreads, 0, s>>>((const V*)src, (const int32_t*)idx,           \
                             (const uint8_t*)ok, (V*)out, rows, M, N, U);  \
    break;
  switch (g) {
    ROW_GATHER_CASE(1)
    ROW_GATHER_CASE(2)
    ROW_GATHER_CASE(4)
    ROW_GATHER_CASE(8)
    ROW_GATHER_CASE(16)
    ROW_GATHER_CASE(32)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef ROW_GATHER_CASE
  return (int)cudaGetLastError();
}

// Lanes per row: one for rows narrower than 16 bytes; else the largest
// power of two up to 32 that divides the units of a row (so no lane idles),
// or, where that is below 4, the largest power of two up to 32 not above
// them.
int lanes_per_row(long long units, int unit_bytes) {
  if (units * unit_bytes < 16) return 1;
  int g = 1;
  while (g < 32 && units % (2 * g) == 0) g *= 2;
  if (g < 4) {
    g = 1;
    while (g < 32 && 2 * g <= units) g *= 2;
  }
  return g;
}

template <typename V>
int launch(const void* src, const void* idx, const void* ok, void* out,
           long long B, long long M, long long N, long long U,
           long long elems_per_unit, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int g = lanes_per_row(U, (int)sizeof(V));
  const long long lim = 1LL << 31;
  if (B * N * U * elems_per_unit < lim && B * M * U * elems_per_unit < lim)
    return launch_g<V, uint32_t>(g, src, idx, ok, out, (uint32_t)(B * M),
                                 (uint32_t)M, (uint32_t)N, (uint32_t)U, s);
  return launch_g<V, long long>(g, src, idx, ok, out, B * M, M, N, U, s);
}

}  // namespace

// C is the row width in elements; vec: rows are copied as 16-byte vectors
// (C a multiple of 4 for f32, 8 for bf16, src 16-byte aligned).
extern "C" int row_gather_f32(const void* src, const void* idx,
                              const void* ok, void* out, long long B,
                              long long M, long long N, long long C,
                              int vec, void* stream) {
  return vec ? launch<uint4>(src, idx, ok, out, B, M, N, C / 4, 4, stream)
             : launch<float>(src, idx, ok, out, B, M, N, C, 1, stream);
}

extern "C" int row_gather_bf16(const void* src, const void* idx,
                               const void* ok, void* out, long long B,
                               long long M, long long N, long long C,
                               int vec, void* stream) {
  return vec ? launch<uint4>(src, idx, ok, out, B, M, N, C / 8, 8, stream)
             : launch<uint16_t>(src, idx, ok, out, B, M, N, C, 1, stream);
}
