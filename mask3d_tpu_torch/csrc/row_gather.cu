// Row gather: out[b, t, :] = src[b, clamp(idx[b, t], 0, N-1), :] where
// ok[b, t], else 0. f32 rows, a copy, so exact.
//
// Replaces the TPU kernel mask3d_tpu/sparse/pallas_gather.py:198
// (monotone_gather). That kernel DMAs a window of sorted source rows into
// VMEM and selects rows with a one-hot MXU matmul, because the TPU has no
// fast row gather; the window premise and the one-hot select are TPU
// workarounds, so this kernel needs no ascending indices.
//
// Bound on the H100: bytes. It reads B*M*C*4 bytes of rows, B*M*5 bytes of
// idx/ok, and writes B*M*C*4 bytes; the level-0 tap of the flagship
// (B=8, M=49152, C=96) moves about 302 MB, about 90 us at 3.35 TB/s.
// Design: one thread per 16-byte vector of an output row (a scalar per
// thread when C % 4 != 0, e.g. the 3-wide coordinate rows), so the writes
// are fully coalesced and each source row is read as contiguous vectors;
// no warp idles on narrow rows. Grid-stride loop, 256 threads a block.

#include <cuda_runtime.h>
#include <stdint.h>

template <int V> struct Vec;
template <> struct Vec<1> {
  using T = float;
  __device__ static T zero() { return 0.f; }
};
template <> struct Vec<4> {
  using T = float4;
  __device__ static T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
};

template <int V>
__global__ void row_gather_kernel(const float* __restrict__ src,
                                  const int32_t* __restrict__ idx,
                                  const uint8_t* __restrict__ ok,
                                  float* __restrict__ out, long long rows,
                                  long long M, long long N, long long C) {
  using T = typename Vec<V>::T;
  const long long per_row = C / V;
  const long long total = rows * per_row;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += step) {
    const long long r = t / per_row;
    const long long c = t - r * per_row;
    T val = Vec<V>::zero();
    if (ok[r]) {
      long long j = idx[r];
      j = j < 0 ? 0 : (j >= N ? N - 1 : j);
      const long long b = r / M;
      val = reinterpret_cast<const T*>(src + (b * N + j) * C)[c];
    }
    reinterpret_cast<T*>(out + r * C)[c] = val;
  }
}

extern "C" int row_gather_f32(const void* src, const void* idx,
                              const void* ok, void* out, long long B,
                              long long M, long long N, long long C,
                              int vec4, void* stream) {
  const long long rows = B * M;
  const long long total = rows * (vec4 ? C / 4 : C);
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (vec4) {
    row_gather_kernel<4><<<(unsigned)blocks, threads, 0, s>>>(
        (const float*)src, (const int32_t*)idx, (const uint8_t*)ok,
        (float*)out, rows, M, N, C);
  } else {
    row_gather_kernel<1><<<(unsigned)blocks, threads, 0, s>>>(
        (const float*)src, (const int32_t*)idx, (const uint8_t*)ok,
        (float*)out, rows, M, N, C);
  }
  return (int)cudaGetLastError();
}
