// Row gather: out[b, t, :] = src[b, clamp(idx[b, t], 0, N-1), :] where
// ok[b, t], else 0. f32 or bf16 rows, a copy, so exact.
//
// Replaces the TPU kernel mask3d_tpu/sparse/pallas_gather.py:198
// (monotone_gather). That kernel DMAs a window of sorted source rows into
// VMEM and selects rows with a one-hot MXU matmul, because the TPU has no
// fast row gather; the window premise and the one-hot select are TPU
// workarounds, so this kernel needs no ascending indices.
//
// Bound on the H100: bytes. It reads B*M*C*E bytes of rows (E = 4 for f32,
// 2 for bf16), B*M*5 bytes of idx/ok, and writes B*M*C*E bytes; the
// level-0 tap of the flagship (B=8, M=49152, C=96) moves about 302 MB in
// f32, about 90 us at 3.35 TB/s, and half of that in bf16.
// Design: one thread per 16-byte vector of an output row (float4, or 8
// bf16 as a uint4; a scalar per thread when the row is not a whole number
// of vectors, e.g. the 3-wide coordinate rows), so the writes are fully
// coalesced and each source row is read as contiguous vectors; no warp
// idles on narrow rows. Grid-stride loop, 256 threads a block.

#include <cuda_runtime.h>
#include <stdint.h>

// T is the unit a thread copies; C counts units of T per row.
template <typename T>
__global__ void row_gather_kernel(const T* __restrict__ src,
                                  const int32_t* __restrict__ idx,
                                  const uint8_t* __restrict__ ok,
                                  T* __restrict__ out, long long rows,
                                  long long M, long long N, long long C) {
  const long long total = rows * C;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += step) {
    const long long r = t / C;
    const long long c = t - r * C;
    T val{};  // zero
    if (ok[r]) {
      long long j = idx[r];
      j = j < 0 ? 0 : (j >= N ? N - 1 : j);
      const long long b = r / M;
      val = src[(b * N + j) * C + c];
    }
    out[r * C + c] = val;
  }
}

template <typename T>
static int launch(const void* src, const void* idx, const void* ok,
                  void* out, long long B, long long M, long long N,
                  long long C, void* stream) {
  const long long rows = B * M;
  const long long total = rows * C;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  row_gather_kernel<T><<<(unsigned)blocks, threads, 0, s>>>(
      (const T*)src, (const int32_t*)idx, (const uint8_t*)ok, (T*)out, rows,
      M, N, C);
  return (int)cudaGetLastError();
}

// C is the row width in elements; vec: rows are copied as 16-byte vectors
// (C a multiple of 4 for f32, 8 for bf16, src 16-byte aligned).
extern "C" int row_gather_f32(const void* src, const void* idx,
                              const void* ok, void* out, long long B,
                              long long M, long long N, long long C,
                              int vec, void* stream) {
  return vec ? launch<float4>(src, idx, ok, out, B, M, N, C / 4, stream)
             : launch<float>(src, idx, ok, out, B, M, N, C, stream);
}

extern "C" int row_gather_bf16(const void* src, const void* idx,
                               const void* ok, void* out, long long B,
                               long long M, long long N, long long C,
                               int vec, void* stream) {
  return vec ? launch<uint4>(src, idx, ok, out, B, M, N, C / 8, stream)
             : launch<uint16_t>(src, idx, ok, out, B, M, N, C, stream);
}
