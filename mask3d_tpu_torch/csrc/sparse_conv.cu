// Sparse (submanifold) gather-conv over a kernel map:
//   out[b, p, :] = sum_k ok[b, p, k] * bf16(feats[b, idx[b, p, k], :])
//                                     @ bf16(W[k])
// f32 products of bf16-rounded inputs, f32 accumulation, f32 out. Rows
// where no offset is ok (padding rows) come out 0.
//
// Replaces the TPU kernel mask3d_tpu/sparse/pallas_conv.py:316
// (sparse_conv_pallas, kernels _kernel :53 / _kernel_grouped :120). That
// kernel DMAs a window of sorted input rows per (tile, offset) into VMEM and
// selects the neighbours with a one-hot MXU matmul, because the TPU has no
// fast row gather; it needs the window premise (`all_hit`), tile-aligned N
// and Cin padded to 128. Those are Mosaic workarounds: here a block loads
// its own indices and gathers the rows directly, for any N and Cin.
//
// Bound on the H100: at the flagship's shapes the operations (2 * sum(ok)
// * Cin * Cout at the bf16 tensor-core rate) and the bytes (idx/ok 5 B per
// row and offset, feats and out once, bf16 weights) are of the same order.
// Design, simple first: one block of 256 threads per tile of 128 output
// rows and one slice of 16*NJ output channels. Per offset k the block loads
// its rows' idx/ok, skips the offset when no row of the tile is ok, and
// otherwise stages 32 input channels at a time: the gathered rows
// (bf16-rounded, zero where ~ok) and the matching slice of W[k] in shared
// memory, then f32 FMAs into an 8 x NJ register tile per thread. No
// tensor cores yet (mma.sync / wgmma come later).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMI = 8;           // rows per thread
constexpr int kTM = 16 * kMI;    // rows per block: 16 row groups
constexpr int kTK = 32;          // input channels per shared-memory stage

template <int NJ>
__global__ void __launch_bounds__(kThreads)
sparse_conv_kernel(const float* __restrict__ feats,
                   const __nv_bfloat16* __restrict__ w,
                   const int32_t* __restrict__ idx,
                   const uint8_t* __restrict__ ok,
                   float* __restrict__ out, long long rows, long long N,
                   int K, int Cin, int Cout) {
  constexpr int TN = 16 * NJ;
  __shared__ float As[kTK][kTM + 1];  // +1: conflict-free transposed stores
  __shared__ float Bs[kTK][TN];
  __shared__ long long src[kTM];      // flat input row, -1 where ~ok

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const long long row0 = (long long)blockIdx.x * kTM;
  const int n0 = blockIdx.y * TN;

  float acc[kMI][NJ];
#pragma unroll
  for (int i = 0; i < kMI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  for (int k = 0; k < K; ++k) {
    int hit = 0;
    if (tid < kTM) {
      const long long r = row0 + tid;
      long long s = -1;
      if (r < rows && ok[r * K + k]) {
        long long j = idx[r * K + k];
        j = j < 0 ? 0 : (j >= N ? N - 1 : j);
        s = (r / N) * N + j;
      }
      src[tid] = s;
      hit = s >= 0;
    }
    if (!__syncthreads_or(hit)) continue;  // no row of the tile is ok

    for (int c0 = 0; c0 < Cin; c0 += kTK) {
      const int kc = min(kTK, Cin - c0);
#pragma unroll
      for (int it = 0; it < kTK * kTM / kThreads; ++it) {
        const int e = tid + it * kThreads;
        const int c = e % kTK;
        const int r = e / kTK;
        if (c < kc) {
          const long long s = src[r];
          float v = 0.f;
          if (s >= 0)
            v = __bfloat162float(__float2bfloat16_rn(feats[s * Cin + c0 + c]));
          As[c][r] = v;
        }
      }
#pragma unroll
      for (int it = 0; it < kTK * TN / kThreads; ++it) {
        const int e = tid + it * kThreads;
        const int c = e / TN;
        const int n = e % TN;
        if (c < kc) {
          float v = 0.f;
          if (n0 + n < Cout)
            v = __bfloat162float(
                w[((long long)k * Cin + c0 + c) * Cout + n0 + n]);
          Bs[c][n] = v;
        }
      }
      __syncthreads();
      for (int c = 0; c < kc; ++c) {
        float a[kMI], b[NJ];
#pragma unroll
        for (int i = 0; i < kMI; ++i) a[i] = As[c][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < NJ; ++j) b[j] = Bs[c][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kMI; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < kMI; ++i) {
    const long long r = row0 + ty + 16 * i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < Cout) out[r * Cout + n] = acc[i][j];
    }
  }
}

template <int NJ>
void launch(const void* feats, const void* w, const void* idx,
            const void* ok, void* out, long long rows, long long N, int K,
            int Cin, int Cout, cudaStream_t s) {
  const dim3 grid((unsigned)((rows + kTM - 1) / kTM),
                  (unsigned)((Cout + 16 * NJ - 1) / (16 * NJ)));
  sparse_conv_kernel<NJ><<<grid, kThreads, 0, s>>>(
      (const float*)feats, (const __nv_bfloat16*)w, (const int32_t*)idx,
      (const uint8_t*)ok, (float*)out, rows, N, K, Cin, Cout);
}

}  // namespace

// feats f32[B, N, Cin], w bf16[K, Cin, Cout], idx i32[B, N, K],
// ok u8[B, N, K] -> out f32[B, N, Cout]; all contiguous. Returns the
// cudaError_t of the launch.
extern "C" int sparse_conv_f32(const void* feats, const void* w,
                               const void* idx, const void* ok, void* out,
                               long long B, long long N, int K, int Cin,
                               int Cout, void* stream) {
  const long long rows = B * N;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  // output-channel slice per block: the narrowest of 32/64/96/128 that
  // holds Cout (wider Cout takes several slices of 128)
  if (Cout <= 32)
    launch<2>(feats, w, idx, ok, out, rows, N, K, Cin, Cout, s);
  else if (Cout <= 64)
    launch<4>(feats, w, idx, ok, out, rows, N, K, Cin, Cout, s);
  else if (Cout <= 96)
    launch<6>(feats, w, idx, ok, out, rows, N, K, Cin, Cout, s);
  else
    launch<8>(feats, w, idx, ok, out, rows, N, K, Cin, Cout, s);
  return (int)cudaGetLastError();
}
