// Masked multi-head cross-attention, f32:
//   out[b, q, h] = softmax_s(q[b,q,h] . k[b,s,h] / sqrt(hd), blocked -> -1e9)
//                  . v[b, s, h]
// mask[b, q, s] != 0 means blocked. A row with every key blocked gets
// uniform weights (the -1e9 fill, never -inf, so it stays finite).
//
// Replaces the TPU kernel mask3d_tpu/ops/pallas_attention.py:102
// (masked_cross_attention). That kernel walks the key tiles of one item in
// order on one core and carries the online-softmax state (running max,
// sum, accumulator) in VMEM scratch from one grid step to the next.
//
// Bound on the H100: bytes. At the flagship's largest level (B=8, Q=25,
// D=128, S=24576) it must read 201 MB of K and V plus a 4.9 MB mask, about
// 61 us at 3.35 TB/s, against about 2.5 GFLOP of f32 work.
// Design: blocks run in parallel and in no order here, so the key axis is
// split into chunks and each block owns one (chunk, item, group of 32
// queries) with all heads inside it: every K/V row is read once, as
// coalesced 16-byte vectors, into shared memory. One warp per head, one
// lane per query; each lane keeps its query, running max, sum and
// accumulator in registers and folds in 32 keys per tile. Each block writes
// its partial (max, sum, accumulator) to scratch, and a second small kernel
// combines the chunks. The chunk count is chosen so that the grid holds a
// few hundred blocks and fills the 132 SMs.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

constexpr int TK = 32;            // keys per shared-memory tile
constexpr int QG = 32;            // queries per block (one per lane)
constexpr int MS_STRIDE = TK + 4;  // mask tile row stride: no bank conflicts
constexpr float BLOCKED = -1e9f;

template <int HD>
__global__ void mca_partial(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const uint8_t* __restrict__ mask,
                            float* __restrict__ part_m,
                            float* __restrict__ part_l,
                            float* __restrict__ part_acc, int Q, int S,
                            int H, int chunk, int nch, float scale) {
  extern __shared__ float4 smem4[];
  const int D = H * HD;
  float* ks = reinterpret_cast<float*>(smem4);  // [TK][D]
  float* vs = ks + TK * D;                      // [TK][D]
  uint8_t* ms = reinterpret_cast<uint8_t*>(vs + TK * D);  // [QG][MS_STRIDE]

  const int c = blockIdx.x, b = blockIdx.y, qg = blockIdx.z;
  const int lane = threadIdx.x & 31, h = threadIdx.x >> 5;
  const int s_begin = c * chunk;
  const int s_end = min(S, s_begin + chunk);
  const int qi = qg * QG + lane;
  const bool q_ok = qi < Q;

  float qr[HD], acc[HD];
  float m = BLOCKED, l = 0.f;
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    qr[d] = q_ok ? q[((long long)b * Q + qi) * D + h * HD + d] : 0.f;
    acc[d] = 0.f;
  }

  for (int t0 = s_begin; t0 < s_end; t0 += TK) {
    const int nk = min(TK, s_end - t0);
    __syncthreads();  // the previous tile is consumed
    const float4* kg =
        reinterpret_cast<const float4*>(k + ((long long)b * S + t0) * D);
    const float4* vg =
        reinterpret_cast<const float4*>(v + ((long long)b * S + t0) * D);
    float4* ks4 = reinterpret_cast<float4*>(ks);
    float4* vs4 = reinterpret_cast<float4*>(vs);
    const int nvec = nk * D / 4;
    for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
      ks4[i] = kg[i];
      vs4[i] = vg[i];
    }
    for (int i = threadIdx.x; i < QG * TK; i += blockDim.x) {
      const int r = i / TK, j = i - r * TK;
      const int qq = qg * QG + r;
      ms[r * MS_STRIDE + j] =
          (qq < Q && j < nk) ? mask[((long long)b * Q + qq) * S + t0 + j] : 0;
    }
    __syncthreads();
    if (!q_ok) continue;

    float s[TK];
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < TK; ++j) {
      float x = -INFINITY;  // past the chunk end: no key at all
      if (j < nk) {
        const float* kr = ks + j * D + h * HD;
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < HD; ++d) dot = fmaf(qr[d], kr[d], dot);
        x = ms[lane * MS_STRIDE + j] ? BLOCKED : dot * scale;
      }
      s[j] = x;
      tmax = fmaxf(tmax, x);
    }
    const float m_new = fmaxf(m, tmax);
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int d = 0; d < HD; ++d) acc[d] *= corr;
#pragma unroll
    for (int j = 0; j < TK; ++j) {
      if (j < nk) {
        const float p = expf(s[j] - m_new);
        l += p;
        const float* vr = vs + j * D + h * HD;
#pragma unroll
        for (int d = 0; d < HD; ++d) acc[d] = fmaf(p, vr[d], acc[d]);
      }
    }
    m = m_new;
  }

  if (q_ok) {
    const long long base = (((long long)b * nch + c) * H + h) * Q + qi;
    part_m[base] = m;
    part_l[base] = l;
#pragma unroll
    for (int d = 0; d < HD; ++d) part_acc[base * HD + d] = acc[d];
  }
}

template <int HD>
__global__ void mca_combine(const float* __restrict__ part_m,
                            const float* __restrict__ part_l,
                            const float* __restrict__ part_acc,
                            float* __restrict__ out, int B, int Q, int H,
                            int nch) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long total = (long long)B * Q * H * HD;
  if (t >= total) return;
  const int d = (int)(t % HD);
  long long r = t / HD;
  const int h = (int)(r % H);
  r /= H;
  const int qi = (int)(r % Q);
  const int b = (int)(r / Q);
  float mx = -INFINITY;
  for (int c = 0; c < nch; ++c)
    mx = fmaxf(mx, part_m[(((long long)b * nch + c) * H + h) * Q + qi]);
  float lsum = 0.f, a = 0.f;
  for (int c = 0; c < nch; ++c) {
    const long long base = (((long long)b * nch + c) * H + h) * Q + qi;
    const float w = expf(part_m[base] - mx);
    lsum = fmaf(part_l[base], w, lsum);
    a = fmaf(part_acc[base * HD + d], w, a);
  }
  out[((long long)b * Q + qi) * (H * HD) + h * HD + d] =
      a / fmaxf(lsum, 1e-20f);
}

template <int HD>
static int launch(const void* q, const void* k, const void* v,
                  const void* mask, void* pm, void* pl, void* pacc, void* out,
                  int B, int Q, int S, int H, int chunk, int nch, float scale,
                  cudaStream_t stream) {
  const int D = H * HD;
  const size_t smem = 2 * (size_t)TK * D * sizeof(float) + QG * MS_STRIDE;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        mca_partial<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(nch, B, (Q + QG - 1) / QG);
  mca_partial<HD><<<grid, 32 * H, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v,
      (const uint8_t*)mask, (float*)pm, (float*)pl, (float*)pacc, Q, S, H,
      chunk, nch, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long total = (long long)B * Q * D;
  const int threads = 256;
  mca_combine<HD><<<(unsigned)((total + threads - 1) / threads), threads, 0,
                    stream>>>((const float*)pm, (const float*)pl,
                              (const float*)pacc, (float*)out, B, Q, H, nch);
  return (int)cudaGetLastError();
}

extern "C" int masked_cross_attention_f32(
    const void* q, const void* k, const void* v, const void* mask, void* pm,
    void* pl, void* pacc, void* out, int B, int Q, int S, int H, int HD,
    int chunk, int nch, float scale, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (HD) {
    case 8:
      return launch<8>(q, k, v, mask, pm, pl, pacc, out, B, Q, S, H, chunk,
                       nch, scale, s);
    case 16:
      return launch<16>(q, k, v, mask, pm, pl, pacc, out, B, Q, S, H, chunk,
                        nch, scale, s);
    case 32:
      return launch<32>(q, k, v, mask, pm, pl, pacc, out, B, Q, S, H, chunk,
                        nch, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
