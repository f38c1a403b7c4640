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
// 62 us at 3.35 TB/s; the f32 work (2.5 GFLOP, 32 FMAs and one exp per
// (query, head, key)) takes about 38 us at the FFMA peak, so the math has
// to run under the stream to approach the bound.
//
// Design, a pipelined stream (the first kernel loaded each 32-key
// tile through registers between two barriers, so every tile cost a full
// memory latency, and gave one lane to each query, idling 7 of 32 lanes at
// Q=25; builds of it with only the loads or only the math showed its math,
// not its loads, as the limit: 0.41 of its 0.54 ms at S=24576):
// - The key axis is split into chunks; a block owns (chunk, item, group of
//   HG heads) with all Q queries, so each K/V element is read once. Its
//   tiles of TK keys stream through a 3-stage shared-memory ring filled by
//   16-byte `cp.async` copies: two tiles are in flight while the block
//   computes on the third. Rows past the end are zero-filled (src-size 0)
//   and never read as keys. Staged rows carry 4 floats of padding, so lanes
//   reading the same columns of consecutive keys hit distinct banks.
// - Lanes: one thread per (head, group of kQ queries, key slice); the kQ
//   queries share each K/V row the thread loads from shared memory, which
//   the math is bound by. The KSL slices of a group are adjacent lanes and
//   take the keys s, s + KSL, ... of each tile (16 keys each); at Q=25 the
//   7 groups of 4 queries a head x 8 heads x 4 slices fill 7 whole warps,
//   and 3 of each head's 28 query slots idle. Each thread keeps its queries,
//   running maxima, sums and accumulators in registers and folds in its 16
//   keys per tile (logits first, one rescale per tile, exponentials as
//   ex2.approx on base-2 logits); at the chunk's end the slices merge their
//   states with shuffles.
// - Each block writes its partial (max, sum, accumulator) to scratch, and
//   mca_combine merges the chunks. The wrapper's `plan()` picks kQ, KSL, HG
//   and the chunk count (one wave of blocks over the 132 SMs).
// - The partial form (out_m, out_l given): the keys are one sequence-
//   parallel rank's chunk of a level's rows. mca_combine also writes each
//   (item, head, query)'s max logit (base e, the -1e9 fill included) and its
//   sum of exponentials relative to that max, so that the ranks' normalized
//   outputs combine into the softmax over every row
//   (ops/masked_attention.py: combine_partial_softmax).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kStages = 3;
constexpr int kKeysPerSlice = 16;  // keys of a tile each thread takes
constexpr int kMaxThreads = 256;
constexpr float kBlocked = -1e9f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; zero-filled and not read when src_bytes 0
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__host__ __device__ constexpr int round16(int x) { return (x + 15) & ~15; }

// bytes of one ring stage: K and V tiles [TK][W + 4] f32, mask [Q][TK] u8
__host__ __device__ inline int stage_bytes(int tk, int w, int nq) {
  return 2 * tk * (w + 4) * 4 + round16(nq * tk);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// q [B, Q, D]; k, v [B, S, D]; mask u8 [B, Q, Sm] (Sm >= S, Sm % 16 == 0);
// block (chunk c, item b, head group z); heads z*HG .. z*HG + HG - 1. A
// thread owns queries kQ*g .. kQ*g + kQ - 1 of one head and one key slice;
// logits
// are kept in base 2 (scale2 = log2(e) / sqrt(hd)), partials in base e.
template <int HD, int KSL, int kQ>
__global__ void __launch_bounds__(kMaxThreads)
    mca_partial(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const uint8_t* __restrict__ mask,
                float* __restrict__ part_m, float* __restrict__ part_l,
                float* __restrict__ part_acc, int Q, int S, int Sm, int H,
                int HG, int chunk, int nch, float scale2) {
  constexpr int TK = kKeysPerSlice * KSL;
  constexpr float kBlocked2 = kBlocked * 1.4426950408889634f;
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = H * HD;
  const int W = HG * HD;  // staged columns: this block's heads
  const int RS = W + 4;   // staged row stride (floats)
  const int stage = stage_bytes(TK, W, Q);
  const int QP = (Q + kQ - 1) / kQ;  // query pairs a head

  const int c = blockIdx.x, b = blockIdx.y, z = blockIdx.z;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int pair = tid / KSL, sl = tid % KSL;
  const bool valid = pair < HG * QP;
  const int hl = valid ? pair / QP : 0;  // head within the group
  const int q0 = valid ? (pair % QP) * kQ : 0;
  const int h = z * HG + hl;
  const int s_begin = c * chunk;
  const int s_end = min(S, s_begin + chunk);
  const int ntile = (s_end - s_begin + TK - 1) / TK;

  float qr[kQ][HD], acc[kQ][HD], m[kQ], l[kQ];
  int qrow[kQ];
#pragma unroll
  for (int u = 0; u < kQ; ++u) {
    const bool ok = valid && q0 + u < Q;
    qrow[u] = ok ? q0 + u : q0;  // a missing query repeats the first
    m[u] = kBlocked2;
    l[u] = 0.f;
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      qr[u][d] = ok ? q[((long long)b * Q + qrow[u]) * D + h * HD + d] : 0.f;
      acc[u][d] = 0.f;
    }
  }

  const float* kb = k + (long long)b * S * D + z * W;
  const float* vb = v + (long long)b * S * D + z * W;
  const uint8_t* mb = mask + (long long)b * Q * Sm;
  const int w4 = W / 4;

  auto issue = [&](int t) {
    float* Ks = reinterpret_cast<float*>(smem + (t % kStages) * stage);
    float* Vs = Ks + TK * RS;
    uint8_t* Ms = reinterpret_cast<uint8_t*>(Vs + TK * RS);
    const int t0 = s_begin + t * TK;
    const int nk = min(TK, s_end - t0);
    for (int e = tid; e < TK * w4; e += nthr) {
      const int r = e / w4, c4 = e - r * w4;
      const bool in = r < nk;
      const long long off = in ? (long long)(t0 + r) * D + c4 * 4 : 0;
      cp_async16(Ks + r * RS + c4 * 4, kb + off, in ? 16 : 0);
      cp_async16(Vs + r * RS + c4 * 4, vb + off, in ? 16 : 0);
    }
    constexpr int M16 = TK / 16;
    for (int e = tid; e < Q * M16; e += nthr) {
      const int qq = e / M16, c16 = e - qq * M16;
      const bool in = c16 * 16 < nk;
      cp_async16(Ms + qq * TK + c16 * 16,
                 mb + (in ? (long long)qq * Sm + t0 + c16 * 16 : 0),
                 in ? 16 : 0);
    }
  };

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < ntile) issue(t);
    cp_async_commit();
  }
  for (int t = 0; t < ntile; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile t landed; tile t-1's slot is free
    if (t + kStages - 1 < ntile) issue(t + kStages - 1);
    cp_async_commit();
    if (valid) {
      const float* Ks = reinterpret_cast<const float*>(
          smem + (t % kStages) * stage);
      const float* Vs = Ks + TK * RS;
      const uint8_t* Ms = reinterpret_cast<const uint8_t*>(Vs + TK * RS);
      const int nk = min(TK, s_end - (s_begin + t * TK));
      float sv[kQ][kKeysPerSlice];
      float tmax[kQ];
#pragma unroll
      for (int u = 0; u < kQ; ++u) tmax[u] = -INFINITY;
#pragma unroll
      for (int i = 0; i < kKeysPerSlice; ++i) {
        const int j = sl + KSL * i;
        float dot[kQ];
#pragma unroll
        for (int u = 0; u < kQ; ++u) dot[u] = 0.f;
        if (j < nk) {
          const float4* kr =
              reinterpret_cast<const float4*>(Ks + j * RS + hl * HD);
#pragma unroll
          for (int d4 = 0; d4 < HD / 4; ++d4) {
            const float4 kv = kr[d4];
#pragma unroll
            for (int u = 0; u < kQ; ++u) {
              dot[u] = fmaf(qr[u][4 * d4], kv.x, dot[u]);
              dot[u] = fmaf(qr[u][4 * d4 + 1], kv.y, dot[u]);
              dot[u] = fmaf(qr[u][4 * d4 + 2], kv.z, dot[u]);
              dot[u] = fmaf(qr[u][4 * d4 + 3], kv.w, dot[u]);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kQ; ++u) {
          // past the chunk end: no key at all
          const float x = j < nk ? (Ms[qrow[u] * TK + j] ? kBlocked2
                                                          : dot[u] * scale2)
                                 : -INFINITY;
          sv[u][i] = x;
          tmax[u] = fmaxf(tmax[u], x);
        }
      }
#pragma unroll
      for (int u = 0; u < kQ; ++u) {
        const float m_new = fmaxf(m[u], tmax[u]);
        const float corr = ex2(m[u] - m_new);
        m[u] = m_new;
        l[u] *= corr;
#pragma unroll
        for (int d = 0; d < HD; ++d) acc[u][d] *= corr;
#pragma unroll
        for (int i = 0; i < kKeysPerSlice; ++i) {
          sv[u][i] = ex2(sv[u][i] - m_new);  // 0 where no key
          l[u] += sv[u][i];
        }
      }
#pragma unroll
      for (int i = 0; i < kKeysPerSlice; ++i) {
        const int j = sl + KSL * i;
        if (j < nk) {
          const float4* vr =
              reinterpret_cast<const float4*>(Vs + j * RS + hl * HD);
#pragma unroll
          for (int d4 = 0; d4 < HD / 4; ++d4) {
            const float4 vv = vr[d4];
#pragma unroll
            for (int u = 0; u < kQ; ++u) {
              const float p = sv[u][i];
              acc[u][4 * d4] = fmaf(p, vv.x, acc[u][4 * d4]);
              acc[u][4 * d4 + 1] = fmaf(p, vv.y, acc[u][4 * d4 + 1]);
              acc[u][4 * d4 + 2] = fmaf(p, vv.z, acc[u][4 * d4 + 2]);
              acc[u][4 * d4 + 3] = fmaf(p, vv.w, acc[u][4 * d4 + 3]);
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // merge the KSL slices of each pair (adjacent lanes)
#pragma unroll
  for (int off = 1; off < KSL; off <<= 1) {
#pragma unroll
    for (int u = 0; u < kQ; ++u) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[u], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[u], off);
      const float mn = fmaxf(m[u], mo);
      const float a = ex2(m[u] - mn), bo = ex2(mo - mn);
      l[u] = l[u] * a + lo * bo;
#pragma unroll
      for (int d = 0; d < HD; ++d) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[u][d], off);
        acc[u][d] = acc[u][d] * a + ao * bo;
      }
      m[u] = mn;
    }
  }
  if (valid && sl == 0) {
#pragma unroll
    for (int u = 0; u < kQ; ++u) {
      if (q0 + u >= Q) continue;
      const long long base = (((long long)b * nch + c) * H + h) * Q + q0 + u;
      part_m[base] = m[u] * 0.6931471805599453f;  // base e for mca_combine
      part_l[base] = l[u];
#pragma unroll
      for (int d = 0; d < HD; ++d) part_acc[base * HD + d] = acc[u][d];
    }
  }
}

template <int HD>
__global__ void mca_combine(const float* __restrict__ part_m,
                            const float* __restrict__ part_l,
                            const float* __restrict__ part_acc,
                            float* __restrict__ out, float* __restrict__ out_m,
                            float* __restrict__ out_l, int B, int Q, int H,
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
  if (out_m != nullptr && d == 0) {  // the partial form: [B, H, Q]
    const long long o = ((long long)b * H + h) * Q + qi;
    out_m[o] = mx;
    out_l[o] = lsum;
  }
}

template <int HD, int KSL, int kQ>
int launch(const void* q, const void* k, const void* v, const void* mask,
           void* pm, void* pl, void* pacc, void* out, void* om, void* ol,
           int B, int Q, int S, int Sm, int H, int HG, int threads, int chunk,
           int nch, float scale, cudaStream_t stream) {
  constexpr int TK = kKeysPerSlice * KSL;
  if (threads > kMaxThreads || threads % 32 ||
      threads < HG * ((Q + kQ - 1) / kQ) * KSL)
    return (int)cudaErrorInvalidValue;
  const int smem = kStages * stage_bytes(TK, HG * HD, Q);
  auto kern = mca_partial<HD, KSL, kQ>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(nch, B, H / HG);
  kern<<<grid, threads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v,
      (const uint8_t*)mask, (float*)pm, (float*)pl, (float*)pacc, Q, S, Sm,
      H, HG, chunk, nch, scale * 1.4426950408889634f);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long total = (long long)B * Q * H * HD;
  const int cthreads = 256;
  mca_combine<HD><<<(unsigned)((total + cthreads - 1) / cthreads), cthreads,
                    0, stream>>>((const float*)pm, (const float*)pl,
                                 (const float*)pacc, (float*)out, (float*)om,
                                 (float*)ol, B, Q, H, nch);
  return (int)cudaGetLastError();
}

template <int HD, int kQ>
int dispatch(int ksl, const void* q, const void* k, const void* v,
             const void* mask, void* pm, void* pl, void* pacc, void* out,
             void* om, void* ol, int B, int Q, int S, int Sm, int H, int HG,
             int threads, int chunk, int nch, float scale, cudaStream_t s) {
  switch (ksl) {
    case 1:
      return launch<HD, 1, kQ>(q, k, v, mask, pm, pl, pacc, out, om, ol, B,
                               Q, S, Sm, H, HG, threads, chunk, nch, scale, s);
    case 2:
      return launch<HD, 2, kQ>(q, k, v, mask, pm, pl, pacc, out, om, ol, B,
                               Q, S, Sm, H, HG, threads, chunk, nch, scale, s);
    case 4:
      return launch<HD, 4, kQ>(q, k, v, mask, pm, pl, pacc, out, om, ol, B,
                               Q, S, Sm, H, HG, threads, chunk, nch, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q f32 [B, Q, D], k/v f32 [B, S, D] (D = H * HD, 16-byte aligned), mask
// u8 [B, Q, Sm] (Sm >= S, Sm % 16 == 0, 16-byte aligned); pm/pl f32
// [B, nch, H, Q], pacc f32 [B, nch, H, Q, HD]; out f32 [B, Q, D]. ksl in
// {1, 2, 4} key slices a group of lanes (tiles of 16 * ksl keys); nqt
// queries a thread (4, 1 at HD 32); hg heads a block (divides H);
// threads a block (a multiple of 32, at least hg * ceil(Q / nqt) * ksl, at
// most 256); chunk keys a block (a multiple of the tile). out_m/out_l: null,
// or f32 [B, H, Q] for the partial form's max logit and sum of
// exponentials. Returns the cudaError_t of the launches.
extern "C" int masked_cross_attention_f32(
    const void* q, const void* k, const void* v, const void* mask, void* pm,
    void* pl, void* pacc, void* out, void* out_m, void* out_l, int B, int Q,
    int S, int Sm, int H, int HD, int ksl, int nqt, int hg, int threads,
    int chunk, int nch, float scale, void* stream) {
  if (hg < 1 || H % hg || Sm % 16 || Sm < S ||
      chunk % (kKeysPerSlice * ksl) || (out_m == nullptr) != (out_l == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define MCA_CASE(D_, NQ_)                                                   \
  if (HD == D_ && nqt == NQ_)                                               \
    return dispatch<D_, NQ_>(ksl, q, k, v, mask, pm, pl, pacc, out, out_m,  \
                             out_l, B, Q, S, Sm, H, hg, threads, chunk, nch, \
                             scale, s);
  MCA_CASE(8, 4)
  MCA_CASE(16, 4)
  MCA_CASE(32, 1)
#undef MCA_CASE
  return (int)cudaErrorInvalidValue;
}
