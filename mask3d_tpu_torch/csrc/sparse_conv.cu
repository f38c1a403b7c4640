// Sparse (submanifold) gather-conv over a kernel map, on the tensor cores:
//   out[b, p, :] = sum_k ok[b, p, k] * bf16(feats[b, idx[b, p, k], :])
//                                     @ bf16(W[k])
// bf16 operands, f32 products and accumulation, f32 out. Rows where no
// offset is ok (padding rows) come out 0.
//
// Replaces the TPU kernel mask3d_tpu/sparse/pallas_conv.py:316
// (sparse_conv_pallas, kernels _kernel :53 / _kernel_grouped :120). That
// kernel DMAs a window of sorted input rows per (tile, offset) into VMEM and
// selects the neighbours with a one-hot MXU matmul, because the TPU has no
// fast row gather; it needs the window premise (`all_hit`), tile-aligned N
// and Cin padded to 128. Those are Mosaic workarounds: here a block loads
// its own indices and gathers the rows directly, for any N.
//
// Bound on the H100 (chip_smoke.py, check_sparse_conv): the larger of the
// bytes (idx/ok 5 B per row and offset, f32 feats and out once, bf16 W)
// over 3.35 TB/s and 2 * sum(ok) * Cin * Cout over the bf16 tensor-core
// peak. At every flagship shape the bytes bound: the work per ok pair is
// small (Cin, Cout <= 384) and 2-42% of the pairs are ok.
//
// What the design does about the four limits of a first, CUDA-core kernel:
// 1. Tensor cores. The wrapper casts feats to bf16 once per call into rows
//    padded with zeros to a multiple of 16 channels (W likewise, and Cout to
//    the block's width). The kernel gathers rows with 16-byte `cp.async`
//    copies into a 3-stage shared-memory ring, so the next (offset, 32
//    channel) stage loads while this one computes; `cp.async`'s src-size 0
//    zero-fills a row that is not ok without reading it. It multiplies with
//    `mma.sync.m16n8k16` bf16 x bf16 -> f32, A fed by `ldmatrix`, B (W[k]
//    is [Cin, Cout] row-major) by `ldmatrix.trans`.
// 2. Skipping below the tile. Each warp owns one 16-row m-fragment. Per
//    offset the block keeps a bitmask of the fragments that hold an ok row;
//    an offset no fragment needs is not staged at all, and a warp whose
//    fragment has no ok row for an offset issues no gathers and no `mma`.
// 3. Index loads. The tile's ok block (rows x K bytes, contiguous) is
//    copied into shared memory once, as 16-byte copies; only a tile with
//    an ok row then copies its idx block (rows x K x 4 bytes) the same way
//    and computes the clamped flat source row there once per (row, offset).
// 4. Filling the card. The coarse levels hold few valid rows in a large
//    capacity (L4: <= 105 of 3072 per item), so only a few tiles have work.
//    The wrapper splits a tile's active offsets over gridDim.z blocks
//    (split-K) and picks 64-row tiles there; each split writes its partial
//    sums to scratch that the wrapper allocates, and
//    sparse_conv_kernel_reduce adds them in split order. No float atomics:
//    two launches on the same input are bitwise equal. A tile with no ok
//    row writes its zeros (or, split, a flag for the reduction) and stops.
// The stem (Cin = 1, K = 125) would waste 15/16 of a 16-channel padding:
// sparse_conv_kernel_stem folds the offsets into the reduction depth,
// A[p, k] = bf16(feats[idx[p, k]]), a [rows x 128] . [128 x Cout] product.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kKC = 32;        // input channels (or folded depth) a stage
constexpr int kStages = 3;     // shared-memory ring depth
constexpr int kAStride = kKC + 8;  // bf16 per staged row: 80 bytes, so the
                                   // 8 rows of an ldmatrix hit 8 bank groups

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; bytes past src_bytes (all 16 when 0) are
// zero-filled and not read
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

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulators
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One k16 step of a warp's 16 x (8 * NT) tile: A from a 16-row staged
// block (row stride kAStride), B from a [16 x 8*NT] block (row stride BS).
template <int NT, int BS>
__device__ __forceinline__ void warp_k16(float (&acc)[NT][4],
                                         const __nv_bfloat16* A,
                                         const __nv_bfloat16* B, int lane) {
  uint32_t a[4];
  ldmatrix_x4(a, A + (lane & 15) * kAStride + (lane >> 4) * 8);
#pragma unroll
  for (int np = 0; np < NT / 2; ++np) {
    uint32_t b[4];
    ldmatrix_x4_trans(
        b, B + ((lane & 7) + ((lane >> 3) & 1) * 8) * BS + np * 16 +
               (lane >> 4) * 8);
    mma_bf16(acc[2 * np], a, b[0], b[1]);
    mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
  }
}

// A warp's accumulators -> rows [row0 + warp*16, +16) of dst (row stride
// ld), columns n0.. below ncols.
template <int NT>
__device__ __forceinline__ void store_tile(const float (&acc)[NT][4],
                                           float* dst, long long row0,
                                           int tile_rows, int warp, int lane,
                                           int n0, int ncols, int ld) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + (lane >> 2) + h * 8;
    if (r >= tile_rows) continue;
    float* d = dst + (row0 + r) * ld;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = n0 + nt * 8 + (lane & 3) * 2;
      if (n < ncols) d[n] = acc[nt][2 * h];
      if (n + 1 < ncols) d[n + 1] = acc[nt][2 * h + 1];
    }
  }
}

template <int WARPS, int NT>
__host__ __device__ constexpr int ring_bytes() {
  return kStages * (16 * WARPS * kAStride + kKC * (8 * NT + 8)) * 2;
}

__host__ __device__ constexpr int round16(int x) { return (x + 15) & ~15; }

// Rows: a block owns 16 * WARPS rows (one m-fragment per warp) x 8 * NT
// output channels x one split of the tile's active offsets.
// feats bf16[rows, Cp] (Cp % 16 == 0, zero padded), w bf16[K, Cp, CoutP]
// (zero padded), idx i32 / ok u8 [rows, K]; out f32[rows, Cout]; with
// gridDim.z > 1 the partial sums go to part f32[S, rows, Cout] and the
// tile's liveness to live[tile].
template <int WARPS, int NT>
__global__ void __launch_bounds__(32 * WARPS)
    sparse_conv_kernel_mma(const __nv_bfloat16* __restrict__ feats,
                           const __nv_bfloat16* __restrict__ w,
                           const int32_t* __restrict__ idx,
                           const uint8_t* __restrict__ ok,
                           float* __restrict__ out, float* __restrict__ part,
                           int32_t* __restrict__ live, long long rows, int N,
                           int K, int Cp, int CoutP, int Cout) {
  constexpr int kThreads = 32 * WARPS;
  constexpr int kTM = 16 * WARPS;
  constexpr int TN = 8 * NT;
  constexpr int kBStride = TN + 8;  // bf16; conflict-free ldmatrix.trans
  constexpr int kAStage = kTM * kAStride;
  constexpr int kStage = kAStage + kKC * kBStride;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  int32_t* src_s = reinterpret_cast<int32_t*>(smem + ring_bytes<WARPS, NT>());
  uint8_t* ok_s = reinterpret_cast<uint8_t*>(src_s + kTM * K);
  uint8_t* fmask = ok_s + round16(kTM * K);  // per offset: live fragments
  uint8_t* list = fmask + K;                 // active offsets, in order
  __shared__ int n_active_s;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long row0 = (long long)blockIdx.x * kTM;
  const int tile_rows = (int)min((long long)kTM, rows - row0);
  const int n0 = blockIdx.y * TN;
  const int split = blockIdx.z, S = gridDim.z;

  // 1. the tile's ok block (rows x K bytes, contiguous): 16-byte copies,
  //    zero past the last row. Per offset the bitmask of fragments with an
  //    ok row, and the list of active offsets.
  {
    const char* go = reinterpret_cast<const char*>(ok + row0 * K);
    const int ob = tile_rows * K;
    for (int off = tid * 16; off < round16(kTM * K); off += kThreads * 16)
      cp_async16(ok_s + off, go + (off < ob ? off : 0),
                 max(0, min(16, ob - off)));
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }
  for (int k = tid; k < K; k += kThreads) {
    int m = 0;
    for (int f = 0; f < WARPS; ++f) {
      int any = 0;
#pragma unroll
      for (int i = 0; i < 16; ++i) any |= ok_s[(f * 16 + i) * K + k];
      m |= (any != 0) << f;
    }
    fmask[k] = (uint8_t)m;
  }
  __syncthreads();
  if (warp == 0) {
    int n = 0;
    for (int k0 = 0; k0 < K; k0 += 32) {
      const int k = k0 + lane;
      const bool act = k < K && fmask[k] != 0;
      const unsigned bal = __ballot_sync(0xffffffffu, act);
      if (act) list[n + __popc(bal & ((1u << lane) - 1u))] = (uint8_t)k;
      n += __popc(bal);
    }
    if (lane == 0) n_active_s = n;
  }
  __syncthreads();
  const int n_active = n_active_s;

  if (S > 1) {
    if (blockIdx.y == 0 && split == 0 && tid == 0)
      live[blockIdx.x] = n_active > 0;
    if (n_active == 0) return;  // the reduction writes the tile's zeros
  } else if (n_active == 0) {
    for (int e = tid; e < tile_rows * TN; e += kThreads) {
      const int n = n0 + e % TN;
      if (n < Cout) out[(row0 + e / TN) * Cout + n] = 0.f;
    }
    return;
  }

  // 2. a tile with work: its idx block, then idx -> clamped flat source row
  //    (once per row and offset)
  {
    const char* gi = reinterpret_cast<const char*>(idx + row0 * K);
    const int ib = tile_rows * K * 4;
    for (int off = tid * 16; off < kTM * K * 4; off += kThreads * 16)
      cp_async16(reinterpret_cast<char*>(src_s) + off,
                 gi + (off < ib ? off : 0), max(0, min(16, ib - off)));
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }
  for (int r = warp; r < tile_rows; r += WARPS) {
    const int base = (int)(((row0 + r) / N) * N);
    for (int k = lane; k < K; k += 32) {
      const int j = src_s[r * K + k];
      src_s[r * K + k] = base + (j < 0 ? 0 : (j >= N ? N - 1 : j));
    }
  }
  __syncthreads();

  // 3. this split's share of the active offsets, as (offset, 32-channel
  //    chunk) stages through the ring
  const int a_lo = (int)((long long)n_active * split / S);
  const int a_hi = (int)((long long)n_active * (split + 1) / S);
  const int n_chunks = (Cp + kKC - 1) / kKC;
  const int n_st = (a_hi - a_lo) * n_chunks;

  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

  auto issue = [&](int st) {
    __nv_bfloat16* As = ring + (st % kStages) * kStage;
    __nv_bfloat16* Bs = As + kAStage;
    const int k = list[a_lo + st / n_chunks];
    const int c0 = (st % n_chunks) * kKC;
    if ((fmask[k] >> warp) & 1) {
      // this warp's 16 rows x 32 channels: 64 pieces of 16 bytes
#pragma unroll
      for (int e = lane; e < 64; e += 32) {
        const int r = warp * 16 + (e >> 2);
        const int c = c0 + (e & 3) * 8;
        if (c < Cp) {
          const bool okr = ok_s[r * K + k] != 0;
          const __nv_bfloat16* src =
              okr ? feats + (long long)src_s[r * K + k] * Cp + c : feats;
          cp_async16(As + r * kAStride + (e & 3) * 8, src, okr ? 16 : 0);
        }
      }
    }
    const int kc = min(kKC, Cp - c0);
    const __nv_bfloat16* wk = w + ((long long)k * Cp + c0) * CoutP + n0;
    for (int e = tid; e < kc * (TN / 8); e += kThreads) {
      const int c = e / (TN / 8), q = e % (TN / 8);
      cp_async16(Bs + c * kBStride + q * 8, wk + (long long)c * CoutP + q * 8,
                 16);
    }
  };

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_st) issue(st);
    cp_async_commit();
  }
  for (int st = 0; st < n_st; ++st) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage st landed; stage st-1's slot is free
    if (st + kStages - 1 < n_st) issue(st + kStages - 1);
    cp_async_commit();
    const int k = list[a_lo + st / n_chunks];
    if ((fmask[k] >> warp) & 1) {
      const __nv_bfloat16* As =
          ring + (st % kStages) * kStage + warp * 16 * kAStride;
      const __nv_bfloat16* Bs = ring + (st % kStages) * kStage + kAStage;
      const int c0 = (st % n_chunks) * kKC;
      warp_k16<NT, kBStride>(acc, As, Bs, lane);
      if (Cp - c0 > 16)
        warp_k16<NT, kBStride>(acc, As + 16, Bs + 16 * kBStride, lane);
    }
  }
  cp_async_wait<0>();

  if (S > 1)
    store_tile<NT>(acc, part + (long long)split * rows * Cout, row0,
                   tile_rows, warp, lane, n0, Cout, Cout);
  else
    store_tile<NT>(acc, out, row0, tile_rows, warp, lane, n0, Cout, Cout);
}

// out[r, :] = sum over splits s = 0, 1, ... of part[s, r, :], in that
// order, where the row's tile is live; 0 elsewhere.
template <typename V>
__global__ void sparse_conv_kernel_reduce(const V* __restrict__ part,
                                          const int32_t* __restrict__ live,
                                          V* __restrict__ out, long long rows,
                                          int width, int S, int tm) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long total = rows * width;
  if (t >= total) return;
  V s{};
  if (live[(t / width) / tm]) {
    s = part[t];
    for (int sp = 1; sp < S; ++sp) {
      const V p = part[sp * total + t];
      if constexpr (sizeof(V) == 16) {
        s.x += p.x; s.y += p.y; s.z += p.z; s.w += p.w;
      } else {
        s += p;
      }
    }
  }
  out[t] = s;
}

// Cin = 1: the offsets fold into the reduction depth. A[r, k] =
// bf16(feats[src(r, k)]) where ok, else 0, for k < K (zero up to Kp, a
// multiple of 16); w bf16[Kp, CoutP]. Staged 32 depth at a time.
template <int WARPS, int NT>
__global__ void __launch_bounds__(32 * WARPS)
    sparse_conv_kernel_stem(const __nv_bfloat16* __restrict__ feats,
                            const __nv_bfloat16* __restrict__ w,
                            const int32_t* __restrict__ idx,
                            const uint8_t* __restrict__ ok,
                            float* __restrict__ out, long long rows, int N,
                            int K, int Kp, int CoutP, int Cout) {
  constexpr int kThreads = 32 * WARPS;
  constexpr int kTM = 16 * WARPS;
  constexpr int TN = 8 * NT;
  constexpr int kBStride = TN + 8;
  __shared__ __align__(16) __nv_bfloat16 As[kTM * kAStride];
  __shared__ __align__(16) __nv_bfloat16 Bs[kKC * kBStride];
  __shared__ int base_s[kTM];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long row0 = (long long)blockIdx.x * kTM;
  const int tile_rows = (int)min((long long)kTM, rows - row0);
  const int n0 = blockIdx.y * TN;
  if (tid < kTM) base_s[tid] = (int)(((row0 + tid) / N) * N);

  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

  for (int d0 = 0; d0 < Kp; d0 += kKC) {
    __syncthreads();  // base_s ready; the previous chunk consumed
    for (int e = tid; e < kTM * kKC; e += kThreads) {
      const int r = e / kKC, k = d0 + e % kKC;
      __nv_bfloat16 v = __float2bfloat16_rn(0.f);
      if (r < tile_rows && k < K) {
        const long long rk = (row0 + r) * K + k;
        if (ok[rk]) {
          const int j = idx[rk];
          v = feats[base_s[r] + (j < 0 ? 0 : (j >= N ? N - 1 : j))];
        }
      }
      As[r * kAStride + e % kKC] = v;
    }
    const int kc = min(kKC, Kp - d0);
    for (int e = tid; e < kc * (TN / 8); e += kThreads) {
      const int c = e / (TN / 8), q = e % (TN / 8);
      *reinterpret_cast<uint4*>(Bs + c * kBStride + q * 8) =
          *reinterpret_cast<const uint4*>(w + (long long)(d0 + c) * CoutP +
                                          n0 + q * 8);
    }
    __syncthreads();
    warp_k16<NT, kBStride>(acc, As + warp * 16 * kAStride, Bs, lane);
    if (kc > 16)
      warp_k16<NT, kBStride>(acc, As + warp * 16 * kAStride + 16,
                             Bs + 16 * kBStride, lane);
  }
  store_tile<NT>(acc, out, row0, tile_rows, warp, lane, n0, Cout, Cout);
}

template <int WARPS, int NT>
int launch_mma(const void* feats, const void* w, const void* idx,
               const void* ok, void* out, void* part, void* live,
               long long rows, int N, int K, int Cp, int CoutP, int Cout,
               int S, cudaStream_t s) {
  constexpr int kTM = 16 * WARPS;
  const int smem = ring_bytes<WARPS, NT>() + kTM * K * 4 +
                   round16(kTM * K) + 2 * K;
  auto kern = sparse_conv_kernel_mma<WARPS, NT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((rows + kTM - 1) / kTM),
                  (unsigned)(CoutP / (8 * NT)), (unsigned)S);
  kern<<<grid, 32 * WARPS, smem, s>>>(
      (const __nv_bfloat16*)feats, (const __nv_bfloat16*)w,
      (const int32_t*)idx, (const uint8_t*)ok, (float*)out, (float*)part,
      (int32_t*)live, rows, N, K, Cp, CoutP, Cout);
  err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return (int)err;
  const int threads = 256;
  if (Cout % 4 == 0) {
    const long long total = rows * (Cout / 4);
    sparse_conv_kernel_reduce<float4>
        <<<(unsigned)((total + threads - 1) / threads), threads, 0, s>>>(
            (const float4*)part, (const int32_t*)live, (float4*)out, rows,
            Cout / 4, S, kTM);
  } else {
    const long long total = rows * Cout;
    sparse_conv_kernel_reduce<float>
        <<<(unsigned)((total + threads - 1) / threads), threads, 0, s>>>(
            (const float*)part, (const int32_t*)live, (float*)out, rows,
            Cout, S, kTM);
  }
  return (int)cudaGetLastError();
}

template <int WARPS, int NT>
int launch_stem(const void* feats, const void* w, const void* idx,
                const void* ok, void* out, long long rows, int N, int K,
                int Kp, int CoutP, int Cout, cudaStream_t s) {
  constexpr int kTM = 16 * WARPS;
  const dim3 grid((unsigned)((rows + kTM - 1) / kTM),
                  (unsigned)(CoutP / (8 * NT)));
  sparse_conv_kernel_stem<WARPS, NT><<<grid, 32 * WARPS, 0, s>>>(
      (const __nv_bfloat16*)feats, (const __nv_bfloat16*)w,
      (const int32_t*)idx, (const uint8_t*)ok, (float*)out, rows, N, K, Kp,
      CoutP, Cout);
  return (int)cudaGetLastError();
}

template <int WARPS>
int dispatch(int tn, int folded, const void* feats, const void* w,
             const void* idx, const void* ok, void* out, void* part,
             void* live, long long rows, int N, int K, int Cp, int CoutP,
             int Cout, int S, cudaStream_t s) {
#define SPCONV_CASE(NT)                                                      \
  case 8 * NT:                                                               \
    return folded ? launch_stem<WARPS, NT>(feats, w, idx, ok, out, rows, N,  \
                                           K, Cp, CoutP, Cout, s)            \
                  : launch_mma<WARPS, NT>(feats, w, idx, ok, out, part,      \
                                          live, rows, N, K, Cp, CoutP, Cout, \
                                          S, s);
  switch (tn) {
    SPCONV_CASE(4)
    SPCONV_CASE(8)
    SPCONV_CASE(12)
    SPCONV_CASE(16)
  }
#undef SPCONV_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// feats16 bf16[rows, Cp] (folded: bf16[rows], Cp = Kp = K padded to 16),
// w16 bf16[K, Cp, CoutP] (folded: [Kp, CoutP]), idx i32 / ok u8 [rows, K],
// out f32[rows, Cout]; part f32[S, rows, Cout] and live i32[tiles] when
// S > 1. tn in {32, 64, 96, 128} divides CoutP; warps in {4, 8} (16 rows
// each). All contiguous, 16-byte aligned. Returns the cudaError_t of the
// launches.
extern "C" int sparse_conv_bf16(const void* feats16, const void* w16,
                                const void* idx, const void* ok, void* out,
                                void* part, void* live, long long rows,
                                int N, int K, int Cp, int CoutP, int Cout,
                                int tn, int warps, int S, int folded,
                                void* stream) {
  if (K < 1 || K > 255 || S < 1 || (folded && S != 1) || Cp % 16 != 0 ||
      rows >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (warps == 4)
    return dispatch<4>(tn, folded, feats16, w16, idx, ok, out, part, live,
                       rows, N, K, Cp, CoutP, Cout, S, s);
  if (warps == 8)
    return dispatch<8>(tn, folded, feats16, w16, idx, ok, out, part, live,
                       rows, N, K, Cp, CoutP, Cout, S, s);
  return (int)cudaErrorInvalidValue;
}
