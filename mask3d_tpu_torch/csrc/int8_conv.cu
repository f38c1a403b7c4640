// int8 same-stride conv over a channels-last dense grid, with the fused
// prologues and epilogue of the int8 block chain:
//
//   q[c]   = prologue(x)[c]                 int8, 0 outside the grid
//   acc    = sum_{taps, c} q[cell + tap, c] * wq[tap, c, o]     (i32)
//   out[o] = cast(f32(acc) * sw[o] * occ)                       (bf16 or f32)
//
// Prologues (`mode`):
//   none:   x is the int8 grid q itself (already quantized, 0 where empty);
//   affine: h = relu(x*A + B), q = occ ? clip(rint(h*inv), +-127) : 0,
//           x bf16, A/B per (item, channel), inv per channel;
//   join:   h = relu(x*A + B + res*Ar + Br), quantized the same way; the
//           quantized centre cells are also written out as `yq` (the next
//           block's identity residual). res is int8 or bf16.
// The affine is written with __fmul_rn/__fadd_rn so nvcc does not contract
// it into an FMA: the plain version rounds twice, and so does this kernel.
// Optional extras: a second 1x1 output from the centre tap (`wd`, `swd`:
// the residual downsample of a chain's entry), and per-(item, channel)
// sum / sum of squares of the (rounded) outputs, accumulated with atomics.
//
// Replaces the TPU kernel mask3d_tpu/sparse/pallas_chain.py:512
// (chain_conv, body _chain_body :287), and serves the XLA int8 conv of
// mask3d_tpu/sparse/dense_ops.py:201 (dense_conv_same_int8) with the
// prologue `none`. The TPU kernel packs rows into 128 lanes, carries the
// occupancy in lane `cout`, and double-buffers DMA windows of rows; those
// are Mosaic workarounds. Here the occupancy is its own f32 grid and a
// block reads a halo tile of the grid directly.
//
// Bound on the H100: each output does 27 taps x 96-384 input channels of
// multiply-adds, so counted over every grid cell the int8 operations bound
// it; counted over the occupied outputs only (10.8% of the flagship's
// level-0 grid), reading the grid bounds it at level 0 and the operations
// elsewhere (chip_smoke.py prints both). This first kernel does not use the
// tensor cores: it runs __dp4a on the CUDA cores and computes every cell
// of a non-empty tile, so it stays far from its bound by design.
// Design, simple first: one block of 128 threads per output tile of 4x4x8
// cells and 32 output channels. A tile with no occupied cell writes zeros
// and stops (outputs are 0 there by definition). Input channels go in
// stages of 32: the stage's weights [taps][8 words][32] and the halo tile
// of quantized inputs (6x6x10 cells x 8 words of 4 int8) sit in shared
// memory; each thread accumulates 4 cells x 8 output channels with __dp4a.
// Integer sums are exact in any order, so the conv is bitwise that of the
// plain version; only the stats (f32 atomics) depend on the order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTX = 4, kTY = 4, kTZ = 8;
constexpr int kCells = kTX * kTY * kTZ;  // output cells per block
constexpr int kCO = 32;                   // output channels per block
constexpr int kCK = 32;                   // input channels per stage
constexpr int kWords = kCK / 4;           // int32 words (4 x int8) per cell

enum { kNone = 0, kAffine = 1, kJoin = 2 };

struct Args {
  const void* x;
  const void* res;
  const float* occ;   // [B, X, Y, Z] 0/1
  const int* w;        // [taps][CinP / 4][CoutP] words of 4 input channels
  const float* sw;     // [Cout]
  const int* wd;       // [CinP / 4][CoutP]
  const float* swd;    // [Cout]
  const float* A;      // [B, Cin]
  const float* Bc;     // [B, Cin]
  const float* Ar;     // [B, Cin]
  const float* Br;     // [B, Cin]
  const float* inv;    // [Cin]
  void* out;           // [B, X, Y, Z, Cout] bf16 or f32
  __nv_bfloat16* out2; // [B, X, Y, Z, Cout]
  int8_t* yq;          // [B, X, Y, Z, Cin]
  float* stats;        // [B, nstats, Cout]
  int B, X, Y, Z, Cin, Cout, CinP, CoutP;
  int ntx, nty, ntz;
  int out_f32, nstats;
};

__device__ __forceinline__ float bf16_bits(uint32_t bits16) {
  return __uint_as_float(bits16 << 16);
}

__device__ __forceinline__ uint32_t quantize(float h, float inv) {
  h = fmaxf(h, 0.f);
  float q = rintf(__fmul_rn(h, inv));
  q = fminf(fmaxf(q, -127.f), 127.f);
  return (uint32_t)(uint8_t)(int8_t)(int)q;
}

// One stage of quantized inputs: the halo tile of channels [c0, c0 + 32).
template <int KS, int MODE, bool RES_I8>
__device__ __forceinline__ void load_halo(const Args& a, int* s_in,
                                          const float* s_aff, int b, int x0,
                                          int y0, int z0, int c0) {
  constexpr int R = KS / 2;
  constexpr int HY = kTY + KS - 1, HZ = kTZ + KS - 1;
  constexpr int NH = (kTX + KS - 1) * HY * HZ;
  for (int e = threadIdx.x; e < NH * kWords; e += kThreads) {
    const int g = e % kWords;
    const int h = e / kWords;
    const int hz = h % HZ, hy = (h / HZ) % HY, hx = h / (HZ * HY);
    const int gx = x0 + hx - R, gy = y0 + hy - R, gz = z0 + hz - R;
    const int c = c0 + 4 * g;
    uint32_t word = 0;
    if (gx >= 0 && gx < a.X && gy >= 0 && gy < a.Y && gz >= 0 && gz < a.Z &&
        c < a.Cin) {
      const long long cell =
          (((long long)b * a.X + gx) * a.Y + gy) * a.Z + gz;
      const long long at = cell * a.Cin + c;
      if (MODE == kNone) {
        word = *reinterpret_cast<const uint32_t*>(
            static_cast<const int8_t*>(a.x) + at);
      } else if (a.occ[cell] > 0.5f) {
        const uint2 xv = *reinterpret_cast<const uint2*>(
            static_cast<const __nv_bfloat16*>(a.x) + at);
        const uint32_t xs[4] = {xv.x & 0xffffu, xv.x >> 16, xv.y & 0xffffu,
                                xv.y >> 16};
        float r[4] = {0.f, 0.f, 0.f, 0.f};
        if (MODE == kJoin) {
          if (RES_I8) {
            const uint32_t rw = *reinterpret_cast<const uint32_t*>(
                static_cast<const int8_t*>(a.res) + at);
#pragma unroll
            for (int k = 0; k < 4; ++k)
              r[k] = (float)(int8_t)((rw >> (8 * k)) & 0xffu);
          } else {
            const uint2 rv = *reinterpret_cast<const uint2*>(
                static_cast<const __nv_bfloat16*>(a.res) + at);
            r[0] = bf16_bits(rv.x & 0xffffu);
            r[1] = bf16_bits(rv.x >> 16);
            r[2] = bf16_bits(rv.y & 0xffffu);
            r[3] = bf16_bits(rv.y >> 16);
          }
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int ch = 4 * g + k;  // channel within the stage
          float hv = __fadd_rn(__fmul_rn(bf16_bits(xs[k]), s_aff[ch]),
                               s_aff[kCK + ch]);
          if (MODE == kJoin) {
            hv = __fadd_rn(hv, __fmul_rn(r[k], s_aff[2 * kCK + ch]));
            hv = __fadd_rn(hv, s_aff[3 * kCK + ch]);
          }
          word |= quantize(hv, s_aff[4 * kCK + ch]) << (8 * k);
        }
      }
    }
    s_in[h * kWords + g] = (int)word;
  }
}

__device__ __forceinline__ int comp(const int4& v, int k) {
  return k == 0 ? v.x : (k == 1 ? v.y : (k == 2 ? v.z : v.w));
}

template <int KS, int MODE, bool RES_I8, bool SECOND>
__global__ void __launch_bounds__(kThreads) int8_conv_kernel(Args a) {
  constexpr int R = KS / 2;
  constexpr int TAPS = KS * KS * KS;
  constexpr int HY = kTY + KS - 1, HZ = kTZ + KS - 1;
  constexpr int NH = (kTX + KS - 1) * HY * HZ;
  __shared__ __align__(16) int s_in[NH * kWords];
  __shared__ __align__(16) int s_w[TAPS * kWords * kCO];
  __shared__ __align__(16) int s_wd[SECOND ? kWords * kCO : 4];
  __shared__ float s_aff[5 * kCK];  // A, B, Ar, Br, inv of the stage
  __shared__ float s_stat[4 * kCO];
  __shared__ uint8_t s_occ[kCells];

  const int tid = threadIdx.x;
  int t = blockIdx.x;
  const int iz = t % a.ntz;
  t /= a.ntz;
  const int iy = t % a.nty;
  t /= a.nty;
  const int ix = t % a.ntx;
  const int b = t / a.ntx;
  const int x0 = ix * kTX, y0 = iy * kTY, z0 = iz * kTZ;
  const int co0 = blockIdx.y * kCO;

  // occupancy of the output tile: cell l = (lx * kTY + ly) * kTZ + lz
  {
    const int gx = x0 + (tid >> 5), gy = y0 + ((tid >> 3) & 3),
              gz = z0 + (tid & 7);
    uint8_t o = 0;
    if (gx < a.X && gy < a.Y && gz < a.Z)
      o = a.occ[(((long long)b * a.X + gx) * a.Y + gy) * a.Z + gz] > 0.5f;
    s_occ[tid] = o;
    if (tid < 4 * kCO) s_stat[tid] = 0.f;
    if (!__syncthreads_or(o)) {
      // no occupied output cell: every output of the tile is 0
      if (gx < a.X && gy < a.Y && gz < a.Z) {
        const long long cell =
            (((long long)b * a.X + gx) * a.Y + gy) * a.Z + gz;
        for (int c = co0; c < min(co0 + kCO, a.Cout); ++c) {
          if (a.out_f32)
            static_cast<float*>(a.out)[cell * a.Cout + c] = 0.f;
          else
            static_cast<__nv_bfloat16*>(a.out)[cell * a.Cout + c] =
                __float2bfloat16_rn(0.f);
          if constexpr (SECOND) a.out2[cell * a.Cout + c] = __float2bfloat16_rn(0.f);
        }
        if (MODE == kJoin && blockIdx.y == 0)
          for (int c = 0; c < a.Cin; ++c) a.yq[cell * a.Cin + c] = 0;
      }
      return;
    }
  }

  const int cg = tid & 3;   // output channels co0 + cg * 8 + j, j < 8
  const int pg = tid >> 2;  // cells lx = i (i < 4), ly = pg / 8, lz = pg % 8
  const int ly = pg >> 3, lz = pg & 7;

  int acc[4][8];
  int acc2[SECOND ? 4 : 1][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0;
#pragma unroll
  for (int i = 0; i < (SECOND ? 4 : 1); ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc2[i][j] = 0;

  const int cin4p = a.CinP / 4;
  for (int c0 = 0; c0 < a.CinP; c0 += kCK) {
    __syncthreads();  // the previous stage's reads are done
    if (MODE != kNone && tid < kCK) {
      const int c = c0 + tid;
      const bool in = c < a.Cin;
      const long long bc = (long long)b * a.Cin + c;
      s_aff[tid] = in ? a.A[bc] : 0.f;
      s_aff[kCK + tid] = in ? a.Bc[bc] : 0.f;
      s_aff[2 * kCK + tid] = (MODE == kJoin && in) ? a.Ar[bc] : 0.f;
      s_aff[3 * kCK + tid] = (MODE == kJoin && in) ? a.Br[bc] : 0.f;
      s_aff[4 * kCK + tid] = in ? a.inv[c] : 0.f;
    }
    // weights of the stage: [tap][word][32 output channels], 16-byte copies
    for (int e = tid; e < TAPS * kWords * (kCO / 4); e += kThreads) {
      const int v = e % (kCO / 4);
      const int g = (e / (kCO / 4)) % kWords;
      const int tap = e / (kCO / 4 * kWords);
      const int4 src = *reinterpret_cast<const int4*>(
          a.w + ((long long)tap * cin4p + c0 / 4 + g) * a.CoutP + co0 +
          4 * v);
      *reinterpret_cast<int4*>(s_w + (tap * kWords + g) * kCO + 4 * v) = src;
    }
    if constexpr (SECOND) {
      for (int e = tid; e < kWords * (kCO / 4); e += kThreads) {
        const int v = e % (kCO / 4);
        const int g = e / (kCO / 4);
        *reinterpret_cast<int4*>(s_wd + g * kCO + 4 * v) =
            *reinterpret_cast<const int4*>(
                a.wd + (long long)(c0 / 4 + g) * a.CoutP + co0 + 4 * v);
      }
    }
    __syncthreads();  // s_aff is read by the halo's prologue
    load_halo<KS, MODE, RES_I8>(a, s_in, s_aff, b, x0, y0, z0, c0);
    __syncthreads();

    if (MODE == kJoin && blockIdx.y == 0) {
      // the quantized centre cells are the next block's residual
      for (int e = tid; e < kCells * kWords; e += kThreads) {
        const int g = e % kWords;
        const int l = e / kWords;
        const int lx = l >> 5, lyy = (l >> 3) & 3, lzz = l & 7;
        const int gx = x0 + lx, gy = y0 + lyy, gz = z0 + lzz;
        const int c = c0 + 4 * g;
        if (gx < a.X && gy < a.Y && gz < a.Z && c < a.Cin) {
          const long long cell =
              (((long long)b * a.X + gx) * a.Y + gy) * a.Z + gz;
          const int h = ((lx + R) * HY + (lyy + R)) * HZ + (lzz + R);
          *reinterpret_cast<int*>(a.yq + cell * a.Cin + c) =
              s_in[h * kWords + g];
        }
      }
    }

#pragma unroll 1
    for (int tap = 0; tap < TAPS; ++tap) {
      const int dx = tap / (KS * KS), dy = (tap / KS) % KS, dz = tap % KS;
      const int* wt = s_w + tap * kWords * kCO + cg * 8;
#pragma unroll
      for (int g4 = 0; g4 < kWords; g4 += 4) {
        int4 av[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int h = ((i + dx) * HY + (ly + dy)) * HZ + (lz + dz);
          av[i] = *reinterpret_cast<const int4*>(s_in + h * kWords + g4);
        }
#pragma unroll
        for (int gg = 0; gg < 4; ++gg) {
          const int4 b0 = *reinterpret_cast<const int4*>(wt + (g4 + gg) * kCO);
          const int4 b1 =
              *reinterpret_cast<const int4*>(wt + (g4 + gg) * kCO + 4);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int ai = comp(av[i], gg);
            acc[i][0] = __dp4a(ai, b0.x, acc[i][0]);
            acc[i][1] = __dp4a(ai, b0.y, acc[i][1]);
            acc[i][2] = __dp4a(ai, b0.z, acc[i][2]);
            acc[i][3] = __dp4a(ai, b0.w, acc[i][3]);
            acc[i][4] = __dp4a(ai, b1.x, acc[i][4]);
            acc[i][5] = __dp4a(ai, b1.y, acc[i][5]);
            acc[i][6] = __dp4a(ai, b1.z, acc[i][6]);
            acc[i][7] = __dp4a(ai, b1.w, acc[i][7]);
          }
        }
      }
    }
    if constexpr (SECOND) {
      const int* wt = s_wd + cg * 8;
#pragma unroll
      for (int g4 = 0; g4 < kWords; g4 += 4) {
        int4 av[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int h = ((i + R) * HY + (ly + R)) * HZ + (lz + R);
          av[i] = *reinterpret_cast<const int4*>(s_in + h * kWords + g4);
        }
#pragma unroll
        for (int gg = 0; gg < 4; ++gg) {
          const int4 b0 = *reinterpret_cast<const int4*>(wt + (g4 + gg) * kCO);
          const int4 b1 =
              *reinterpret_cast<const int4*>(wt + (g4 + gg) * kCO + 4);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int ai = comp(av[i], gg);
            acc2[i][0] = __dp4a(ai, b0.x, acc2[i][0]);
            acc2[i][1] = __dp4a(ai, b0.y, acc2[i][1]);
            acc2[i][2] = __dp4a(ai, b0.z, acc2[i][2]);
            acc2[i][3] = __dp4a(ai, b0.w, acc2[i][3]);
            acc2[i][4] = __dp4a(ai, b1.x, acc2[i][4]);
            acc2[i][5] = __dp4a(ai, b1.y, acc2[i][5]);
            acc2[i][6] = __dp4a(ai, b1.z, acc2[i][6]);
            acc2[i][7] = __dp4a(ai, b1.w, acc2[i][7]);
          }
        }
      }
    }
  }

  // epilogue: requant, occupancy mask, cast, stats
  const bool stats = a.stats != nullptr;
  float s1[8], s2[8], d1[8], d2[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) s1[j] = s2[j] = d1[j] = d2[j] = 0.f;
  const int cbase = co0 + cg * 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gx = x0 + i, gy = y0 + ly, gz = z0 + lz;
    if (gx >= a.X || gy >= a.Y || gz >= a.Z) continue;
    const float occf = s_occ[(i * kTY + ly) * kTZ + lz] ? 1.f : 0.f;
    const long long cell = (((long long)b * a.X + gx) * a.Y + gy) * a.Z + gz;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int co = cbase + j;
      if (co >= a.Cout) continue;
      const float v =
          __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j]), a.sw[co]), occf);
      float r;
      if (a.out_f32) {
        static_cast<float*>(a.out)[cell * a.Cout + co] = v;
        r = v;
      } else {
        const __nv_bfloat16 vb = __float2bfloat16_rn(v);
        static_cast<__nv_bfloat16*>(a.out)[cell * a.Cout + co] = vb;
        r = __bfloat162float(vb);
      }
      s1[j] += r;
      s2[j] += r * r;
      if constexpr (SECOND) {
        const float v2 = __fmul_rn(
            __fmul_rn(__int2float_rn(acc2[i][j]), a.swd[co]), occf);
        const __nv_bfloat16 vb2 = __float2bfloat16_rn(v2);
        a.out2[cell * a.Cout + co] = vb2;
        const float r2 = __bfloat162float(vb2);
        d1[j] += r2;
        d2[j] += r2 * r2;
      }
    }
  }
  if (!stats) return;
  // reduce over the 8 lanes of a warp that share cg, then over the warps
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      s1[j] += __shfl_xor_sync(0xffffffffu, s1[j], off);
      s2[j] += __shfl_xor_sync(0xffffffffu, s2[j], off);
      if constexpr (SECOND) {
        d1[j] += __shfl_xor_sync(0xffffffffu, d1[j], off);
        d2[j] += __shfl_xor_sync(0xffffffffu, d2[j], off);
      }
    }
  }
  if ((tid & 31) < 4) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      atomicAdd(&s_stat[cg * 8 + j], s1[j]);
      atomicAdd(&s_stat[kCO + cg * 8 + j], s2[j]);
      if constexpr (SECOND) {
        atomicAdd(&s_stat[2 * kCO + cg * 8 + j], d1[j]);
        atomicAdd(&s_stat[3 * kCO + cg * 8 + j], d2[j]);
      }
    }
  }
  __syncthreads();
  if (tid < a.nstats * kCO) {
    const int row = tid / kCO, c = tid % kCO;
    if (co0 + c < a.Cout)
      atomicAdd(&a.stats[((long long)b * a.nstats + row) * a.Cout + co0 + c],
                s_stat[tid]);
  }
}

template <int KS, int MODE, bool RES_I8, bool SECOND>
int launch(const Args& a, cudaStream_t s) {
  const long long tiles = (long long)a.B * a.ntx * a.nty * a.ntz;
  const dim3 grid((unsigned)tiles, (unsigned)(a.CoutP / kCO));
  int8_conv_kernel<KS, MODE, RES_I8, SECOND><<<grid, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// x: int8 (mode 0) or bf16 (modes 1, 2) [B, X, Y, Z, Cin]; res: int8 or
// bf16 (mode 2); occ: f32 0/1 [B, X, Y, Z]; w: int32 [ks^3, CinP/4, CoutP]
// (4 input channels per word, CinP and CoutP multiples of 32); sw: f32
// [Cout]; wd/swd: the optional 1x1 second output (mode 0, ks 3); A, Bc,
// Ar, Br: f32 [B, Cin]; inv: f32 [Cin]; out: bf16 or f32 (out_f32);
// out2: bf16; yq: int8 [B, X, Y, Z, Cin] (mode 2); stats: f32 zeroed
// [B, 2 or 4, Cout] or null. Cin % 4 == 0; all contiguous. Returns the
// cudaError_t of the launch.
extern "C" int int8_conv(const void* x, const void* res, const void* occ,
                         const void* w, const void* sw, const void* wd,
                         const void* swd, const void* A, const void* Bc,
                         const void* Ar, const void* Br, const void* inv,
                         void* out, void* out2, void* yq, void* stats, int B,
                         int X, int Y, int Z, int Cin, int Cout, int CinP,
                         int CoutP, int ks, int mode, int res_i8,
                         int out_f32, void* stream) {
  Args a;
  a.x = x;
  a.res = res;
  a.occ = static_cast<const float*>(occ);
  a.w = static_cast<const int*>(w);
  a.sw = static_cast<const float*>(sw);
  a.wd = static_cast<const int*>(wd);
  a.swd = static_cast<const float*>(swd);
  a.A = static_cast<const float*>(A);
  a.Bc = static_cast<const float*>(Bc);
  a.Ar = static_cast<const float*>(Ar);
  a.Br = static_cast<const float*>(Br);
  a.inv = static_cast<const float*>(inv);
  a.out = out;
  a.out2 = static_cast<__nv_bfloat16*>(out2);
  a.yq = static_cast<int8_t*>(yq);
  a.stats = static_cast<float*>(stats);
  a.B = B;
  a.X = X;
  a.Y = Y;
  a.Z = Z;
  a.Cin = Cin;
  a.Cout = Cout;
  a.CinP = CinP;
  a.CoutP = CoutP;
  a.ntx = (X + kTX - 1) / kTX;
  a.nty = (Y + kTY - 1) / kTY;
  a.ntz = (Z + kTZ - 1) / kTZ;
  a.out_f32 = out_f32;
  a.nstats = out2 ? 4 : 2;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const bool second = out2 != nullptr;
  if (ks == 1 && mode == kNone && !second)
    return launch<1, kNone, false, false>(a, s);
  if (ks == 3 && mode == kNone)
    return second ? launch<3, kNone, false, true>(a, s)
                  : launch<3, kNone, false, false>(a, s);
  if (ks == 3 && mode == kAffine && !second)
    return launch<3, kAffine, false, false>(a, s);
  if (ks == 3 && mode == kJoin && !second)
    return res_i8 ? launch<3, kJoin, true, false>(a, s)
                  : launch<3, kJoin, false, false>(a, s);
  return (int)cudaErrorInvalidValue;
}
