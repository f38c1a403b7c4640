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
// sum / sum of squares of the (rounded) outputs, summed in a fixed order.
//
// Replaces the TPU kernel mask3d_tpu/sparse/pallas_chain.py:512
// (chain_conv, body _chain_body :287), and serves the XLA int8 conv of
// mask3d_tpu/sparse/dense_ops.py:201 (dense_conv_same_int8) with the
// prologue `none`. The TPU kernel packs rows into 128 lanes, carries the
// occupancy in lane `cout`, and double-buffers DMA windows of rows; those
// are Mosaic workarounds. Here the occupancy is its own f32 grid and a
// block reads a halo tile of the grid directly.
//
// Bound on the H100 (chip_smoke.py prints both readings). At level 0 the
// bytes bound: the int8 (or bf16) grid read once and the bf16 output
// written at every cell, 0.25 ms for 96->96 over the flagship's 112x80x40
// x 8 grid, while the int8 work of the occupied outputs (10.8% of cells)
// takes 0.07 ms at 1979 TOP/s. Elsewhere the int8 operations bound. What a
// kernel of 16-cell fragments must compute is larger: the fragments that
// hold an occupied output, 0.44-0.63 of the 1.43 T int8 operations of the
// whole level-0 96->96 grid (0.32-0.46 ms at the peak).
//
// Design (the first kernel ran __dp4a on the CUDA cores over every
// cell of a non-empty 4x4x8 tile, one 32-channel output block at a time):
// 1. Tensor cores: mma.sync.m16n8k32 s8 x s8 -> s32. A is 16 cells x 32
//    input channels of the quantized halo in shared memory, loaded with
//    ldmatrix (int8 rows read as b16 pairs) from per-lane cell addresses.
//    A fragment is 4x4x1 cells (x, y, z): of the 16-cell shapes, the flat
//    one leaves the fewest live fragments on the flagship's fine levels.
//    The halo is stored chunk-major, [Cin/16][position][16 B], with the y
//    and x strides of a position chosen by the plan so the 8 rows of each
//    ldmatrix phase fall in distinct bank groups. B is the tap's [Cin x Cout] int8 weights, packed
//    by the wrapper in fragment order ([tap][k32][n16][lane][4 words]): one
//    16-byte load per lane feeds two mma.
// 2. Skipping: a tile with no occupied output writes zeros and stops; in a
//    live tile a fragment with no occupied output issues no ldmatrix and
//    no mma (its outputs are 0 by definition, x occ).
// 3. One halo, one prologue, all output channels: a block of 8 warps
//    computes every output channel of its tile, each warp 1 or 2 fragments
//    x 12 or 16 n-tiles (the warps split over the channels where one warp's
//    do not cover Cout: halves at Cout 256, quarters at 384). The halo is loaded and quantized once; the weights
//    stream through a 3-stage ring of (tap, group of 32-channel chunks)
//    filled by 16-byte cp.async, the first stages issued before the block
//    reads its occupancy. The tile's outputs are staged in shared memory
//    and written as whole rows of 16-byte stores.
// 4. Cout above 384 (the bottleneck's 512- and 1024-wide 1x1 expands and
//    residual downsamples): a grid dimension over channel groups of at most
//    256 outputs. A block computes one group with the tile of a Cout-256
//    conv (4 or 8 fragments) and streams only that group's weights; the
//    halo is loaded and quantized once a group (Cin bytes a cell a group,
//    small next to the weights). Each group writes its own channel range of
//    the outputs, of the split scratch and of the per-tile sums.
// 5. Filling the card on the coarse levels: the plan splits each tile's
//    (tap, chunk) stages over several blocks; each adds its int32 partial
//    sums into zeroed scratch with atomicAdd (integer sums are exact in any
//    order) and int8_conv_kernel_epilogue requantizes once after the sum.
// What holds it back (builds that left one phase out, PERF.md): at level
// 0 the mma and the other phases (halo, weight stream, epilogue) take
// about half the time each and overlap little with two blocks an SM; the
// next step is wgmma with a warp-specialized producer.
// Integer sums are exact in any order, so the conv is bitwise that of the
// plain version and of any other launch. The f32 stats are not exact, so
// they are summed without atomics, in an order fixed by the plan: each
// block sums its tile's cells in order into its own slot of `parts`, and
// int8_conv_stats_reduce adds the slots of an item in a fixed order. They
// are bitwise equal from launch to launch (and the chain's quantize steps,
// which divide by them, with them).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;   // a block
constexpr int kStages = 3;  // weight ring depth
constexpr int kFX = 4, kFY = 4, kFZ = 1;  // fragment shape (16 cells)

enum { kNone = 0, kAffine = 1, kJoin = 2 };

struct Args {
  const void* x;
  const void* res;
  const float* occ;    // [B, X, Y, Z] 0/1
  const uint4* w;      // [taps][KC][CoutP/16][32][4 words]
  const float* sw;     // [Cout]
  const uint4* wd;     // [1][KC][CoutP/16][32][4 words]
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
  float* parts;        // [B * nparts, nstats, Cout]: per tile (or per
                       // epilogue block) sums, then reduced into stats
  int* part;           // split: [B*X*Y*Z, groups * CoutP] int32, zeroed
  int* part2;          // split + second output: the same
  int B, X, Y, Z, Cin, Cout, CinP, CoutP;  // CoutP: one group's padded width
  int groups, coutg;   // channel groups (grid z) of coutg outputs
  int gx, gy, gz;      // fragments a tile, per axis
  int ntx, nty, ntz;   // tiles per axis
  int ys, xs, npos;    // halo position strides and count
  int kcs;             // 32-channel chunks a weight stage
  int splits;
  int out_f32, nstats;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
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
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
// c += a (16x32 s8, row) * b (32x8 s8, col), s32 accumulators
__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float bf16_bits(uint32_t bits16) {
  return __uint_as_float(bits16 << 16);
}

__device__ __forceinline__ uint32_t quantize(float h, float inv) {
  h = fmaxf(h, 0.f);
  float q = rintf(__fmul_rn(h, inv));
  q = fminf(fmaxf(q, -127.f), 127.f);
  return (uint32_t)(uint8_t)(int8_t)(int)q;
}

__host__ __device__ constexpr int round16(int x) { return (x + 15) & ~15; }

// the staged output rows of a tile: [cells][row] of esize-byte outputs, 16
// bytes of padding a row against bank conflicts
__host__ __device__ inline int stage_row(int coutp, int esize) {
  return round16(coutp * esize) + 16;
}

// dynamic shared memory: halo [CinP/16][npos][16 B] | weight ring
// [kStages][kcs * CoutP * 32 B], after the main loop the staged outputs
// [cells][stage_row] | prologue constants [5][CinP] f32 | occupancy of the
// output tile [cells] u8 | live fragments [nfrag] u8
struct Smem {
  int halo, ring, stage, aff, occ, live, total;
};
__host__ __device__ inline Smem smem_layout(int cinp, int coutp, int npos,
                                            int kcs, int cells, int nfrag,
                                            bool aff, int esize) {
  Smem s;
  s.halo = 0;
  s.stage = kcs * coutp * 32;
  s.ring = cinp * npos;
  const int ring = kStages * s.stage;
  const int staged = cells * stage_row(coutp, esize);
  s.aff = s.ring + (ring > staged ? ring : staged);
  s.occ = s.aff + (aff ? 5 * cinp * 4 : 0);
  s.live = s.occ + round16(cells);
  s.total = s.live + round16(nfrag);
  return s;
}

struct Tile {
  int b, x0, y0, z0, tx, ty, tz;
};

// this block's channel group: outputs [c0, c0 + n)
struct Group {
  int g, c0, n;
};
__device__ __forceinline__ Group group_of(const Args& a) {
  Group G;
  G.g = blockIdx.z;
  G.c0 = G.g * a.coutg;
  G.n = min(a.coutg, a.Cout - G.c0);
  return G;
}

__device__ __forceinline__ Tile tile_of(const Args& a, int t) {
  Tile T;
  T.tx = kFX * a.gx;
  T.ty = kFY * a.gy;
  T.tz = kFZ * a.gz;
  const int iz = t % a.ntz;
  t /= a.ntz;
  const int iy = t % a.nty;
  t /= a.nty;
  const int ix = t % a.ntx;
  T.b = t / a.ntx;
  T.x0 = ix * T.tx;
  T.y0 = iy * T.ty;
  T.z0 = iz * T.tz;
  return T;
}

__device__ __forceinline__ long long cell_index(const Args& a, int b, int x,
                                                int y, int z) {
  return (((long long)b * a.X + x) * a.Y + y) * a.Z + z;
}

// tile-local cell (lx, ly, lz) of fragment f, row r (0..15)
__device__ __forceinline__ void frag_cell(const Args& a, const Tile& T,
                                          int f, int r, int& lx, int& ly,
                                          int& lz) {
  const int fz_ = f % a.gz, fy_ = (f / a.gz) % a.gy, fx_ = f / (a.gz * a.gy);
  const int iz = r % kFZ, iy = (r / kFZ) % kFY, ix = r / (kFZ * kFY);
  lx = fx_ * kFX + ix;
  ly = fy_ * kFY + iy;
  lz = fz_ * kFZ + iz;
}

// The quantized halo of the tile: every halo cell's CinP channels, chunk
// c of position p at halo + (c * npos + p) * 16. Mode none copies the int8
// grid with cp.async (committed with the first weight stage); the
// prologues compute q in registers.
template <int KS, int MODE, bool RES_I8>
__device__ __forceinline__ void load_halo(const Args& a, const Tile& T,
                                          unsigned char* halo,
                                          const float* s_aff) {
  constexpr int R = KS / 2;
  const int hx = T.tx + KS - 1, hy = T.ty + KS - 1, hz = T.tz + KS - 1;
  const int nch = a.CinP / 16;
  const int total = hx * hy * hz * nch;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int c = e % nch;
    int h = e / nch;
    const int iz = h % hz;
    h /= hz;
    const int iy = h % hy, ix = h / hy;
    const int gx = T.x0 + ix - R, gy = T.y0 + iy - R, gz = T.z0 + iz - R;
    const int pos = ix * a.xs + iy * a.ys + iz;
    unsigned char* dst = halo + ((long long)c * a.npos + pos) * 16;
    const bool in = gx >= 0 && gx < a.X && gy >= 0 && gy < a.Y && gz >= 0 &&
                    gz < a.Z && c * 16 < a.Cin;
    const long long cell = in ? cell_index(a, T.b, gx, gy, gz) : 0;
    const long long at = cell * a.Cin + c * 16;
    if (MODE == kNone) {
      cp_async16(dst, static_cast<const int8_t*>(a.x) + (in ? at : 0),
                 in ? 16 : 0);
      continue;
    }
    uint4 word = make_uint4(0u, 0u, 0u, 0u);
    if (in && a.occ[cell] > 0.5f) {
      const uint4* xp = reinterpret_cast<const uint4*>(
          static_cast<const __nv_bfloat16*>(a.x) + at);
      const uint4 xv[2] = {xp[0], xp[1]};
      uint32_t xw[8] = {xv[0].x, xv[0].y, xv[0].z, xv[0].w,
                        xv[1].x, xv[1].y, xv[1].z, xv[1].w};
      float r[16];
      if (MODE == kJoin) {
        if (RES_I8) {
          const uint4 rv = *reinterpret_cast<const uint4*>(
              static_cast<const int8_t*>(a.res) + at);
          const uint32_t rw[4] = {rv.x, rv.y, rv.z, rv.w};
#pragma unroll
          for (int i = 0; i < 16; ++i)
            r[i] = (float)(int8_t)((rw[i >> 2] >> (8 * (i & 3))) & 0xffu);
        } else {
          const uint4* rp = reinterpret_cast<const uint4*>(
              static_cast<const __nv_bfloat16*>(a.res) + at);
          const uint4 rv[2] = {rp[0], rp[1]};
          const uint32_t rw[8] = {rv[0].x, rv[0].y, rv[0].z, rv[0].w,
                                  rv[1].x, rv[1].y, rv[1].z, rv[1].w};
#pragma unroll
          for (int i = 0; i < 16; ++i)
            r[i] = bf16_bits((rw[i >> 1] >> (16 * (i & 1))) & 0xffffu);
        }
      }
      uint32_t q[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int ch = c * 16 + i;
        const float xf = bf16_bits((xw[i >> 1] >> (16 * (i & 1))) & 0xffffu);
        float hv = __fadd_rn(__fmul_rn(xf, s_aff[ch]), s_aff[a.CinP + ch]);
        if (MODE == kJoin) {
          hv = __fadd_rn(hv, __fmul_rn(r[i], s_aff[2 * a.CinP + ch]));
          hv = __fadd_rn(hv, s_aff[3 * a.CinP + ch]);
        }
        q[i >> 2] |= quantize(hv, s_aff[4 * a.CinP + ch]) << (8 * (i & 3));
      }
      word = make_uint4(q[0], q[1], q[2], q[3]);
    }
    *reinterpret_cast<uint4*>(dst) = word;
  }
}

// zeros for every output of a tile with no occupied output cell
template <int MODE, bool SECOND>
__device__ void write_dead_tile(const Args& a, const Tile& T, const Group& G,
                                bool outputs) {
  const int cells = T.tx * T.ty * T.tz;
  if (outputs) {
    const int per = G.n / 2;  // pairs of the group's channels
    for (int e = threadIdx.x; e < cells * per; e += blockDim.x) {
      const int l = e / per, c = G.c0 + 2 * (e % per);
      const int lz = l % T.tz, ly = (l / T.tz) % T.ty, lx = l / (T.tz * T.ty);
      const int gx = T.x0 + lx, gy = T.y0 + ly, gz = T.z0 + lz;
      if (gx >= a.X || gy >= a.Y || gz >= a.Z) continue;
      const long long o = cell_index(a, T.b, gx, gy, gz) * a.Cout + c;
      if (a.out_f32)
        *reinterpret_cast<float2*>(static_cast<float*>(a.out) + o) =
            make_float2(0.f, 0.f);
      else
        *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(a.out) +
                                     o) = 0u;
      if (SECOND) *reinterpret_cast<uint32_t*>(a.out2 + o) = 0u;
    }
  }
  if (MODE == kJoin && G.g == 0) {
    const int nch = a.Cin / 16;
    for (int e = threadIdx.x; e < cells * nch; e += blockDim.x) {
      const int l = e / nch, c = e % nch;
      const int lz = l % T.tz, ly = (l / T.tz) % T.ty, lx = l / (T.tz * T.ty);
      const int gx = T.x0 + lx, gy = T.y0 + ly, gz = T.z0 + lz;
      if (gx >= a.X || gy >= a.Y || gz >= a.Z) continue;
      *reinterpret_cast<uint4*>(a.yq + cell_index(a, T.b, gx, gy, gz) *
                                           a.Cin + c * 16) =
          make_uint4(0u, 0u, 0u, 0u);
    }
  }
  if (outputs && a.stats != nullptr) {  // this tile's slot of the sums
    float* dst = a.parts + (long long)blockIdx.x * a.nstats * a.Cout + G.c0;
    for (int e = threadIdx.x; e < a.nstats * G.n; e += blockDim.x)
      dst[(e / G.n) * a.Cout + e % G.n] = 0.f;
  }
}

// The rows a lane holds in the accumulator layout: fragment i of the warp,
// rows gid and gid + 8 (hh = 0, 1): global cell (or -1 outside the grid)
// and occupancy.
template <int kMF>
struct Rows {
  long long cell[kMF][2];  // global cell, -1 outside the grid
  int l[kMF][2];           // tile-local cell
  float occ[kMF][2];
};

template <int kMF>
__device__ __forceinline__ Rows<kMF> lane_rows(const Args& a, const Tile& T,
                                          const uint8_t* s_occ, int f0,
                                          int lane) {
  Rows<kMF> w;
#pragma unroll
  for (int i = 0; i < kMF; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      int lx, ly, lz;
      frag_cell(a, T, f0 + i, (lane >> 2) + 8 * hh, lx, ly, lz);
      const int gx = T.x0 + lx, gy = T.y0 + ly, gz = T.z0 + lz;
      const bool in = gx < a.X && gy < a.Y && gz < a.Z;
      w.cell[i][hh] = in ? cell_index(a, T.b, gx, gy, gz) : -1;
      w.l[i][hh] = (lx * T.ty + ly) * T.tz + lz;
      w.occ[i][hh] = in && s_occ[(lx * T.ty + ly) * T.tz + lz] ? 1.f : 0.f;
    }
  return w;
}

// requant, mask and cast a warp's accumulators into the staged rows of
// the tile (row w.l, f32 or bf16)
template <int kMF, int NT>
__device__ __forceinline__ void stage_outputs(
    const Args& a, const Rows<kMF>& w, const int (&acc)[kMF][NT][4],
    const float* scale, unsigned char* staged, bool f32, int nt0, int ncg,
    int lane) {
  const int row = stage_row(a.CoutP, f32 ? 4 : 2);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int n = (nt0 + nt) * 8 + (lane & 3) * 2;  // within the group
    if (n >= ncg) continue;
    const float sc0 = scale[n], sc1 = scale[n + 1];
#pragma unroll
    for (int i = 0; i < kMF; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        if (w.cell[i][hh] < 0) continue;
        const float o = w.occ[i][hh];
        const float v0 = __fmul_rn(
            __fmul_rn(__int2float_rn(acc[i][nt][2 * hh]), sc0), o);
        const float v1 = __fmul_rn(
            __fmul_rn(__int2float_rn(acc[i][nt][2 * hh + 1]), sc1), o);
        unsigned char* d = staged + w.l[i][hh] * row;
        if (f32)
          *reinterpret_cast<float2*>(d + n * 4) = make_float2(v0, v1);
        else
          *reinterpret_cast<__nv_bfloat162*>(d + n * 2) =
              __floats2bfloat162_rn(v0, v1);
      }
  }
}

// the sum and sum of squares of each output channel over the staged rows
// of the tile's occupied cells (the others are 0), in the order of the
// cells, into rows row0, row0 + 1 of this block's slot of `parts`
__device__ __forceinline__ void tile_stats(const Args& a, const Group& G,
                                           const unsigned char* staged,
                                           const uint8_t* s_occ, int cells,
                                           bool f32, int row0) {
  const int row = stage_row(a.CoutP, f32 ? 4 : 2);
  float* dst = a.parts + ((long long)blockIdx.x * a.nstats + row0) * a.Cout +
               G.c0;
  for (int n = threadIdx.x; n < G.n; n += blockDim.x) {
    float s1 = 0.f, s2 = 0.f;
    for (int l = 0; l < cells; ++l) {
      if (!s_occ[l]) continue;
      const unsigned char* p = staged + l * row;
      const float r =
          f32 ? reinterpret_cast<const float*>(p)[n]
              : __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[n]);
      s1 = __fadd_rn(s1, r);
      s2 = __fadd_rn(s2, __fmul_rn(r, r));
    }
    dst[n] = s1;
    dst[a.Cout + n] = s2;
  }
}

// the staged rows of the tile's cells inside the grid -> dst, contiguous
// per cell (z-runs of cells are contiguous too): 16-byte stores where the
// rows allow, else 4-byte ones
__device__ __forceinline__ void copy_out(const Args& a, const Tile& T,
                                         const Group& G,
                                         const unsigned char* staged,
                                         void* dst, int esize) {
  const int row = stage_row(a.CoutP, esize);
  const int cell_bytes = a.Cout * esize;     // a cell's whole output row
  const int bytes = G.n * esize;             // this group's part of it
  const int cells = T.tx * T.ty * T.tz;
  unsigned char* out = static_cast<unsigned char*>(dst) + G.c0 * esize;
  const int vec =
      (bytes % 16 == 0 && cell_bytes % 16 == 0 && (G.c0 * esize) % 16 == 0)
          ? 16
          : 4;
  const int per = bytes / vec;
  for (int e = threadIdx.x; e < cells * per; e += blockDim.x) {
    const int l = e / per, v = e - (e / per) * per;
    const int lz = l % T.tz, ly = (l / T.tz) % T.ty, lx = l / (T.tz * T.ty);
    const int gx = T.x0 + lx, gy = T.y0 + ly, gz = T.z0 + lz;
    if (gx >= a.X || gy >= a.Y || gz >= a.Z) continue;
    unsigned char* g =
        out + cell_index(a, T.b, gx, gy, gz) * cell_bytes + v * vec;
    const unsigned char* s = staged + l * row + v * vec;
    if (vec == 16)
      *reinterpret_cast<uint4*>(g) = *reinterpret_cast<const uint4*>(s);
    else
      *reinterpret_cast<uint32_t*>(g) = *reinterpret_cast<const uint32_t*>(s);
  }
}

// split: add a warp's accumulators into the int32 scratch (live fragments)
template <int kMF, int NT>
__device__ __forceinline__ void add_partials(const Args& a,
                                             const Rows<kMF>& w,
                                             const int (&acc)[kMF][NT][4],
                                             const bool (&lv)[kMF], int* part,
                                             int nt0, int lane) {
#pragma unroll
  for (int i = 0; i < kMF; ++i) {
    if (!lv[i]) continue;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      if (w.cell[i][hh] < 0) continue;
      int* p = part + w.cell[i][hh] * (a.groups * a.CoutP) + nt0 * 8 +
               (lane & 3) * 2;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        atomicAdd(p + nt * 8, acc[i][nt][2 * hh]);
        atomicAdd(p + nt * 8 + 1, acc[i][nt][2 * hh + 1]);
      }
    }
  }
}

template <int kMF, int NT>
__device__ __forceinline__ void zero_acc(int (&acc)[kMF][NT][4]) {
#pragma unroll
  for (int i = 0; i < kMF; ++i)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      acc[i][nt][0] = acc[i][nt][1] = acc[i][nt][2] = acc[i][nt][3] = 0;
}

// one weight stage's k32 chunks [k0, k1) at tap offset toff
template <int kMF, int NT>
__device__ __forceinline__ void mma_stage(int (&acc)[kMF][NT][4],
                                          const bool (&lv)[kMF],
                                          const int (&p0)[kMF],
                                          uint32_t hbase, int npos,
                                          const uint4* wst, int np_all,
                                          int np0, int k0, int k1, int toff,
                                          int lane) {
  for (int kc = k0; kc < k1; ++kc) {
    uint32_t af[kMF][4];
#pragma unroll
    for (int i = 0; i < kMF; ++i)
      if (lv[i])
        ldmatrix_x4(af[i],
                    hbase + ((2 * kc) * npos + p0[i] + toff) * 16);
    const uint4* bp = wst + ((kc - k0) * np_all + np0) * 32 + lane;
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      const uint4 bw = bp[np * 32];
#pragma unroll
      for (int i = 0; i < kMF; ++i) {
        if (!lv[i]) continue;
        mma_s8(acc[i][2 * np], af[i], bw.x, bw.y);
        mma_s8(acc[i][2 * np + 1], af[i], bw.z, bw.w);
      }
    }
  }
}

// A block: one output tile (gx*gy*gz fragments of 4x4x1 = 16 cells) x
// every output channel x one split of the tile's (tap, chunk group) stages.
// 8 warps of kMF fragments each; one fragment a warp keeps to 128
// registers so that two blocks share an SM.
template <int KS, int MODE, bool RES_I8, bool SECOND, int NT, int kMF>
__global__ void __launch_bounds__(32 * kWarps, kMF == 1 ? 2 : 1)
    int8_conv_kernel(Args a) {
  constexpr int R = KS / 2;
  constexpr int TAPS = KS * KS * KS;
  extern __shared__ __align__(16) unsigned char smem[];
  const Tile T = tile_of(a, blockIdx.x);
  const Group G = group_of(a);
  const int split = blockIdx.y;
  const int nfrag = a.gx * a.gy * a.gz;
  const int cells = T.tx * T.ty * T.tz;
  const Smem L = smem_layout(a.CinP, a.CoutP, a.npos, a.kcs, cells, nfrag,
                             MODE != kNone, a.out_f32 ? 4 : 2);
  unsigned char* halo = smem + L.halo;
  unsigned char* ring = smem + L.ring;
  float* s_aff = reinterpret_cast<float*>(smem + L.aff);
  uint8_t* s_occ = smem + L.occ;
  uint8_t* s_live = smem + L.live;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // 1. this split's weight stages start streaming from L2 at once, while
  //    the block reads its tile's occupancy and halo
  const int nkc = a.CinP / 32;
  const int ngroups = (nkc + a.kcs - 1) / a.kcs;
  const int nst = TAPS * ngroups;
  const int lo = nst * split / a.splits, hi = nst * (split + 1) / a.splits;
  const int n_my = hi - lo;
  const int np_all = a.CoutP / 16;
  // this group's packed weights: [groups][taps][KC][CoutP/16][32][4 words]
  const uint4* wg = a.w + (long long)G.g * TAPS * nkc * np_all * 32;
  auto stage_k = [&](int st, int& tap, int& k0, int& k1) {
    tap = st / ngroups;
    k0 = (st % ngroups) * a.kcs;
    k1 = min(nkc, k0 + a.kcs);
  };
  auto issue = [&](int st, int slot, const uint4* src_w) {
    int tap, k0, k1;
    stage_k(st, tap, k0, k1);
    const uint4* src = src_w + (long long)(tap * nkc + k0) * np_all * 32;
    uint4* dst = reinterpret_cast<uint4*>(ring + slot * L.stage);
    const int n16 = (k1 - k0) * np_all * 32;
    for (int e = tid; e < n16; e += blockDim.x)
      cp_async16(dst + e, src + e, 16);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_my) issue(lo + s, s, wg);
    cp_async_commit();
  }

  // 2. occupancy of the output tile and its live fragments; a tile
  //    without any occupied cell stops here
  for (int f = tid; f < nfrag; f += blockDim.x) s_live[f] = 0;
  __syncthreads();
  int any = 0;
  for (int l = tid; l < cells; l += blockDim.x) {
    const int lz = l % T.tz, ly = (l / T.tz) % T.ty, lx = l / (T.tz * T.ty);
    const int gx = T.x0 + lx, gy = T.y0 + ly, gz = T.z0 + lz;
    uint8_t o = 0;
    if (gx < a.X && gy < a.Y && gz < a.Z)
      o = a.occ[cell_index(a, T.b, gx, gy, gz)] > 0.5f;
    s_occ[l] = o;
    if (o)  // fragment index as frag_cell decodes it
      s_live[((lx / kFX) * a.gy + ly / kFY) * a.gz + lz / kFZ] = 1;
    any |= o;
  }
  if (!__syncthreads_or(any)) {
    cp_async_wait<0>();  // no copy may land in a block that has left
    if (split == 0) write_dead_tile<MODE, SECOND>(a, T, G, a.splits == 1);
    return;
  }

  // 3. the halo, quantized by the prologue (mode none: copied as it is)
  if (MODE != kNone) {
    for (int c = tid; c < a.CinP; c += blockDim.x) {
      const bool in = c < a.Cin;
      const long long bc = (long long)T.b * a.Cin + c;
      s_aff[c] = in ? a.A[bc] : 0.f;
      s_aff[a.CinP + c] = in ? a.Bc[bc] : 0.f;
      s_aff[2 * a.CinP + c] = (MODE == kJoin && in) ? a.Ar[bc] : 0.f;
      s_aff[3 * a.CinP + c] = (MODE == kJoin && in) ? a.Br[bc] : 0.f;
      s_aff[4 * a.CinP + c] = in ? a.inv[c] : 0.f;
    }
  }
  __syncthreads();  // s_live and s_aff are read below
  load_halo<KS, MODE, RES_I8>(a, T, halo, s_aff);
  cp_async_commit();  // the halo's group, the newest

  // 4. this warp's fragments and channels
  const int nr_count = a.CoutP / (8 * NT);
  const int nr = warp % nr_count;  // warps over channels, then fragments
  const int f0 = (warp / nr_count) * kMF;
  const int nt0 = nr * NT, np0 = nt0 / 2;
  bool lv[kMF];
  int p0[kMF];
#pragma unroll
  for (int i = 0; i < kMF; ++i) {
    lv[i] = s_live[f0 + i] != 0;
    int lx, ly, lz;
    frag_cell(a, T, f0 + i, lane & 15, lx, ly, lz);
    p0[i] = lx * a.xs + ly * a.ys + lz;
  }
  const uint32_t hbase = smem_u32(halo) + (lane >> 4) * a.npos * 16;

  bool any_live = false;
#pragma unroll
  for (int i = 0; i < kMF; ++i) any_live |= lv[i];
  int acc[kMF][NT][4];
  zero_acc<kMF, NT>(acc);
  for (int t = 0; t < n_my; ++t) {
    // stage t landed (at t = 0 the halo too: its group is the newest)
    if (t == 0)
      cp_async_wait<0>();
    else
      cp_async_wait<kStages - 2>();
    __syncthreads();  // ... for every thread; slot t-1 is free
    if (t + kStages - 1 < n_my)
      issue(lo + t + kStages - 1, (t + kStages - 1) % kStages, wg);
    cp_async_commit();
    if (!any_live) continue;
    int tap, k0, k1;
    stage_k(lo + t, tap, k0, k1);
    const int toff = (tap / (KS * KS)) * a.xs + ((tap / KS) % KS) * a.ys +
                     tap % KS;
    mma_stage<kMF, NT>(acc, lv, p0, hbase, a.npos,
                  reinterpret_cast<const uint4*>(ring + (t % kStages) *
                                                            L.stage),
                  np_all, np0, k0, k1, toff, lane);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free

  // 5. yq: the quantized centre cells of a junction (group 0 writes them)
  if (MODE == kJoin && split == 0 && G.g == 0) {
    const int nch = a.Cin / 16;
    for (int e = tid; e < cells * nch; e += blockDim.x) {
      const int l = e / nch, c = e % nch;
      const int lz = l % T.tz, ly = (l / T.tz) % T.ty, lx = l / (T.tz * T.ty);
      const int gx = T.x0 + lx, gy = T.y0 + ly, gz = T.z0 + lz;
      if (gx >= a.X || gy >= a.Y || gz >= a.Z) continue;
      const int pos = (lx + R) * a.xs + (ly + R) * a.ys + (lz + R);
      *reinterpret_cast<uint4*>(a.yq + cell_index(a, T.b, gx, gy, gz) *
                                           a.Cin + c * 16) =
          *reinterpret_cast<const uint4*>(halo +
                                          ((long long)c * a.npos + pos) * 16);
    }
  }

  // 6. epilogue (or the split's partial sums), then the second output
  const Rows<kMF> w = lane_rows<kMF>(a, T, s_occ, f0, lane);
  const bool stats = a.stats != nullptr;
  if (a.splits == 1) {
    stage_outputs<kMF, NT>(a, w, acc, a.sw + G.c0, ring, a.out_f32, nt0,
                           G.n, lane);
    __syncthreads();
    copy_out(a, T, G, ring, a.out, a.out_f32 ? 4 : 2);
    if (stats) tile_stats(a, G, ring, s_occ, cells, a.out_f32, 0);
  } else {
    add_partials<kMF, NT>(a, w, acc, lv, a.part + G.g * a.CoutP, nt0, lane);
  }
  if (SECOND && split == 0) {
    zero_acc<kMF, NT>(acc);
    const int centre = R * a.xs + R * a.ys + R;
    for (int k0 = 0; k0 < nkc; k0 += a.kcs) {
      const int k1 = min(nkc, k0 + a.kcs);
      const uint4* src =
          a.wd + ((long long)G.g * nkc + k0) * np_all * 32;
      uint4* dst = reinterpret_cast<uint4*>(ring);
      __syncthreads();  // the ring's staged rows / last chunk are consumed
      for (int e = tid; e < (k1 - k0) * np_all * 32; e += blockDim.x)
        cp_async16(dst + e, src + e, 16);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      if (any_live)
        mma_stage<kMF, NT>(acc, lv, p0, hbase, a.npos, dst, np_all, np0, k0,
                           k1, centre, lane);
    }
    __syncthreads();
    if (a.splits == 1) {
      stage_outputs<kMF, NT>(a, w, acc, a.swd + G.c0, ring, false, nt0, G.n,
                             lane);
      __syncthreads();
      copy_out(a, T, G, ring, a.out2, 2);
      if (stats) tile_stats(a, G, ring, s_occ, cells, false, 2);
    } else {
      add_partials<kMF, NT>(a, w, acc, lv, a.part2 + G.g * a.CoutP, nt0,
                            lane);
    }
  }
}

// After a split launch: out (and out2) from the summed int32 scratch, and
// the block's sums of them into its slot of `parts`. A block takes 32
// cells of one item; a thread one channel.
template <bool SECOND>
__global__ void __launch_bounds__(256) int8_conv_kernel_epilogue(
    Args a) {
  const long long xyz = (long long)a.X * a.Y * a.Z;
  const int b = blockIdx.y;
  const long long c0 = (long long)blockIdx.x * 32;
  for (int n = threadIdx.x; n < a.Cout; n += blockDim.x) {
    float s1 = 0.f, s2 = 0.f, d1 = 0.f, d2 = 0.f;
    const float sc = a.sw[n], sc2 = SECOND ? a.swd[n] : 0.f;
    // column of channel n in the scratch: its group's CoutP-wide block
    const int pn = (n / a.coutg) * a.CoutP + n % a.coutg;
    const int pw = a.groups * a.CoutP;
    for (int l = 0; l < 32 && c0 + l < xyz; ++l) {
      const long long cell = b * xyz + c0 + l;
      const float o = a.occ[cell] > 0.5f ? 1.f : 0.f;
      const float v = __fmul_rn(
          __fmul_rn(__int2float_rn(a.part[cell * pw + pn]), sc), o);
      float r = v;
      if (a.out_f32) {
        static_cast<float*>(a.out)[cell * a.Cout + n] = v;
      } else {
        const __nv_bfloat16 vb = __float2bfloat16_rn(v);
        static_cast<__nv_bfloat16*>(a.out)[cell * a.Cout + n] = vb;
        r = __bfloat162float(vb);
      }
      s1 = __fadd_rn(s1, r);
      s2 = __fadd_rn(s2, __fmul_rn(r, r));
      if (SECOND) {
        const __nv_bfloat16 vb = __float2bfloat16_rn(__fmul_rn(
            __fmul_rn(__int2float_rn(a.part2[cell * pw + pn]), sc2), o));
        a.out2[cell * a.Cout + n] = vb;
        const float r2 = __bfloat162float(vb);
        d1 = __fadd_rn(d1, r2);
        d2 = __fadd_rn(d2, __fmul_rn(r2, r2));
      }
    }
    if (a.stats == nullptr) continue;
    float* st = a.parts +
                ((long long)b * gridDim.x + blockIdx.x) * a.nstats * a.Cout + n;
    st[0] = s1;
    st[a.Cout] = s2;
    if (SECOND) {
      st[2 * a.Cout] = d1;
      st[3 * a.Cout] = d2;
    }
  }
}

// stats[b][r] = the sum over p of parts[b * nparts + p][r] (r < rowlen):
// 8 warps take the slots p = w, w + 8, ... in order, then one adds their 8
// sums in order. A block takes 32 columns of one item.
__global__ void __launch_bounds__(256) int8_conv_stats_reduce(
    const float* __restrict__ parts, float* __restrict__ stats, int nparts,
    int rowlen) {
  __shared__ float s[8][32];
  const int col = threadIdx.x & 31, g = threadIdx.x >> 5;
  const int r = blockIdx.x * 32 + col, b = blockIdx.y;
  float sum = 0.f;
  if (r < rowlen) {
    const float* p = parts + (long long)b * nparts * rowlen + r;
#pragma unroll 4
    for (int i = g; i < nparts; i += 8)
      sum = __fadd_rn(sum, p[(long long)i * rowlen]);
  }
  s[g][col] = sum;
  __syncthreads();
  if (g == 0 && r < rowlen) {
    float t = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) t = __fadd_rn(t, s[j][col]);
    stats[(long long)b * rowlen + r] = t;
  }
}

template <int KS, int MODE, bool RES_I8, bool SECOND, int NT, int kMF>
int launch(const Args& a, cudaStream_t s) {
  const int nfrag = a.gx * a.gy * a.gz;
  if (a.CoutP % (8 * NT) || kWarps % (a.CoutP / (8 * NT)) ||
      nfrag != kWarps / (a.CoutP / (8 * NT)) * kMF)
    return (int)cudaErrorInvalidValue;
  const Smem L = smem_layout(a.CinP, a.CoutP, a.npos, a.kcs, nfrag * 16,
                             nfrag, MODE != kNone, a.out_f32 ? 4 : 2);
  auto kern = int8_conv_kernel<KS, MODE, RES_I8, SECOND, NT, kMF>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (e != cudaSuccess) return (int)e;
  const long long tiles = (long long)a.B * a.ntx * a.nty * a.ntz;
  kern<<<dim3((unsigned)tiles, (unsigned)a.splits, (unsigned)a.groups),
         32 * kWarps, L.total, s>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  long long nparts = tiles / a.B;  // slots of the sums an item
  if (a.splits > 1) {
    const long long xyz = (long long)a.X * a.Y * a.Z;
    nparts = (xyz + 31) / 32;
    int8_conv_kernel_epilogue<SECOND>
        <<<dim3((unsigned)nparts, (unsigned)a.B), 256, 0, s>>>(a);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (a.stats == nullptr) return 0;
  const int rowlen = a.nstats * a.Cout;
  int8_conv_stats_reduce<<<dim3((unsigned)((rowlen + 31) / 32),
                                (unsigned)a.B),
                           256, 0, s>>>(a.parts, a.stats, (int)nparts,
                                        rowlen);
  return (int)cudaGetLastError();
}

template <int NT, int MF>
int dispatch(const Args& a, int ks, int mode, int res_i8, bool second,
             cudaStream_t s) {
  if (ks == 1 && mode == kNone && !second)
    return launch<1, kNone, false, false, NT, MF>(a, s);
  if (ks == 3 && mode == kNone)
    return second ? launch<3, kNone, false, true, NT, MF>(a, s)
                  : launch<3, kNone, false, false, NT, MF>(a, s);
  if (ks == 3 && mode == kAffine && !second)
    return launch<3, kAffine, false, false, NT, MF>(a, s);
  if (ks == 3 && mode == kJoin && !second)
    return res_i8 ? launch<3, kJoin, true, false, NT, MF>(a, s)
                  : launch<3, kJoin, false, false, NT, MF>(a, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x: int8 (mode 0) or bf16 (modes 1, 2) [B, X, Y, Z, Cin]; res: int8 or
// bf16 (mode 2); occ: f32 0/1 [B, X, Y, Z]; w: the packed int8 weights
// [ks^3][CinP/32][CoutP/16][32 lanes][16 B] (CinP a multiple of 32, zero
// padded); sw: f32 [Cout]; wd/swd: the optional 1x1 second output (mode 0,
// ks 3), packed the same; A, Bc, Ar, Br: f32 [B, Cin]; inv: f32 [Cin];
// out: bf16 or f32 (out_f32); out2: bf16; yq: int8 [B, X, Y, Z, Cin]
// (mode 2); stats: f32 [B, 2 or 4, Cout] or null; parts: with stats, f32
// scratch [B * nparts, 2 or 4, Cout], nparts the tiles of an item
// (ceil(X/tx) * ceil(Y/ty) * ceil(Z/tz)) or, when split, ceil(X*Y*Z / 32);
// part/part2: int32 zeroed [B*X*Y*Z, groups * CoutP] when split. plan: gx,
// gy, gz (4x4x1 fragments a tile, per axis), ys, xs, npos (halo
// positions), kcs, splits, nt (12 or 16 n-tiles a warp), mf (1 or 2
// fragments a warp), groups, coutg (channel groups of coutg outputs; w and
// wd then hold each group's packed weights one after the other, CoutP
// being one group's padded width).
// Cin % 16 == 0, Cout % 2 == 0; all contiguous and 16-byte aligned.
// Returns the cudaError_t of the launches.
extern "C" int int8_conv(const void* x, const void* res, const void* occ,
                         const void* w, const void* sw, const void* wd,
                         const void* swd, const void* A, const void* Bc,
                         const void* Ar, const void* Br, const void* inv,
                         void* out, void* out2, void* yq, void* stats,
                         void* parts, void* part, void* part2, int B, int X, int Y, int Z,
                         int Cin, int Cout, int CinP, int CoutP, int ks,
                         int mode, int res_i8, int out_f32, const int* plan,
                         void* stream) {
  Args a;
  a.x = x;
  a.res = res;
  a.occ = static_cast<const float*>(occ);
  a.w = static_cast<const uint4*>(w);
  a.sw = static_cast<const float*>(sw);
  a.wd = static_cast<const uint4*>(wd);
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
  a.parts = static_cast<float*>(parts);
  a.part = static_cast<int*>(part);
  a.part2 = static_cast<int*>(part2);
  a.B = B;
  a.X = X;
  a.Y = Y;
  a.Z = Z;
  a.Cin = Cin;
  a.Cout = Cout;
  a.CinP = CinP;
  a.CoutP = CoutP;
  a.gx = plan[0];
  a.gy = plan[1];
  a.gz = plan[2];
  a.ys = plan[3];
  a.xs = plan[4];
  a.npos = plan[5];
  a.kcs = plan[6];
  a.splits = plan[7];
  const int nt = plan[8], mf = plan[9];
  a.groups = plan[10];
  a.coutg = plan[11];
  a.ntx = (X + kFX * a.gx - 1) / (kFX * a.gx);
  a.nty = (Y + kFY * a.gy - 1) / (kFY * a.gy);
  a.ntz = (Z + kFZ * a.gz - 1) / (kFZ * a.gz);
  a.out_f32 = out_f32;
  a.nstats = out2 ? 4 : 2;
  if (Cin % 16 || Cout % 2 || CinP % 32 || a.groups < 1 || a.coutg % 2 ||
      a.coutg > CoutP || (long long)a.groups * a.coutg < Cout ||
      (long long)(a.groups - 1) * a.coutg >= Cout ||
      a.splits < 1 || a.kcs < 1 || (a.splits > 1 && !part) ||
      (stats && !parts) ||
      (a.splits > 1 && out2 && !part2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const bool second = out2 != nullptr;
#define INT8_CONV_CASE(NT, MF)  \
  if (nt == NT && mf == MF)     \
    return dispatch<NT, MF>(a, ks, mode, res_i8, second, s);
  INT8_CONV_CASE(12, 1)
  INT8_CONV_CASE(12, 2)
  INT8_CONV_CASE(16, 1)
  INT8_CONV_CASE(16, 2)
#undef INT8_CONV_CASE
  return (int)cudaErrorInvalidValue;
}
