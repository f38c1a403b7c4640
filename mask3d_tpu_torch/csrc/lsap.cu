// Batched linear sum assignment: the Jonker-Volgenant shortest augmenting
// path solver of the JAX package (mask3d_tpu/ops/lsap.py:30, _solve_square,
// vmapped over the problems at :117), one square float32 problem a thread
// block, every problem of a batch in one launch.
//
// The JAX solver is no Pallas kernel: it is a lax.scan over rows with a
// lax.while_loop Dijkstra search inside, which XLA keeps on the device. On
// the card an eager PyTorch loop would wait for the host at every search
// step, so the loop lives in this kernel.
//
// Design: one block of ceil(n / 32) warps a problem, thread t owns column t
// (and row t for the row duals); u, v, spc, path, the scanned-row and
// scanned-column flags, col4row and row4col live in shared memory. A
// search step reads one cost row (coalesced), updates each unscanned
// column's shortest path in its own thread, and takes one block-wide
// (value, index) argmin: warp shuffles, then one warp over the warps'
// results; a tied value goes to the lower column, as jnp.argmin does. The
// dual update is elementwise; the augmentation walks the path in one
// thread. No atomics: a run repeats bitwise.
//
// Every sum is written as JAX orders it, with __fadd_rn / __fsub_rn so
// that nvcc contracts nothing: r = ((min_val + cost[i]) - u[i]) - v,
// u + min_val - spc[col] and v - (min_val - spc); the compare r < spc is
// strict. The assignment then equals JAX's bit for bit, ties included.
//
// Bound on the H100: the search is sequential, O(n) steps a row and O(n^2)
// a problem, each step a few block barriers; the bytes (the cost matrices
// read once, col4row written once) are far below a microsecond.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kSent = 0x7fffffff;  // "unassigned", JAX's SENT

struct ArgMin {
  float v;
  int i;
};

// The lower value; on a tie the lower index (inf ties resolve the same).
__device__ __forceinline__ ArgMin pick(ArgMin a, ArgMin b) {
  if (b.v < a.v || (b.v == a.v && b.i < a.i)) return b;
  return a;
}

__device__ __forceinline__ ArgMin warp_argmin(ArgMin a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    ArgMin b;
    b.v = __shfl_down_sync(0xffffffffu, a.v, off);
    b.i = __shfl_down_sync(0xffffffffu, a.i, off);
    a = pick(a, b);
  }
  return a;
}

__global__ void lsap_kernel(const float* __restrict__ cost, int n,
                            int32_t* __restrict__ out) {
  extern __shared__ unsigned char smem[];
  float* u = reinterpret_cast<float*>(smem);
  float* v = u + n;
  float* spc = v + n;
  int* path = reinterpret_cast<int*>(spc + n);
  int* col4row = path + n;
  int* row4col = col4row + n;
  unsigned char* sr = reinterpret_cast<unsigned char*>(row4col + n);
  unsigned char* sc = sr + n;
  __shared__ ArgMin warp_best[32];
  __shared__ ArgMin best;

  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;
  const bool own = t < n;
  const float* c = cost + (size_t)blockIdx.x * n * n;
  if (own) {
    u[t] = 0.f;
    v[t] = 0.f;
    col4row[t] = kSent;
    row4col[t] = kSent;
  }
  __syncthreads();

  for (int cur = 0; cur < n; ++cur) {
    if (own) {
      sr[t] = 0;
      sc[t] = 0;
      spc[t] = CUDART_INF_F;
      path[t] = 0;
    }
    __syncthreads();
    int i = cur, sink = kSent;
    float min_val = 0.f;
    while (sink == kSent) {
      // every thread reads u[i] before any write of this step
      const float ui = u[i];
      ArgMin mine{CUDART_INF_F, own ? t : kSent};
      if (own) {
        if (t == i) sr[t] = 1;
        if (!sc[t]) {
          const float r =
              __fsub_rn(__fsub_rn(__fadd_rn(min_val, c[(size_t)i * n + t]),
                                  ui),
                        v[t]);
          if (r < spc[t]) {
            spc[t] = r;
            path[t] = i;
          }
          mine.v = spc[t];
        }
      }
      mine = warp_argmin(mine);
      if (lane == 0) warp_best[warp] = mine;
      __syncthreads();
      if (warp == 0) {
        ArgMin a = lane < n_warps ? warp_best[lane]
                                  : ArgMin{CUDART_INF_F, kSent};
        a = warp_argmin(a);
        if (lane == 0) best = a;
      }
      __syncthreads();
      const ArgMin b = best;
      const int j = b.i;
      if (t == j) sc[t] = 1;
      const int nxt = row4col[j];
      if (nxt == kSent) {
        sink = j;
      } else {
        i = nxt;
      }
      min_val = b.v;
      __syncthreads();
    }

    // the dual update (scipy's _lsap.c, as JAX's)
    if (own) {
      if (t == cur) {
        u[t] = __fadd_rn(u[t], min_val);
      } else if (sr[t]) {
        const int col = col4row[t] == kSent ? 0 : col4row[t];
        u[t] = __fsub_rn(__fadd_rn(u[t], min_val), spc[col]);
      }
      if (sc[t]) v[t] = __fsub_rn(v[t], __fsub_rn(min_val, spc[t]));
    }
    __syncthreads();

    // augment along the alternating path, from the sink back to `cur`
    if (t == 0) {
      int j = sink;
      while (true) {
        const int r = path[j];
        row4col[j] = r;
        const int nj = col4row[r];
        col4row[r] = j;
        if (r == cur) break;
        j = nj;
      }
    }
    __syncthreads();
  }
  if (own) out[(size_t)blockIdx.x * n + t] = col4row[t];
}

}  // namespace

extern "C" int lsap_solve(const float* cost, long long problems, int n,
                          int32_t* out, cudaStream_t stream) {
  if (problems <= 0 || n <= 0) return 0;
  if (n > 1024) return (int)cudaErrorInvalidValue;
  const int threads = (n + 31) / 32 * 32;
  const size_t shared = (size_t)n * (3 * sizeof(float) + 3 * sizeof(int) + 2);
  lsap_kernel<<<(unsigned)problems, threads, shared, stream>>>(cost, n, out);
  return (int)cudaGetLastError();
}
