// K3: batched kNN from subtile-min candidates, the k best kept on chip.
//
// Replaces the TPU kernel `knn_candidates_pallas_batched`
// (meshrcnn_tpu/ops/chamfer_pallas.py, body `_knn_kernel_b` -> `_knn_kernel_j`)
// together with the `lax.top_k` merge that follows it in `batched_knn`
// (meshrcnn_tpu/ops/chamfer.py); K4, the single-sample form
// `knn_candidates_pallas` behind `knn`, is a launch with B=1.
// Contract: p [B,N,3] and q [B,M,3] float32, a subtile s and k give
//   dists [B,N,k] float32 ascending, idx [B,N,k] int32:
// the k smallest of the C = ceil(M/s) candidates of each point, where
// candidate g is the min squared distance from p_i to the run
// q[g*s : min((g+1)*s, M)) and its argmin (first minimum inside the run).
// Equal candidates keep the order of their runs (the rule of a stable sort,
// and of `lax.top_k` on the negated values); a point with fewer than k
// candidates repeats its last.
//
// What bounds it on an H100: the instruction rate of the FP32 CUDA cores, as for K1.
// Self-kNN at B=3, N=M=10^4 is 3*10^8 pairs at 8 arithmetic instructions
// (sqdist.cuh, no FMA, bit-equal to the plain twin) plus compare and two
// selects for the run's argmin. The TPU kernel wrote all C candidates to device
// memory (37.7 MB here) because a merge could not live in it, and a top-k read
// them back; here they never leave the registers, and 2.4 MB of results do.
//
//   * A thread owns QPT query points. For each it keeps the running (min,
//     argmin) of the current run and a sorted list of KC (value, index) pairs,
//     all in registers (KC is a template parameter: 10 and 16 with QPT = 2, 64
//     with QPT = 1, the slow form: 164 registers a thread, no spill).
//   * The block stages q through shared memory in x, y, z planes of TILE
//     points, read four points at a time as 16-byte vectors that every lane
//     reads at the same address (a broadcast): three reads feed 4 * QPT
//     distances. Runs are walked in ascending index with strict `<`, so the
//     first minimum of a run wins. TILE is a multiple of every subtile the
//     wrapper accepts, so a run never straddles two tiles. The ragged end of
//     a span is staged as NaN points: a NaN distance fails `<` and never wins,
//     so the inner loop needs no mask.
//   * At a run's end the thread offers (min, argmin) to its list: one compare
//     against the k-th entry rejects most offers, an unrolled insertion does
//     the rest. Values are compared as the unsigned bit patterns of
//     non-negative floats, with all-ones as the empty slot, so +inf
//     candidates keep their place too. Strict `<` puts an offer behind its
//     equals, and runs arrive in ascending order: the stable order.
//   * Filling the card: a block is 64 threads and 128 queries, 79 blocks a
//     sample of 10^4 points, too few at any B, so the q range is cut into
//     `spans` of whole tiles (blockIdx.y); the wrapper picks the cut from the
//     SM count, about eight blocks an SM. Each span writes its k best to
//     scratch [spans, B, k, N] as packed keys (value bits << 32 | index;
//     coalesced: consecutive threads, consecutive points), and a second
//     kernel, one thread a point, merges them. A key orders equal values by
//     index, and the index ascends with the run, so the merge is free to take
//     entries in any order: first the two best of every span (loads that do
//     not wait for one another), then the rest of each list up to its first
//     rejected entry. The scratch is spans * k entries a point, 4 to 20 spans
//     at 10^4 points, where the candidates were C = 157. (The other way, the
//     lanes of a warp splitting the runs of a few queries and merging by
//     shuffles, makes every lane read another run: no broadcast, and a padded
//     layout for each subtile to avoid 32-way bank conflicts.)
//   * What was tried and moved the sweep's time on an H100 by no more than its
//     spread: one to four queries a thread, 32 to 128 threads a block, a
//     register cap for more resident blocks, staging the next tile through
//     registers while the current one is computed, and tracking the argmin a
//     vector of four points at a time (fewer instructions a pair). The simple
//     form stays.
//
// NaN coordinates are outside the contract (the twin's `min` propagates NaN,
// the kernel's compare drops it); +inf distances are handled as the twin's.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a into a shared library
// with a plain C interface, loaded through ctypes (meshrcnn_tpu_torch/ops/knn_cuda.py).

#include <cuda_runtime.h>
#include <math_constants.h>

#include "sqdist.cuh"

namespace {

constexpr int THREADS = 64;           // threads per block of the sweep
constexpr int TILE = 256;             // q points per shared-memory tile
constexpr unsigned EMPTY = 0xffffffffu;  // above every float's bits: an empty slot

typedef unsigned long long u64;
constexpr u64 EMPTY_KEY = ~0ull;

// Insert (x, xi) into the ascending list behind its equals, dropping the last.
template <int KC>
__device__ __forceinline__ void offer(unsigned (&lv)[KC], int (&li)[KC], unsigned x, int xi) {
  if (x < lv[KC - 1]) {
#pragma unroll
    for (int t = KC - 1; t > 0; --t) {
      const bool up = x < lv[t - 1];   // the entry above moves down into slot t
      const bool here = x < lv[t];     // else the offer lands here, or the slot stays
      lv[t] = up ? lv[t - 1] : (here ? x : lv[t]);
      li[t] = up ? li[t - 1] : (here ? xi : li[t]);
    }
    if (x < lv[0]) {
      lv[0] = x;
      li[0] = xi;
    }
  }
}

// The same for packed keys (value bits << 32 | index), which order themselves:
// offers may come in any order.
template <int KC>
__device__ __forceinline__ void offer_key(u64 (&lk)[KC], u64 x) {
  if (x < lk[KC - 1]) {
#pragma unroll
    for (int t = KC - 1; t > 0; --t) {
      const bool up = x < lk[t - 1];
      const bool here = x < lk[t];
      lk[t] = up ? lk[t - 1] : (here ? x : lk[t]);
    }
    if (x < lk[0]) lk[0] = x;
  }
}

// The k best candidates of every point of p [B,n,3] among the runs of q [B,m,3]
// in the span [blockIdx.y*span, min((blockIdx.y+1)*span, m));
// grid (ceil(n/(THREADS*QPT)), spans, B). part is [spans, B, k, n] packed keys.
template <int KC, int QPT>
__global__ void __launch_bounds__(THREADS)
knn_sweep_kernel(const float* __restrict__ p, const float* __restrict__ q,
                 int n, int m, int s, int span, int k, u64* __restrict__ part) {
  __shared__ __align__(16) float sx[TILE];
  __shared__ __align__(16) float sy[TILE];
  __shared__ __align__(16) float sz[TILE];

  const int b = blockIdx.z;
  const float* pb = p + (size_t)b * n * 3;
  const float* qb = q + (size_t)b * m * 3;

  float px[QPT], py[QPT], pz[QPT];
  unsigned lv[QPT][KC];
  int li[QPT][KC];
  const int i0 = blockIdx.x * THREADS * QPT + threadIdx.x;
#pragma unroll
  for (int r = 0; r < QPT; ++r) {
    const int i = min(i0 + r * THREADS, n - 1);  // lanes past n compute on a real point and never write
    px[r] = pb[3 * (size_t)i];
    py[r] = pb[3 * (size_t)i + 1];
    pz[r] = pb[3 * (size_t)i + 2];
#pragma unroll
    for (int t = 0; t < KC; ++t) {
      lv[r][t] = EMPTY;
      li[r][t] = -1;  // with EMPTY, the all-ones key
    }
  }

  const int lo = blockIdx.y * span;
  const int hi = min(lo + span, m);
  for (int base = lo; base < hi; base += TILE) {
    const int cnt = min(TILE, hi - base);
    __syncthreads();  // every thread is done with the previous tile
    for (int t = threadIdx.x; t < TILE; t += THREADS) {
      const bool real = t < cnt;
      const float* qp = qb + 3 * (size_t)(base + (real ? t : 0));
      sx[t] = real ? qp[0] : CUDART_NAN_F;
      sy[t] = real ? qp[1] : CUDART_NAN_F;
      sz[t] = real ? qp[2] : CUDART_NAN_F;
    }
    __syncthreads();
    for (int g0 = 0; g0 < cnt; g0 += s) {
      float best[QPT];
      int arg[QPT];
#pragma unroll
      for (int r = 0; r < QPT; ++r) {
        best[r] = CUDART_INF_F;
        arg[r] = base + g0;
      }
#pragma unroll 2
      for (int j = g0; j < g0 + s; j += 4) {
        const float4 vx = *reinterpret_cast<const float4*>(&sx[j]);
        const float4 vy = *reinterpret_cast<const float4*>(&sy[j]);
        const float4 vz = *reinterpret_cast<const float4*>(&sz[j]);
        const float qx[4] = {vx.x, vx.y, vx.z, vx.w};
        const float qy[4] = {vy.x, vy.y, vy.z, vy.w};
        const float qz[4] = {vz.x, vz.y, vz.z, vz.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
#pragma unroll
          for (int r = 0; r < QPT; ++r) {
            const float d = sqdist(px[r], py[r], pz[r], qx[u], qy[u], qz[u]);
            if (d < best[r]) { best[r] = d; arg[r] = base + j + u; }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < QPT; ++r) offer<KC>(lv[r], li[r], __float_as_uint(best[r]), arg[r]);
    }
  }

  // the span's k best as packed keys; an empty slot is the all-ones key
  const size_t slab = ((size_t)blockIdx.y * gridDim.z + b) * k;
#pragma unroll
  for (int r = 0; r < QPT; ++r) {
    const int i = i0 + r * THREADS;
    if (i < n) {
#pragma unroll
      for (int t = 0; t < KC; ++t) {
        if (t < k)
          part[(slab + t) * n + i] =
              (static_cast<u64>(lv[r][t]) << 32) | static_cast<unsigned>(li[r][t]);
      }
    }
  }
}

// One thread a point: merge the spans' lists and write dists / idx [B,n,k];
// entries from `fill` = min(k, C) on repeat entry fill-1. A key orders equal
// values by index, which ascends with the run, so the merge may take the
// spans' entries in any order: first every span's two best, loads that do not
// wait for one another, then what is left of each list up to its first
// rejected entry (the list ascends: the rest fails too).
template <int KC>
__global__ void knn_merge_kernel(const u64* __restrict__ part, int spans, int B, int n,
                                 int k, int fill, float* __restrict__ dists,
                                 int* __restrict__ idx) {
  const long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= (long long)B * n) return;
  const int b = (int)(w / n), i = (int)(w % n);
  u64 lk[KC];
#pragma unroll
  for (int t = 0; t < KC; ++t) lk[t] = EMPTY_KEY;
  const int eager = k < 2 ? k : 2;
#pragma unroll 4
  for (int sp = 0; sp < spans; ++sp) {
    const size_t slab = ((size_t)sp * B + b) * k;
    u64 x[2];
#pragma unroll
    for (int t = 0; t < 2; ++t) x[t] = t < eager ? part[(slab + t) * n + i] : EMPTY_KEY;
#pragma unroll
    for (int t = 0; t < 2; ++t) offer_key<KC>(lk, x[t]);
  }
  for (int sp = 0; sp < spans; ++sp) {
    const size_t slab = ((size_t)sp * B + b) * k;
    for (int t = eager; t < k; ++t) {
      const u64 x = part[(slab + t) * n + i];
      if (!(x < lk[KC - 1])) break;
      offer_key<KC>(lk, x);
    }
  }
  u64 cur = EMPTY_KEY;
#pragma unroll
  for (int t = 0; t < KC; ++t) {
    if (t < k) {
      if (t < fill) cur = lk[t];
      dists[(size_t)w * k + t] = __uint_as_float(static_cast<unsigned>(cur >> 32));
      idx[(size_t)w * k + t] = static_cast<int>(cur & 0xffffffffu);
    }
  }
}

int ceil_div(long long a, int b) { return (int)((a + b - 1) / b); }

template <int KC, int QPT>
int run(const float* p, const float* q, int B, int n, int m, int s, int k,
        int query_blocks, int spans, int span, u64* part, float* dists, int* idx,
        cudaStream_t st) {
  if (query_blocks != ceil_div(n, THREADS * QPT)) return static_cast<int>(cudaErrorInvalidValue);
  knn_sweep_kernel<KC, QPT><<<dim3(query_blocks, spans, B), THREADS, 0, st>>>(
      p, q, n, m, s, span, k, part);
  const int C = ceil_div(m, s);
  knn_merge_kernel<KC><<<ceil_div((long long)B * n, 64), 64, 0, st>>>(
      part, spans, B, n, k, k < C ? k : C, dists, idx);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// kNN on `stream`. s must divide TILE, k be at most 64; the grid
// (query_blocks, spans, B) and `span` (points of q a span, a multiple of TILE)
// are the caller's plan, checked here. part is scratch of spans*B*k*n 64-bit
// words. Returns a cudaError (cudaGetLastError() after the launches,
// cudaErrorInvalidValue for what the kernels do not take).
extern "C" int knn_topk(const float* p, const float* q, int B, int n, int m, int s, int k,
                        int query_blocks, int spans, int span,
                        void* part, float* dists, int* idx, void* stream) {
  if (B <= 0 || n <= 0 || m <= 0 || s < 4 || TILE % s != 0 || k < 1 || k > 64 ||
      span <= 0 || span % TILE != 0 || spans != ceil_div(m, span))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  u64* pt = static_cast<u64*>(part);
  if (k <= 10) return run<10, 2>(p, q, B, n, m, s, k, query_blocks, spans, span, pt, dists, idx, st);
  if (k <= 16) return run<16, 2>(p, q, B, n, m, s, k, query_blocks, spans, span, pt, dists, idx, st);
  return run<64, 1>(p, q, B, n, m, s, k, query_blocks, spans, span, pt, dists, idx, st);
}
