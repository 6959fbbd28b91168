// K3: batched subtile-min kNN candidates.
//
// Replaces the TPU kernel `knn_candidates_pallas_batched`
// (meshrcnn_tpu/ops/chamfer_pallas.py, body `_knn_kernel_b` -> `_knn_kernel_j`);
// K4, its single-sample form `knn_candidates_pallas`, is a launch with B=1.
// Contract: p [B,N,3] and q [B,M,3] float32 and a subtile s give
//   vals [B,C,N] float32, idx [B,C,N] int32, C = ceil(M/s),
// candidate-major. Entry (b,g,i) is the min squared distance from p_i to the
// run q[g*s : min((g+1)*s, M)) and its argmin; ties go to the first minimum and
// the ragged last run is cut at M. The caller (ops/chamfer.py) merges the C
// candidates of a point with an exact top-k. The Pallas kernel writes the same
// candidate-major layout ([B*J*G, n_pad]); the wrapper hands the merge a
// transposed [B,N,C] view.
//
// What bounds it on an H100: FP32 CUDA-core throughput. At the reference
// normal estimator's shapes (self-kNN, B=3, N=M=10^4, s=64, C=157) there are
// 3*10^8 point pairs at 9 FP32 operations each (3 sub, 3 mul, 2 add, 1
// compare): 0.040 ms at 67 TFLOP/s. The output is B*C*N*8 bytes = 37.7 MB,
// 0.011 ms at 3.35 TB/s, and the inputs 0.7 MB. So operations bound it, as for
// K1, and the same design serves:
//   * one thread owns QPT query points and keeps their running min and argmin
//     in registers; every q point read from shared memory feeds QPT distances;
//   * the block stages q through shared memory in structure-of-arrays tiles of
//     TILE points, walked in ascending index with strict `<`, so the first
//     minimum of a run wins without atomics; TILE is a multiple of every
//     subtile the wrapper accepts, so runs never straddle two tiles;
//   * at each run's end a warp stores 32 consecutive points' candidates of that
//     run: the candidate-major layout makes every store coalesced;
//   * to fill 132 SMs the q range is cut into `splits` spans of whole tiles
//     (blockIdx.y). A run lies inside one span, so spans write disjoint
//     candidates and need no merge pass.
// Distances are sqdist (sqdist.cuh): no FMA contraction, so the values are bit
// for bit those of the plain twin (ops/knn_cuda.py).
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a into a shared library
// with a plain C interface, loaded through ctypes (meshrcnn_tpu_torch/ops/knn_cuda.py).

#include <cuda_runtime.h>
#include <math_constants.h>

#include "sqdist.cuh"

namespace {

constexpr int THREADS = 128;  // threads per block
constexpr int QPT = 4;        // query points per thread
constexpr int TILE = 256;     // q points per shared-memory tile

// Candidates of every point of p [B,n,3] for the runs of q [B,m,3] in the span
// [blockIdx.y*span, min((blockIdx.y+1)*span, m)); grid (ceil(n/(THREADS*QPT)), spans, B).
__global__ void __launch_bounds__(THREADS)
knn_candidates_kernel(const float* __restrict__ p, const float* __restrict__ q,
                      int n, int m, int s, int span, int C,
                      float* __restrict__ vals, int* __restrict__ idx) {
  __shared__ float sx[TILE];
  __shared__ float sy[TILE];
  __shared__ float sz[TILE];

  const int b = blockIdx.z;
  const float* pb = p + (size_t)b * n * 3;
  const float* qb = q + (size_t)b * m * 3;
  float* vb = vals + (size_t)b * C * n;
  int* ib = idx + (size_t)b * C * n;

  float px[QPT], py[QPT], pz[QPT];
  const int i0 = blockIdx.x * THREADS * QPT + threadIdx.x;
#pragma unroll
  for (int k = 0; k < QPT; ++k) {
    const int i = i0 + k * THREADS;
    const int ic = i < n ? i : n - 1;  // lanes past n compute on a real point and never write
    px[k] = pb[3 * (size_t)ic];
    py[k] = pb[3 * (size_t)ic + 1];
    pz[k] = pb[3 * (size_t)ic + 2];
  }

  const int lo = blockIdx.y * span;
  const int hi = min(lo + span, m);
  for (int base = lo; base < hi; base += TILE) {
    const int cnt = min(TILE, hi - base);
    __syncthreads();  // every thread is done with the previous tile
    for (int t = threadIdx.x; t < cnt; t += THREADS) {
      const float* qp = qb + 3 * (size_t)(base + t);
      sx[t] = qp[0];
      sy[t] = qp[1];
      sz[t] = qp[2];
    }
    __syncthreads();
    for (int g0 = 0; g0 < cnt; g0 += s) {
      const int g1 = min(g0 + s, cnt);
      float best[QPT];
      int arg[QPT];
#pragma unroll
      for (int k = 0; k < QPT; ++k) {
        best[k] = CUDART_INF_F;
        arg[k] = base + g0;
      }
#pragma unroll 4
      for (int j = g0; j < g1; ++j) {
        const float qx = sx[j], qy = sy[j], qz = sz[j];
#pragma unroll
        for (int k = 0; k < QPT; ++k) {
          const float d = sqdist(px[k], py[k], pz[k], qx, qy, qz);
          if (d < best[k]) { best[k] = d; arg[k] = base + j; }
        }
      }
      const size_t row = (size_t)((base + g0) / s) * n;
#pragma unroll
      for (int k = 0; k < QPT; ++k) {
        const int i = i0 + k * THREADS;
        if (i < n) {
          vb[row + i] = best[k];
          ib[row + i] = arg[k];
        }
      }
    }
  }
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

}  // namespace

// Candidates on `stream`; s must divide TILE. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a subtile the kernel does not take.
extern "C" int knn_candidates(const float* p, const float* q, int B, int n, int m,
                              int s, int splits, float* vals, int* idx,
                              void* stream) {
  if (s <= 0 || TILE % s != 0) return static_cast<int>(cudaErrorInvalidValue);
  // spans are whole tiles; the spans actually used may be fewer than asked
  const int span = ceil_div(ceil_div(m, splits), TILE) * TILE;
  const int used = ceil_div(m, span);
  const dim3 grid(ceil_div(n, THREADS * QPT), used, B);
  knn_candidates_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      p, q, n, m, s, span, ceil_div(m, s), vals, idx);
  return static_cast<int>(cudaGetLastError());
}
