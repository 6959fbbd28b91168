// K1: batched nearest neighbour in both directions between two point clouds.
//
// Replaces the TPU kernel `_chamfer_bidir_pallas_batched`
// (meshrcnn_tpu/ops/chamfer_pallas.py, body `_kernel_b` -> `_kernel_body`).
// Contract, identical to it: p [B,N,3] and q [B,M,3] float32 give
//   d_p [B,N] float32, i_p [B,N] int32  (min squared distance into q, argmin)
//   d_q [B,M] float32, i_q [B,M] int32  (the same from q into p)
// with ties going to the lowest index.
//
// What bounds it on an H100: FP32 CUDA-core throughput. At the eval path's
// shapes (B=3, N=M=10^4) the pair count B*N*M is 3*10^8 at about 8-9 FP32
// operations a pair, while the bytes moved are under 1 MB. K=3 is far too thin
// for a tensor-core Gram, and the argmins must stay exact f32 (a bf16 Gram
// flipped enough of them to cost held-out F1), so distances are formed in
// difference form on the CUDA cores:
//   d = (dx*dx + dy*dy) + dz*dz, each operation rounded separately (no FMA
//   contraction), so the result is bit-for-bit the plain PyTorch twin's.
//
// Design:
//   * one thread owns QPT query points and keeps their running min and argmin
//     in registers, so every reference point read from shared memory feeds
//     QPT distance evaluations;
//   * the block stages the other cloud through shared memory in tiles of TILE
//     points, stored structure-of-arrays; the ragged edge is masked by count;
//   * updates take strict `<` while indices ascend, so the first minimum wins
//     with no atomics and the result is deterministic;
//   * to fill 132 SMs at N = 10^4 the reference range is cut into `splits`
//     contiguous spans, one per blockIdx.y; each span writes a partial
//     (min, argmin) and a second kernel merges the spans in ascending order
//     with the same strict `<`, which keeps the lowest-index tie rule.
// Both directions are two launches of the one-direction kernel with the roles
// swapped. That does twice the pair work of the fused TPU sweep, which took
// both directions from one distance tile; a fused single sweep (for example a
// packed 64-bit (dist_bits, idx) atomicMin for the column direction, which is
// order-independent) is left for later work.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a into a shared library
// with a plain C interface, loaded through ctypes
// (meshrcnn_tpu_torch/ops/chamfer_cuda.py).

#include <cuda_runtime.h>
#include <math_constants.h>

#include "sqdist.cuh"

namespace {

constexpr int THREADS = 128;  // threads per block
constexpr int QPT = 4;        // query points per thread
constexpr int TILE = 256;     // reference points per shared-memory tile

// Partial nearest neighbour of every point of x [B,n,3] within the span
// [s*span, min((s+1)*span, m)) of y [B,m,3]; grid (ceil(n/(THREADS*QPT)), splits, B).
// Writes part_d / part_i laid out [splits, B, n].
__global__ void __launch_bounds__(THREADS)
nn_partial_kernel(const float* __restrict__ x, const float* __restrict__ y,
                  int n, int m, int span,
                  float* __restrict__ part_d, int* __restrict__ part_i) {
  __shared__ float sx[TILE];
  __shared__ float sy[TILE];
  __shared__ float sz[TILE];

  const int b = blockIdx.z;
  const int s = blockIdx.y;
  const float* xb = x + (size_t)b * n * 3;
  const float* yb = y + (size_t)b * m * 3;

  float px[QPT], py[QPT], pz[QPT], best[QPT];
  int arg[QPT];
  const int i0 = blockIdx.x * THREADS * QPT + threadIdx.x;
#pragma unroll
  for (int k = 0; k < QPT; ++k) {
    const int i = i0 + k * THREADS;
    const int ic = i < n ? i : n - 1;  // lanes past n compute on a real point and never write
    px[k] = xb[3 * (size_t)ic];
    py[k] = xb[3 * (size_t)ic + 1];
    pz[k] = xb[3 * (size_t)ic + 2];
    best[k] = CUDART_INF_F;
    arg[k] = 0;
  }

  const int lo = s * span;
  const int hi = min(lo + span, m);
  for (int base = lo; base < hi; base += TILE) {
    const int cnt = min(TILE, hi - base);
    __syncthreads();  // every thread is done with the previous tile
    for (int t = threadIdx.x; t < cnt; t += THREADS) {
      const float* yp = yb + 3 * (size_t)(base + t);
      sx[t] = yp[0];
      sy[t] = yp[1];
      sz[t] = yp[2];
    }
    __syncthreads();
    if (cnt == TILE) {
#pragma unroll 4
      for (int j = 0; j < TILE; ++j) {
        const float qx = sx[j], qy = sy[j], qz = sz[j];
#pragma unroll
        for (int k = 0; k < QPT; ++k) {
          const float d = sqdist(px[k], py[k], pz[k], qx, qy, qz);
          if (d < best[k]) { best[k] = d; arg[k] = base + j; }
        }
      }
    } else {
      for (int j = 0; j < cnt; ++j) {
        const float qx = sx[j], qy = sy[j], qz = sz[j];
#pragma unroll
        for (int k = 0; k < QPT; ++k) {
          const float d = sqdist(px[k], py[k], pz[k], qx, qy, qz);
          if (d < best[k]) { best[k] = d; arg[k] = base + j; }
        }
      }
    }
  }

  const size_t row = ((size_t)s * gridDim.z + b) * n;
#pragma unroll
  for (int k = 0; k < QPT; ++k) {
    const int i = i0 + k * THREADS;
    if (i < n) {
      part_d[row + i] = best[k];
      part_i[row + i] = arg[k];
    }
  }
}

// Merge the spans in ascending order; strict `<` keeps the lowest index on ties.
__global__ void nn_merge_kernel(const float* __restrict__ part_d,
                                const int* __restrict__ part_i,
                                int splits, int total,
                                float* __restrict__ d, int* __restrict__ idx) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  float best = part_d[t];
  int arg = part_i[t];
  for (int s = 1; s < splits; ++s) {
    const float v = part_d[(size_t)s * total + t];
    if (v < best) { best = v; arg = part_i[(size_t)s * total + t]; }
  }
  d[t] = best;
  idx[t] = arg;
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

void one_direction(const float* x, const float* y, int B, int n, int m,
                   int splits, float* part_d, int* part_i, float* d, int* idx,
                   cudaStream_t stream) {
  // spans are whole tiles; the spans actually used may be fewer than asked
  const int span = ceil_div(ceil_div(m, splits), TILE) * TILE;
  const int used = ceil_div(m, span);
  const dim3 grid(ceil_div(n, THREADS * QPT), used, B);
  nn_partial_kernel<<<grid, THREADS, 0, stream>>>(x, y, n, m, span, part_d, part_i);
  const int total = B * n;
  nn_merge_kernel<<<ceil_div(total, 256), 256, 0, stream>>>(part_d, part_i, used,
                                                            total, d, idx);
}

}  // namespace

// Both directions on `stream`. part_d / part_i are scratch of at least
// max(splits_p * B * n, splits_q * B * m) elements. Returns cudaGetLastError().
extern "C" int chamfer_nn_bidir(const float* p, const float* q, int B, int n, int m,
                                int splits_p, int splits_q,
                                float* part_d, int* part_i,
                                float* d_p, int* i_p, float* d_q, int* i_q,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  one_direction(p, q, B, n, m, splits_p, part_d, part_i, d_p, i_p, st);
  one_direction(q, p, B, m, n, splits_q, part_d, part_i, d_q, i_q, st);
  return static_cast<int>(cudaGetLastError());
}
