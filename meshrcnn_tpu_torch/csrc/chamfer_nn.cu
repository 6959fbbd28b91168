// K1: batched nearest neighbour in both directions between two point clouds.
//
// Replaces the TPU kernel `_chamfer_bidir_pallas_batched`
// (meshrcnn_tpu/ops/chamfer_pallas.py, body `_kernel_b` -> `_kernel_body`);
// K2, its single-sample form `_chamfer_bidir_pallas`, is a launch with B=1.
// Contract, identical to it: p [B,N,3] and q [B,M,3] float32 give
//   d_p [B,N] float32, i_p [B,N] int32  (min squared distance into q, argmin)
//   d_q [B,M] float32, i_q [B,M] int32  (the same from q into p)
// with ties going to the lowest index.
//
// What bounds it on an H100: the instruction rate of the FP32 CUDA cores. At the
// eval path's shapes (B=3, N=M=10^4) there are 3*10^8 point pairs and under
// 1 MB of input and output. The distance is the difference form
//   d = (dx*dx + dy*dy) + dz*dz, each operation rounded separately,
// so that it is bit for bit the plain PyTorch twin's (sqdist.cuh): 8
// instructions a pair, none of them a fused multiply-add, so the floor of this
// arithmetic is pairs * instructions / (SMs * 128 lanes * clock), not the
// 67 TFLOP/s rate that only FMAs reach. K=3 is too thin for a tensor-core Gram
// and the argmins must stay exact float32. The design therefore spends as few
// instructions a pair as it can:
//
//   * One sweep serves both directions. The grid is (p tiles, q tiles, B) with
//     tiles of 128 p points by 256 q points; a block computes each of its
//     distances once and feeds it to the minimum of its p point and of its q
//     point: 8 arithmetic instructions and 2 `fminf` a pair, where two one-way
//     sweeps with a running argmin took 22.
//   * Register tile: a block is 16 row groups by 16 column groups of threads.
//     A thread keeps 8 p points (its row group) and their minima in registers
//     for the whole tile and walks its 16 q points in four steps of 4, read
//     from shared memory as three 16-byte vectors (x, y, z planes), so one
//     shared-memory read feeds 32 distances. The 16 threads of a row group
//     read the same p addresses (a broadcast); a step's q vectors are 256
//     contiguous bytes a plane, free of bank conflicts. 64 registers a thread,
//     four blocks (32 warps) an SM. (16 p points a thread, 128 registers and
//     two blocks an SM, was slower on an H100; q tiles of 512 or 1024 points
//     made the sweep faster and the rescan below slower by as much.)
//   * No index in the hot loop. The loop keeps minima only. A block knows which
//     tile its q points (p points) come from, so what it offers for a point is
//     the packed key (float bits of the minimum << 32) | tile number. For
//     non-negative floats the bit pattern orders as an unsigned integer, so
//     the smallest key is the smallest distance and, among equal distances,
//     the lowest tile. Inside the block the minima are reduced by halving
//     exchanges over warp shuffles (p side: 7 shuffles leave each of 8 lanes
//     with one row's minimum) and by shared-memory `atomicMin` on the float
//     bits (q side, across warps); then one global 64-bit `atomicMin` a point
//     a block. The minimum over keys does not depend on the order in which
//     blocks arrive, so the result is deterministic. (Reading the key first,
//     early or late, to skip atomics that cannot win, and letting the last
//     warp of a block make the offers without a block barrier, changed the
//     time by less than its spread; the plain form stays.)
//   * A second, small kernel resolves a key to (distance, index): 16 lanes a
//     point rescan the one winning tile with the same `sqdist` (the same bits,
//     so equality is exact) and take the first equal j by ballot. First tile
//     with the minimum, first j inside it: the lowest-index rule. That is 128
//     or 256 more pairs a point against 10^4.
//   * One tile pair a block leaves nothing to double-buffer: a block loads
//     4.5 KB, then computes 32,768 pairs; four blocks are resident on an SM and
//     one's loads hide behind the others' arithmetic. The 2-D grid is 3,160
//     blocks at B=1 and N=M=10^4, so a single sample fills the 132 SMs with no
//     heuristic that depends on B. TMA and `cp.async` would save nothing here.
//   * Ragged edges: rows past n and columns past m repeat the last real point.
//     A duplicate has its original's distances and tile, so it changes no
//     minimum and no key, and its own result is never written.
//
// NaN and infinity: `fminf` drops a NaN operand, so a NaN distance never
// lowers a minimum, and a point is offered only if its minimum is below +inf.
// A point with no distance below +inf (a NaN coordinate of its own, or only NaN
// or infinite distances) keeps the all-ones key and resolves to (+inf, 0); a
// NaN point of the other cloud is never anyone's neighbour. No NaN bit pattern
// reaches an `atomicMin`. -0.0 cannot arise from a sum of squares. The plain
// twin does the same (ops/chamfer_cuda.py: NaN distances read as +inf, strict
// `<` from (+inf, 0)).
//
// The FMA form (dx*dx, then two FMAs) would be 6 arithmetic instructions a pair
// in place of 8 but rounds twice less, which a CPU twin of separate operations
// cannot reproduce bit for bit; it is not used.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a into a shared library
// with a plain C interface, loaded through ctypes
// (meshrcnn_tpu_torch/ops/chamfer_cuda.py).

#include <cuda_runtime.h>
#include <math_constants.h>

#include "sqdist.cuh"

namespace {

constexpr int TY = 16;              // row groups of a block
constexpr int TX = 16;              // column groups: 16 neighbouring lanes
constexpr int RP = 8;               // p points a thread keeps in registers
constexpr int RQ = 4;               // q points a thread reads a step (one float4 a plane)
constexpr int THREADS = TY * TX;
constexpr int TILE_P = TY * RP;     // 128 p points of a block's tile pair
constexpr int TILE_Q = 256;         // q points of it, walked in steps of TX * RQ
constexpr int RG = 16;              // lanes that resolve one point's key
constexpr unsigned INF_BITS = 0x7f800000u;
constexpr unsigned long long EMPTY_KEY = ~0ull;
constexpr unsigned FULL = 0xffffffffu;

typedef unsigned long long u64;

// Offer `bits` (a minimum's float bits) with `tile` for one point.
__device__ __forceinline__ void offer(u64* slot, unsigned bits, int tile) {
  if (bits < INF_BITS) atomicMin(slot, (static_cast<u64>(bits) << 32) | static_cast<unsigned>(tile));
}

// Stage points [first, first + TILE) of cloud x [count,3], clamped to the last
// real point, into x, y, z planes.
template <int TILE>
__device__ __forceinline__ void stage(const float* __restrict__ x, int first, int count,
                                      float* sx, float* sy, float* sz) {
  for (int t = threadIdx.x; t < TILE; t += THREADS) {
    const float* xp = x + 3 * (size_t)min(first + t, count - 1);
    sx[t] = xp[0];
    sy[t] = xp[1];
    sz[t] = xp[2];
  }
}

// One tile pair of sample blockIdx.z: p tile blockIdx.x against q tile
// blockIdx.y. key_p [B,n] and key_q [B,m] start as EMPTY_KEY.
__global__ void __launch_bounds__(THREADS, 4)
nn_sweep_kernel(const float* __restrict__ p, const float* __restrict__ q, int n, int m,
                u64* __restrict__ key_p, u64* __restrict__ key_q) {
  __shared__ __align__(16) float spx[TILE_P];
  __shared__ __align__(16) float spy[TILE_P];
  __shared__ __align__(16) float spz[TILE_P];
  __shared__ __align__(16) float sqx[TILE_Q];
  __shared__ __align__(16) float sqy[TILE_Q];
  __shared__ __align__(16) float sqz[TILE_Q];
  __shared__ unsigned s_qmin[TILE_Q];
  __shared__ float s_pmin[TILE_P];

  const int b = blockIdx.z;
  const int tp = blockIdx.x, tq = blockIdx.y;
  const int t = threadIdx.x;
  const int tx = t & (TX - 1), ty = t / TX;

  stage<TILE_P>(p + (size_t)b * n * 3, tp * TILE_P, n, spx, spy, spz);
  stage<TILE_Q>(q + (size_t)b * m * 3, tq * TILE_Q, m, sqx, sqy, sqz);
  for (int j = t; j < TILE_Q; j += THREADS) s_qmin[j] = INF_BITS;
  __syncthreads();

  float px[RP], py[RP], pz[RP], pmin[RP];
#pragma unroll
  for (int k = 0; k < RP; k += 4) {
    const float4 vx = *reinterpret_cast<const float4*>(&spx[ty * RP + k]);
    const float4 vy = *reinterpret_cast<const float4*>(&spy[ty * RP + k]);
    const float4 vz = *reinterpret_cast<const float4*>(&spz[ty * RP + k]);
    px[k] = vx.x; px[k + 1] = vx.y; px[k + 2] = vx.z; px[k + 3] = vx.w;
    py[k] = vy.x; py[k + 1] = vy.y; py[k + 2] = vy.z; py[k + 3] = vy.w;
    pz[k] = vz.x; pz[k + 1] = vz.y; pz[k + 2] = vz.z; pz[k + 3] = vz.w;
  }
#pragma unroll
  for (int k = 0; k < RP; ++k) pmin[k] = CUDART_INF_F;

  const bool upper = (t & 16) != 0;  // the warp's second row group
#pragma unroll 1
  for (int c = 0; c < TILE_Q / (TX * RQ); ++c) {
    const int j0 = c * (TX * RQ) + tx * RQ;
    const float4 vx = *reinterpret_cast<const float4*>(&sqx[j0]);
    const float4 vy = *reinterpret_cast<const float4*>(&sqy[j0]);
    const float4 vz = *reinterpret_cast<const float4*>(&sqz[j0]);
    const float qx[RQ] = {vx.x, vx.y, vx.z, vx.w};
    const float qy[RQ] = {vy.x, vy.y, vy.z, vy.w};
    const float qz[RQ] = {vz.x, vz.y, vz.z, vz.w};
    float qmin[RQ] = {CUDART_INF_F, CUDART_INF_F, CUDART_INF_F, CUDART_INF_F};
#pragma unroll
    for (int k = 0; k < RP; ++k) {
#pragma unroll
      for (int r = 0; r < RQ; ++r) {
        const float d = sqdist(px[k], py[k], pz[k], qx[r], qy[r], qz[r]);
        pmin[k] = fminf(pmin[k], d);
        qmin[r] = fminf(qmin[r], d);
      }
    }
    // q side: the warp's two row groups trade halves (each keeps two columns
    // and gets the other's minima of them), then the block's warps meet in
    // shared memory (float bits of a non-negative float order as unsigned)
#pragma unroll
    for (int r = 0; r < RQ / 2; ++r) {
      const float keep = upper ? qmin[r + 2] : qmin[r];
      const float send = upper ? qmin[r] : qmin[r + 2];
      const float v = fminf(keep, __shfl_xor_sync(FULL, send, 16));
      atomicMin(&s_qmin[j0 + (upper ? 2 : 0) + r], __float_as_uint(v));
    }
  }

  // p side: the TX column groups of a row group are 16 neighbouring lanes. A
  // halving exchange: at each step a lane keeps half of its rows and gets its
  // partner's minima of them, so RP - 1 shuffles leave lane tx (tx < RP)
  // with the minimum of row tx; lanes beyond RP hold copies.
#pragma unroll
  for (int h = RP / 2; h >= 1; h >>= 1) {
    const bool up = (tx & h) != 0;
#pragma unroll
    for (int k = 0; k < h; ++k) {
      const float keep = up ? pmin[k + h] : pmin[k];
      const float send = up ? pmin[k] : pmin[k + h];
      pmin[k] = fminf(keep, __shfl_xor_sync(FULL, send, h));
    }
  }
#pragma unroll
  for (int h = RP; h < TX; h <<= 1) pmin[0] = fminf(pmin[0], __shfl_xor_sync(FULL, pmin[0], h));
  if (tx < RP) s_pmin[ty * RP + tx] = pmin[0];
  __syncthreads();

  // one global atomic a point a block; a point with no finite distance here offers nothing
  for (int r = t; r < TILE_P; r += THREADS) {
    const int i = tp * TILE_P + r;
    if (i < n) offer(key_p + (size_t)b * n + i, __float_as_uint(s_pmin[r]), tq);
  }
  for (int r = t; r < TILE_Q; r += THREADS) {
    const int j = tq * TILE_Q + r;
    if (j < m) offer(key_q + (size_t)b * m + j, s_qmin[r], tp);
  }
}

// RG lanes a point: keys [B*n + B*m] (p side, then q side) to d and idx of the
// same layout. A group rescans the winning tile, RG points a step, for the first
// point at the minimum; the groups of a warp step together until all are done.
__global__ void __launch_bounds__(256)
nn_resolve_kernel(const float* __restrict__ p, const float* __restrict__ q,
                  int B, int n, int m, const u64* __restrict__ keys,
                  float* __restrict__ d_out, int* __restrict__ i_out) {
  const long long w = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / RG;
  const int lane = threadIdx.x & 31, sub = lane % RG;
  const unsigned group_mask = (RG == 32 ? FULL : ((1u << RG) - 1)) << (lane - sub);
  const long long np = (long long)B * n;
  const bool valid = w < np + (long long)B * m;
  const bool from_q = w >= np;
  const long long r = valid ? (from_q ? w - np : w) : 0;
  const int own = from_q ? m : n, other = from_q ? n : m;
  const int tile = from_q ? TILE_P : TILE_Q;   // the other cloud's tile
  const int b = (int)(r / own);
  const float* x = ((valid && from_q) ? q : p) + 3 * (size_t)r;
  const float* y = (from_q ? p : q) + 3 * (size_t)b * other;

  const u64 key = valid ? keys[w] : EMPTY_KEY;
  bool done = key == EMPTY_KEY;
  const float best = done ? CUDART_INF_F : __uint_as_float((unsigned)(key >> 32));
  const float ax = x[0], ay = x[1], az = x[2];
  const int lo = done ? 0 : (int)(key & 0xffffffffu) * tile;
  const int hi = min(lo + tile, other);
  int idx = 0;
  for (int o = 0; !__all_sync(FULL, done); o += RG) {
    const int j = lo + o + sub;
    bool hit = false;
    if (!done && j < hi) {
      const float* yp = y + 3 * (size_t)j;
      // the sweep's operand order: the p point first
      const float d = from_q ? sqdist(yp[0], yp[1], yp[2], ax, ay, az)
                             : sqdist(ax, ay, az, yp[0], yp[1], yp[2]);
      hit = d == best;
    }
    const unsigned mine = __ballot_sync(FULL, hit) & group_mask;
    if (!done && mine) {
      idx = lo + o + (__ffs(mine) - 1 - (lane - sub));
      done = true;
    }
    if (lo + o + RG >= hi) done = true;   // past the tile: cannot happen for a real key
  }
  if (valid && sub == 0) {
    d_out[w] = best;
    i_out[w] = idx;
  }
}

int ceil_div(long long a, int b) { return (int)((a + b - 1) / b); }

}  // namespace

// Both directions on `stream`. keys is scratch of B*(n+m) 64-bit words; d and
// idx hold B*n p-side entries, then B*m q-side entries. tiles_p and tiles_q are
// the caller's grid, checked against the tiles of this source. Returns a
// cudaError (cudaGetLastError() after the launches).
extern "C" int chamfer_nn_bidir(const float* p, const float* q, int B, int n, int m,
                                int tiles_p, int tiles_q, void* keys,
                                float* d, int* idx, void* stream) {
  if (B <= 0 || n <= 0 || m <= 0 || tiles_p != ceil_div(n, TILE_P) ||
      tiles_q != ceil_div(m, TILE_Q))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long total = (long long)B * ((long long)n + m);
  u64* k = static_cast<u64*>(keys);
  const cudaError_t err = cudaMemsetAsync(k, 0xff, sizeof(u64) * total, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  nn_sweep_kernel<<<dim3(tiles_p, tiles_q, B), THREADS, 0, st>>>(p, q, n, m, k,
                                                                 k + (size_t)B * n);
  nn_resolve_kernel<<<ceil_div(total * RG, 256), 256, 0, st>>>(p, q, B, n, m, k, d, idx);
  return static_cast<int>(cudaGetLastError());
}
