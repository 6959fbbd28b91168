// Squared distance between two points, shared by the K1 and K3 kernels.
//
// Difference form, d = (dx*dx + dy*dy) + dz*dz, with every operation rounded
// on its own (__fsub_rn / __fmul_rn / __fadd_rn forbid FMA contraction), so a
// distance is bit for bit the one the plain PyTorch twins compute with
// separate elementwise operations in the same order.
#pragma once

__device__ __forceinline__ float sqdist(float ax, float ay, float az,
                                        float bx, float by, float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}
