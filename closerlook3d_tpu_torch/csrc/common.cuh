// Shared by the kernels under csrc/: each .cu builds into its own shared
// library with a plain C interface (loaded from Python with ctypes), and
// each library reports launch errors as cudaError_t codes that Python
// turns into text through cl3d_error_string.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <cmath>

extern "C" const char* cl3d_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Feature values are float or bf16; kernels compute in f32 and round to
// the feature type only where the plain PyTorch version rounds.
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Squared distance with every product and sum rounded to f32 in the
// order ((dx*dx + dy*dy) + dz*dz), d = a - b. The intrinsics keep nvcc
// from contracting a*a+b into one FMA, which rounds once instead of
// twice and would break bit-equality with the plain PyTorch version
// (near-ties and points at exactly the radius would flip).
__device__ __forceinline__ float dist2_rn(float ax, float ay, float az,
                                          float bx, float by, float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  float d2 = __fmul_rn(dx, dx);
  d2 = __fadd_rn(d2, __fmul_rn(dy, dy));
  return __fadd_rn(d2, __fmul_rn(dz, dz));
}
