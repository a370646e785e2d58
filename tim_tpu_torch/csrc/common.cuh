// Small device helpers shared by the kernels in this directory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tim {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Round a float to T and back: the value a T-typed intermediate holds.
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// Load N consecutive T (N * sizeof(T) bytes, aligned to that size up to 16)
// with the widest vector loads that fit, converted to float.
template <typename T, int N>
__device__ __forceinline__ void load_floats(const T* p, float* out) {
  constexpr int kBytes = N * (int)sizeof(T);
  if constexpr (kBytes % 16 == 0) {
    constexpr int kPer = 16 / (int)sizeof(T);
#pragma unroll
    for (int c = 0; c < kBytes / 16; ++c) {
      const uint4 v = reinterpret_cast<const uint4*>(p)[c];
      const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
      for (int i = 0; i < kPer; ++i) out[c * kPer + i] = to_f(e[i]);
    }
  } else if constexpr (kBytes == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_f(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_f(p[i]);
  }
}

// Butterfly reductions: every lane ends with the same, bitwise identical,
// result (each step adds the same two operands on both partner lanes).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

}  // namespace tim
