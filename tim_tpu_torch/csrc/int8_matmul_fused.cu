// Kernel 3, the fused static-scale int8 matmul: its C entry and its
// instances without the GELU. The kernel and its note are in
// int8_matmul_fused.cuh.

#include "int8_matmul_fused.cuh"

// x: [batches, rows, K] read through (stride_b, stride_r) with a
// contiguous K, any K and strides; w: [N, kw] int8, kw >= K a multiple of
// 16 (zeros past K), 16-byte aligned; partial: an int32 [M, N] scratch
// for K > 2048, else null. Returns cudaGetLastError() after the (last)
// launch (0 on success).
extern "C" int tim_int8_matmul_fused(
    const void* x, const void* w, const void* w_scale, const void* bias,
    void* out, long long stride_b, long long stride_r, int batches,
    int rows, int k, int kw, int n, float inv_sx, float sx, int gelu,
    int x_bf16, int out_bf16, int* partial, void* stream) {
  const long long m = (long long)batches * rows;
  if (m == 0 || n == 0) return 0;
  if (m > INT_MAX || k <= 0 || kw < k || kw % 16)
    return (int)cudaErrorInvalidValue;
  const int per16 = x_bf16 ? 8 : 4;   // values a 16-byte load holds
  tim_i8::Args a;
  a.x = x;
  a.w_scale = static_cast<const float*>(w_scale);
  a.bias = static_cast<const float*>(bias);
  a.out = out;
  a.stride_b = stride_b;
  a.stride_r = stride_r;
  a.rows = rows;
  a.m = (int)m;
  a.k = k;
  a.n = n;
  a.inv_sx = inv_sx;
  a.sx = sx;
  a.x_bf16 = x_bf16;
  a.out_bf16 = out_bf16;
  a.vec = k % per16 == 0 && stride_b % per16 == 0 &&
          stride_r % per16 == 0 &&
          reinterpret_cast<uintptr_t>(x) % 16 == 0;
  a.partial = partial;
  a.part = 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return gelu ? tim_i8::launch_gelu(a, w, kw, st)
              : tim_i8::launch_any<false>(a, w, kw, st);
}
