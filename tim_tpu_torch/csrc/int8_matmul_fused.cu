// Kernel 3, the fused static-scale int8 matmul: its C entry and its
// instances without the GELU. The kernel and its note are in
// int8_matmul_fused.cuh.

#include "int8_matmul_fused.cuh"

// x: [batches, rows, K] read through (stride_b, stride_r) with a
// contiguous K; K a multiple of 16 up to 2048, strides multiples of 8
// elements, x and w 16-byte aligned (the wrapper checks). Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int tim_int8_matmul_fused(
    const void* x, const void* w, const void* w_scale, const void* bias,
    void* out, long long stride_b, long long stride_r, int batches,
    int rows, int k, int n, float inv_sx, float sx, int gelu, int x_bf16,
    int out_bf16, void* stream) {
  const long long m = (long long)batches * rows;
  if (m == 0 || n == 0) return 0;
  if (m > INT_MAX || k <= 0 || k % 16 || k > 2048)
    return (int)cudaErrorInvalidValue;
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return gelu ? tim_i8::launch_gelu(a, w, st)
              : tim_i8::launch_any<false>(a, w, st);
}
