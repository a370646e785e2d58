// The bias epilogue of the port's bf16 linears, with an optional exact GELU,
// in one pass over the GEMM's output.
//
// Replaces no Pallas kernel: the JAX package leaves this to XLA's fusion
// of the layer's bias add (tim_tpu/models/common.py:76-79, TorchLinear;
// flax nn.Dense) and of a following exact_gelu. It exists because the bf16
// linears round as the JAX layer they replace, and cuBLAS's bias epilogue
// rounds neither way:
//   TORCH_LINEAR  h = bf16(y + bias),          y the GEMM's fp32 output;
//   DENSE         h = bf16(y + bf16(bias)),    y the GEMM's bf16 output;
//   no bias (null) h = bf16(y),                 the exact GELU alone;
//   out = gelu ? gelu_bf16(h) : h,
//   gelu_bf16(h) = bf16(bf16(0.5 h) * bf16(erfc(bf16(-h * 0.70703125)))),
// jax.nn.gelu(approximate=False) on bf16 as XLA runs it: each step a bf16
// operation (0.70703125 is sqrt(1/2) in bf16), computed here in fp32 and
// rounded once (a product of two bf16 values is exact in fp32). With
// `pre`, h is also written (the backward's input to the GELU derivative).
// The fused tail's GELU (kernel 2) and the int8 heads' (kernel 3) are
// fp32 in JAX, and are not this one.
//
// What bounds it on the H100: bytes. A row of y is read once (4 or 2 bytes
// an element), the fp32 bias from L1/L2, out written once (2 bytes; 2 more
// for pre); one thread takes 8 consecutive columns (16-byte stores), or
// one element where a row is not a whole number of 16-byte stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <bool F32_IN>
__device__ __forceinline__ float add_bias(float y, float b) {
  return round_bf16(F32_IN ? y + b : y + round_bf16(b));
}

__device__ __forceinline__ float gelu_bf16(float h) {
  const float half = round_bf16(__fmul_rn(h, 0.5f));
  const float d = round_bf16(__fmul_rn(h, -0.70703125f));
  return round_bf16(__fmul_rn(half, round_bf16(erfcf(d))));
}

template <bool F32_IN, bool GELU>
__global__ void __launch_bounds__(256) bias_act_kernel(
    const void* __restrict__ y, const float* __restrict__ bias,
    __nv_bfloat16* __restrict__ out, __nv_bfloat16* __restrict__ pre,
    long long chunks, int cols) {
  const int per_row = cols / 8;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < chunks; i += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(i % per_row) * 8;
    float v[8], b[8];
    if constexpr (F32_IN) {
      const float4* p = reinterpret_cast<const float4*>(y) + 2 * i;
      const float4 a = p[0], d = p[1];
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = d.x; v[5] = d.y; v[6] = d.z; v[7] = d.w;
    } else {
      const uint4 a = reinterpret_cast<const uint4*>(y)[i];
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&a);
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = __bfloat162float(e[k]);
    }
    float h[8];
    if (bias != nullptr) {
      const float4 b0 = __ldg(reinterpret_cast<const float4*>(bias + c));
      const float4 b1 = __ldg(reinterpret_cast<const float4*>(bias + c) + 1);
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
      for (int k = 0; k < 8; ++k) h[k] = add_bias<F32_IN>(v[k], b[k]);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) h[k] = round_bf16(v[k]);
    }
    if (GELU && pre != nullptr) {
      uint4 w;
      w.x = pack2(h[0], h[1]); w.y = pack2(h[2], h[3]);
      w.z = pack2(h[4], h[5]); w.w = pack2(h[6], h[7]);
      reinterpret_cast<uint4*>(pre)[i] = w;
    }
    if constexpr (GELU) {
#pragma unroll
      for (int k = 0; k < 8; ++k) h[k] = gelu_bf16(h[k]);
    }
    uint4 w;
    w.x = pack2(h[0], h[1]); w.y = pack2(h[2], h[3]);
    w.z = pack2(h[4], h[5]); w.w = pack2(h[6], h[7]);
    reinterpret_cast<uint4*>(out)[i] = w;
  }
}

template <bool F32_IN, bool GELU>
__global__ void __launch_bounds__(256) bias_act_scalar_kernel(
    const void* __restrict__ y, const float* __restrict__ bias,
    __nv_bfloat16* __restrict__ out, __nv_bfloat16* __restrict__ pre,
    long long n, int cols) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += (long long)gridDim.x * blockDim.x) {
    const float v = F32_IN ? static_cast<const float*>(y)[i]
                           : __bfloat162float(
                                 static_cast<const __nv_bfloat16*>(y)[i]);
    float h = bias != nullptr ? add_bias<F32_IN>(v, __ldg(bias + i % cols))
                              : round_bf16(v);
    if (GELU && pre != nullptr) pre[i] = __float2bfloat16(h);
    if (GELU) h = gelu_bf16(h);
    out[i] = __float2bfloat16(h);
  }
}

template <bool F32_IN, bool GELU>
void launch(const void* y, const float* bias, __nv_bfloat16* out,
            __nv_bfloat16* pre, long long rows, int cols, bool vec,
            cudaStream_t st) {
  const long long items = vec ? rows * (cols / 8) : rows * cols;
  const long long want = (items + 255) / 256;
  const unsigned blocks = (unsigned)(want < 132 * 16 ? want : 132 * 16);
  if (vec)
    bias_act_kernel<F32_IN, GELU><<<blocks, 256, 0, st>>>(y, bias, out, pre,
                                                          items, cols);
  else
    bias_act_scalar_kernel<F32_IN, GELU><<<blocks, 256, 0, st>>>(
        y, bias, out, pre, items, cols);
}

}  // namespace

// y: [rows, cols] fp32 (y_f32) or bf16, contiguous; bias: [cols] fp32 or
// null (no add); out
// and pre (or null): [rows, cols] bf16, contiguous. Rows of a multiple of 8
// columns with 16-byte aligned pointers take the 8-column kernel. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int tim_bias_act(const void* y, int y_f32, const float* bias,
                            void* out, void* pre, long long rows, int cols,
                            int gelu, void* stream) {
  if (rows <= 0 || cols <= 0) return 0;
  const bool vec =
      cols % 8 == 0 &&
      ((reinterpret_cast<uintptr_t>(y) | reinterpret_cast<uintptr_t>(bias) |
        reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(pre)) &
       15) == 0;
  auto* o = static_cast<__nv_bfloat16*>(out);
  auto* p = static_cast<__nv_bfloat16*>(pre);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (y_f32 && gelu)
    launch<true, true>(y, bias, o, p, rows, cols, vec, st);
  else if (y_f32)
    launch<true, false>(y, bias, o, p, rows, cols, vec, st);
  else if (gelu)
    launch<false, true>(y, bias, o, p, rows, cols, vec, st);
  else
    launch<false, false>(y, bias, o, p, rows, cols, vec, st);
  return (int)cudaGetLastError();
}
