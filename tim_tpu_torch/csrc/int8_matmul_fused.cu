// Fused static-scale int8 matmul for Hopper (sm_90a).
//
// Replaces: tim_tpu/ops/pallas_int8.py::int8_matmul_fused (kernel body
// _kernel, pl.pallas_call at :97). Per output tile:
//   xq  = clip(round_half_even(x * inv_sx), -127, 127)        int8
//   acc = xq . w_q^T                                           int32
//   y   = f32(acc) * (sx * w_scale[n]) [+ bias[n]] [-> exact GELU]
// cast to the output type. x is fp32 or bf16, the output fp32 or bf16.
//
// What bounds it on the H100: at the detection class head fc_action
// (M = 128 windows x 399 queries = 51,072 rows, K 1024, N 3806, bf16 in and
// out) the product is 398 G int8 operations, 0.20 ms at the 1,979 TOPS
// dense int8 peak, against 0.50 GB of bytes (x 105 MB, out 389 MB, w 3.9
// MB), 0.15 ms at 3.35 TB/s: operations bound it, barely. fc_audio (N 44)
// is bound by reading x: about 0.03 ms.
//
// Design (simple first): one block of 8 warps per 128 x 128 output tile,
// the K loop in steps of 64. Each step quantizes the block's 128 x 64 x
// tile into shared memory as int8 (so quantized activations never reach
// device memory) and copies the 128 x 64 int8 weight tile beside it; each
// warp then runs mma.sync.m16n8k32 (s8 x s8 -> s32) over its 64 x 32
// sub-tile, fragments loaded as 32-bit words from rows padded to 80 bytes
// (the 8 row groups of a fragment load fall in distinct banks). The
// epilogue dequantizes in registers with the TPU kernel's rounding points
// (no fused multiply-add: y = acc * ws, then + bias, each rounded), stages
// the tile in shared memory and writes it row-coalesced. Ragged M and N are
// guarded: rows and columns past the end load as zeros and are not stored.
// x may be a strided view (the heads slice the query rows out of the
// [B, S, 1024] encoder output): the kernel takes its (batch, row) strides
// and reads it in place. Known cost of this first design: each x tile is
// re-quantized once per N tile (30 times for fc_action), and there is no
// copy/compute overlap; wgmma and TMA come later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "common.cuh"

namespace {

using tim::from_f;
using tim::load_floats;

constexpr int kBM = 128, kBN = 128, kBK = 64;
constexpr int kThreads = 256;             // 8 warps: 2 along M x 4 along N
constexpr int kWarpM = 64, kWarpN = 32;   // each warp's sub-tile
constexpr int kMT = kWarpM / 16;          // m16 tiles per warp
constexpr int kNT = kWarpN / 8;           // n8 tiles per warp
constexpr int kLD = kBK + 16;             // int8 tile row stride (bytes)
constexpr int kLDO = kBN + 8;             // output staging row stride

struct Args {
  const void* x;
  const int8_t* w;        // [N, K] row-major
  const float* w_scale;   // [N]
  const float* bias;      // [N] or null
  void* out;              // [M, N] row-major
  long long stride_b, stride_r;  // x element strides of (batch, row)
  int rows;               // rows per batch; M = batches * rows
  int m, k, n;
  float inv_sx, sx;
  int gelu;
};

__device__ __forceinline__ uint32_t quant4(const float* v, float inv) {
  uint32_t packed = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // cvt.rni saturates out-of-range values; then clip to +-127
    const int q = max(-127, min(127, __float2int_rn(__fmul_rn(v[i], inv))));
    packed |= (uint32_t)(uint8_t)(int8_t)q << (8 * i);
  }
  return packed;
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename T, typename O>
__global__ void __launch_bounds__(kThreads, 2)
    int8_matmul_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* s_x = reinterpret_cast<int8_t*>(smem);   // [kBM][kLD]
  int8_t* s_w = s_x + kBM * kLD;                    // [kBN][kLD]
  O* s_out = reinterpret_cast<O*>(smem);            // [kBM][kLDO], after

  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int g = lane / 4, t = lane % 4;  // mma fragment group and slot

  int acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int k0 = 0; k0 < a.k; k0 += kBK) {
    // x tile: 128 rows x 8 chunks of 8 values, quantized to int8
    for (int c = threadIdx.x; c < kBM * (kBK / 8); c += kThreads) {
      const int r = c / (kBK / 8), kc = (c % (kBK / 8)) * 8;
      const int gm = m0 + r, gk = k0 + kc;
      uint2 q = make_uint2(0u, 0u);
      if (gm < a.m && gk < a.k) {
        const int b = gm / a.rows, row = gm - b * a.rows;
        const T* p = static_cast<const T*>(a.x) + b * a.stride_b +
                     row * a.stride_r + gk;
        float v[8];
        load_floats<T, 8>(p, v);
        q = make_uint2(quant4(v, a.inv_sx), quant4(v + 4, a.inv_sx));
      }
      *reinterpret_cast<uint2*>(s_x + r * kLD + kc) = q;
    }
    // w tile: 128 rows x 4 chunks of 16 bytes
    for (int c = threadIdx.x; c < kBN * (kBK / 16); c += kThreads) {
      const int r = c / (kBK / 16), kc = (c % (kBK / 16)) * 16;
      const int gn = n0 + r, gk = k0 + kc;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (gn < a.n && gk < a.k)
        v = *reinterpret_cast<const uint4*>(a.w + (long long)gn * a.k + gk);
      *reinterpret_cast<uint4*>(s_w + r * kLD + kc) = v;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t af[kMT][4], bf[kNT][2];
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        const int8_t* p = s_x + (wm * kWarpM + i * 16 + g) * kLD + kk + t * 4;
        af[i][0] = *reinterpret_cast<const uint32_t*>(p);
        af[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kLD);
        af[i][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        af[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kLD + 16);
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int8_t* p = s_w + (wn * kWarpN + j * 8 + g) * kLD + kk + t * 4;
        bf[j][0] = *reinterpret_cast<const uint32_t*>(p);
        bf[j][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
    __syncthreads();  // the tiles are rewritten next step / by the epilogue
  }

  // Epilogue: each thread holds rows (g, g + 8) x columns (2t, 2t + 1) of
  // every m16 x n8 tile.
  float ws[kNT][2], bs[kNT][2];
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int gn = n0 + wn * kWarpN + j * 8 + t * 2 + e;
      const bool in = gn < a.n;
      ws[j][e] = in ? __fmul_rn(a.sx, a.w_scale[gn]) : 0.f;
      bs[j][e] = (in && a.bias) ? a.bias[gn] : 0.f;
    }
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = wm * kWarpM + i * 16 + g + (e / 2) * 8;
        const int c = wn * kWarpN + j * 8 + t * 2 + (e % 2);
        float y = __fmul_rn(__int2float_rn(acc[i][j][e]), ws[j][e % 2]);
        if (a.bias) y = __fadd_rn(y, bs[j][e % 2]);
        if (a.gelu) y = 0.5f * y * (1.f + erff(y * 0.70710678118654752f));
        s_out[r * kLDO + c] = from_f<O>(y);
      }
  __syncthreads();

  O* out = static_cast<O*>(a.out);
  for (int i = threadIdx.x; i < kBM * kBN; i += kThreads) {
    const int r = i / kBN, c = i % kBN;
    const int gm = m0 + r, gn = n0 + c;
    if (gm < a.m && gn < a.n)
      out[(long long)gm * a.n + gn] = s_out[r * kLDO + c];
  }
}

template <typename T, typename O>
int launch(const Args& a, cudaStream_t stream) {
  const size_t tiles = (size_t)(kBM + kBN) * kLD;
  const size_t staging = (size_t)kBM * kLDO * sizeof(O);
  const size_t smem = tiles > staging ? tiles : staging;
  auto kernel = int8_matmul_kernel<T, O>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.n + kBN - 1) / kBN, (a.m + kBM - 1) / kBM);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_out(const Args& a, int out_bf16, cudaStream_t stream) {
  return out_bf16 ? launch<T, __nv_bfloat16>(a, stream)
                  : launch<T, float>(a, stream);
}

}  // namespace

// x: [batches, rows, K] read through (stride_b, stride_r) with a
// contiguous K; K a multiple of 16, strides multiples of 8 elements, x and
// w 16-byte aligned (the wrapper checks). Returns cudaGetLastError() after
// the launch (0 on success).
extern "C" int tim_int8_matmul_fused(
    const void* x, const void* w, const void* w_scale, const void* bias,
    void* out, long long stride_b, long long stride_r, int batches,
    int rows, int k, int n, float inv_sx, float sx, int gelu, int x_bf16,
    int out_bf16, void* stream) {
  const long long m = (long long)batches * rows;
  if (m == 0 || n == 0) return 0;
  if (m > INT_MAX || (m + kBM - 1) / kBM > 65535 || k <= 0 || k % 16)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = x;
  a.w = static_cast<const int8_t*>(w);
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
  a.gelu = gelu;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return x_bf16 ? dispatch_out<__nv_bfloat16>(a, out_bf16, st)
                : dispatch_out<float>(a, out_bf16, st);
}
