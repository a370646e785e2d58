// TIM post-attention encoder tail for Hopper (sm_90a).
//
// Replaces: tim_tpu/ops/pallas_fused.py::fused_post_attention (kernel body
// _fused_kernel, pl.pallas_call at :134):
//     y = LN1(x + attn);  z = LN2(y + W2 . gelu(W1 . y + b1) + b2)
// LayerNorm in fp32 with the fast variance E[x^2] - mu^2 clamped at 0 and
// eps 1e-5; matmuls accumulate in fp32 and add their bias in fp32; GELU is
// the exact erf form (erff: the TPU kernel's A&S polynomial existed only
// because Mosaic lowers no erf); adds and intermediates round to the input
// dtype exactly where the TPU kernel rounds them. Forward only.
//
// What bounds it on the H100: the two FFN products, 4*N*C*FF flop
// (0.96 TFLOP per layer at batch 128 x 898 tokens, C 1024, FF 2048), so
// the tensor cores. bf16 runs fused_post_attention_sm90.cuh: wgmma fed by
// TMA, LN1 in a row pass that makes y, b1 + GELU in the first product's
// epilogue, b2 and the residual in the second's, LN2 in a row pass after
// it (4 launches). fp32 is the parity path and
// runs true fp32 FMA on the CUDA cores (no TF32), in the design below.
//
// fp32 design. The TPU kernel keeps all 8 MB of W1 and W2 resident in
// VMEM; Hopper gives a block at most 227 KB of shared memory, so the
// weights are streamed in [BN x BK] tiles (from L2 after the first block
// touches them). LN2 needs whole rows, so the tail is two launches, each
// one block per 64 rows:
//   1. ln1_ffn1: LN1(x + attn) -> y (written once, kept for the residual),
//      then h = gelu(y W1^T + b1), one 64x128 output tile at a time.
//   2. ffn2_ln2: o = h W2^T + b2, s = y + o into the output rows, then LN2
//      over those rows in place (the block re-reads what it just wrote).
// Weights stay in nn.Linear's [out, in] layout, the column-major B operand
// the tiles want. C or FF off the tiles (128 columns, 16 of K) take the
// TAIL instances, which load each element on its own, masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include "common.cuh"

namespace {

using tim::from_f;
using tim::round_to;
using tim::to_f;
using tim::warp_sum;

constexpr int BM = 64;   // rows per block
constexpr int BN = 128;  // output columns per tile
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int LDC = BN + 4;  // fp32 accumulator tile row stride

template <typename T> struct Tile;
template <> struct Tile<float> {
  static constexpr int BK = 16;
  static constexpr int LDS = BK + 1;  // odd stride: conflict-free columns
  static constexpr int kStages = 1;
};

template <typename T>
constexpr size_t smem_bytes() {
  return (size_t)Tile<T>::kStages * (BM + BN) * Tile<T>::LDS * sizeof(T) +
         (size_t)BM * LDC * sizeof(float);
}

// TAIL: K or the tile's output columns (n_valid of BN) ragged, so every
// element is loaded on its own and masked (zeros past K and past n_valid).
template <bool TAIL = false>
__device__ void gemm_tile(const float* A, int rows, const float* W, int K,
                          float* sA, float* sB, float* sC,
                          int n_valid = BN) {
  constexpr int BK = Tile<float>::BK, LDS = Tile<float>::LDS;
  const int t = threadIdx.x;
  const int ty = t / 16, tx = t % 16;  // rows ty + 16i, cols tx + 16j
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    if constexpr (TAIL) {
      for (int i = t; i < BM * BK; i += kThreads) {
        const int r = i / BK, c = i % BK, k = k0 + c;
        sA[r * LDS + c] = r < rows && k < K ? A[(long long)r * K + k] : 0.f;
      }
      for (int i = t; i < BN * BK; i += kThreads) {
        const int r = i / BK, c = i % BK, k = k0 + c;
        sB[r * LDS + c] =
            r < n_valid && k < K ? W[(long long)r * K + k] : 0.f;
      }
    } else {
    {  // A: 64 x 16 fp32, one float4 per thread
      const int r = t / 4, c = (t % 4) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < rows)
        v = *reinterpret_cast<const float4*>(A + (long long)r * K + k0 + c);
      float* d = sA + r * LDS + c;
      d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
    }
#pragma unroll
    for (int it = 0; it < 2; ++it) {  // W: 128 x 16 fp32, two per thread
      const int idx = t + it * kThreads, r = idx / 4, c = (idx % 4) * 4;
      const float4 v =
          *reinterpret_cast<const float4*>(W + (long long)r * K + k0 + c);
      float* d = sB + r * LDS + c;
      d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
    }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float av[4], bv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = sA[(ty + 16 * i) * LDS + k];
#pragma unroll
      for (int j = 0; j < 8; ++j) bv[j] = sB[(tx + 16 * j) * LDS + k];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) sC[(ty + 16 * i) * LDC + tx + 16 * j] = acc[i][j];
}

// Row statistics of the fast-variance LayerNorm over one row held by a warp.
struct RowStats {
  float mu, rstd;
};

__device__ __forceinline__ RowStats finish_stats(float sum, float sq, int C,
                                                 float eps) {
  const float mu = warp_sum(sum) / C;
  const float var = fmaxf(warp_sum(sq) / C - mu * mu, 0.f);
  return {mu, rsqrtf(var + eps)};
}

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

template <typename T>
struct Smem {
  T* sA;
  T* sB;
  float* sC;
  __device__ explicit Smem(unsigned char* raw) {
    sA = reinterpret_cast<T*>(raw);
    sB = sA + Tile<T>::kStages * BM * Tile<T>::LDS;
    sC = reinterpret_cast<float*>(sB + Tile<T>::kStages * BN * Tile<T>::LDS);
  }
};

template <typename T, bool TAIL>
__global__ void __launch_bounds__(kThreads)
    ln1_ffn1_kernel(const T* __restrict__ x, const T* __restrict__ attn,
                    const float* __restrict__ g1, const float* __restrict__ be1,
                    const T* __restrict__ w1, const float* __restrict__ b1,
                    T* y, T* __restrict__ h, int N, int C,
                    int FF, float eps) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem<T> sm(smem_raw);
  const int row0 = blockIdx.x * BM;
  const int rows = min(BM, N - row0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int r = warp; r < rows; r += kWarps) {
    const long long off = (long long)(row0 + r) * C;
    float sum = 0.f, sq = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float s = round_to<T>(to_f(x[off + c]) + to_f(attn[off + c]));
      sum += s;
      sq += s * s;
    }
    const RowStats st = finish_stats(sum, sq, C, eps);
    for (int c = lane; c < C; c += 32) {
      const float s = round_to<T>(to_f(x[off + c]) + to_f(attn[off + c]));
      y[off + c] = from_f<T>((s - st.mu) * st.rstd * g1[c] + be1[c]);
    }
  }
  __syncthreads();  // this block's y rows are visible to all its threads

  const T* yb = y + (long long)row0 * C;
  for (int n0 = 0; n0 < FF; n0 += BN) {
    gemm_tile<TAIL>(yb, rows, w1 + (long long)n0 * C, C, sm.sA, sm.sB,
                    sm.sC, FF - n0);
    __syncthreads();
    for (int i = threadIdx.x; i < BM * BN; i += kThreads) {
      const int r = i / BN, c = i % BN;
      if (r >= rows) break;
      if (TAIL && n0 + c >= FF) continue;
      const float v = round_to<T>(sm.sC[r * LDC + c] + b1[n0 + c]);
      h[(long long)(row0 + r) * FF + n0 + c] = from_f<T>(gelu_erf(v));
    }
    __syncthreads();
  }
}

template <typename T, bool TAIL>
__global__ void __launch_bounds__(kThreads)
    ffn2_ln2_kernel(const T* __restrict__ h, const T* __restrict__ y,
                    const T* __restrict__ w2, const float* __restrict__ b2,
                    const float* __restrict__ g2, const float* __restrict__ be2,
                    T* z, int N, int C, int FF, float eps) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem<T> sm(smem_raw);
  const int row0 = blockIdx.x * BM;
  const int rows = min(BM, N - row0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  const T* hb = h + (long long)row0 * FF;
  for (int n0 = 0; n0 < C; n0 += BN) {
    gemm_tile<TAIL>(hb, rows, w2 + (long long)n0 * FF, FF, sm.sA, sm.sB,
                    sm.sC, C - n0);
    __syncthreads();
    for (int i = threadIdx.x; i < BM * BN; i += kThreads) {
      const int r = i / BN, c = i % BN;
      if (r >= rows) break;
      if (TAIL && n0 + c >= C) continue;
      const long long off = (long long)(row0 + r) * C + n0 + c;
      const float o = round_to<T>(sm.sC[r * LDC + c] + b2[n0 + c]);
      z[off] = from_f<T>(to_f(y[off]) + o);
    }
    __syncthreads();  // also orders the z writes before the LN2 reads
  }

  for (int r = warp; r < rows; r += kWarps) {
    T* zr = z + (long long)(row0 + r) * C;
    float sum = 0.f, sq = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float s = to_f(zr[c]);
      sum += s;
      sq += s * s;
    }
    const RowStats st = finish_stats(sum, sq, C, eps);
    for (int c = lane; c < C; c += 32)
      zr[c] = from_f<T>((to_f(zr[c]) - st.mu) * st.rstd * g2[c] + be2[c]);
  }
}

// TAIL: C or FF not a multiple of the tiles (BN columns, BK of K).
template <typename T, bool TAIL>
int launch(const void* x, const void* attn, const float* g1, const float* be1,
           const void* w1, const float* b1, const void* w2, const float* b2,
           const float* g2, const float* be2, void* y, void* h, void* out,
           int N, int C, int FF, float eps, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      ln1_ffn1_kernel<T, TAIL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(ffn2_ln2_kernel<T, TAIL>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (N + BM - 1) / BM;
  ln1_ffn1_kernel<T, TAIL><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(attn), g1, be1,
      static_cast<const T*>(w1), b1, static_cast<T*>(y), static_cast<T*>(h),
      N, C, FF, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ffn2_ln2_kernel<T, TAIL><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(y),
      static_cast<const T*>(w2), b2, g2, be2, static_cast<T*>(out), N, C, FF,
      eps);
  return (int)cudaGetLastError();
}

}  // namespace

// fused_post_attention_sm90.cu (its own source, so that the two compile in
// parallel): the bf16 tail, same arguments.
extern "C" int tim_fused_post_attention_sm90(
    const void* x, const void* attn, const void* ln1_w, const void* ln1_b,
    const void* w1, const void* b1, const void* w2, const void* b2,
    const void* ln2_w, const void* ln2_b, void* y, void* h, void* out, int n,
    int c, int ff, int c_valid, float eps, cudaStream_t stream);

// x, attn, out, y: [N, C]; h: [N, FF] (y and h are scratch the caller
// allocates); w1 [FF, C], w2 [C, FF] in the input dtype; biases and LN
// params fp32. fp32: any C and FF (c_valid = C). bf16: C and FF multiples
// of 8 (TMA's row pitch); the caller may pad a row of c_valid channels to
// C with zeros (weights, biases and LN parameters zero there too): the
// LayerNorms then take their statistics over c_valid and write zeros past
// it. Returns cudaGetLastError() after the launches (0 on success).
extern "C" int tim_fused_post_attention(
    const void* x, const void* attn, const void* ln1_w, const void* ln1_b,
    const void* w1, const void* b1, const void* w2, const void* b2,
    const void* ln2_w, const void* ln2_b, void* y, void* h, void* out, int n,
    int c, int ff, int c_valid, int is_bf16, float eps, void* stream) {
  if (n <= 0) return 0;
  if (c <= 0 || ff <= 0 || c_valid <= 0 || c_valid > c)
    return (int)cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (c % 8 != 0 || ff % 8 != 0) return (int)cudaErrorInvalidValue;
    return tim_fused_post_attention_sm90(x, attn, ln1_w, ln1_b, w1, b1, w2,
                                         b2, ln2_w, ln2_b, y, h, out, n, c,
                                         ff, c_valid, eps, st);
  }
  if (c_valid != c) return (int)cudaErrorInvalidValue;
  if (c % BN != 0 || ff % BN != 0)
    return launch<float, true>(x, attn, f(ln1_w), f(ln1_b), w1, f(b1), w2,
                               f(b2), f(ln2_w), f(ln2_b), y, h, out, n, c,
                               ff, eps, st);
  return launch<float, false>(x, attn, f(ln1_w), f(ln1_b), w1, f(b1), w2,
                              f(b2), f(ln2_w), f(ln2_b), y, h, out, n, c,
                              ff, eps, st);
}
