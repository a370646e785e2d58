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
// the tensor cores. The LN/GELU/residual passes are memory-bound and are
// folded into the products' prologue and epilogues here. Measured at that
// shape in bf16: 7.18 ms, 134 TFLOP/s or 13.5% of the data-sheet peak,
// against 7.65 ms for the unfused cuBLAS tail and 29.4 ms for the plain
// version's fp32 products (H100 80GB HBM3, 700 W power limit): WMMA tiles
// of 64 x 128 with one block of 256 threads are latency-bound; larger
// tiles, deeper pipelines and wgmma are the next steps.
//
// Design. The TPU kernel keeps all 8 MB of W1 and W2 resident in VMEM;
// Hopper gives a block at most 227 KB of shared memory, so the weights are
// streamed in [BN x BK] tiles (from L2 after the first block touches them).
// LN2 needs whole 1024-wide rows and a block of 64 rows of the [rows, 2048]
// hidden activation is 256 KB in bf16, which does not fit beside the
// tiles, so the tail is two launches, each one block per 64 rows:
//   1. ln1_ffn1: LN1(x + attn) -> y (written once, kept for the residual),
//      then h = gelu(y W1^T + b1), one 64x128 output tile at a time.
//   2. ffn2_ln2: o = h W2^T + b2, s = y + o into the output rows, then LN2
//      over those rows in place (the block re-reads what it just wrote).
// Products: bf16 runs WMMA 16x16x16 on the tensor cores with fp32
// accumulators; fp32 is the parity path and runs true fp32 FMA on the CUDA
// cores (no TF32). Weights stay in nn.Linear's [out, in] layout, which is
// the column-major B operand the tiles want. bf16 tiles stream through a
// two-stage cp.async double buffer; the fp32 parity path loads them
// synchronously.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

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
template <> struct Tile<__nv_bfloat16> {
  static constexpr int BK = 32;
  static constexpr int LDS = BK + 8;  // WMMA wants ldm % 8 == 0 (16-bit)
  static constexpr int kStages = 2;   // cp.async double buffer
};
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

// 16-byte global -> shared copy that bypasses registers; `valid` false
// writes zeros (src-size 0 reads nothing).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// sC[BM][LDC] = A[0:BM, 0:K] . W[0:BN, 0:K]^T in fp32. A is row-major with
// row stride K and `rows` valid rows (the rest read as 0); W is row-major
// [out, K] already offset to the tile's first output column. sA/sB hold
// Tile<T>::kStages buffers each.
__device__ void gemm_tile(const __nv_bfloat16* A, int rows,
                          const __nv_bfloat16* W, int K, __nv_bfloat16* sA,
                          __nv_bfloat16* sB, float* sC) {
  using namespace nvcuda;
  constexpr int BK = Tile<__nv_bfloat16>::BK, LDS = Tile<__nv_bfloat16>::LDS;
  const int t = threadIdx.x, warp = t / 32;
  const int wm = warp / 4, wn = warp % 4;  // 2 x 4 warps, 32x32 each
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  // A: 64 x 32 bf16, one 16-byte copy per thread; W: 128 x 32, two.
  auto load_stage = [&](int stage, int k0) {
    __nv_bfloat16* a = sA + stage * BM * LDS;
    __nv_bfloat16* b = sB + stage * BN * LDS;
    const int r = t / 4, c = (t % 4) * 8;
    cp_async16(a + r * LDS + c,
               A + (long long)min(r, rows - 1) * K + k0 + c, r < rows);
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int idx = t + it * kThreads, rw = idx / 4, cw = (idx % 4) * 8;
      cp_async16(b + rw * LDS + cw, W + (long long)rw * K + k0 + cw, true);
    }
    cp_async_commit();
  };

  const int nk = K / BK;
  load_stage(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) {  // the next tile streams in while this one computes
      load_stage(cur ^ 1, (kt + 1) * BK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* a = sA + cur * BM * LDS;
    const __nv_bfloat16* b = sB + cur * BN * LDS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], a + (wm * 32 + i * 16) * LDS + kk, LDS);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], b + (wn * 32 + j * 16) * LDS + kk, LDS);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(sC + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16,
                              acc[i][j], LDC, wmma::mem_row_major);
}

__device__ void gemm_tile(const float* A, int rows, const float* W, int K,
                          float* sA, float* sB, float* sC) {
  constexpr int BK = Tile<float>::BK, LDS = Tile<float>::LDS;
  const int t = threadIdx.x;
  const int ty = t / 16, tx = t % 16;  // rows ty + 16i, cols tx + 16j
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
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

template <typename T>
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
    gemm_tile(yb, rows, w1 + (long long)n0 * C, C, sm.sA, sm.sB, sm.sC);
    __syncthreads();
    for (int i = threadIdx.x; i < BM * BN; i += kThreads) {
      const int r = i / BN, c = i % BN;
      if (r >= rows) break;
      const float v = round_to<T>(sm.sC[r * LDC + c] + b1[n0 + c]);
      h[(long long)(row0 + r) * FF + n0 + c] = from_f<T>(gelu_erf(v));
    }
    __syncthreads();
  }
}

template <typename T>
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
    gemm_tile(hb, rows, w2 + (long long)n0 * FF, FF, sm.sA, sm.sB, sm.sC);
    __syncthreads();
    for (int i = threadIdx.x; i < BM * BN; i += kThreads) {
      const int r = i / BN, c = i % BN;
      if (r >= rows) break;
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

template <typename T>
int launch(const void* x, const void* attn, const float* g1, const float* be1,
           const void* w1, const float* b1, const void* w2, const float* b2,
           const float* g2, const float* be2, void* y, void* h, void* out,
           int N, int C, int FF, float eps, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      ln1_ffn1_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(ffn2_ln2_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (N + BM - 1) / BM;
  ln1_ffn1_kernel<T><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(attn), g1, be1,
      static_cast<const T*>(w1), b1, static_cast<T*>(y), static_cast<T*>(h),
      N, C, FF, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ffn2_ln2_kernel<T><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(y),
      static_cast<const T*>(w2), b2, g2, be2, static_cast<T*>(out), N, C, FF,
      eps);
  return (int)cudaGetLastError();
}

}  // namespace

// x, attn, out, y: [N, C]; h: [N, FF] (y and h are scratch the caller
// allocates); w1 [FF, C], w2 [C, FF] in the input dtype; biases and LN
// params fp32. C and FF must be multiples of 128. Returns
// cudaGetLastError() after the launches (0 on success).
extern "C" int tim_fused_post_attention(
    const void* x, const void* attn, const void* ln1_w, const void* ln1_b,
    const void* w1, const void* b1, const void* w2, const void* b2,
    const void* ln2_w, const void* ln2_b, void* y, void* h, void* out, int n,
    int c, int ff, int is_bf16, float eps, void* stream) {
  if (n <= 0) return 0;
  if (c % BN != 0 || ff % BN != 0) return (int)cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, attn, f(ln1_w), f(ln1_b), w1, f(b1), w2,
                                 f(b2), f(ln2_w), f(ln2_b), y, h, out, n, c,
                                 ff, eps, st);
  return launch<float>(x, attn, f(ln1_w), f(ln1_b), w1, f(b1), w2, f(b2),
                       f(ln2_w), f(ln2_b), y, h, out, n, c, ff, eps, st);
}
