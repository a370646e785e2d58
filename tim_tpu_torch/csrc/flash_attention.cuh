// Exact softmax attention, forward, with an online softmax over key tiles:
// the core shared by flash_mha.cu (kernel 5, no bias) and
// window_attention.cu (kernel 4, relative-position bias plus the shifted
// windows' region mask). The backward is flash_attention_bwd.cuh.
//
//   out[b, h, i] = sum_j p_ij v[b, h, j] / sum_j p_ij,
//   p_ij = exp(s_ij - m_i),  s_ij = (q_i . k_j) * scale [+ bias[h, i, j]
//          - 100 * (region[w, i] != region[w, j])],  w = b % n_win,
//
// with fp32 scores, running maxima and sums. The TPU kernels hold a whole
// [S, S] fp32 score block in VMEM (2.4 MB at S = 784, 9.8 MB at 1568); a
// Hopper block has at most 227 KB of shared memory, so both kernels here
// walk the keys in tiles and rescale an fp32 accumulator whenever the
// running maximum grows. Neither pads S: keys past S score -inf, query rows
// past S are computed from a clamped row and not stored.
//
// bf16 (tensor cores): flash_attention_sm90.cuh, wgmma products with the
// softmax work overlapped (the unnormalised probabilities rounded to bf16
// before the PV product; the TPU kernels round normalised ones). This file
// keeps what both directions share (parameters, tiles, the mma.sync,
// ldmatrix and cp.async helpers of the backward's bf16 kernels) and the
// fp32 kernel.
//
// fp32 (CUDA cores, no TF32, so the function stays fp32): one thread per
// query row, 128 rows per block, 16-key tiles of k and v in shared memory
// read as broadcasts.
//
// q, k and v are read in place through (batch, head, row) element strides
// (they are strided views of one packed qkv projection); the last dim is
// contiguous. out is written through its own strides, so a caller can ask
// for the [B, S, H, dh] layout that the output projection reads.
//
// For training, a caller passes an lse buffer: each row's log-sum-exp
// m_i + log(sum_j p_ij) of the fp32 scores goes to lse[(b * H + h) * S + i],
// which the backward needs to recompute normalised probabilities. That
// store is a compile-time variant (LSE): with a null pointer (inference)
// the launch is the kernel without it, and nothing more is written.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace tim_attn {

struct Strides {
  long long b, h, n;  // element strides; the last (dh) dim is contiguous
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  Strides sq, sk, sv, so;
  int batch, heads, seq;
  float scale;
  float* lse;   // [batch, heads, seq] fp32, or null (no row statistic)
  // kernel 4 only (BIAS = true): bias [heads, seq, seq] fp32, contiguous;
  // region [n_win, seq] int32 or null (no mask)
  const float* bias;
  const int* region;
  int n_win;
  // the bf16 instances past head dim 64 only: the head dim of q, k, v and
  // out (their instance's, or 8 less: read in place, the columns past it
  // zero); the others read their instance's head dim
  int dh;
};

constexpr float kMaskValue = -100.f;  // shift_attention_mask's value
#define TIM_NEG_INF (-CUDART_INF_F)

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d += a * b, m16n8k16, bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Which (batch, head, query tile) a block computes. Blocks of one head are
// consecutive (head-major), so the windows that share bias[h] run together
// and find it in L2; the query tiles of one (batch, head) are consecutive,
// so they share its k and v there too.
struct Tile {
  int b, h, q0;
};

__device__ __forceinline__ Tile block_tile(const Params& p, int rows) {
  const int n_tiles = (p.seq + rows - 1) / rows;
  const long long bh = blockIdx.x / n_tiles;
  Tile t;
  t.h = (int)(bh / p.batch);
  t.b = (int)(bh % p.batch);
  t.q0 = (int)(blockIdx.x % n_tiles) * rows;
  return t;
}

// 16-byte global -> shared copy that bypasses registers; src_bytes 0
// fills the 16 bytes with zeros (rows past S)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes));
}

// 4-byte variant (.ca: the 16-byte .cg form needs 16-byte alignment)
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 b16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8. Without .trans, lane t receives row t / 4,
// columns 2(t % 4) and 2(t % 4) + 1 of each matrix; with .trans the
// transposed matrix's.
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* smem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* smem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// A 64-key fp32 bias tile's row, padded so that the 8 rows an ldmatrix-
// shaped access touches fall in distinct banks (flash_attention_bwd.cuh).
constexpr int kLDB = 64 + 8;

template <int DH, bool BIAS, bool LSE>
__global__ void __launch_bounds__(128) attention_f32_kernel(const Params p) {
  constexpr int BQ = 128, BK = 16;
  __shared__ __align__(16) float s_k[BK * DH];
  __shared__ __align__(16) float s_v[BK * DH];
  __shared__ int s_region[BK];

  const Tile t = block_tile(p, BQ);
  const int S = p.seq;
  const float* q = static_cast<const float*>(p.q) + t.b * p.sq.b + t.h * p.sq.h;
  const float* k = static_cast<const float*>(p.k) + t.b * p.sk.b + t.h * p.sk.h;
  const float* v = static_cast<const float*>(p.v) + t.b * p.sv.b + t.h * p.sv.h;
  const int tid = threadIdx.x;
  const int row = t.q0 + tid;
  const int rc = min(row, S - 1);

  float qr[DH], acc[DH];
#pragma unroll
  for (int c = 0; c < DH / 4; ++c) {
    const float4 x = *reinterpret_cast<const float4*>(q + rc * p.sq.n + 4 * c);
    qr[4 * c] = x.x; qr[4 * c + 1] = x.y; qr[4 * c + 2] = x.z; qr[4 * c + 3] = x.w;
  }
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] = 0.f;
  const float* bias_row = nullptr;
  int region_row = 0;
  if constexpr (BIAS) {
    bias_row = p.bias + ((long long)t.h * S + rc) * S;
    if (p.region != nullptr)
      region_row = p.region[(long long)(t.b % p.n_win) * S + rc];
  }
  float m = TIM_NEG_INF, l = 0.f;

  for (int k0 = 0; k0 < S; k0 += BK) {
    __syncthreads();
    for (int i = tid; i < BK * DH / 4; i += 128) {
      const int r = i / (DH / 4), c = i % (DH / 4);
      const int key = k0 + r;
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      reinterpret_cast<float4*>(s_k)[i] =
          key < S ? *reinterpret_cast<const float4*>(k + key * p.sk.n + 4 * c)
                  : zero;
      reinterpret_cast<float4*>(s_v)[i] =
          key < S ? *reinterpret_cast<const float4*>(v + key * p.sv.n + 4 * c)
                  : zero;
    }
    if constexpr (BIAS) {
      if (p.region != nullptr && tid < BK)
        s_region[tid] =
            p.region[(long long)(t.b % p.n_win) * S + min(k0 + tid, S - 1)];
    }
    __syncthreads();

    float s[BK];
    float mx = TIM_NEG_INF;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) dot = fmaf(qr[d], s_k[j * DH + d], dot);
      float x = TIM_NEG_INF;
      if (k0 + j < S) {
        x = dot * p.scale;
        if constexpr (BIAS) {
          x += bias_row[k0 + j];
          if (p.region != nullptr && region_row != s_region[j])
            x += kMaskValue;
        }
      }
      s[j] = x;
      mx = fmaxf(mx, x);
    }
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    m = m_new;
    l *= corr;
#pragma unroll
    for (int d = 0; d < DH; ++d) acc[d] *= corr;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float pj = expf(s[j] - m);
      l += pj;
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[d] = fmaf(pj, s_v[j * DH + d], acc[d]);
    }
  }

  if (row < S) {
    float* out = static_cast<float*>(p.out) + t.b * p.so.b + t.h * p.so.h +
                 row * p.so.n;
    const float inv = 1.f / l;
    if constexpr (LSE)
      p.lse[((long long)t.b * p.heads + t.h) * S + row] = m + logf(l);
#pragma unroll
    for (int c = 0; c < DH / 4; ++c)
      *reinterpret_cast<float4*>(out + 4 * c) =
          make_float4(acc[4 * c] * inv, acc[4 * c + 1] * inv,
                      acc[4 * c + 2] * inv, acc[4 * c + 3] * inv);
  }
}

// fp32 past head dim 64 (128, 256; kernel 4's bias and region ids with
// BIAS, as in attention_f32_kernel): a thread's q row and its
// DH output sums would not fit its registers, so each block takes 64 of
// the output dims (blockIdx.y) and keeps its 128 q rows in shared memory
// (rows padded to an odd length: a warp's 32 rows fall in 32 banks); the
// blocks of one query tile each recompute its scores. Otherwise the walk
// of attention_f32_kernel.
constexpr int kWideDims = 64;

template <int DH>
constexpr int f32_wide_smem_bytes() {
  return (128 * (DH + 1) + 16 * DH + 16 * kWideDims) * 4;
}

template <int DH, bool BIAS, bool LSE>
__global__ void __launch_bounds__(128) attention_f32_wide_kernel(
    const Params p) {
  constexpr int BQ = 128, BK = 16, DO = kWideDims, LQ = DH + 1;
  extern __shared__ __align__(16) float wide_smem[];
  float* s_q = wide_smem;              // [BQ][LQ]
  float* s_k = s_q + BQ * LQ;          // [BK][DH]
  float* s_v = s_k + BK * DH;          // [BK][DO]: this block's dims
  __shared__ int s_region[BK];

  const Tile t = block_tile(p, BQ);
  const int S = p.seq, d0 = blockIdx.y * DO;
  const float* q = static_cast<const float*>(p.q) + t.b * p.sq.b + t.h * p.sq.h;
  const float* k = static_cast<const float*>(p.k) + t.b * p.sk.b + t.h * p.sk.h;
  const float* v = static_cast<const float*>(p.v) + t.b * p.sv.b + t.h * p.sv.h;
  const int tid = threadIdx.x;
  const int row = t.q0 + tid;
  for (int i = tid; i < BQ * DH; i += 128) {
    const int r = i / DH, c = i % DH, qr = min(t.q0 + r, S - 1);
    s_q[r * LQ + c] = q[qr * p.sq.n + c];
  }
  const float* qs = s_q + tid * LQ;
  const int rc = min(row, S - 1);
  const int* region = BIAS && p.region != nullptr
                          ? p.region + (long long)(t.b % p.n_win) * S
                          : nullptr;
  const float* bias_row =
      BIAS ? p.bias + ((long long)t.h * S + rc) * S : nullptr;
  const int region_row = region != nullptr ? region[rc] : 0;

  float acc[DO];
#pragma unroll
  for (int d = 0; d < DO; ++d) acc[d] = 0.f;
  float m = TIM_NEG_INF, l = 0.f;

  for (int k0 = 0; k0 < S; k0 += BK) {
    __syncthreads();   // also: the q rows are in before the first tile
    for (int i = tid; i < BK * DH; i += 128) {
      const int r = i / DH, c = i % DH, key = k0 + r;
      s_k[i] = key < S ? k[key * p.sk.n + c] : 0.f;
    }
    for (int i = tid; i < BK * DO; i += 128) {
      const int r = i / DO, c = i % DO, key = k0 + r;
      s_v[i] = key < S ? v[key * p.sv.n + d0 + c] : 0.f;
    }
    if (region != nullptr && tid < BK)
      s_region[tid] = region[min(k0 + tid, S - 1)];
    __syncthreads();

    float s[BK];
    float mx = TIM_NEG_INF;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < DH; ++d) dot = fmaf(qs[d], s_k[j * DH + d], dot);
      float x = TIM_NEG_INF;
      if (k0 + j < S) {
        x = dot * p.scale;
        if constexpr (BIAS) {
          x += bias_row[k0 + j];
          if (region != nullptr && region_row != s_region[j])
            x += kMaskValue;
        }
      }
      s[j] = x;
      mx = fmaxf(mx, s[j]);
    }
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    m = m_new;
    l *= corr;
#pragma unroll
    for (int d = 0; d < DO; ++d) acc[d] *= corr;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float pj = expf(s[j] - m);
      l += pj;
#pragma unroll
      for (int d = 0; d < DO; ++d) acc[d] = fmaf(pj, s_v[j * DO + d], acc[d]);
    }
  }

  if (row < S) {
    float* out = static_cast<float*>(p.out) + t.b * p.so.b + t.h * p.so.h +
                 row * p.so.n + d0;
    const float inv = 1.f / l;
    if constexpr (LSE) {
      if (blockIdx.y == 0)
        p.lse[((long long)t.b * p.heads + t.h) * S + row] = m + logf(l);
    }
#pragma unroll
    for (int c = 0; c < DO / 4; ++c)
      *reinterpret_cast<float4*>(out + 4 * c) =
          make_float4(acc[4 * c] * inv, acc[4 * c + 1] * inv,
                      acc[4 * c + 2] * inv, acc[4 * c + 3] * inv);
  }
}

// The fp32 kernel's launch (flash_attention_sm90.cuh's launch chooses
// between it and the bf16 kernel); returns cudaGetLastError() after it.
template <int DH, bool BIAS, bool LSE>
int launch_f32(const Params& p, cudaStream_t stream) {
  const long long blocks = (long long)p.batch * p.heads *
                           ((p.seq + 127) / 128);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  if constexpr (DH > kWideDims) {
    constexpr int smem = f32_wide_smem_bytes<DH>();
    auto kernel = attention_f32_wide_kernel<DH, BIAS, LSE>;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<dim3((unsigned)blocks, DH / kWideDims), 128, smem, stream>>>(p);
  } else {
    attention_f32_kernel<DH, BIAS, LSE><<<(unsigned)blocks, 128, 0,
                                          stream>>>(p);
  }
  return (int)cudaGetLastError();
}

// strides: 12 element strides, (batch, head, row) for q, k, v and out.
inline void set_strides(Params& p, const long long* st) {
  Strides* s[4] = {&p.sq, &p.sk, &p.sv, &p.so};
  for (int i = 0; i < 4; ++i) {
    s[i]->b = st[3 * i];
    s[i]->h = st[3 * i + 1];
    s[i]->n = st[3 * i + 2];
  }
}

}  // namespace tim_attn
