// Exact softmax attention, forward only, with an online softmax over key
// tiles: the core shared by flash_mha.cu (kernel 5, no bias) and
// window_attention.cu (kernel 4, relative-position bias plus the shifted
// windows' region mask).
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
// bf16 (tensor cores): one block per (batch, head, 64 query rows), four
// warps of 16 rows each. q stays in registers as mma.sync A fragments. The
// 64-key tiles of k and v (and, for kernel 4, the fp32 bias of the block's
// rows against those keys) stream through a two-stage cp.async ring in
// shared memory, the next tile loading while this one computes; B
// fragments come from ldmatrix (.trans for v, which stays row-major).
// Scores accumulate in fp32 m16n8k16 fragments, which are rescaled and
// exponentiated in registers and repacked as bf16 A fragments for the PV
// product (unnormalised probabilities rounded to bf16; the TPU kernels
// round normalised ones). Row maxima and sums reduce over the four lanes
// that share a row.
//
// fp32 (CUDA cores, no TF32, so the function stays fp32): one thread per
// query row, 128 rows per block, 16-key tiles of k and v in shared memory
// read as broadcasts.
//
// q, k and v are read in place through (batch, head, row) element strides
// (they are strided views of one packed qkv projection); the last dim is
// contiguous. out is written through its own strides, so a caller can ask
// for the [B, S, H, dh] layout that the output projection reads.

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
  // kernel 4 only (BIAS = true): bias [heads, seq, seq] fp32, contiguous;
  // region [n_win, seq] int32 or null (no mask)
  const float* bias;
  const int* region;
  int n_win;
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

// Shared memory of the bf16 kernel: the q tile and two stages of (k tile,
// v tile), bf16 [rows][DH + 8] (16-byte rows; the 8 rows of an ldmatrix
// fall in distinct banks), then for kernel 4 two stages of the bias tile,
// fp32 [64 rows][64 + 8 keys].
constexpr int kBQ = 64, kBK = 64, kLDB = kBK + 8;

template <int DH, bool BIAS>
constexpr int bf16_smem_bytes() {
  return (kBQ + 4 * kBK) * (DH + 8) * 2 + (BIAS ? 2 * kBQ * kLDB * 4 : 0);
}

// Three blocks an SM: 170 registers a thread at most (shared memory allows
// three blocks of kernel 4 with dh 32).
template <int DH, bool BIAS>
__global__ void __launch_bounds__(128, 3) attention_bf16_kernel(const Params p) {
  constexpr int BQ = kBQ, BK = kBK, LDB = kLDB;
  constexpr int LD = DH + 8;
  constexpr int CH = DH / 8;   // 16-byte chunks per row
  extern __shared__ __align__(128) unsigned char dyn_smem[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(dyn_smem);
  float* s_bias = reinterpret_cast<float*>(smem + (BQ + 4 * BK) * LD);
  __shared__ int s_region[2][BK];
  __nv_bfloat16* s_q = smem;

  const Tile t = block_tile(p, BQ);
  const int S = p.seq;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) +
                           t.b * p.sq.b + t.h * p.sq.h;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k) +
                           t.b * p.sk.b + t.h * p.sk.h;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v) +
                           t.b * p.sv.b + t.h * p.sv.h;
  const int* region = (BIAS && p.region != nullptr)
                          ? p.region + (long long)(t.b % p.n_win) * S
                          : nullptr;
  const int tid = threadIdx.x;
  const int n_tiles = (S + BK - 1) / BK;

  // stage s of the k/v ring
  auto s_k = [&](int s) { return smem + (BQ + 2 * s * BK) * LD; };
  auto s_v = [&](int s) { return smem + (BQ + (2 * s + 1) * BK) * LD; };
  auto load_kv = [&](int tile, int s) {
    const int k0 = tile * BK;
    for (int i = tid; i < BK * CH; i += 128) {
      const int r = i / CH, c = i % CH;
      const int key = min(k0 + r, S - 1);
      const int bytes = k0 + r < S ? 16 : 0;
      cp_async16(s_k(s) + r * LD + c * 8, k + key * p.sk.n + c * 8, bytes);
      cp_async16(s_v(s) + r * LD + c * 8, v + key * p.sv.n + c * 8, bytes);
    }
    if (region != nullptr && tid < BK)
      s_region[s][tid] = region[min(k0 + tid, S - 1)];
    if constexpr (BIAS) {
      // the bias of the block's query rows x this tile's keys; 16-byte
      // copies where rows of bias are 16-byte aligned (S % 4 == 0)
      float* sb = s_bias + s * BQ * LDB;
      const float* hb = p.bias + (long long)t.h * S * S;
      if (S % 4 == 0) {
        for (int i = tid; i < BQ * BK / 4; i += 128) {
          const int r = i / (BK / 4), c = 4 * (i % (BK / 4));
          const int row = min(t.q0 + r, S - 1), key = k0 + c;
          cp_async16(sb + r * LDB + c, hb + (long long)row * S +
                     min(key, S - 4), key < S ? 16 : 0);
        }
      } else {
        for (int i = tid; i < BQ * BK; i += 128) {
          const int r = i / BK, c = i % BK;
          const int row = min(t.q0 + r, S - 1), key = k0 + c;
          cp_async4(sb + r * LDB + c, hb + (long long)row * S +
                    min(key, S - 1), key < S ? 4 : 0);
        }
      }
    }
  };

  for (int i = tid; i < BQ * CH; i += 128) {
    const int r = i / CH, c = i % CH;
    const int row = min(t.q0 + r, S - 1);
    cp_async16(s_q + r * LD + c * 8, q + row * p.sq.n + c * 8,
               t.q0 + r < S ? 16 : 0);
  }
  load_kv(0, 0);
  cp_async_commit();

  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;   // fragment row group, column pair
  const int mi = lane / 8, mr = lane % 8;   // ldmatrix: matrix, row

  // this thread's two rows: r = 0 -> row g, r = 1 -> row g + 8 of the warp
  int rows[2], region_row[2] = {0, 0};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rows[r] = t.q0 + warp * 16 + g + 8 * r;
    if (region != nullptr) region_row[r] = region[min(rows[r], S - 1)];
  }

  uint32_t qa[DH / 16][4];
  float o[DH / 8][4];
#pragma unroll
  for (int i = 0; i < DH / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  float m[2] = {TIM_NEG_INF, TIM_NEG_INF}, l[2] = {0.f, 0.f};

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int st = kt & 1, k0 = kt * BK;
    if (kt + 1 < n_tiles) {
      load_kv(kt + 1, st ^ 1);   // its stage was last read before the
      cp_async_commit();         // barrier that ended the previous tile
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kt == 0) {
      // A fragments of this warp's 16 query rows: matrices (rows 0-7 |
      // 8-15) x (dims 0-7 | 8-15) of each 16-dim step
#pragma unroll
      for (int ks = 0; ks < DH / 16; ++ks)
        ldmatrix_x4(qa[ks], s_q + (warp * 16 + (mi & 1) * 8 + mr) * LD +
                                ks * 16 + (mi >> 1) * 8);
    }

    // scores of this warp's 16 rows against the 64 keys: B fragments of
    // key rows nt*8..+7, dims (ks, lo | hi) and (ks + 1, lo | hi)
    const __nv_bfloat16* kt_s = s_k(st);
    float s[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < DH / 16; ks += 2) {
        uint32_t b[4];
        ldmatrix_x4(b, kt_s + (nt * 8 + mr) * LD + ks * 16 + mi * 8);
        mma_bf16(s[nt], qa[ks], b[0], b[1]);
        mma_bf16(s[nt], qa[ks + 1], b[2], b[3]);
      }
    }

    float mx[2] = {TIM_NEG_INF, TIM_NEG_INF};
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * tig + (e & 1);
        const int r = e >> 1;
        float x = TIM_NEG_INF;
        if (k0 + col < S) {
          x = s[nt][e] * p.scale;
          if constexpr (BIAS) {
            x += s_bias[(st * BQ + warp * 16 + g + 8 * r) * LDB + col];
            if (region != nullptr && region_row[r] != s_region[st][col])
              x += kMaskValue;
          }
        }
        s[nt][e] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);  // finite: key k0 < S
      corr[r] = __expf(m[r] - m_new);          // 0 on the first tile
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int i = 0; i < DH / 8; ++i) {
      o[i][0] *= corr[0];
      o[i][1] *= corr[0];
      o[i][2] *= corr[1];
      o[i][3] *= corr[1];
    }
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = __expf(s[nt][e] - m[e >> 1]);  // exp(-inf) = 0
        s[nt][e] = pe;
        l[e >> 1] += pe;
      }
    }

    // out += P V: the score fragments of key tiles 2kk and 2kk+1 are the
    // A fragment of keys [16kk, 16kk + 16); B fragments from v (row-major
    // [key][dim]) through ldmatrix.trans: matrices (keys lo | hi) x
    // (dims dt*8.. | dt*8+8..)
    const __nv_bfloat16* vt_s = s_v(st);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dt = 0; dt < DH / 8; dt += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vt_s + (kk * 16 + (mi & 1) * 8 + mr) * LD +
                                 (dt + (mi >> 1)) * 8);
        mma_bf16(o[dt], pa, b[0], b[1]);
        mma_bf16(o[dt + 1], pa, b[2], b[3]);
      }
    }
    __syncthreads();   // this stage is free for the tile after next
  }

  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out) + t.b * p.so.b +
                       t.h * p.so.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float inv = 1.f / sum;
    if (rows[r] < S) {
#pragma unroll
      for (int dt = 0; dt < DH / 8; ++dt) {
        *reinterpret_cast<uint32_t*>(out + rows[r] * p.so.n + dt * 8 + 2 * tig) =
            pack_bf16(o[dt][2 * r] * inv, o[dt][2 * r + 1] * inv);
      }
    }
  }
}

template <int DH, bool BIAS>
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
#pragma unroll
    for (int c = 0; c < DH / 4; ++c)
      *reinterpret_cast<float4*>(out + 4 * c) =
          make_float4(acc[4 * c] * inv, acc[4 * c + 1] * inv,
                      acc[4 * c + 2] * inv, acc[4 * c + 3] * inv);
  }
}

template <int DH, bool BIAS>
int launch_dh(const Params& p, bool bf16, cudaStream_t stream) {
  const int rows = bf16 ? 64 : 128;
  const long long blocks = (long long)p.batch * p.heads *
                           ((p.seq + rows - 1) / rows);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  if (bf16) {
    constexpr int smem = bf16_smem_bytes<DH, BIAS>();
    auto kernel = attention_bf16_kernel<DH, BIAS>;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<(unsigned)blocks, 128, smem, stream>>>(p);
  } else
    attention_f32_kernel<DH, BIAS><<<(unsigned)blocks, 128, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

// Launch for head dim 32 or 64; returns cudaGetLastError() after the
// launch (0 on success).
template <bool BIAS>
int launch(const Params& p, int dh, bool bf16, cudaStream_t stream) {
  if (p.batch <= 0 || p.heads <= 0 || p.seq <= 0) return 0;
  switch (dh) {
    case 32: return launch_dh<32, BIAS>(p, bf16, stream);
    case 64: return launch_dh<64, BIAS>(p, bf16, stream);
    default: return (int)cudaErrorInvalidValue;
  }
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
