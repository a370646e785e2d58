// Exact softmax attention, backward, at head dims past 256: kernel 5b's
// column-slice route (flash_mha_bwd_cols.cu), the function of
// flash_attention_bwd.cuh (no bias):
//
//   p_ij = exp(s_ij - lse_i), dp_ij = do_i . v_j,
//   ds_ij = p_ij (dp_ij - D_i), D_i = do_i . o_i,
//   dv_j = sum_i p_ij do_i, dk_j = sum_i ds_ij scale q_i,
//   dq_i = sum_j ds_ij scale k_j,
//
// fp32 intermediates, p rounded to v's dtype before dv's product and
// ds * scale to q's before dq's and dk's, as the other routes.
//
// Why column slices: the 256 route keeps a 64-row block's k and v (or q
// and dO) resident in shared memory over the whole head dim and sums 128
// output columns a block; past 256 neither the resident rows nor the sums
// fit. So two passes, dk/dv and dq, each with a grid axis over slices of
// output columns; a block walks the other side's tiles, forms s and dp
// over the full head dim as sums over 64-column chunks, and feeds them
// into its slice alone. Every slice recomputes s and dp. Nothing is summed
// across blocks, so there are no atomics: the same bits every run, with
// or without torch.use_deterministic_algorithms (the same kernels either
// way).
//
// This file keeps D (any head dim, both dtypes) and the fp32 passes (the
// parity path: CUDA cores, one thread a row of 128, 32-row walked tiles,
// 64 output columns a block); the bf16 passes run on wgmma
// (attention_cols_bwd_sm90.cuh). Rows past S read as zeros and are not
// stored; columns past dh read as zeros and are not stored.

#pragma once

#include "flash_attention_bwd.cuh"

namespace tim_attn {
namespace colsbwd {

using bf = __nv_bfloat16;

// D_i = do_i . o_i in fp32, one thread a row, any head dim.
template <typename T>
__global__ void __launch_bounds__(256) delta_kernel(const BwdParams p,
                                                    int dh) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)p.batch * p.heads * p.seq) return;
  const int row = (int)(i % p.seq);
  const long long bh = i / p.seq;
  const int h = (int)(bh % p.heads), b = (int)(bh / p.heads);
  const T* o = at<T>(p.o, p.so, b, h) + row * p.so.n;
  const T* d = at<T>(p.dout, p.sdo, b, h) + row * p.sdo.n;
  float acc = 0.f;
  for (int c = 0; c < dh; ++c)
    acc = fmaf(tim::to_f(o[c]), tim::to_f(d[c]), acc);
  p.delta[i] = acc;
}

// ---- fp32 (CUDA cores) ----

constexpr int kF32Rows = 128, kF32Walk = 32, kF32Dims = 64;
constexpr int kF32Smem = (2 * kF32Rows * (kF32Dims + 1) +
                          4 * kF32Walk * kF32Dims + 2 * kF32Walk) * 4;

// rows [row0, row0 + n) x columns [col0, col0 + 64) of a [S, dh] fp32
// operand into dst (row pitch pitch); rows past S, columns past dh zeros
__device__ __forceinline__ void load_f32(float* dst, int pitch,
                                         const float* src, long long ld,
                                         int row0, int n, int S, int col0,
                                         int dh, int tid) {
  for (int i = tid; i < n * kF32Dims; i += 128) {
    const int r = i / kF32Dims, c = i % kF32Dims;
    const int row = row0 + r, col = col0 + c;
    dst[r * pitch + c] = row < S && col < dh ? src[row * ld + col] : 0.f;
  }
}

// One thread a row of 128 (DKDV: keys, writing dk and dv; else queries,
// writing dq), 64 output columns a block (grid axis y), walking 32-row
// tiles of the other side: s and dp summed over 64-column chunks (the
// rows' chunks in shared memory padded to 65 floats), then the block's
// columns.
template <bool DKDV>
__global__ void __launch_bounds__(128) bwd_f32_kernel(const BwdParams p,
                                                      int dh) {
  constexpr int BR = kF32Rows, BT = kF32Walk, DC = kF32Dims, LR = DC + 1;
  extern __shared__ __align__(16) float f32_smem[];
  float* s_a1 = f32_smem;             // [BR][LR]
  float* s_a2 = s_a1 + BR * LR;       // [BR][LR]
  float* s_b1 = s_a2 + BR * LR;       // [BT][DC]: the walked tile's chunk
  float* s_b2 = s_b1 + BT * DC;
  float* s_c1 = s_b2 + BT * DC;       // [BT][DC]: the slice operands
  float* s_c2 = s_c1 + BT * DC;
  float* s_lse = s_c2 + BT * DC;      // [BT] (DKDV)
  float* s_delta = s_lse + BT;

  const Tile t = bwd_tile(p, BR);
  const int S = p.seq, tid = threadIdx.x, d0 = blockIdx.y * DC;
  const int row = t.q0 + tid, rc = min(row, S - 1);
  const long long bh = ((long long)t.b * p.heads + t.h) * S;
  const float* q = at<float>(p.q, p.sq, t.b, t.h);
  const float* k = at<float>(p.k, p.sk, t.b, t.h);
  const float* v = at<float>(p.v, p.sv, t.b, t.h);
  const float* dout = at<float>(p.dout, p.sdo, t.b, t.h);
  const float* a1 = DKDV ? k : q;
  const float* a2 = DKDV ? v : dout;
  const float* b1 = DKDV ? q : k;
  const float* b2 = DKDV ? dout : v;
  const long long la1 = DKDV ? p.sk.n : p.sq.n, la2 = DKDV ? p.sv.n : p.sdo.n;
  const long long lb1 = DKDV ? p.sq.n : p.sk.n, lb2 = DKDV ? p.sdo.n : p.sv.n;
  const float lse_r = DKDV ? 0.f : p.lse[bh + rc];
  const float delta_r = DKDV ? 0.f : p.delta[bh + rc];

  float o1[DC], o2[DKDV ? DC : 1];   // dv, dk | dq
#pragma unroll
  for (int d = 0; d < DC; ++d) o1[d] = 0.f;
#pragma unroll
  for (int d = 0; d < (DKDV ? DC : 1); ++d) o2[d] = 0.f;

  for (int j0 = 0; j0 < S; j0 += BT) {
    float s[BT], dp[BT];
#pragma unroll
    for (int j = 0; j < BT; ++j) s[j] = dp[j] = 0.f;
    for (int c = 0; c < dh; c += DC) {
      __syncthreads();
      load_f32(s_a1, LR, a1, la1, t.q0, BR, S, c, dh, tid);
      load_f32(s_a2, LR, a2, la2, t.q0, BR, S, c, dh, tid);
      load_f32(s_b1, DC, b1, lb1, j0, BT, S, c, dh, tid);
      load_f32(s_b2, DC, b2, lb2, j0, BT, S, c, dh, tid);
      __syncthreads();
      const float* x1 = s_a1 + tid * LR;
      const float* x2 = s_a2 + tid * LR;
#pragma unroll
      for (int j = 0; j < BT; ++j) {
        float u = s[j], w = dp[j];
#pragma unroll 16
        for (int d = 0; d < DC; ++d) {
          u = fmaf(x1[d], s_b1[j * DC + d], u);
          w = fmaf(x2[d], s_b2[j * DC + d], w);
        }
        s[j] = u;
        dp[j] = w;
      }
    }
    __syncthreads();
    if constexpr (DKDV) {
      load_f32(s_c1, DC, q, p.sq.n, j0, BT, S, d0, dh, tid);
      load_f32(s_c2, DC, dout, p.sdo.n, j0, BT, S, d0, dh, tid);
      if (tid < BT) {
        const int r = min(j0 + tid, S - 1);
        s_lse[tid] = p.lse[bh + r];
        s_delta[tid] = p.delta[bh + r];
      }
    } else {
      load_f32(s_c1, DC, k, p.sk.n, j0, BT, S, d0, dh, tid);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < BT; ++j) {
      if (j0 + j >= S) break;
      if constexpr (DKDV) {
        const float pj = expf(s[j] * p.scale - s_lse[j]);
        const float ds = pj * (dp[j] - s_delta[j]) * p.scale;
#pragma unroll
        for (int d = 0; d < DC; ++d) {
          o1[d] = fmaf(pj, s_c2[j * DC + d], o1[d]);
          o2[d] = fmaf(ds, s_c1[j * DC + d], o2[d]);
        }
      } else {
        const float ds = expf(s[j] * p.scale - lse_r) * (dp[j] - delta_r) *
                         p.scale;
#pragma unroll
        for (int d = 0; d < DC; ++d) o1[d] = fmaf(ds, s_c1[j * DC + d], o1[d]);
      }
    }
  }
  if (row < S) {
    float* out1 = DKDV ? at_mut<float>(p.dv, p.sdv, t.b, t.h) + row * p.sdv.n
                       : at_mut<float>(p.dq, p.sdq, t.b, t.h) + row * p.sdq.n;
    float* out2 = DKDV ? at_mut<float>(p.dk, p.sdk, t.b, t.h) + row * p.sdk.n
                       : nullptr;
#pragma unroll
    for (int d = 0; d < DC; ++d) {
      if (d0 + d >= dh) continue;
      out1[d0 + d] = o1[d];
      if constexpr (DKDV) out2[d0 + d] = o2[d];
    }
  }
}

}  // namespace colsbwd

// The fp32 column-slice backward: D, then the dk/dv pass and the dq pass,
// on one stream; returns the first launch's CUDA error (0 on success).
inline int launch_bwd_cols_f32(const BwdParams& p, int dh,
                               cudaStream_t stream) {
  namespace cb = colsbwd;
  const long long rows = (long long)p.batch * p.heads * p.seq;
  if (p.batch <= 0 || p.heads <= 0 || p.seq <= 0 || dh <= 0) return 0;
  if ((rows + 255) / 256 > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  cb::delta_kernel<float><<<(unsigned)((rows + 255) / 256), 256, 0,
                            stream>>>(p, dh);
  int err = (int)cudaGetLastError();
  const long long blocks = (long long)p.batch * p.heads *
                           ((p.seq + cb::kF32Rows - 1) / cb::kF32Rows);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)blocks, (dh + cb::kF32Dims - 1) / cb::kF32Dims);
  for (int pass = 0; pass < 2 && err == 0; ++pass) {
    auto kernel =
        pass == 0 ? cb::bwd_f32_kernel<true> : cb::bwd_f32_kernel<false>;
    err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, cb::kF32Smem);
    if (err != 0) return err;
    kernel<<<grid, cb::kF32Rows, cb::kF32Smem, stream>>>(p, dh);
    err = (int)cudaGetLastError();
  }
  return err;
}

}  // namespace tim_attn
