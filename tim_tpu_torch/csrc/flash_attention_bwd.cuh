// Exact softmax attention, backward: the fp32 routes (the parity paths)
// of flash_mha_bwd.cu (kernel 5b, no bias) and window_attention_bwd.cu
// (kernel 4b, bias plus the shifted windows' region mask, and the bias
// gradient), and the atomic-free bf16 dq pass that both bf16 routes take
// under torch.use_deterministic_algorithms (their default bf16 routes are
// the one-pass wgmma cores flash_mha_bwd_sm90.cuh and
// window_attention_bwd_sm90.cuh).
//
// With s_ij = (q_i . k_j) * scale [+ bias[h, i, j] - 100 * (region differs)]
// and the forward's row statistic lse_i = log sum_j exp(s_ij):
//
//   p_ij  = exp(s_ij - lse_i)                 (fp32, recomputed)
//   dv_j  = sum_i p_ij do_i                   (p rounded to v's dtype)
//   dp_ij = do_i . v_j
//   ds_ij = p_ij (dp_ij - D_i),  D_i = do_i . o_i  (= sum_j p_ij dp_ij)
//   dq_i  = sum_j (ds_ij * scale) k_j,  dk_j = sum_i (ds_ij * scale) q_i
//   dbias[h, i, j] = sum over the batch's windows of ds_ij   (kernel 4b)
//
// as pallas_swin._bwd_kernel computes it: fp32 intermediates, each cast to
// the operand dtype before its product (ds * scale is rounded, as dsc is
// there). D comes from a short preprocess over do and o; the TPU kernel
// takes rowsum(dp * p), the same quantity up to the rounding of o.
//
// Blocks run in no order, so nothing is summed across blocks: there are no
// atomics and the result does not change from run to run. fp32 (CUDA
// cores, no TF32, one thread per row): one pass per output, each
// recomputing the scores it needs: dk/dv (one block per (batch, head, 128
// keys)), dq (per 128 queries) and, kernel 4b, dbias (per (head, 128
// queries, 32 keys), walking the batch's windows with the sum in
// registers). bf16 dq (mma.sync m16n8k16 with fp32 accumulators, a
// two-stage cp.async ring, ldmatrix fragments): one block per (batch,
// head, 64 queries) walks the key tiles (3 products a score). Ragged S is
// masked as in the forward (rows past S load as zeros, score nothing and
// are not stored); nothing is padded.

#pragma once

#include "common.cuh"
#include "flash_attention.cuh"

namespace tim_attn {

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  // element strides (batch, head, row) of q, k, v, o, do, dq, dk, dv; the
  // last (dh) dim of each is contiguous
  Strides sq, sk, sv, so, sdo, sdq, sdk, sdv;
  const float* lse;   // [batch, heads, seq], from the forward
  float* delta;       // [batch, heads, seq], written by delta_kernel
  int batch, heads, seq;
  float scale;
  // kernel 4 only (BIAS = true): as in Params, plus dbias [heads, seq, seq]
  // fp32, contiguous, written whole (no accumulation into it)
  const float* bias;
  const int* region;
  int n_win;
  float* dbias;
};

// (batch, head, tile) of a block over (batch, head, 64-row tiles), head
// major as in the forward.
__device__ __forceinline__ Tile bwd_tile(const BwdParams& p, int rows) {
  const int n_tiles = (p.seq + rows - 1) / rows;
  const long long bh = blockIdx.x / n_tiles;
  Tile t;
  t.h = (int)(bh / p.batch);
  t.b = (int)(bh % p.batch);
  t.q0 = (int)(blockIdx.x % n_tiles) * rows;
  return t;
}

template <typename T>
__device__ __forceinline__ const T* at(const void* base, const Strides& s,
                                       int b, int h) {
  return static_cast<const T*>(base) + b * s.b + h * s.h;
}

template <typename T>
__device__ __forceinline__ T* at_mut(void* base, const Strides& s, int b,
                                     int h) {
  return static_cast<T*>(base) + b * s.b + h * s.h;
}

// D_i = do_i . o_i in fp32, one thread per row.
template <int DH, typename T>
__global__ void __launch_bounds__(256) delta_kernel(const BwdParams p) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)p.batch * p.heads * p.seq) return;
  const int row = (int)(i % p.seq);
  const long long bh = i / p.seq;
  const int h = (int)(bh % p.heads), b = (int)(bh / p.heads);
  const T* o = at<T>(p.o, p.so, b, h) + row * p.so.n;
  const T* d = at<T>(p.dout, p.sdo, b, h) + row * p.sdo.n;
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < DH; c += 8) {
    float x[8], y[8];
    tim::load_floats<T, 8>(o + c, x);
    tim::load_floats<T, 8>(d + c, y);
#pragma unroll
    for (int e = 0; e < 8; ++e) acc = fmaf(x[e], y[e], acc);
  }
  p.delta[i] = acc;
}

// Copy a 64 x 64 tile of a [S, S] fp32 matrix (rows row0.., cols col0..)
// into shared memory with row stride ld, clamping rows past S and
// zero-filling columns past S (one cp.async group's worth; 128 threads).
__device__ __forceinline__ void load_bias_tile(float* dst, int ld,
                                               const float* hb, int S,
                                               int row0, int col0, int tid) {
  if (S % 4 == 0) {
    for (int i = tid; i < 64 * 16; i += 128) {
      const int r = i / 16, c = 4 * (i % 16);
      const int row = min(row0 + r, S - 1), col = col0 + c;
      cp_async16(dst + r * ld + c, hb + (long long)row * S + min(col, S - 4),
                 col < S ? 16 : 0);
    }
  } else {
    for (int i = tid; i < 64 * 64; i += 128) {
      const int r = i / 64, c = i % 64;
      const int row = min(row0 + r, S - 1), col = col0 + c;
      cp_async4(dst + r * ld + c, hb + (long long)row * S + min(col, S - 1),
                col < S ? 4 : 0);
    }
  }
}

// 64 rows x DH of a [rows, DH] bf16 operand (row stride ld_g elements)
// into shared memory rows of LD, rows past S zero-filled.
template <int DH>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long ld_g, int row0, int S,
                                          int tid) {
  constexpr int LD = DH + 8, CH = DH / 8;
  for (int i = tid; i < 64 * CH; i += 128) {
    const int r = i / CH, c = i % CH;
    const int row = min(row0 + r, S - 1);
    cp_async16(dst + r * LD + c * 8, src + row * ld_g + c * 8,
               row0 + r < S ? 16 : 0);
  }
}

// acc[nt] (16 rows of this warp x 64 columns) += A (16 x DH, fragments a)
// . B^T, B [64][LD] row-major in shared memory (rows = the 64 columns).
template <int DH>
__device__ __forceinline__ void mma_abt(float (*acc)[4],
                                        uint32_t (*a)[4],
                                        const __nv_bfloat16* b_s, int lane) {
  constexpr int LD = DH + 8;
  const int mi = lane / 8, mr = lane % 8;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DH / 16; ks += 2) {
      uint32_t b[4];
      ldmatrix_x4(b, b_s + (nt * 8 + mr) * LD + ks * 16 + mi * 8);
      mma_bf16(acc[nt], a[ks], b[0], b[1]);
      mma_bf16(acc[nt], a[ks + 1], b[2], b[3]);
    }
  }
}

// out (16 rows x DH) += X . B, X the 16 x 64 fp32 fragments x (rounded to
// bf16 here), B [64][LD] row-major in shared memory (rows = the 64 summed
// indices).
template <int DH>
__device__ __forceinline__ void mma_xb(float (*out)[4], float (*x)[4],
                                       const __nv_bfloat16* b_s, int lane) {
  constexpr int LD = DH + 8;
  const int mi = lane / 8, mr = lane % 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t pa[4];
    pa[0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    pa[1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    pa[2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    pa[3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
#pragma unroll
    for (int dt = 0; dt < DH / 8; dt += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, b_s + (kk * 16 + (mi & 1) * 8 + mr) * LD +
                               (dt + (mi >> 1)) * 8);
      mma_bf16(out[dt], pa, b[0], b[1]);
      mma_bf16(out[dt + 1], pa, b[2], b[3]);
    }
  }
}

// A fragments of this warp's 16 rows of a [64][LD] shared tile.
template <int DH>
__device__ __forceinline__ void load_a(uint32_t (*a)[4],
                                       const __nv_bfloat16* s, int warp,
                                       int lane) {
  constexpr int LD = DH + 8;
  const int mi = lane / 8, mr = lane % 8;
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks)
    ldmatrix_x4(a[ks], s + (warp * 16 + (mi & 1) * 8 + mr) * LD + ks * 16 +
                           (mi >> 1) * 8);
}

// Store this warp's 16 x DH fp32 accumulators (rows row0 + g, + 8) as bf16.
template <int DH>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, long long ld,
                                           float (*acc)[4], int row0,
                                           int S, int lane) {
  const int g = lane / 4, tig = lane % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= S) continue;
#pragma unroll
    for (int dt = 0; dt < DH / 8; ++dt)
      *reinterpret_cast<uint32_t*>(dst + row * ld + dt * 8 + 2 * tig) =
          pack_bf16(acc[dt][2 * r], acc[dt][2 * r + 1]);
  }
}

template <int DH, bool BIAS>
constexpr int dq_smem_bytes() {
  return (2 * 64 + 4 * 64) * (DH + 8) * 2 + (BIAS ? 2 * 64 * kLDB * 4 : 0);
}

// dq of 64 queries: the forward's walk over key tiles (q and dO as
// register A fragments, k and v tiles through the cp.async ring), with
// dp = dO V^T beside s = Q K^T and dq += dS K in place of P V.
template <int DH, bool BIAS>
__global__ void __launch_bounds__(128, 2) dq_bf16_kernel(const BwdParams p) {
  constexpr int BK = 64, LD = DH + 8, LDB = kLDB;
  using bf = __nv_bfloat16;
  extern __shared__ __align__(128) unsigned char dyn_smem[];
  bf* s_q = reinterpret_cast<bf*>(dyn_smem);
  bf* s_do = s_q + 64 * LD;
  auto s_k = [&](int s) { return s_do + (1 + 2 * s) * 64 * LD; };
  auto s_v = [&](int s) { return s_do + (2 + 2 * s) * 64 * LD; };
  float* s_bias = reinterpret_cast<float*>(s_q + 6 * 64 * LD);
  __shared__ int s_region[2][BK];

  const Tile t = bwd_tile(p, 64);
  const int S = p.seq, q0 = t.q0;
  const bf* k = at<bf>(p.k, p.sk, t.b, t.h);
  const bf* v = at<bf>(p.v, p.sv, t.b, t.h);
  const long long bh = ((long long)t.b * p.heads + t.h) * S;
  const int* region = (BIAS && p.region != nullptr)
                          ? p.region + (long long)(t.b % p.n_win) * S
                          : nullptr;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;
  const int n_kt = (S + BK - 1) / BK;

  auto load_kv = [&](int tile, int s) {
    const int k0 = tile * BK;
    load_rows<DH>(s_k(s), k, p.sk.n, k0, S, tid);
    load_rows<DH>(s_v(s), v, p.sv.n, k0, S, tid);
    if (region != nullptr && tid < BK)
      s_region[s][tid] = region[min(k0 + tid, S - 1)];
    if constexpr (BIAS)
      load_bias_tile(s_bias + s * 64 * LDB, LDB,
                     p.bias + (long long)t.h * S * S, S, q0, k0, tid);
  };

  load_rows<DH>(s_q, at<bf>(p.q, p.sq, t.b, t.h), p.sq.n, q0, S, tid);
  load_rows<DH>(s_do, at<bf>(p.dout, p.sdo, t.b, t.h), p.sdo.n, q0, S, tid);
  load_kv(0, 0);
  cp_async_commit();

  float lse[2], delta[2];
  int region_row[2] = {0, 0};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = min(q0 + warp * 16 + g + 8 * r, S - 1);
    lse[r] = p.lse[bh + row];
    delta[r] = p.delta[bh + row];
    if (region != nullptr) region_row[r] = region[row];
  }

  uint32_t qa[DH / 16][4], doa[DH / 16][4];
  float dq[DH / 8][4];
#pragma unroll
  for (int i = 0; i < DH / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[i][e] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt & 1, k0 = kt * BK;
    if (kt + 1 < n_kt) {
      load_kv(kt + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kt == 0) {
      load_a<DH>(qa, s_q, warp, lane);
      load_a<DH>(doa, s_do, warp, lane);
    }

    float pr[8][4];
    mma_abt<DH>(pr, qa, s_k(st), lane);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * tig + (e & 1), r = e >> 1;
        float x = pr[nt][e] * p.scale;
        if constexpr (BIAS) {
          x += s_bias[(st * 64 + warp * 16 + g + 8 * r) * LDB + col];
          if (region != nullptr && region_row[r] != s_region[st][col])
            x += kMaskValue;
        }
        pr[nt][e] = k0 + col < S ? __expf(x - lse[r]) : 0.f;
      }
    }
    float ds[8][4];                         // dp, then dS * scale
    mma_abt<DH>(ds, doa, s_v(st), lane);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[nt][e] = pr[nt][e] * (ds[nt][e] - delta[e >> 1]) * p.scale;
    mma_xb<DH>(dq, ds, s_k(st), lane);      // dq += dS K
    __syncthreads();
  }
  store_rows<DH>(at_mut<bf>(p.dq, p.sdq, t.b, t.h), p.sdq.n, dq,
                 q0 + warp * 16, S, lane);
}

// ---- bf16 at head dim 256: kernel 5b's widest route ----
//
// The one-pass wgmma core (flash_mha_bwd_sm90.cuh) holds dq, dk and dv
// accumulators of a 64-wide head in 225 registers a thread; past 64 they
// do not fit. Up to 128 the two wgmma passes of flash_mha_bwd_wide_sm90.cuh
// keep one kind of sum each; at 256 even dk and dv alone do not fit
// there. These two mma.sync passes (the dq pass's design, with
// no atomics, so the same bits every run) keep no A fragments resident:
// each k16 step's fragment is read from shared memory where it is used,
// and a block accumulates at most 128 output columns (a head of 256 takes
// two blocks, each recomputing the scores), so a thread holds at most
// 2 x 64 fp32 sums beside two [16 x 64] score tiles.
constexpr int kWideCols = 128;

template <int DH>
__host__ __device__ constexpr int wide_cols() {
  return DH < kWideCols ? DH : kWideCols;
}

// acc[nt] (16 rows of this warp x 64 columns) = A (the warp's 16 rows of a
// [64][LD] shared tile a_s) . B^T, B [64][LD] in shared memory; A's
// fragments are read a k-step at a time.
template <int DH>
__device__ __forceinline__ void mma_sbt(float (*acc)[4],
                                        const __nv_bfloat16* a_s,
                                        const __nv_bfloat16* b_s, int warp,
                                        int lane) {
  constexpr int LD = DH + 8;
  const int mi = lane / 8, mr = lane % 8;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < DH / 16; ks += 2) {
    uint32_t a0[4], a1[4];
    ldmatrix_x4(a0, a_s + (warp * 16 + (mi & 1) * 8 + mr) * LD + ks * 16 +
                        (mi >> 1) * 8);
    ldmatrix_x4(a1, a_s + (warp * 16 + (mi & 1) * 8 + mr) * LD +
                        (ks + 1) * 16 + (mi >> 1) * 8);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      uint32_t b[4];
      ldmatrix_x4(b, b_s + (nt * 8 + mr) * LD + ks * 16 + mi * 8);
      mma_bf16(acc[nt], a0, b[0], b[1]);
      mma_bf16(acc[nt], a1, b[2], b[3]);
    }
  }
}

// out (16 rows x DC columns) += X . B[:, 0:DC], X the 16 x 64 fp32
// fragments x (rounded to bf16 here), B [64][DH + 8] row-major in shared
// memory from its first wanted column (rows = the 64 summed indices).
template <int DH, int DC>
__device__ __forceinline__ void mma_xb_cols(float (*out)[4], float (*x)[4],
                                            const __nv_bfloat16* b_s,
                                            int lane) {
  constexpr int LD = DH + 8;
  const int mi = lane / 8, mr = lane % 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t pa[4];
    pa[0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    pa[1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    pa[2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    pa[3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
#pragma unroll
    for (int dt = 0; dt < DC / 8; dt += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, b_s + (kk * 16 + (mi & 1) * 8 + mr) * LD +
                               (dt + (mi >> 1)) * 8);
      mma_bf16(out[dt], pa, b[0], b[1]);
      mma_bf16(out[dt + 1], pa, b[2], b[3]);
    }
  }
}

template <int DH>
constexpr int wide_smem_bytes() {
  return (2 * 64 + 4 * 64) * (DH + 8) * 2;
}

// dk, dv of 64 keys, output columns c0 = blockIdx.y * DC ..: warp w holds
// keys k0 + 16w.. as the rows of the transposed products s^T = K Q^T and
// dp^T = V dO^T; dv += P^T dO and dk += dS^T Q over the block's columns,
// with dO and Q as ldmatrix.trans B operands. Query tiles (q, dO, their
// lse and D) stream through a two-stage cp.async ring.
template <int DH>
__global__ void __launch_bounds__(128, 1) dkdv_bf16_wide_kernel(
    const BwdParams p) {
  constexpr int BQ = 64, LD = DH + 8, DC = wide_cols<DH>();
  using bf = __nv_bfloat16;
  extern __shared__ __align__(128) unsigned char dyn_smem[];
  bf* s_k = reinterpret_cast<bf*>(dyn_smem);
  bf* s_v = s_k + 64 * LD;
  auto s_q = [&](int s) { return s_v + (1 + 2 * s) * 64 * LD; };
  auto s_do = [&](int s) { return s_v + (2 + 2 * s) * 64 * LD; };
  __shared__ float s_lse[2][BQ], s_delta[2][BQ];

  const Tile t = bwd_tile(p, 64);
  const int S = p.seq, k0 = t.q0, c0 = blockIdx.y * DC;
  const bf* q = at<bf>(p.q, p.sq, t.b, t.h);
  const bf* dout = at<bf>(p.dout, p.sdo, t.b, t.h);
  const long long bh = ((long long)t.b * p.heads + t.h) * S;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tig = lane % 4;
  const int n_qt = (S + BQ - 1) / BQ;

  auto load_q = [&](int tile, int s) {
    const int q0 = tile * BQ;
    load_rows<DH>(s_q(s), q, p.sq.n, q0, S, tid);
    load_rows<DH>(s_do(s), dout, p.sdo.n, q0, S, tid);
    if (tid < BQ) {
      const int row = min(q0 + tid, S - 1);
      s_lse[s][tid] = p.lse[bh + row];
      s_delta[s][tid] = p.delta[bh + row];
    }
  };

  load_rows<DH>(s_k, at<bf>(p.k, p.sk, t.b, t.h), p.sk.n, k0, S, tid);
  load_rows<DH>(s_v, at<bf>(p.v, p.sv, t.b, t.h), p.sv.n, k0, S, tid);
  load_q(0, 0);
  cp_async_commit();

  float dk[DC / 8][4], dv[DC / 8][4];
#pragma unroll
  for (int i = 0; i < DC / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;

  for (int jt = 0; jt < n_qt; ++jt) {
    const int st = jt & 1, q0 = jt * BQ;
    if (jt + 1 < n_qt) {
      load_q(jt + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // p^T: rows = this warp's keys, columns = the tile's queries
    float pt[8][4];
    mma_sbt<DH>(pt, s_k, s_q(st), warp, lane);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * tig + (e & 1);
        pt[nt][e] = q0 + col < S
                        ? __expf(pt[nt][e] * p.scale - s_lse[st][col])
                        : 0.f;
      }
    mma_xb_cols<DH, DC>(dv, pt, s_do(st) + c0, lane);   // dv += P^T dO

    float dst[8][4];                        // dp^T, then dS^T * scale
    mma_sbt<DH>(dst, s_v, s_do(st), warp, lane);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * tig + (e & 1);
        dst[nt][e] = pt[nt][e] * (dst[nt][e] - s_delta[st][col]) * p.scale;
      }
    mma_xb_cols<DH, DC>(dk, dst, s_q(st) + c0, lane);   // dk += dS^T Q
    __syncthreads();   // this stage is free for the tile after next
  }

  const int row0 = k0 + warp * 16;
  store_rows<DC>(at_mut<bf>(p.dk, p.sdk, t.b, t.h) + c0, p.sdk.n, dk, row0,
                 S, lane);
  store_rows<DC>(at_mut<bf>(p.dv, p.sdv, t.b, t.h) + c0, p.sdv.n, dv, row0,
                 S, lane);
}

// dq of 64 queries, output columns c0 = blockIdx.y * DC ..: the walk of
// dq_bf16_kernel over key tiles with A fragments read from shared memory.
template <int DH>
__global__ void __launch_bounds__(128, 1) dq_bf16_wide_kernel(
    const BwdParams p) {
  constexpr int BK = 64, LD = DH + 8, DC = wide_cols<DH>();
  using bf = __nv_bfloat16;
  extern __shared__ __align__(128) unsigned char dyn_smem[];
  bf* s_q = reinterpret_cast<bf*>(dyn_smem);
  bf* s_do = s_q + 64 * LD;
  auto s_k = [&](int s) { return s_do + (1 + 2 * s) * 64 * LD; };
  auto s_v = [&](int s) { return s_do + (2 + 2 * s) * 64 * LD; };

  const Tile t = bwd_tile(p, 64);
  const int S = p.seq, q0 = t.q0, c0 = blockIdx.y * DC;
  const bf* k = at<bf>(p.k, p.sk, t.b, t.h);
  const bf* v = at<bf>(p.v, p.sv, t.b, t.h);
  const long long bh = ((long long)t.b * p.heads + t.h) * S;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;
  const int n_kt = (S + BK - 1) / BK;

  auto load_kv = [&](int tile, int s) {
    load_rows<DH>(s_k(s), k, p.sk.n, tile * BK, S, tid);
    load_rows<DH>(s_v(s), v, p.sv.n, tile * BK, S, tid);
  };

  load_rows<DH>(s_q, at<bf>(p.q, p.sq, t.b, t.h), p.sq.n, q0, S, tid);
  load_rows<DH>(s_do, at<bf>(p.dout, p.sdo, t.b, t.h), p.sdo.n, q0, S, tid);
  load_kv(0, 0);
  cp_async_commit();

  float lse[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = min(q0 + warp * 16 + g + 8 * r, S - 1);
    lse[r] = p.lse[bh + row];
    delta[r] = p.delta[bh + row];
  }

  float dq[DC / 8][4];
#pragma unroll
  for (int i = 0; i < DC / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[i][e] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt & 1, k0 = kt * BK;
    if (kt + 1 < n_kt) {
      load_kv(kt + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    float pr[8][4];
    mma_sbt<DH>(pr, s_q, s_k(st), warp, lane);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * tig + (e & 1);
        pr[nt][e] = k0 + col < S ? __expf(pr[nt][e] * p.scale - lse[e >> 1])
                                 : 0.f;
      }
    float ds[8][4];                         // dp, then dS * scale
    mma_sbt<DH>(ds, s_do, s_v(st), warp, lane);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[nt][e] = pr[nt][e] * (ds[nt][e] - delta[e >> 1]) * p.scale;
    mma_xb_cols<DH, DC>(dq, ds, s_k(st) + c0, lane);   // dq += dS K
    __syncthreads();
  }
  store_rows<DC>(at_mut<bf>(p.dq, p.sdq, t.b, t.h) + c0, p.sdq.n, dq,
                 q0 + warp * 16, S, lane);
}

// fp32: dq, one thread per query row, 16-key tiles of k and v in shared
// memory (the forward's fp32 walk).
template <int DH, bool BIAS>
__global__ void __launch_bounds__(128) dq_f32_kernel(const BwdParams p) {
  constexpr int BK = 16;
  __shared__ __align__(16) float s_k[BK * DH];
  __shared__ __align__(16) float s_v[BK * DH];
  __shared__ int s_region[BK];

  const Tile t = bwd_tile(p, 128);
  const int S = p.seq, tid = threadIdx.x;
  const int row = t.q0 + tid, rc = min(row, S - 1);
  const float* k = at<float>(p.k, p.sk, t.b, t.h);
  const float* v = at<float>(p.v, p.sv, t.b, t.h);
  const long long bh = ((long long)t.b * p.heads + t.h) * S;
  float qr[DH], dor[DH], acc[DH];
  tim::load_floats<float, DH>(at<float>(p.q, p.sq, t.b, t.h) + rc * p.sq.n, qr);
  tim::load_floats<float, DH>(
      at<float>(p.dout, p.sdo, t.b, t.h) + rc * p.sdo.n, dor);
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] = 0.f;
  const float lse = p.lse[bh + rc], delta = p.delta[bh + rc];
  const int* region = (BIAS && p.region != nullptr)
                          ? p.region + (long long)(t.b % p.n_win) * S
                          : nullptr;
  const float* bias_row =
      BIAS ? p.bias + ((long long)t.h * S + rc) * S : nullptr;
  const int region_row = region != nullptr ? region[rc] : 0;

  for (int k0 = 0; k0 < S; k0 += BK) {
    __syncthreads();
    for (int i = tid; i < BK * DH / 4; i += 128) {
      const int r = i / (DH / 4), c = i % (DH / 4), key = k0 + r;
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      reinterpret_cast<float4*>(s_k)[i] =
          key < S ? *reinterpret_cast<const float4*>(k + key * p.sk.n + 4 * c)
                  : zero;
      reinterpret_cast<float4*>(s_v)[i] =
          key < S ? *reinterpret_cast<const float4*>(v + key * p.sv.n + 4 * c)
                  : zero;
    }
    if (region != nullptr && tid < BK)
      s_region[tid] = region[min(k0 + tid, S - 1)];
    __syncthreads();
#pragma unroll 1
    for (int j = 0; j < BK && k0 + j < S; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        s = fmaf(qr[d], s_k[j * DH + d], s);
        dp = fmaf(dor[d], s_v[j * DH + d], dp);
      }
      float x = s * p.scale;
      if constexpr (BIAS) {
        x += bias_row[k0 + j];
        if (region != nullptr && region_row != s_region[j]) x += kMaskValue;
      }
      const float ds = expf(x - lse) * (dp - delta) * p.scale;
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[d] = fmaf(ds, s_k[j * DH + d], acc[d]);
    }
  }
  if (row < S) {
    float* out = at_mut<float>(p.dq, p.sdq, t.b, t.h) + row * p.sdq.n;
#pragma unroll
    for (int d = 0; d < DH; ++d) out[d] = acc[d];
  }
}

// dk/dv dims that one fp32 dk/dv block writes (see dkdv_f32_kernel)
template <int DH>
__host__ __device__ constexpr int dkdv_f32_dims() {
  return DH > 32 ? DH / 2 : DH;
}

// fp32: dk and dv, one thread per key row, 16-query tiles of q and dO in
// shared memory. A thread holds its k and v rows and DO dims of dk and dv:
// at DH 64 all of dk and dv would make 256 floats a thread, past the
// register file (ptxas moves them to local memory), so each block writes
// half of the dims (blockIdx.y) and the two halves recompute the scores.
template <int DH, bool BIAS>
__global__ void __launch_bounds__(128) dkdv_f32_kernel(const BwdParams p) {
  constexpr int BQ = 16;
  constexpr int DO = dkdv_f32_dims<DH>();
  const int d0 = blockIdx.y * DO;
  __shared__ __align__(16) float s_q[BQ * DH];
  __shared__ __align__(16) float s_do[BQ * DH];
  __shared__ float s_lse[BQ], s_delta[BQ];
  __shared__ int s_region[BQ];

  const Tile t = bwd_tile(p, 128);
  const int S = p.seq, tid = threadIdx.x;
  const int key = t.q0 + tid, kc = min(key, S - 1);
  const float* q = at<float>(p.q, p.sq, t.b, t.h);
  const float* dout = at<float>(p.dout, p.sdo, t.b, t.h);
  const long long bh = ((long long)t.b * p.heads + t.h) * S;
  float kr[DH], vr[DH], dk[DO], dv[DO];
  tim::load_floats<float, DH>(at<float>(p.k, p.sk, t.b, t.h) + kc * p.sk.n, kr);
  tim::load_floats<float, DH>(at<float>(p.v, p.sv, t.b, t.h) + kc * p.sv.n, vr);
#pragma unroll
  for (int d = 0; d < DO; ++d) dk[d] = dv[d] = 0.f;
  const int* region = (BIAS && p.region != nullptr)
                          ? p.region + (long long)(t.b % p.n_win) * S
                          : nullptr;
  const float* bias_col = BIAS ? p.bias + (long long)t.h * S * S + kc
                               : nullptr;
  const int region_key = region != nullptr ? region[kc] : 0;

  for (int q0 = 0; q0 < S; q0 += BQ) {
    __syncthreads();
    for (int i = tid; i < BQ * DH / 4; i += 128) {
      const int r = i / (DH / 4), c = i % (DH / 4), row = q0 + r;
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      reinterpret_cast<float4*>(s_q)[i] =
          row < S ? *reinterpret_cast<const float4*>(q + row * p.sq.n + 4 * c)
                  : zero;
      reinterpret_cast<float4*>(s_do)[i] =
          row < S ? *reinterpret_cast<const float4*>(dout + row * p.sdo.n +
                                                      4 * c)
                  : zero;
    }
    if (tid < BQ) {
      const int row = min(q0 + tid, S - 1);
      s_lse[tid] = p.lse[bh + row];
      s_delta[tid] = p.delta[bh + row];
      if (region != nullptr) s_region[tid] = region[row];
    }
    __syncthreads();
#pragma unroll 1
    for (int j = 0; j < BQ && q0 + j < S; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        s = fmaf(kr[d], s_q[j * DH + d], s);
        dp = fmaf(vr[d], s_do[j * DH + d], dp);
      }
      float x = s * p.scale;
      if constexpr (BIAS) {
        x += bias_col[(long long)(q0 + j) * S];
        if (region != nullptr && region_key != s_region[j]) x += kMaskValue;
      }
      const float pj = expf(x - s_lse[j]);
      const float ds = pj * (dp - s_delta[j]) * p.scale;
#pragma unroll
      for (int d = 0; d < DO; ++d) {
        dv[d] = fmaf(pj, s_do[j * DH + d0 + d], dv[d]);
        dk[d] = fmaf(ds, s_q[j * DH + d0 + d], dk[d]);
      }
    }
  }
  if (key < S) {
    float* ok = at_mut<float>(p.dk, p.sdk, t.b, t.h) + key * p.sdk.n + d0;
    float* ov = at_mut<float>(p.dv, p.sdv, t.b, t.h) + key * p.sdv.n + d0;
#pragma unroll
    for (int d = 0; d < DO; ++d) {
      ok[d] = dk[d];
      ov[d] = dv[d];
    }
  }
}

// fp32: dbias of (head, 128 queries, 32 keys), one thread per query row,
// summed over the batch's windows in registers.
template <int DH>
__global__ void __launch_bounds__(128) dbias_f32_kernel(const BwdParams p) {
  constexpr int BK = 32;
  __shared__ __align__(16) float s_k[BK * DH];
  __shared__ __align__(16) float s_v[BK * DH];
  __shared__ int s_rk[BK];

  const int S = p.seq, tid = threadIdx.x;
  const int n_qt = (S + 127) / 128, n_kt = (S + BK - 1) / BK;
  const int h = blockIdx.x / (n_qt * n_kt), rem = blockIdx.x % (n_qt * n_kt);
  const int q0 = (rem / n_kt) * 128, k0 = (rem % n_kt) * BK;
  const int row = q0 + tid, rc = min(row, S - 1);
  float bias[BK], acc[BK];
#pragma unroll
  for (int j = 0; j < BK; ++j) {
    bias[j] = p.bias[((long long)h * S + rc) * S + min(k0 + j, S - 1)];
    acc[j] = 0.f;
  }

  for (int b = 0; b < p.batch; ++b) {
    const float* k = at<float>(p.k, p.sk, b, h);
    const float* v = at<float>(p.v, p.sv, b, h);
    const int* rw = p.region != nullptr
                        ? p.region + (long long)(b % p.n_win) * S
                        : nullptr;
    __syncthreads();
    for (int i = tid; i < BK * DH / 4; i += 128) {
      const int r = i / (DH / 4), c = i % (DH / 4), key = k0 + r;
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      reinterpret_cast<float4*>(s_k)[i] =
          key < S ? *reinterpret_cast<const float4*>(k + key * p.sk.n + 4 * c)
                  : zero;
      reinterpret_cast<float4*>(s_v)[i] =
          key < S ? *reinterpret_cast<const float4*>(v + key * p.sv.n + 4 * c)
                  : zero;
    }
    if (rw != nullptr && tid < BK) s_rk[tid] = rw[min(k0 + tid, S - 1)];
    __syncthreads();
    float qr[DH], dor[DH];
    tim::load_floats<float, DH>(at<float>(p.q, p.sq, b, h) + rc * p.sq.n, qr);
    tim::load_floats<float, DH>(
        at<float>(p.dout, p.sdo, b, h) + rc * p.sdo.n, dor);
    const long long bh = ((long long)b * p.heads + h) * S;
    const float lse = p.lse[bh + rc], delta = p.delta[bh + rc];
    const int region_row = rw != nullptr ? rw[rc] : 0;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        s = fmaf(qr[d], s_k[j * DH + d], s);
        dp = fmaf(dor[d], s_v[j * DH + d], dp);
      }
      float x = s * p.scale + bias[j];
      if (rw != nullptr && region_row != s_rk[j]) x += kMaskValue;
      acc[j] += expf(x - lse) * (dp - delta);
    }
  }
  if (row < S) {
    float* db = p.dbias + ((long long)h * S + row) * S + k0;
#pragma unroll
    for (int j = 0; j < BK; ++j)
      if (k0 + j < S) db[j] = acc[j];
  }
}

template <typename Kernel>
int launch_smem(Kernel kernel, long long blocks, int smem,
                cudaStream_t stream, const BwdParams& p,
                unsigned grid_y = 1) {
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  if (smem > 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<dim3((unsigned)blocks, grid_y), 128, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// The fp32 route: D, then dk/dv, dq and (BIAS) dbias, on one stream;
// returns the first launch's CUDA error (0 on success).
template <int DH, bool BIAS>
int launch_bwd_f32(const BwdParams& p, cudaStream_t stream) {
  const long long rows = (long long)p.batch * p.heads * p.seq;
  if (p.batch <= 0 || p.heads <= 0 || p.seq <= 0) return 0;
  if ((rows + 255) / 256 > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  delta_kernel<DH, float><<<(unsigned)((rows + 255) / 256), 256, 0,
                            stream>>>(p);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const long long bh = (long long)p.batch * p.heads;
  const long long t128 = (p.seq + 127) / 128;
  err = launch_smem(dkdv_f32_kernel<DH, BIAS>, bh * t128, 0, stream, p,
                    DH / dkdv_f32_dims<DH>());
  if (err != 0) return err;
  err = launch_smem(dq_f32_kernel<DH, BIAS>, bh * t128, 0, stream, p);
  if constexpr (BIAS) {
    if (err == 0)
      err = launch_smem(dbias_f32_kernel<DH>,
                        p.heads * t128 * ((p.seq + 31) / 32), 0, stream, p);
  }
  return err;
}

// The bf16 route at head dim 256: D, then dk/dv and dq (the two wide
// passes above), on one stream; returns the first launch's CUDA error.
template <int DH>
int launch_bwd_bf16_wide(const BwdParams& p, cudaStream_t stream) {
  const long long rows = (long long)p.batch * p.heads * p.seq;
  if (p.batch <= 0 || p.heads <= 0 || p.seq <= 0) return 0;
  if ((rows + 255) / 256 > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  delta_kernel<DH, __nv_bfloat16><<<(unsigned)((rows + 255) / 256), 256, 0,
                                    stream>>>(p);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const long long blocks = (long long)p.batch * p.heads * ((p.seq + 63) / 64);
  constexpr unsigned kSplit = DH / wide_cols<DH>();
  err = launch_smem(dkdv_bf16_wide_kernel<DH>, blocks, wide_smem_bytes<DH>(),
                    stream, p, kSplit);
  if (err != 0) return err;
  return launch_smem(dq_bf16_wide_kernel<DH>, blocks, wide_smem_bytes<DH>(),
                     stream, p, kSplit);
}

// strides: 24 element strides, (batch, head, row) for q, k, v, o, do, dq,
// dk and dv.
inline void set_bwd_strides(BwdParams& p, const long long* st) {
  Strides* s[8] = {&p.sq, &p.sk, &p.sv, &p.so, &p.sdo, &p.sdq, &p.sdk, &p.sdv};
  for (int i = 0; i < 8; ++i) {
    s[i]->b = st[3 * i];
    s[i]->h = st[3 * i + 1];
    s[i]->n = st[3 * i + 2];
  }
}

}  // namespace tim_attn
