// Multi-head flash attention, backward, bf16, at head dims 80, 96, 112 and
// 128 on Hopper's warpgroup tensor-core products (wgmma, sm_90a): kernel
// 5b's route between head dims 64 and 128 (flash_mha_bwd_wide.cu), and
// with BIAS kernel 4b's dq, dk and dv at head dims 64-128
// (window_attention_bwd_wide.cu: the relative-position bias and the shift
// mask added to each score, dbias left to window_dbias_sm90.cuh), which
// replaces the backward of tim_tpu/ops/flash.py::flash_mha (the Pallas
// flash kernel's dkv and dq kernels) at the public VideoMAE widths past 64:
// ViT-H/16 (80), ViT-g/14 (88, on the 96 instance), ViT-G/14 (104, on the
// 112 instance).
//
// The function is flash_mha_bwd_sm90.cuh's: with s_ij = (q_i . k_j) * scale
// and the forward's row statistic lse_i,
//   p_ij = exp(s_ij - lse_i),  dp_ij = do_i . v_j,  D_i = do_i . o_i,
//   ds_ij = p_ij (dp_ij - D_i) * scale,
//   dv_j = sum_i p_ij do_i,  dk_j = sum_i ds_ij q_i,  dq_i = sum_j ds_ij k_j,
// p and ds rounded to bf16 before their products, every product summed in
// fp32, each gradient rounded once to bf16.
//
// What bounds it on the H100: the tensor cores. At [8, 16, 1568, 80] the
// five products of one pass are 2 S^2 dh flops each per (batch, head),
// 252 GFLOP, 0.25 ms at 989 TFLOP/s, against 0.1 GB of operands.
//
// Design: two passes, no atomics, so every gradient is the same bits every
// run (the deterministic route is this route). The one-pass core of head
// dim 64 keeps dq, dk and dv sums of a 64-wide head in 225 registers a
// thread; past 64 they do not fit, and its dq sum across key blocks needs
// atomic adds besides. Here each pass keeps one kind of sum:
//   dk/dv pass: a block owns 128 keys (two warpgroups of 64, their K and V
//     rows resident in shared memory) and streams 64-query tiles of q, do,
//     lse and D through a four-stage TMA ring. Per tile each warpgroup runs
//     S^T = K Q^T and dP^T = V dO^T (both operands from shared memory), P^T
//     and dS^T in registers, then dV += P^T dO and dK += dS^T Q (A from
//     registers, B read transposed): dk and dv of 64 keys stay in
//     registers (80 a thread at head dim 80, 128 at 128).
//   dq pass: the forward's walk (flash_attention_sm90.cuh): a block owns 128
//     queries (Q, dO resident), streams 64-key tiles of K and V through a
//     TMA ring, and runs S = Q K^T, dP = dO V^T and dQ += dS K, the dQ
//     product of one tile overlapping the softmax work of the next.
// That is 7 products a score against one pass's 5 (the bound above times
// 1.4). The two warpgroups of a block share a ring but never wait for each
// other except to free a stage, so one's products overlap the other's
// softmax work.
//
// Tiles are kept as flash_attention_sm90.cuh's column blocks (Cols): a
// 64-column block in the 128-byte swizzle (two at 128), then a 32- and /
// or 16-column block in the 64- / 32-byte swizzles; each block is one TMA
// box and one wgmma operand. The TMA maps span the true head dim dh and
// fill the columns past it with zeros, and the resident tiles' loads do the
// same, so a head dim 8 below the instance (88, 104, 120) is read in place;
// columns past dh are not stored. Ragged S is not padded: rows past S load
// as zeros, scores of queries (dk/dv pass) or keys (dq pass) past S are
// probabilities of 0, and rows past S are not stored.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "flash_attention.cuh"
#include "flash_attention_sm90.cuh"
#include "wgmma.cuh"

namespace tim_attn {
namespace bwd90 {

using bf = __nv_bfloat16;
using fwd90::Cols;
using fwd90::desc;
using fwd90::TailAcc;

constexpr int kThreads = 256;   // two warpgroups
constexpr int kRows = 128;      // rows a block keeps: keys or queries
constexpr int kTile = 64;       // rows a streamed tile: queries or keys
constexpr int kStages = 4;      // ring stages
constexpr int kAhead = 2;       // tiles loaded ahead
constexpr int kStat = 2 * kTile * 4;   // a tile's lse and D (dk/dv pass)
constexpr float kLog2e = 1.4426950408889634f;
// The dk/dv pass overlaps the dV/dK products of one query tile with the
// softmax work of the next where the registers allow it (a tile's P^T,
// dS^T fragments stay live beside the next tile's scores: 32 more a
// thread, past 255 at head dims 112 and 128).
template <int DH>
constexpr bool kPipe = DH <= 96;

struct Params {
  const bf* q;
  const bf* k;
  const bf* v;
  const bf* o;
  const bf* dout;
  bf* dq;
  bf* dk;
  bf* dv;
  Strides sq, sk, sv, so, sdo, sdq, sdk, sdv;
  const float* lse;    // [batch, heads, seq], from the forward
  // [2][batch * heads][seq_pad]: lse and D, rows padded to a multiple of 4
  // (16 bytes, for their TMA boxes) with zeros; written by stats_kernel
  float* stats;
  int batch, heads, seq, seq_pad;
  int dh;              // the head dim read (the instance's, or 8 less)
  float scale;
  // kernel 4b (BIAS): bias [heads, seq, seq] fp32; region [n_win, seq]
  // int32 or null; the window type is batch % n_win
  const float* bias;
  const int* region;
  int n_win;
};

// The TMA maps a pass streams: the main column blocks' of its two tensors
// (q and do, or k and v), their tail blocks' (fwd90::TailMaps order), and
// for the dk/dv pass the padded rows of lse and D.
template <int DH>
struct Maps {
  CUtensorMap a, b;
  fwd90::TailMaps<DH> tail;
  CUtensorMap lse, delta;
};

template <int DH>
struct Shape {
  static constexpr int kResident = kRows * DH * 2;   // one resident tile
  static constexpr int kStream = kTile * DH * 2;     // one streamed tile
  // 2 resident | stages x 2 streamed | stages x lse, D | stages x (full,
  // empty) barriers, + alignment slack
  static constexpr int kSmem = 2 * kResident + kStages * 2 * kStream +
                               kStages * kStat + kStages * 16 + 1024;
};

// Rows [row0, row0 + kRows) of a [S, dh] operand (row stride ld) into a
// resident [kRows][DH] tile of column blocks at dst; rows past S and
// columns past dh zero-filled; all threads copy together.
template <int DH>
__device__ __forceinline__ void load_resident(uint32_t dst, const bf* src,
                                              long long ld, int row0, int S,
                                              int dh, int tid) {
  constexpr int CH = DH / 8;
  for (int i = tid; i < kRows * CH; i += kThreads) {
    const int r = i / CH, c = i % CH;
    const bool in = row0 + r < S && c * 8 < dh;
    sm90::cp16(dst + fwd90::tile_at<DH, kRows>(r, c),
               src + (long long)min(row0 + r, S - 1) * ld + (in ? c * 8 : 0),
               in ? 16 : 0);
  }
}

// The streamed tile `tile` of the maps' two tensors (a at dst_a, b at
// dst_b, kTile rows of (batch b, head h)), completing on bar.
template <int DH>
__device__ __forceinline__ void load_stream(const Maps<DH>& mp, uint32_t dst_a,
                                            uint32_t dst_b, int tile, int h,
                                            int b, uint32_t bar) {
  using C = Cols<DH>;
  const int r0 = tile * kTile;
#pragma unroll
  for (int j = 0; j < C::kNC; ++j) {
    fwd90::tma_load_4d(dst_a + j * kTile * 128, &mp.a, j * 64, r0, h, b, bar);
    fwd90::tma_load_4d(dst_b + j * kTile * 128, &mp.b, j * 64, r0, h, b, bar);
  }
  if constexpr (C::kT32) {
    fwd90::tma_load_4d(dst_a + kTile * C::kC32 * 2, &mp.tail.m[0], C::kC32,
                       r0, h, b, bar);
    fwd90::tma_load_4d(dst_b + kTile * C::kC32 * 2, &mp.tail.m[1], C::kC32,
                       r0, h, b, bar);
  }
  if constexpr (C::kT16) {
    constexpr int m16 = C::kT32 ? 2 : 0;
    fwd90::tma_load_4d(dst_a + kTile * C::kC16 * 2, &mp.tail.m[m16], C::kC16,
                       r0, h, b, bar);
    fwd90::tma_load_4d(dst_b + kTile * C::kC16 * 2, &mp.tail.m[m16 + 1],
                       C::kC16, r0, h, b, bar);
  }
}

// acc (64 x 64) = A B^T over the head dim (ACC: acc += A B^T, acc holding
// kernel 4b's bias terms over the scale): A the 64 rows from a_r0 of a
// [AROWS][DH] tile at a, B the kTile rows of a [kTile][DH] tile at b, both
// K-major; k-steps walk the column blocks.
template <int DH, int AROWS, bool ACC = false>
__device__ __forceinline__ void product_rows(float (&acc)[32], uint32_t a,
                                             int a_r0, uint32_t b) {
  using C = Cols<DH>;
#pragma unroll
  for (int j = 0; j < C::kNC; ++j) {
    const uint64_t da = desc<64>(a + AROWS * j * 128 + a_r0 * 128);
    const uint64_t db = desc<64>(b + kTile * j * 128);
    if (j == 0)
      sm90::wgmma_ss<0, 0, ACC>(acc, da, db);
    else
      sm90::wgmma_ss<0, 0, true>(acc, da, db);
#pragma unroll
    for (int kk = 1; kk < 4; ++kk)
      sm90::wgmma_ss<0, 0, true>(acc, da + 2 * kk, db + 2 * kk);
  }
  if constexpr (C::kT32) {
    const uint64_t da = desc<32>(a + AROWS * C::kC32 * 2 + a_r0 * 64);
    const uint64_t db = desc<32>(b + kTile * C::kC32 * 2);
    sm90::wgmma_ss<0, 0, true>(acc, da, db);
    sm90::wgmma_ss<0, 0, true>(acc, da + 2, db + 2);
  }
  if constexpr (C::kT16)
    sm90::wgmma_ss<0, 0, true>(
        acc, desc<16>(a + AROWS * C::kC16 * 2 + a_r0 * 32),
        desc<16>(b + kTile * C::kC16 * 2));
}

// acc (64 x DH, main blocks and tails) += A B: A (64 x kTile) the bf16
// fragments a, B the [kTile][DH] tile at b read transposed (MN-major), one
// product a column block and k-step of 16 rows.
template <int DH>
__device__ __forceinline__ void product_cols(float (&acc)[Cols<DH>::kNC][32],
                                             TailAcc<DH>& tail,
                                             const uint32_t (&a)[4][4],
                                             uint32_t b) {
  using C = Cols<DH>;
#pragma unroll
  for (int j = 0; j < C::kNC; ++j)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      sm90::wgmma_rs<1>(acc[j], a[kk],
                        desc<64>(b + kTile * j * 128 + kk * 16 * 128));
  if constexpr (C::kT32) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      sm90::wgmma_rs<1>(tail.a32, a[kk],
                        desc<32>(b + kTile * C::kC32 * 2 + kk * 16 * 64));
  }
  if constexpr (C::kT16) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      sm90::wgmma_rs<1>(tail.a16, a[kk],
                        desc<16>(b + kTile * C::kC16 * 2 + kk * 16 * 32));
  }
}

template <int DH>
__device__ __forceinline__ void zero(float (&acc)[Cols<DH>::kNC][32],
                                     TailAcc<DH>& tail) {
#pragma unroll
  for (int j = 0; j < Cols<DH>::kNC; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;
  tail.zero();
}

template <int DH>
__device__ __forceinline__ void fence(float (&acc)[Cols<DH>::kNC][32],
                                      TailAcc<DH>& tail) {
#pragma unroll
  for (int j = 0; j < Cols<DH>::kNC; ++j) sm90::fence_regs(acc[j]);
  fwd90::fence_tail(tail);
}

// The rows of a 64 x DH accumulator (this thread's rows row0 + 8 r of the
// warp's 16) as bf16 through dst's row stride ld, rows below S and columns
// below dh only.
template <int DH>
__device__ __forceinline__ void store_rows(bf* dst, long long ld,
                                           float (&acc)[Cols<DH>::kNC][32],
                                           TailAcc<DH>& tail, int row0,
                                           int S, int dh, int tig) {
  using C = Cols<DH>;
  auto put = [&](int c0, int i, float x0, float x1) {
    const int row = row0 + 8 * ((i >> 1) & 1);
    const int col = c0 + (i / 4) * 8 + 2 * tig;
    if (row < S && col < dh)
      *reinterpret_cast<uint32_t*>(dst + row * ld + col) = pack_bf16(x0, x1);
  };
#pragma unroll
  for (int j = 0; j < C::kNC; ++j)
#pragma unroll
    for (int i = 0; i < 32; i += 2) put(j * 64, i, acc[j][i], acc[j][i + 1]);
  if constexpr (C::kT32) {
#pragma unroll
    for (int i = 0; i < 16; i += 2)
      put(C::kC32, i, tail.a32[i], tail.a32[i + 1]);
  }
  if constexpr (C::kT16) {
#pragma unroll
    for (int i = 0; i < 8; i += 2)
      put(C::kC16, i, tail.a16[i], tail.a16[i + 1]);
  }
}

// The padded rows of stats: lse copied, D = do . o over the head dim read,
// zeros past seq; one thread a padded row. (Internal linkage: two sources
// include this header.)
namespace {
__global__ void __launch_bounds__(256) stats_kernel(const Params p) {
  const long long n = (long long)p.batch * p.heads * p.seq_pad;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int row = (int)(i % p.seq_pad);
  const long long bh = i / p.seq_pad;
  float lse = 0.f, acc = 0.f;
  if (row < p.seq) {
    const int h = (int)(bh % p.heads), b = (int)(bh / p.heads);
    const bf* o = p.o + b * p.so.b + h * p.so.h + row * p.so.n;
    const bf* d = p.dout + b * p.sdo.b + h * p.sdo.h + row * p.sdo.n;
    for (int c = 0; c < p.dh; c += 8) {
      float x[8], y[8];
      tim::load_floats<bf, 8>(o + c, x);
      tim::load_floats<bf, 8>(d + c, y);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc = fmaf(x[e], y[e], acc);
    }
    lse = p.lse[bh * p.seq + row];
  }
  p.stats[i] = lse;
  p.stats[n + i] = acc;
}
}  // namespace

// Kernel 4b's terms of one 64 x 64 score tile (BIAS): this thread's rows
// (clamped) and their region ids, the head's bias and the window's ids.
struct TileBias {
  const float* hb;
  const int* rw;
  int rows[2], rrow[2];
  __device__ __forceinline__ TileBias(const Params& p, int b, int h,
                                      int row0, bool on) {
    const int S = p.seq;
    hb = on ? p.bias + (long long)h * S * S : nullptr;
    rw = on && p.region != nullptr ? p.region + (long long)(b % p.n_win) * S
                                   : nullptr;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rows[r] = min(row0 + 8 * r, S - 1);
      rrow[r] = rw != nullptr ? rw[rows[r]] : 0;
    }
  }
};

// The shared memory of a pass: resident tiles a, b; the ring's streamed
// tiles; the dk/dv pass's lse and D; the ring's barriers.
template <int DH>
struct Smem {
  uint32_t res_a, res_b, ring, stat, bar;
  __device__ __forceinline__ explicit Smem(uint32_t base) {
    using Sh = Shape<DH>;
    res_a = base;
    res_b = base + Sh::kResident;
    ring = base + 2 * Sh::kResident;
    stat = ring + kStages * 2 * Sh::kStream;
    bar = stat + kStages * kStat;
  }
  __device__ __forceinline__ uint32_t a(int st) const {
    return ring + st * 2 * Shape<DH>::kStream;
  }
  __device__ __forceinline__ uint32_t b(int st) const {
    return a(st) + Shape<DH>::kStream;
  }
  __device__ __forceinline__ uint32_t full(int st) const {
    return bar + 8 * st;
  }
  __device__ __forceinline__ uint32_t empty(int st) const {
    return bar + 8 * (kStages + st);
  }
};

// dk, dv of 128 keys (blocks: (batch, head) major, then key blocks), q, do,
// lse and D streamed through the ring; BIAS: each tile's S^T accumulator
// starts at kernel 4b's bias and mask over the scale.
template <int DH, bool BIAS>
__global__ void __launch_bounds__(kThreads, 1)
    dkdv_kernel(const Params p, const __grid_constant__ Maps<DH> mp) {
  extern __shared__ unsigned char dyn_smem[];
  const uint32_t raw = sm90::smem_u32(dyn_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const unsigned char* gbase = dyn_smem + (base - raw);
  const Smem<DH> sm(base);
  const int S = p.seq, dh = p.dh;
  const int n_kb = (S + kRows - 1) / kRows;
  const long long bh = blockIdx.x / n_kb;
  const int h = (int)(bh % p.heads), b = (int)(bh / p.heads);
  const int k0 = (int)(blockIdx.x % n_kb) * kRows;
  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int tig = lane % 4;
  const int n_qt = (S + kTile - 1) / kTile;
  const float scale_log2 = p.scale * kLog2e;

  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      fwd90::mbar_init(sm.full(st), 1);
      fwd90::mbar_init(sm.empty(st), kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  load_resident<DH>(sm.res_a, p.k + b * p.sk.b + h * p.sk.h, p.sk.n, k0, S,
                    dh, tid);
  load_resident<DH>(sm.res_b, p.v + b * p.sv.b + h * p.sv.h, p.sv.n, k0, S,
                    dh, tid);
  cp_async_commit();
  cp_async_wait<0>();
  sm90::fence_async_smem();   // cp.async's writes, seen by wgmma
  __syncthreads();            // K, V and the initialised barriers

  // q, do of query tile j and its lse and D into stage j % kStages, once
  // every thread is done with the tile kStages before it
  auto load = [&](int j) {
    if (tid == 0) {
      const int st = j % kStages;
      if (j >= kStages) fwd90::mbar_wait(sm.empty(st), (j / kStages - 1) & 1);
      fwd90::mbar_expect_tx(sm.full(st), 2 * Shape<DH>::kStream + kStat);
      load_stream<DH>(mp, sm.a(st), sm.b(st), j, h, b, sm.full(st));
      fwd90::tma_load_2d(sm.stat + st * kStat, &mp.lse, j * kTile, (int)bh,
                         sm.full(st));
      fwd90::tma_load_2d(sm.stat + st * kStat + kTile * 4, &mp.delta,
                         j * kTile, (int)bh, sm.full(st));
    }
    __syncwarp();   // the warp converges before its next wgmma
  };
#pragma unroll
  for (int j = 0; j < kAhead; ++j)
    if (j < n_qt) load(j);

  float sc[32], dp[32];
  float dk[Cols<DH>::kNC][32], dv[Cols<DH>::kNC][32];
  TailAcc<DH> dk_t, dv_t;
  uint32_t pa[4][4], da[4][4];
  // BIAS: the scores' terms (S^T: rows this warpgroup's keys)
  const TileBias tb(p, b, h, k0 + wg * 64 + warp * 16 + lane / 4, BIAS);
  const float inv_scale = 1.f / p.scale;
  zero<DH>(dk, dk_t);
  zero<DH>(dv, dv_t);
  auto arrived = [&](int jt) {
    fwd90::mbar_wait(sm.full(jt % kStages), (jt / kStages) & 1);
  };
  // S^T = K Q^T, dP^T = V dO^T of query tile jt: this warpgroup's 64 keys
  // as M
  auto issue_sdp = [&](int jt) {
    if constexpr (BIAS) {
      fwd90::score_bias<true>(sc, tb.hb, tb.rw, tb.rows, tb.rrow, jt * kTile,
                              tig, S, inv_scale);
      sm90::wg_fence();   // sc written by these loads, read by the product
    }
    product_rows<DH, kRows, BIAS>(sc, sm.res_a, wg * 64, sm.a(jt % kStages));
    product_rows<DH, kRows>(dp, sm.res_b, wg * 64, sm.b(jt % kStages));
  };
  // dV += P^T dO, dK += dS^T Q of query tile jt (pa, da: its fragments)
  auto issue_dvdk = [&](int jt) {
    product_cols<DH>(dv, dv_t, pa, sm.b(jt % kStages));
    product_cols<DH>(dk, dk_t, da, sm.a(jt % kStages));
  };
  auto retire_dvdk = [&]() {
    fence<DH>(dv, dv_t);
    fence<DH>(dk, dk_t);
    sm90::fence_regs(pa);
    sm90::fence_regs(da);
  };
  // P^T and dS^T of query tile jt in place of its scores: element i is key
  // row (i / 2) % 2 * 8 + g of the warp's 16, query column (i / 4) * 8 +
  // 2 tig + i % 2; queries past S (the last tile only) are probabilities
  // and score gradients of 0
  auto softmax = [&](int jt) {
    const float* stat = reinterpret_cast<const float*>(
        gbase + (sm.stat - base) + (jt % kStages) * kStat);
    const int q0 = jt * kTile;
    const bool full = q0 + kTile <= S;
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int col = (i / 4) * 8 + 2 * tig;
      const float2 l2 = *reinterpret_cast<const float2*>(stat + col);
      const float2 d2 = *reinterpret_cast<const float2*>(stat + kTile + col);
      const float lv[2] = {l2.x * kLog2e, l2.y * kLog2e};
      const float dl[2] = {d2.x, d2.y};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool in = full || q0 + col + e < S;
        const float pe = sm90::ex2(sc[i + e] * scale_log2 - lv[e]);
        sc[i + e] = in ? pe : 0.f;
        dp[i + e] = in ? pe * (dp[i + e] - dl[e]) * p.scale : 0.f;
      }
    }
  };

  if constexpr (kPipe<DH>) {
    // the dV/dK products of tile jt - 1 run while the softmax work of
    // tile jt does
    arrived(0);
    sm90::wg_fence();
    issue_sdp(0);
    sm90::wg_commit();
    sm90::wg_wait<0>();
    sm90::fence_regs(sc);
    sm90::fence_regs(dp);
    softmax(0);
    fwd90::pack_p<64>(sc, pa);
    fwd90::pack_p<64>(dp, da);
    if (kAhead < n_qt) load(kAhead);
    for (int jt = 1; jt < n_qt; ++jt) {
      arrived(jt);
      sm90::wg_fence();
      issue_sdp(jt);
      sm90::wg_commit();
      issue_dvdk(jt - 1);
      sm90::wg_commit();
      sm90::wg_wait<1>();   // S^T, dP^T of tile jt done; dV/dK still run
      sm90::fence_regs(sc);
      sm90::fence_regs(dp);
      softmax(jt);
      sm90::wg_wait<0>();
      retire_dvdk();
      fwd90::mbar_arrive(sm.empty((jt - 1) % kStages));   // done with jt - 1
      fwd90::pack_p<64>(sc, pa);
      fwd90::pack_p<64>(dp, da);
      if (jt + kAhead < n_qt) load(jt + kAhead);
    }
    sm90::wg_fence();
    issue_dvdk(n_qt - 1);
    sm90::wg_commit();
    sm90::wg_wait<0>();
    retire_dvdk();
  } else {
    for (int jt = 0; jt < n_qt; ++jt) {
      arrived(jt);
      sm90::wg_fence();
      issue_sdp(jt);
      sm90::wg_commit();
      sm90::wg_wait<0>();
      sm90::fence_regs(sc);
      sm90::fence_regs(dp);
      softmax(jt);
      fwd90::pack_p<64>(sc, pa);
      fwd90::pack_p<64>(dp, da);
      sm90::wg_fence();
      issue_dvdk(jt);
      sm90::wg_commit();
      sm90::wg_wait<0>();
      retire_dvdk();
      fwd90::mbar_arrive(sm.empty(jt % kStages));   // done with this tile
      if (jt + kAhead < n_qt) load(jt + kAhead);
    }
  }

  const int row0 = k0 + wg * 64 + warp * 16 + lane / 4;
  store_rows<DH>(p.dk + b * p.sdk.b + h * p.sdk.h, p.sdk.n, dk, dk_t, row0,
                 S, dh, tig);
  store_rows<DH>(p.dv + b * p.sdv.b + h * p.sdv.h, p.sdv.n, dv, dv_t, row0,
                 S, dh, tig);
}

// dq of 128 queries (blocks: (batch, head) major, then query blocks), k and
// v streamed through the ring; the dQ product of key tile kt - 1 runs while
// the softmax work of tile kt does; BIAS: each tile's S accumulator starts
// at kernel 4b's bias and mask over the scale.
template <int DH, bool BIAS>
__global__ void __launch_bounds__(kThreads, 1)
    dq_kernel(const Params p, const __grid_constant__ Maps<DH> mp) {
  extern __shared__ unsigned char dyn_smem[];
  const uint32_t raw = sm90::smem_u32(dyn_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const Smem<DH> sm(base);
  const int S = p.seq, dh = p.dh;
  const int n_qb = (S + kRows - 1) / kRows;
  const long long bh = blockIdx.x / n_qb;
  const int h = (int)(bh % p.heads), b = (int)(bh / p.heads);
  const int q0 = (int)(blockIdx.x % n_qb) * kRows;
  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int tig = lane % 4;
  const int n_kt = (S + kTile - 1) / kTile;
  const float scale_log2 = p.scale * kLog2e;

  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      fwd90::mbar_init(sm.full(st), 1);
      fwd90::mbar_init(sm.empty(st), kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  load_resident<DH>(sm.res_a, p.q + b * p.sq.b + h * p.sq.h, p.sq.n, q0, S,
                    dh, tid);
  load_resident<DH>(sm.res_b, p.dout + b * p.sdo.b + h * p.sdo.h, p.sdo.n,
                    q0, S, dh, tid);
  cp_async_commit();
  cp_async_wait<0>();
  sm90::fence_async_smem();
  __syncthreads();

  auto load = [&](int j) {
    if (tid == 0) {
      const int st = j % kStages;
      if (j >= kStages) fwd90::mbar_wait(sm.empty(st), (j / kStages - 1) & 1);
      fwd90::mbar_expect_tx(sm.full(st), 2 * Shape<DH>::kStream);
      load_stream<DH>(mp, sm.a(st), sm.b(st), j, h, b, sm.full(st));
    }
    __syncwarp();
  };
#pragma unroll
  for (int j = 0; j < kAhead; ++j)
    if (j < n_kt) load(j);

  // this thread's two query rows: lse (in log2 units) and D
  const int row0 = q0 + wg * 64 + warp * 16 + lane / 4;
  const float* lse = p.stats + bh * p.seq_pad;
  const float* delta = lse + (long long)p.batch * p.heads * p.seq_pad;
  float lv[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = min(row0 + 8 * r, S - 1);
    lv[r] = lse[row] * kLog2e;
    dl[r] = delta[row];
  }

  float sc[32], dp[32];
  float dq[Cols<DH>::kNC][32];
  TailAcc<DH> dq_t;
  uint32_t da[4][4];
  const TileBias tb(p, b, h, row0, BIAS);
  const float inv_scale = 1.f / p.scale;
  // S and dP of key tile kt (BIAS: S from the tile's terms over the scale)
  auto issue_sdp = [&](int kt) {
    if constexpr (BIAS) {
      fwd90::score_bias<false>(sc, tb.hb, tb.rw, tb.rows, tb.rrow,
                               kt * kTile, tig, S, inv_scale);
      sm90::wg_fence();   // sc written by these loads, read by the product
    }
    product_rows<DH, kRows, BIAS>(sc, sm.res_a, wg * 64, sm.a(kt % kStages));
    product_rows<DH, kRows>(dp, sm.res_b, wg * 64, sm.b(kt % kStages));
  };
  zero<DH>(dq, dq_t);
  auto arrived = [&](int kt) {
    fwd90::mbar_wait(sm.full(kt % kStages), (kt / kStages) & 1);
  };
  // dS * scale of key tile kt in place of dp (keys past S: 0)
  auto softmax = [&](int kt) {
    const int k0 = kt * kTile;
    const bool full = k0 + kTile <= S;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      const int col = (i / 4) * 8 + 2 * tig + (i & 1);
      const float pe = sm90::ex2(sc[i] * scale_log2 - lv[r]);
      dp[i] = full || k0 + col < S ? pe * (dp[i] - dl[r]) * p.scale : 0.f;
    }
  };

  // tile 0: S and dP, then dS
  arrived(0);
  sm90::wg_fence();
  issue_sdp(0);
  sm90::wg_commit();
  sm90::wg_wait<0>();
  sm90::fence_regs(sc);
  sm90::fence_regs(dp);
  softmax(0);
  fwd90::pack_p<64>(dp, da);
  if (kAhead < n_kt) load(kAhead);

  for (int kt = 1; kt < n_kt; ++kt) {
    const int prev = (kt - 1) % kStages;
    arrived(kt);
    sm90::wg_fence();
    issue_sdp(kt);
    sm90::wg_commit();
    product_cols<DH>(dq, dq_t, da, sm.a(prev));   // dQ += dS K, tile kt - 1
    sm90::wg_commit();
    sm90::wg_wait<1>();   // S, dP of tile kt done; the dQ product runs
    sm90::fence_regs(sc);
    sm90::fence_regs(dp);
    softmax(kt);
    sm90::wg_wait<0>();
    fence<DH>(dq, dq_t);
    sm90::fence_regs(da);
    fwd90::mbar_arrive(sm.empty(prev));   // done with tile kt - 1
    fwd90::pack_p<64>(dp, da);
    if (kt + kAhead < n_kt) load(kt + kAhead);
  }
  sm90::wg_fence();
  product_cols<DH>(dq, dq_t, da, sm.a((n_kt - 1) % kStages));
  sm90::wg_commit();
  sm90::wg_wait<0>();
  fence<DH>(dq, dq_t);
  sm90::fence_regs(da);

  store_rows<DH>(p.dq + b * p.sdq.b + h * p.sdq.h, p.sdq.n, dq, dq_t, row0,
                 S, dh, tig);
}

// The map of one [batch * heads][seq_pad] fp32 half of stats, boxes of
// one tile's rows of one (batch, head); columns past seq_pad read as
// zeros. (A box's first byte must be 16-byte aligned: hence the padding.)
inline int stat_map(CUtensorMap* map, const float* base, long long rows,
                    int seq_pad) {
  const fwd90::EncodeTiled encode = fwd90::encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  cuuint64_t dims[2] = {(cuuint64_t)seq_pad, (cuuint64_t)rows};
  cuuint64_t strides[1] = {(cuuint64_t)seq_pad * 4};
  cuuint32_t box[2] = {(cuuint32_t)kTile, 1};
  cuuint32_t step[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <typename Kernel, typename M>
int launch_pass(Kernel kernel, const Params& p, const M& maps,
                cudaStream_t stream, int smem) {
  const long long blocks =
      (long long)p.batch * p.heads * ((p.seq + kRows - 1) / kRows);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != 0) return err;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(p, maps);
  return (int)cudaGetLastError();
}

// The floats of stats (Params) for seq rows: two [batch * heads][seq
// rounded up to 4] halves.
inline long long stats_floats(int batch, int heads, int seq) {
  return 2LL * batch * heads * ((seq + 3) / 4 * 4);
}

// stats, the dk/dv pass and the dq pass on one stream; returns the first
// CUDA error of the launches (0 on success).
template <int DH, bool BIAS = false>
int launch(const Params& p, cudaStream_t stream) {
  if (p.batch <= 0 || p.heads <= 0 || p.seq <= 0) return 0;
  const long long bh = (long long)p.batch * p.heads;
  const long long rows = bh * p.seq_pad;
  if ((rows + 255) / 256 > 0x7fffffffLL || bh > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  Maps<DH> kv, qdo;
  int err = fwd90::block_maps<DH>(&qdo.a, &qdo.tail.m[0], 2, p.q, p.sq,
                                  p.batch, p.heads, p.seq, p.dh, kTile);
  if (err == 0)
    err = fwd90::block_maps<DH>(&qdo.b, &qdo.tail.m[1], 2, p.dout, p.sdo,
                                p.batch, p.heads, p.seq, p.dh, kTile);
  if (err == 0) err = stat_map(&qdo.lse, p.stats, bh, p.seq_pad);
  if (err == 0) err = stat_map(&qdo.delta, p.stats + rows, bh, p.seq_pad);
  if (err == 0)
    err = fwd90::block_maps<DH>(&kv.a, &kv.tail.m[0], 2, p.k, p.sk, p.batch,
                                p.heads, p.seq, p.dh, kTile);
  if (err == 0)
    err = fwd90::block_maps<DH>(&kv.b, &kv.tail.m[1], 2, p.v, p.sv, p.batch,
                                p.heads, p.seq, p.dh, kTile);
  if (err != 0) return err;
  kv.lse = qdo.lse;
  kv.delta = qdo.delta;
  stats_kernel<<<(unsigned)((rows + 255) / 256), 256, 0, stream>>>(p);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  err = launch_pass(dkdv_kernel<DH, BIAS>, p, qdo, stream, Shape<DH>::kSmem);
  if (err != 0) return err;
  return launch_pass(dq_kernel<DH, BIAS>, p, kv, stream, Shape<DH>::kSmem);
}

}  // namespace bwd90
}  // namespace tim_attn
