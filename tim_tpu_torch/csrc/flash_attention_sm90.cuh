// Exact softmax attention, forward, bf16, on Hopper's warpgroup tensor-core
// products (wgmma, sm_90a): the bf16 core of kernel 5 (flash_mha.cu, head
// dims 64, 128, 256; flash_mha_wide.cu, 80, 96, 112; no bias) and kernel 4
// (bias and region ids: window_attention.cu, head dim 32;
// window_attention_wide.cu and window_attention_256.cu, kernel 5's head
// dims past 64; from 33 to 64 kernel 4 has a design of its own,
// window_attention_sm90.cuh). The fp32 instances keep the CUDA-core kernel of
// flash_attention.cuh, whose comment gives the function:
//
//   out[b, h, i] = sum_j p_ij v[b, h, j] / sum_j p_ij,  p_ij = exp(s_ij - m_i),
//   s_ij = (q_i . k_j) * scale [+ bias[h, i, j]
//          - 100 * (region[w, i] != region[w, j])],  w = b % n_win,
//
// fp32 scores and running statistics, the unnormalised probabilities
// rounded to bf16 before the PV product (as the first version did), the
// output in bf16 through its strides, and the row log-sum-exp for the
// backward in a compile-time variant (LSE).
//
// What bounds it on the H100: the products are 4 S^2 dh flops per (batch,
// head) (kernel 5 at [8, 16, 1568, 64]: 80.6 GFLOP, 0.08 ms at 989
// TFLOP/s), and every score also costs one exponential on the SM's
// 16-a-clock unit (kernel 5: 315 M scores, 0.08 ms at 1.755 GHz; kernel 4
// at Swin-B's stage 1, [512, 4, 784, 32]: 1.26 G scores, 0.34 ms, twice its
// 0.16 ms of products, since dh 32 gives only 128 flops a score), all
// computed from shapes. So the design keeps the tensor cores and the
// softmax work busy at once.
//
// Design: two warpgroups a block, each owning 64 query rows; Q is loaded
// once into shared memory. For kernel 5 they are 128 rows of one (batch,
// head) sharing one ring of K and V tiles; for kernel 4 they are the same
// 64 rows of a pair of windows (so of the same bias rows), each warpgroup
// with a ring of its own. Key tiles (64 keys; 48 for kernel 4) stream
// through a four-stage ring filled by TMA (one thread issues both boxes of
// a tile two tiles ahead; an mbarrier per stage says it landed, another
// that every thread of the ring is done with it), so the warpgroups never
// wait for each other. Per key tile kt each warpgroup issues
//   S_kt = Q K_kt^T           (wgmma, both operands from shared memory),
//   O += P_{kt-1} V_{kt-1}    (wgmma, A = P from registers, V read
//                              MN-major through the descriptor),
// waits for S_kt only, runs the softmax of tile kt (scale, bias, region
// compare, row max over the four lanes of a row, ex2 of one FMA a score,
// row sums) while the PV product runs, then waits for it, rescales O by
// the change of the running max and repacks S_kt's probabilities as the
// bf16 A fragments of the next PV product (FlashAttention-3's overlap of
// the softmax with the products inside a warpgroup). Every product group
// is waited for inside the iteration that issued it.
//
// Kernel 4's extra per-score work (an fp32 bias from L2 and, in shifted
// windows, a region compare) stalls its warps more than the products do,
// so at head dim 32 it runs two blocks an SM (128 registers a thread;
// past 64 one, with 64-key tiles up to 128 and 32 at 256, one window a
// block, kernel 5's layout: two rings of wider tiles do not fit beside
// Q, PERF.md row 4); each thread reads
// its own scores' bias into registers a tile ahead of their use (the
// window pair's second read of a bias row comes from L1: the bias is read
// once from L2 for two windows), and each window's region ids sit in
// shared memory. A shifted window whose tokens all lie in one region (most
// of them) has a zero mask, and skips the compare. Two other designs
// measured slower on the card: the two warpgroups taking turns on the
// tensor cores (FlashAttention-3's ping-pong, named barriers), and a
// cp.async ring behind one block barrier a tile. `python -m
// tim_tpu_torch.ablate` builds and times the alternatives of this one
// (one window a block, one block an SM, other key tiles).
//
// Shared-memory tiles are [rows][dh] bf16 in the swizzle that TMA writes
// and wgmma's descriptors name: 128-byte rows in the 128-byte swizzle
// (dh 64), 64-byte rows in the 64-byte swizzle (dh 32), 1024-byte aligned;
// past 64 a tile is kept as column blocks (Cols): 64-column blocks, then
// a 32- and / or 16-column tail in the 64- / 32-byte swizzle, each its own
// TMA box and wgmma operand. Past 64 the TMA maps span the head dim that
// was passed (Params::dh), which may be 8 below the instance's: TMA fills
// the columns past it with zeros, Q's loads do the same, and the output
// columns past it are not stored.
//
// Ragged S is not padded: K and V rows past S arrive as zeros (TMA fills
// boxes past the tensor's end) and their scores are -inf in the last key
// tile only; query rows past S compute from zero rows and are not stored.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_attention.cuh"
#include "wgmma.cuh"

namespace tim_attn {
namespace fwd90 {

constexpr int kThreads = 256;   // two warpgroups
constexpr int kRows = 128;      // query rows a block, 64 a warpgroup

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// one arrival that also expects `bytes` of asynchronous copies (TMA)
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes)
               : "memory");
}
// wait for the completion of the barrier's phase of the given parity
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred P1;\nTIM_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra TIM_DONE;\nbra TIM_WAIT;\nTIM_DONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// a box of a 4-d tensor map into shared memory, completing on bar
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, int c2, int c3,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// a box of a 2-d tensor map into shared memory, completing on bar
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// Byte offset of 16-byte chunk c of row r in a swizzled [rows][W] tile:
// address bits [4, 7) ^= [7, 10) for 128-byte rows (W 64), [4, 6) ^= [7, 9)
// for 64-byte rows (W 32), bit 4 ^= bit 7 for 32-byte rows (W 16).
template <int W>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  if constexpr (W == 64)
    return (uint32_t)(r * 128 + ((c ^ (r & 7)) << 4));
  else if constexpr (W == 32)
    return (uint32_t)(r * 64 + ((c ^ ((r >> 1) & 3)) << 4));
  else
    return (uint32_t)(r * 32 + ((c ^ ((r >> 2) & 1)) << 4));
}

// The column blocks of a [rows][DH] tile: up to head dim 64 one block of
// DH columns (16, 32 or 64: one swizzle atom wide); past it DH / 64 blocks
// of 64 columns in the 128-byte swizzle (the widest a swizzle atom and a
// TMA box of it can be), then, for head dims that are no multiple of 64
// (48, 80, 96, 112), a block of 32 columns in the 64-byte swizzle and / or
// one of 16 in the 32-byte swizzle (48: 32 + 16). Each block is one TMA
// box and one wgmma operand width; a block of w columns holds rows * w * 2
// bytes, so the blocks of one tile lie back to back, each 1024-byte
// aligned when the tile is.
template <int DH>
struct Cols {
  static constexpr int kBW =                        // the main blocks' width
      DH == 48 ? 32 : (DH < 64 ? DH : 64);
  static constexpr int kNC = DH / kBW;              // main blocks
  static constexpr int kTail = DH - kNC * kBW;      // 0, 16, 32 or 48
  static constexpr bool kT32 = (kTail & 32) != 0;   // a 32-column block
  static constexpr bool kT16 = (kTail & 16) != 0;   // a 16-column block
  static constexpr int kC32 = kNC * kBW;            // their first columns
  static constexpr int kC16 = kC32 + (kT32 ? 32 : 0);
  static constexpr int kNT = (kT32 ? 1 : 0) + (kT16 ? 1 : 0);
};

// Chunk c of row r of a [ROWS][DH] tile kept as its column blocks.
template <int DH, int ROWS>
__device__ __forceinline__ uint32_t tile_at(int r, int c) {
  using C = Cols<DH>;
  if constexpr (DH <= 64 && C::kTail == 0) {
    return swz<DH>(r, c);
  } else {
    if constexpr (C::kTail != 0) {
      if (c >= C::kC16 / 8 && C::kT16)
        return (uint32_t)(ROWS * C::kC16 * 2) + swz<16>(r, c - C::kC16 / 8);
      if (c >= C::kC32 / 8)
        return (uint32_t)(ROWS * C::kC32 * 2) + swz<32>(r, c - C::kC32 / 8);
    }
    constexpr int kPer = C::kBW / 8;   // 16-byte chunks a main block row
    return (uint32_t)((c / kPer) * ROWS * C::kBW * 2) +
           swz<C::kBW>(r, c % kPer);
  }
}

// wgmma descriptor of a swizzled [rows][W] tile (or column block) at addr:
// the stride between 8-row groups is 8 rows; the leading byte offset is
// unused by these one-swizzle-atom-wide operands. A k16 step along a row
// adds 32 bytes (2 in descriptor units), a step of 16 rows 16 * 2 W bytes.
template <int W>
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  // 128-, 64- or 32-byte swizzle
  constexpr uint64_t kMode = W == 64 ? 1 : (W == 32 ? 2 : 3);
  constexpr uint64_t kGroup = 8 * W * 2;        // bytes of 8 rows
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((kGroup >> 4) << 32) | (kMode << 62);
}

template <int DH, bool BIAS>
struct Shape {
  // keys a tile: 48 for kernel 4 at head dim 32 keeps its registers at two
  // blocks an SM (128 a thread) free of spills; 32 at head dim 256 keeps
  // four stages of K and V (and Q) in shared memory
  static constexpr int kKeys =
      BIAS && DH <= 32 ? 48 : (DH > 128 ? 32 : 64);
  // main column blocks of a tile (Cols) and their width
  static constexpr int kBW = Cols<DH>::kBW;
  static constexpr int kNC = Cols<DH>::kNC;
  static constexpr int kStages = 4;               // ring stages
  static constexpr int kAhead = kStages - 2;      // tiles loaded ahead
  // blocks an SM: two for kernel 4 at head dim 32 (at most 128 registers
  // a thread), whose per-score work stalls one block's warps more than the
  // tensor cores do; past 64 its O accumulator (DH / 2 a thread) and bias
  // registers take one block an SM
  static constexpr int kMinBlocks = BIAS && DH <= 32 ? 2 : 1;
  // kernel 4 at head dim 32: each warpgroup takes one window of a pair,
  // the same 64 query rows of both (so the same bias rows, read twice from
  // L1), with a K/V ring of its own; past 64 two rings no longer fit
  // beside Q, and kernel 4 takes kernel 5's layout: the block's 128 rows
  // of one (batch, head) share one ring
  static constexpr bool kPair = BIAS && DH <= 32;
  static constexpr int kRings = kPair ? 2 : 1;
  static constexpr int kBlockRows = kPair ? 64 : kRows;   // rows a window
  static constexpr int kRowBytes = DH * 2;
  static constexpr int kQBytes = kRows * kRowBytes;
  static constexpr int kKVBytes = kKeys * kRowBytes;
  // Q | rings x stages x (K, V) | rings x stages x (full, empty) barriers,
  // + alignment slack; kernel 4 adds its windows' region ids at launch
  static constexpr int kSmem =
      kQBytes + kRings * kStages * (2 * kKVBytes + 16) + 1024;
};

// What a thread's softmax step needs besides its scores.
struct RowCtx {
  float scale;           // kernel 4: the products' scale before the bias
  float c;               // exp(x) = ex2(x c): log2(e), times scale in kernel 5
  int region_row[2];     // their region ids (kernel 4, shifted blocks)
  bool masked;           // the window holds more than one region
  int tig;               // lane % 4: the thread's column pair
  const float* bias[2];  // kernel 4: bias[h] rows of the two rows
  bool pairs;            // bias rows 8-byte aligned (S even)
};

// This thread's bias of key tile k0 (kernel 4): for accumulator element i,
// bias[h, row (i / 2) % 2, k0 + (i / 4) * 8 + 2 tig + i % 2], read from L2
// into registers a tile ahead of its use; keys past S read a clamped
// column (their scores are -inf).
template <int BK>
__device__ __forceinline__ void load_bias(float (&bias)[BK / 2],
                                          const RowCtx& rc, int k0, int S) {
#pragma unroll
  for (int i = 0; i < BK / 2; i += 2) {
    const float* row = rc.bias[(i >> 1) & 1];
    const int col = k0 + (i / 4) * 8 + 2 * rc.tig;
    if (rc.pairs) {
      const float2 b2 =
          __ldg(reinterpret_cast<const float2*>(row + min(col, S - 2)));
      bias[i] = b2.x;
      bias[i + 1] = b2.y;
    } else {
      bias[i] = __ldg(row + min(col, S - 1));
      bias[i + 1] = __ldg(row + min(col + 1, S - 1));
    }
  }
}

// Kernel 4's score terms of a 64 x 64 accumulator tile (wgmma's layout, or
// a warp's mma.sync m16n8 tiles in order): element i at row rows[r], r =
// (i / 2) % 2, and column c0 + (i / 4) * 8 + 2 tig + i % 2: bias[row, col]
// + (-100 where their region ids differ), from the head's [S, S] bias hb
// and the window's [S] region ids rw (or null), times `mul` into bv (with
// mul = 1 / scale, the value an S accumulator starts at, so that its
// scores come out as (q . k + terms / scale) * scale with no registers
// beside the accumulator's); columns past S read column S - 1's (their
// scores are masked where they are used). TRANS: the tile is
// S^T (rows keys, columns queries), the bias read as bias[col, row]. rows
// are clamped below S, rrow their region ids. The reads go through L1
// (the block's other tiles read the same rows); each row's are at fixed
// offsets from one pointer, so that the 32 loads in flight need no
// address registers of their own.
template <bool TRANS>
__device__ __forceinline__ void score_bias(float* bv, const float* hb,
                                           const int* rw, const int (&rows)[2],
                                           const int (&rrow)[2], int c0,
                                           int tig, int S, float mul = 1.f) {
  const int cb = c0 + 2 * tig;
  const long long step = TRANS ? S : 1;   // from one column to the next
  const float* p0 = hb + (TRANS ? (long long)cb * S + rows[0]
                                : (long long)rows[0] * S + cb);
  const float* p1 = hb + (TRANS ? (long long)cb * S + rows[1]
                                : (long long)rows[1] * S + cb);
  // a tile past S (the last, ragged one) reads its columns clamped below
  // S; the others at fixed offsets
  const bool ragged = c0 + 64 > S;
  auto col = [&](int k0) { return ragged ? min(k0, S - 1 - cb) : k0; };
  // the region compares first, as two 16-bit masks (bit j * 2 + e: row 0
  // / 1 against column j * 8 + e), so that the ids are dead before the 32
  // bias loads are in flight (the compiler keeps loads below the barrier)
  unsigned m0 = 0, m1 = 0;
  if (rw != nullptr) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int g = __ldg(rw + cb + col(j * 8 + e));
        m0 |= (unsigned)(g != rrow[0]) << (j * 2 + e);
        m1 |= (unsigned)(g != rrow[1]) << (j * 2 + e);
      }
  }
  asm volatile("" ::: "memory");
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int k = col(j * 8 + e);
      const float x0 = __ldg(p0 + k * step);
      const float x1 = __ldg(p1 + k * step);
      bv[j * 4 + e] = mul * (x0 + ((m0 >> (j * 2 + e)) & 1 ? kMaskValue
                                                             : 0.f));
      bv[j * 4 + 2 + e] = mul * (x1 + ((m1 >> (j * 2 + e)) & 1 ? kMaskValue
                                                                 : 0.f));
    }
}

// S = Q K^T of one key tile over the main column blocks: k-steps of m64 x
// BK x k16; past head dim 64 they walk the column blocks (QB, KB: a Q and
// a K column block's bytes). issue_s_tail adds the tail blocks' steps.
template <int DH, int BK, int QB, int KB>
__device__ __forceinline__ void issue_s(float (&sc)[BK / 2], uint64_t dq,
                                        uint64_t dk) {
  constexpr int kPer = Cols<DH>::kBW / 16;   // k-steps a column block
  sm90::wgmma_ss<0, 0, false>(sc, dq, dk);
#pragma unroll
  for (int ks = 1; ks < Cols<DH>::kNC * kPer; ++ks) {
    const int j = ks / kPer, kk = ks % kPer;
    sm90::wgmma_ss<0, 0, true>(sc, dq + j * (QB >> 4) + 2 * kk,
                               dk + j * (KB >> 4) + 2 * kk);
  }
}

// The k-steps of S = Q K^T over the tail column blocks (Cols): two of the
// 32-column block, one of the 16-column block (q_tail, k_tail: the Q
// block of this warpgroup's rows and the K block, 32-column first).
template <int DH, int BK>
__device__ __forceinline__ void issue_s_tail(float (&sc)[BK / 2],
                                             uint32_t s_q, int wg,
                                             uint32_t s_k) {
  using C = Cols<DH>;
  if constexpr (C::kT32) {
    const uint64_t dq = desc<32>(s_q + kRows * C::kC32 * 2 + wg * 64 * 64);
    const uint64_t dk = desc<32>(s_k + BK * C::kC32 * 2);
    sm90::wgmma_ss<0, 0, true>(sc, dq, dk);
    sm90::wgmma_ss<0, 0, true>(sc, dq + 2, dk + 2);
  }
  if constexpr (C::kT16)
    sm90::wgmma_ss<0, 0, true>(
        sc, desc<16>(s_q + kRows * C::kC16 * 2 + wg * 64 * 32),
        desc<16>(s_k + BK * C::kC16 * 2));
}

// The output columns of the tail blocks (Cols): m64n32 and m64n16
// accumulators, element i at column (i / 4) * 8 + 2 (lane % 4) + i % 2 of
// its block (a one-element placeholder where a block is absent).
template <int DH>
struct TailAcc {
  float a32[Cols<DH>::kT32 ? 16 : 1];
  float a16[Cols<DH>::kT16 ? 8 : 1];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < (Cols<DH>::kT32 ? 16 : 0); ++i) a32[i] = 0.f;
#pragma unroll
    for (int i = 0; i < (Cols<DH>::kT16 ? 8 : 0); ++i) a16[i] = 0.f;
  }
};

// O_tail += P V_tail of one key tile (s_v: the stage's V tile).
template <int DH, int BK>
__device__ __forceinline__ void issue_pv_tail(TailAcc<DH>& o,
                                              const uint32_t (&pa)[BK / 16][4],
                                              uint32_t s_v) {
  using C = Cols<DH>;
  if constexpr (C::kT32) {
    const uint64_t dv = desc<32>(s_v + BK * C::kC32 * 2);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      sm90::wgmma_rs<1>(o.a32, pa[kk], dv + kk * ((16 * 32 * 2) >> 4));
  }
  if constexpr (C::kT16) {
    const uint64_t dv = desc<16>(s_v + BK * C::kC16 * 2);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      sm90::wgmma_rs<1>(o.a16, pa[kk], dv + kk * ((16 * 16 * 2) >> 4));
  }
}

// O += P V of one key tile: BK / 16 k-steps of m64 x DH x k16 (one
// product a column block past head dim 64), P's bf16 fragments from
// registers, V [keys][DH] read transposed.
template <int DH, int BK, int NC>
__device__ __forceinline__ void issue_pv(float (&o)[NC][Cols<DH>::kBW / 2],
                                         const uint32_t (&pa)[BK / 16][4],
                                         uint64_t dv) {
  constexpr int BW = Cols<DH>::kBW;
  constexpr int kStep = (16 * BW * 2) >> 4;   // 16 key rows
  constexpr int kBlock = (BK * BW * 2) >> 4;  // a column block of V
#pragma unroll
  for (int j = 0; j < NC; ++j)
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      sm90::wgmma_rs<1>(o[j], pa[kk], dv + j * kBlock + kk * kStep);
}

// The softmax step of one key tile, in place on the fp32 scores: the
// scores of keys past S, the bias and region mask of kernel 4, the running
// max m (in the units the scores are kept in), corr = exp(m_old - m_new)
// (0 on the first tile), the unnormalised probabilities, and the running
// sums l (this thread's columns only; summed over the row's four lanes at
// the end).
template <int BK, bool BIAS, int NB>
__device__ __forceinline__ void softmax_tile(float (&sc)[BK / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&corr)[2],
                                             const RowCtx& rc,
                                             const float (&bias)[NB],
                                             const int* sr, int k0, int S) {
  const bool ragged = k0 + BK > S;
  float mx[2] = {TIM_NEG_INF, TIM_NEG_INF};
#pragma unroll
  for (int i = 0; i < BK / 2; i += 2) {
    const int r = (i >> 1) & 1;
    const int col = (i / 4) * 8 + 2 * rc.tig;
    float x0 = sc[i], x1 = sc[i + 1];
    if constexpr (BIAS) {
      x0 = fmaf(x0, rc.scale, bias[i]);
      x1 = fmaf(x1, rc.scale, bias[i + 1]);
      if (rc.masked) {
        const int2 rr = *reinterpret_cast<const int2*>(sr + k0 + col);
        x0 += rr.x != rc.region_row[r] ? kMaskValue : 0.f;
        x1 += rr.y != rc.region_row[r] ? kMaskValue : 0.f;
      }
    }
    if (ragged) {
      x0 = k0 + col < S ? x0 : TIM_NEG_INF;
      x1 = k0 + col + 1 < S ? x1 : TIM_NEG_INF;
    }
    sc[i] = x0;
    sc[i + 1] = x1;
    mx[r] = fmaxf(mx[r], fmaxf(x0, x1));
  }
  float mc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);    // finite: key k0 < S
    corr[r] = sm90::ex2((m[r] - m_new) * rc.c);
    m[r] = m_new;
    l[r] *= corr[r];
    mc[r] = m_new * rc.c;
  }
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const int r = (i >> 1) & 1;
    const float pe = sm90::ex2(fmaf(sc[i], rc.c, -mc[r]));   // -inf -> 0
    sc[i] = pe;
    l[r] += pe;
  }
}

// The probabilities as bf16 A fragments: k-step kk takes accumulator
// columns 16 kk .. 16 kk + 15 (fragment j: row (j % 2) * 8 + g, columns
// (j / 2) * 8 + 2 tig + {0, 1} of the step).
template <int BK>
__device__ __forceinline__ void pack_p(const float (&sc)[BK / 2],
                                       uint32_t (&pa)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = kk * 8 + (j / 2) * 4 + (j & 1) * 2;
      pa[kk][j] = pack_bf16(sc[i], sc[i + 1]);
    }
}

template <int NC, int NO>
__device__ __forceinline__ void rescale(float (&o)[NC][NO],
                                        const float (&corr)[2]) {
#pragma unroll
  for (int j = 0; j < NC; ++j)
#pragma unroll
    for (int i = 0; i < NO; ++i) o[j][i] *= corr[(i >> 1) & 1];
}

template <int DH>
__device__ __forceinline__ void rescale(TailAcc<DH>& o,
                                        const float (&corr)[2]) {
  if constexpr (Cols<DH>::kT32) {
#pragma unroll
    for (int i = 0; i < 16; ++i) o.a32[i] *= corr[(i >> 1) & 1];
  }
  if constexpr (Cols<DH>::kT16) {
#pragma unroll
    for (int i = 0; i < 8; ++i) o.a16[i] *= corr[(i >> 1) & 1];
  }
}

template <int DH>
__device__ __forceinline__ void fence_tail(TailAcc<DH>& o) {
  if constexpr (Cols<DH>::kT32) sm90::fence_regs(o.a32);
  if constexpr (Cols<DH>::kT16) sm90::fence_regs(o.a16);
}

// The TMA maps of the tail column blocks' boxes (Cols), K then V for the
// 32-column block, then for the 16-column one; one unused entry where
// there is no tail.
template <int DH>
struct TailMaps {
  CUtensorMap m[Cols<DH>::kNT > 0 ? 2 * Cols<DH>::kNT : 1];
};

// One block for 128 query rows of one (batch, head) (kernel 5) or 64 rows
// of a pair of windows (kernel 4). K and V tiles arrive by TMA (tm_k,
// tm_v: [batch, heads, seq, DH] maps of the strided views, boxes of kKeys
// rows); kernel 4 reads its bias into registers a tile ahead and keeps its
// windows' region ids in shared memory.
template <int DH, bool BIAS, bool LSE>
__global__ void __launch_bounds__(kThreads, (Shape<DH, BIAS>::kMinBlocks))
    attention_kernel(const Params p, const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ TailMaps<DH> tm_tail) {
  using Sh = Shape<DH, BIAS>;
  using Co = Cols<DH>;
  using bf = __nv_bfloat16;
  constexpr int BK = Sh::kKeys, NS = Sh::kStages, AHEAD = Sh::kAhead;
  constexpr int RB = Sh::kRowBytes, CH = RB / 16;
  constexpr bool PAIR = Sh::kPair;
  // column blocks: count, width, bytes of a Q and of a K/V block
  constexpr int NC = Sh::kNC, BW = Sh::kBW;
  constexpr int QB = kRows * BW * 2, KVB = BK * BW * 2;
  extern __shared__ unsigned char dyn_smem[];
  // 1024-byte aligned tiles (the swizzles repeat every 1024 or 512 bytes)
  const uint32_t raw = sm90::smem_u32(dyn_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = dyn_smem + (base - raw);
  const int S = p.seq;
  // the head dim read: past 64 up to DH, columns past it zero-filled
  const int dh = DH > 64 ? p.dh : DH;
  const int n_tiles = (S + BK - 1) / BK;
  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  // this warpgroup's ring: K stages, V stages, then after every ring's
  // tiles full[s] (the stage's K and V have landed) and empty[s] (every
  // thread of the ring is done with them)
  const int ring = PAIR ? wg : 0;
  const uint32_t s_q = base;
  const uint32_t s_k = s_q + Sh::kQBytes + ring * 2 * NS * Sh::kKVBytes;
  const uint32_t s_v = s_k + NS * Sh::kKVBytes;
  const uint32_t s_bar0 = s_q + Sh::kQBytes + Sh::kRings * 2 * NS *
                                                 Sh::kKVBytes;
  const uint32_t s_bar = s_bar0 + ring * 16 * NS;
  auto full = [&](int st) { return s_bar + 8 * st; };
  auto empty = [&](int st) { return s_bar + 8 * (NS + st); };
  int* s_region =
      reinterpret_cast<int*>(gbase + (s_bar0 + Sh::kRings * 16 * NS - base)) +
      ring * n_tiles * BK;

  // the block: head-major, then (kernel 5) batch and 128-row tiles, or
  // (kernel 4) window pair and 64-row tiles
  const int n_q = (S + Sh::kBlockRows - 1) / Sh::kBlockRows;
  const int n_b = PAIR ? (p.batch + 1) / 2 : p.batch;
  const long long bh = blockIdx.x / n_q;
  const int h = (int)(bh / n_b);
  const int q0 = (int)(blockIdx.x % n_q) * Sh::kBlockRows;
  const int b0 = PAIR ? 2 * (int)(bh % n_b) : (int)(bh % n_b);
  const int b = PAIR ? b0 + wg : b0;   // this warpgroup's batch entry
  const bool live = b < p.batch;    // an odd last window pair: idle
  const int* region = (BIAS && p.region != nullptr && live)
                          ? p.region + (long long)(b % p.n_win) * S
                          : nullptr;
  const int ring_threads = PAIR ? 128 : kThreads;
  const int ring_tid = PAIR ? tid % 128 : tid;

  if (tid == 0) {
    for (int st = 0; st < Sh::kRings * NS; ++st) {
      const uint32_t rg = s_bar0 + 16 * NS * (st / NS) + 8 * (st % NS);
      mbar_init(rg, 1);                   // full
      mbar_init(rg + 8 * NS, ring_threads);   // empty
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // Q: kernel 5's 128 rows from q0, or each window's 64 rows from q0
  for (int i = tid; i < kRows * CH; i += kThreads) {
    const int r = i / CH, c = i % CH;
    const int rb = PAIR ? b0 + r / 64 : b;
    const int row = q0 + (PAIR ? r % 64 : r);
    const bf* qr = static_cast<const bf*>(p.q) +
                   min(rb, p.batch - 1) * p.sq.b + h * p.sq.h +
                   min(row, S - 1) * p.sq.n;
    const bool in = c * 8 < dh;
    sm90::cp16(s_q + tile_at<DH, kRows>(r, c), qr + (in ? c * 8 : 0),
               row < S && rb < p.batch && in ? 16 : 0);
  }
  // the windows' region ids, and whether each holds more than one region
  // (most shifted windows hold one; their mask is 0 and is skipped)
  int mixed = 0;
  if (region != nullptr) {
    const int first = region[0];
    for (int i = ring_tid; i < S; i += ring_threads) {
      cp_async4(s_region + i, region + i, 4);
      mixed |= region[i] != first;
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  sm90::fence_async_smem();   // cp.async's writes, seen by wgmma
  // Q, the region ids and the initialised barriers; the mask flags
  const int mixed0 = __syncthreads_or(wg == 0 && mixed);
  const int mixed1 = __syncthreads_or(wg == 1 && mixed);
  if (!live) return;   // no block-wide barrier follows

  // K and V of key tile j into ring stage j % NS by one TMA each from the
  // ring's first thread, once every thread of the ring is done with the
  // tile NS before it; rows past S read as zeros.
  auto load = [&](int j) {
    if (ring_tid == 0) {
      const int st = j % NS;
      if (j >= NS) mbar_wait(empty(st), (j / NS - 1) & 1);
      mbar_expect_tx(full(st), 2 * Sh::kKVBytes);
#pragma unroll
      for (int cb = 0; cb < NC; ++cb) {
        tma_load_4d(s_k + st * Sh::kKVBytes + cb * KVB, &tm_k, cb * BW,
                    j * BK, h, b, full(st));
        tma_load_4d(s_v + st * Sh::kKVBytes + cb * KVB, &tm_v, cb * BW,
                    j * BK, h, b, full(st));
      }
      if constexpr (Co::kT32) {
        tma_load_4d(s_k + st * Sh::kKVBytes + BK * Co::kC32 * 2,
                    &tm_tail.m[0], Co::kC32, j * BK, h, b, full(st));
        tma_load_4d(s_v + st * Sh::kKVBytes + BK * Co::kC32 * 2,
                    &tm_tail.m[1], Co::kC32, j * BK, h, b, full(st));
      }
      if constexpr (Co::kT16) {
        constexpr int m16 = Co::kT32 ? 2 : 0;
        tma_load_4d(s_k + st * Sh::kKVBytes + BK * Co::kC16 * 2,
                    &tm_tail.m[m16], Co::kC16, j * BK, h, b, full(st));
        tma_load_4d(s_v + st * Sh::kKVBytes + BK * Co::kC16 * 2,
                    &tm_tail.m[m16 + 1], Co::kC16, j * BK, h, b, full(st));
      }
    }
    __syncwarp();   // the warp converges before its next wgmma
  };
#pragma unroll
  for (int j = 0; j < AHEAD; ++j)
    if (j < n_tiles) load(j);

  RowCtx rc;
  rc.scale = p.scale;
  rc.c = BIAS ? 1.4426950408889634f : p.scale * 1.4426950408889634f;
  rc.tig = lane % 4;
  // (one window a block: both warpgroups' flags are the window's)
  rc.masked = (PAIR ? (wg == 0 ? mixed0 : mixed1) : (mixed0 | mixed1)) != 0;
  rc.pairs = S % 2 == 0;
  // this thread's two rows of its batch entry: r = 0 -> row g, r = 1 ->
  // row g + 8 of its warp's 16
  const int row0 = q0 + (PAIR ? 0 : wg * 64) + warp * 16 + lane / 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = min(row0 + 8 * r, S - 1);
    rc.region_row[r] = region != nullptr ? region[row] : 0;
    rc.bias[r] = BIAS ? p.bias + ((long long)h * S + row) * S : nullptr;
  }

  float sc[BK / 2], o[NC][BW / 2];
  TailAcc<DH> ot;
  float bias[BIAS ? BK / 2 : 1];
  uint32_t pa[BK / 16][4];
  float m[2] = {TIM_NEG_INF, TIM_NEG_INF}, l[2] = {0.f, 0.f}, corr[2];
#pragma unroll
  for (int j = 0; j < NC; ++j)
#pragma unroll
    for (int i = 0; i < BW / 2; ++i) o[j][i] = 0.f;
  ot.zero();
  const uint64_t dq = desc<BW>(s_q + wg * 64 * BW * 2);
  auto dk = [&](int kt) { return desc<BW>(s_k + (kt % NS) * Sh::kKVBytes); };
  auto dv = [&](int kt) { return desc<BW>(s_v + (kt % NS) * Sh::kKVBytes); };
  auto arrived = [&](int kt) { mbar_wait(full(kt % NS), (kt / NS) & 1); };
  auto stage_k = [&](int kt) { return s_k + (kt % NS) * Sh::kKVBytes; };
  auto stage_v = [&](int kt) { return s_v + (kt % NS) * Sh::kKVBytes; };
  if constexpr (BIAS) load_bias<BK>(bias, rc, 0, S);

  // tile 0: its scores and probabilities (O is still zero)
  arrived(0);
  sm90::wg_fence();
  issue_s<DH, BK, QB, KVB>(sc, dq, dk(0));
  issue_s_tail<DH, BK>(sc, s_q, wg, stage_k(0));
  sm90::wg_commit();
  sm90::wg_wait<0>();
  sm90::fence_regs(sc);
  softmax_tile<BK, BIAS>(sc, m, l, corr, rc, bias, s_region, 0, S);
  if constexpr (BIAS) {
    if (n_tiles > 1) load_bias<BK>(bias, rc, BK, S);
  }
  pack_p<BK>(sc, pa);
  if (AHEAD < n_tiles) load(AHEAD);

  for (int kt = 1; kt < n_tiles; ++kt) {
    arrived(kt);
    sm90::wg_fence();
    issue_s<DH, BK, QB, KVB>(sc, dq, dk(kt));
    issue_s_tail<DH, BK>(sc, s_q, wg, stage_k(kt));
    sm90::wg_commit();
    issue_pv<DH, BK, NC>(o, pa, dv(kt - 1));
    issue_pv_tail<DH, BK>(ot, pa, stage_v(kt - 1));
    sm90::wg_commit();
    sm90::wg_wait<1>();   // S_kt done; the PV product still runs
    sm90::fence_regs(sc);
    softmax_tile<BK, BIAS>(sc, m, l, corr, rc, bias, s_region, kt * BK, S);
    if constexpr (BIAS) {
      if (kt + 1 < n_tiles) load_bias<BK>(bias, rc, (kt + 1) * BK, S);
    }
    sm90::wg_wait<0>();
#pragma unroll
    for (int j = 0; j < NC; ++j) sm90::fence_regs(o[j]);
    fence_tail(ot);
    sm90::fence_regs(pa);
    mbar_arrive(empty((kt - 1) % NS));   // done with tile kt - 1
    rescale(o, corr);
    rescale(ot, corr);
    pack_p<BK>(sc, pa);
    if (kt + AHEAD < n_tiles) load(kt + AHEAD);
  }
  sm90::wg_fence();
  issue_pv<DH, BK, NC>(o, pa, dv(n_tiles - 1));
  issue_pv_tail<DH, BK>(ot, pa, stage_v(n_tiles - 1));
  sm90::wg_commit();
  sm90::wg_wait<0>();
#pragma unroll
  for (int j = 0; j < NC; ++j) sm90::fence_regs(o[j]);
  fence_tail(ot);
  sm90::fence_regs(pa);

  bf* out = static_cast<bf*>(p.out) + b * p.so.b + h * p.so.h;
  // lse in natural-log units: kernel 5 keeps its max in unscaled scores
  const float m_scale = BIAS ? 1.f : p.scale;
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / l[r];
    const int row = row0 + 8 * r;
    if constexpr (LSE) {
      if (rc.tig == 0 && row < S)
        p.lse[((long long)b * p.heads + h) * S + row] =
            m[r] * m_scale + logf(l[r]);
    }
  }
  // a column pair of an accumulator's element i: past 64 only those
  // below the head dim read are stored
  auto store = [&](int c0, int i, float x0, float x1) {
    const int r = (i >> 1) & 1;
    const int row = row0 + 8 * r;
    const int col = c0 + (i / 4) * 8 + 2 * rc.tig;
    if (row < S && (DH <= 64 || col < dh))
      *reinterpret_cast<uint32_t*>(out + row * p.so.n + col) =
          pack_bf16(x0 * inv[r], x1 * inv[r]);
  };
#pragma unroll
  for (int j = 0; j < NC; ++j)
#pragma unroll
    for (int i = 0; i < BW / 2; i += 2) store(j * BW, i, o[j][i], o[j][i + 1]);
  if constexpr (Co::kT32) {
#pragma unroll
    for (int i = 0; i < 16; i += 2)
      store(Co::kC32, i, ot.a32[i], ot.a32[i + 1]);
  }
  if constexpr (Co::kT16) {
#pragma unroll
    for (int i = 0; i < 8; i += 2)
      store(Co::kC16, i, ot.a16[i], ot.a16[i + 1]);
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no link
// against libcuda), or null.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      ptr = nullptr;
    return reinterpret_cast<EncodeTiled>(ptr);
  }();
  return fn;
}

// The TMA map of a row-major [rows, cols] matrix of `type` (elem_bytes
// each, rows contiguous, 16-byte aligned, `pitch` elements apart), boxes
// of box_rows rows x 128 bytes in the 128-byte swizzle: the K-major GEMM
// operand tiles of kernels 2 and 3. Rows and columns past the end read as
// zeros. Returns a CUDA error code.
inline int row_major_map(CUtensorMap* map, CUtensorMapDataType type,
                         const void* base, long long rows, long long cols,
                         int elem_bytes, int box_rows, long long pitch = 0) {
  // pitch: the row stride in elements (0: cols), a multiple of 16 bytes
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  cuuint64_t strides[1] = {(cuuint64_t)((pitch > 0 ? pitch : cols) *
                                        elem_bytes)};
  cuuint32_t box[2] = {(cuuint32_t)(128 / elem_bytes), (cuuint32_t)box_rows};
  cuuint32_t step[2] = {1, 1};
  const CUresult r = encode(
      map, type, 2, const_cast<void*>(base), dims, strides, box, step,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The TMA map of a [batch, heads, seq, dh] bf16 view with element strides
// s (the last dim contiguous), boxes of `rows` rows x `cols` columns (64,
// 32 or 16: one column block, Cols) in the block's swizzle; rows past seq
// and columns past dh read as zeros (so a head dim below the kernel's
// instance is read in place). Returns a CUDA error code.
inline int kv_map(CUtensorMap* map, const void* base, const Strides& s,
                  int batch, int heads, int seq, int dh, int rows, int cols) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)seq, (cuuint64_t)heads,
                        (cuuint64_t)batch};
  // bytes; a dim of one element takes a stride that is never used
  long long st[3] = {s.n, s.h, s.b};
  cuuint64_t strides[3];
  long long extent = dh;
  for (int i = 0; i < 3; ++i) {
    strides[i] = (cuuint64_t)(dims[i + 1] > 1 ? st[i] : extent) * 2;
    extent = (long long)(strides[i] / 2) * (long long)dims[i + 1];
  }
  cuuint32_t box[4] = {(cuuint32_t)cols, (cuuint32_t)rows, 1, 1};
  cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
      dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                 : (cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                               : CU_TENSOR_MAP_SWIZZLE_32B),
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The maps of a [batch, heads, seq, dh] view's column blocks for DH's
// tiles (Cols): the main blocks' (one map, the box moved along) into
// `main`, the tails' into tail[t0], tail[t0 + step] (32, then 16 columns).
template <int DH>
int block_maps(CUtensorMap* main, CUtensorMap* tail, int step,
               const void* base, const Strides& s, int batch, int heads,
               int seq, int dh, int rows) {
  using C = Cols<DH>;
  int err = kv_map(main, base, s, batch, heads, seq, dh, rows, C::kBW);
  if (err == 0 && C::kT32)
    err = kv_map(tail, base, s, batch, heads, seq, dh, rows, 32);
  if (err == 0 && C::kT16)
    err = kv_map(tail + (C::kT32 ? step : 0), base, s, batch, heads, seq,
                 dh, rows, 16);
  return err;
}

// The dynamic shared memory each kernel instance was allowed, per device.
// Internal linkage: a static local of a template would be one symbol shared
// by every library that holds this kernel (another build of it, loaded
// beside this one, has its own function and needs its own attribute).
constexpr int kMaxDevices = 64;
namespace {
template <int DH, bool BIAS, bool LSE>
int smem_set[kMaxDevices] = {};
}  // namespace

template <int DH, bool BIAS, bool LSE>
int launch(const Params& p, cudaStream_t stream) {
  using Sh = Shape<DH, BIAS>;
  const int n_keys = (p.seq + Sh::kKeys - 1) / Sh::kKeys * Sh::kKeys;
  const int smem = Sh::kSmem + (BIAS ? 4 * Sh::kRings * n_keys : 0);
  const long long n_b = Sh::kPair ? (p.batch + 1) / 2 : p.batch;
  const long long blocks = n_b * p.heads *
                           ((p.seq + Sh::kBlockRows - 1) / Sh::kBlockRows);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  CUtensorMap tm_k, tm_v;
  TailMaps<DH> tm_tail;
  const int dh = DH > 64 ? p.dh : DH;
  int err = block_maps<DH>(&tm_k, &tm_tail.m[0], 2, p.k, p.sk, p.batch,
                           p.heads, p.seq, dh, Sh::kKeys);
  if (err == 0)
    err = block_maps<DH>(&tm_v, &tm_tail.m[1], 2, p.v, p.sv, p.batch,
                         p.heads, p.seq, dh, Sh::kKeys);
  if (err != 0) return err;
  auto kernel = attention_kernel<DH, BIAS, LSE>;
  // the shared-memory limit is raised once for each device, and again
  // only when a longer sequence needs more (kernel 4's bias rows)
  int device = 0;
  err = (int)cudaGetDevice(&device);
  if (err != 0) return err;
  if (device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  int& allowed = smem_set<DH, BIAS, LSE>[device];
  if (smem > allowed) {
    err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != 0) return err;
    allowed = smem;
  }
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(p, tm_k, tm_v,
                                                      tm_tail);
  return (int)cudaGetLastError();
}

}  // namespace fwd90

// Launch for head dim DH (each caller builds the one head dim its models
// use): bf16 on this file's wgmma kernel, fp32 on flash_attention.cuh's
// CUDA-core kernel, with the lse store compiled in only when lse is given;
// returns cudaGetLastError() after the launch (0 on success).
template <int DH, bool BIAS>
int launch_bf16(const Params& p, cudaStream_t stream) {
  if (p.batch <= 0 || p.heads <= 0 || p.seq <= 0) return 0;
  return p.lse != nullptr ? fwd90::launch<DH, BIAS, true>(p, stream)
                          : fwd90::launch<DH, BIAS, false>(p, stream);
}

template <int DH, bool BIAS>
int launch(const Params& p, int dh, bool bf16, cudaStream_t stream) {
  if (dh != DH) return (int)cudaErrorInvalidValue;
  if (bf16) return launch_bf16<DH, BIAS>(p, stream);
  if (p.batch <= 0 || p.heads <= 0 || p.seq <= 0) return 0;
  const bool lse = p.lse != nullptr;
  return lse ? launch_f32<DH, BIAS, true>(p, stream)
             : launch_f32<DH, BIAS, false>(p, stream);
}

}  // namespace tim_attn
