// Fused static-scale int8 matmul for Hopper (sm_90a): kernel 3, built by
// int8_matmul_fused.cu (the C entry; instances without the GELU) and
// int8_matmul_fused_gelu.cu (with it).
//
// Replaces: tim_tpu/ops/pallas_int8.py::int8_matmul_fused (kernel body
// _kernel, pl.pallas_call at :97). For every output row and column:
//   xq  = clip(round_half_even(x * inv_sx), -127, 127)        int8
//   acc = xq . w_q^T                                           int32, exact
//   y   = f32(acc) * (sx * w_scale[n]) [+ bias[n]] [-> exact fp32 GELU]
// cast to the output type. x is fp32 or bf16, the output fp32 or bf16. As
// in the TPU kernel, the quantized activations and the int32 sums never
// reach device memory.
//
// What bounds it on the H100: at the detection class head fc_action
// (M = 128 windows x 399 queries = 51,072 rows, K 1024, N 3806, bf16 in and
// out) the product is 398 G int8 operations, 0.20 ms at the 1,979 TOPS
// dense int8 peak, against 0.50 GB of bytes (x 105 MB, out 389 MB, w 3.9
// MB), 0.15 ms at 3.35 TB/s: operations bound it, barely. fc_audio (N 44)
// is bound by reading x: about 0.03 ms.
//
// Design: one persistent block an SM, 384 threads: a producer warpgroup
// and two consumer warpgroups.
// - Each block keeps an M tile of 128 quantized rows (K padded with zeros
//   to 1024: 128 KB) resident in shared memory, K-major in the 128-byte
//   swizzle that the products' descriptors name, and walks the N tiles
//   against it: every activation row is read from device memory and
//   quantized once a block that takes it (x is read ~1.3 times in all,
//   not once per N tile). The consumers fill it with 16-byte loads, a warp
//   a row, through the (batch, row) strides: the heads hand over a
//   399-row window of each [898, 1024] sequence, which no TMA box can
//   follow into the next window, and every value passes through registers
//   to be quantized anyway. M tiles run across window boundaries: a tile
//   inside each window would waste up to 22% of its rows (399 = 3 x 128 +
//   15).
// - Weight tiles ([BN rows, 128 bytes of K]; BN 112, or 48 for N <= 48:
//   fc_audio) stream through a ring of 64 KB filled by TMA from L2 (w_q is
//   3.9 MB), full and empty mbarriers a stage, one producer thread.
// - The products are wgmma m64nBNk32 s8 x s8 -> s32, both operands from
//   shared memory: a consumer warpgroup takes a whole output tile (128
//   rows: two m64 products a k32 step, 112 s32 accumulators a thread),
//   waits for each stage's products only after issuing the next stage's
//   (the ring stage then goes back to the producer), and the two
//   warpgroups take turns on tiles (named barriers): one issues its
//   products while the other dequantizes and stores its last tile. BN 112
//   (3806 = 34 x 112 - 2) leaves the epilogue registers that 128
//   accumulators take (of the 168 a thread that 384 threads allow), and
//   the GELU is an instance's constant: instances with it, compiled in
//   int8_matmul_fused_gelu.cu, and without (the serving heads').
// - The epilogue (store_tile) stages 8 rows of int32 sums at a time in a
//   2 KB slab a warp and stores each row with one instruction, a lane a
//   column pair (4 or 8 bytes; an output row, 7612 bytes of bf16, is not
//   16-byte aligned): contiguous along the row, where the quads of the
//   accumulator layout write 16 bytes of each of 8 rows. The tile's
//   columns' sx * w_scale and bias are read while the products run and
//   kept in shared memory: read in the epilogue, each column group waited
//   for its own round trip.
// - Work: the (M tile, N tile) items, M tile major, are cut into one
//   contiguous range a block. At fc_action that is 399 x 34 = 13,566
//   items, 102 or 103 a block on 132 SMs (99.9% of the last wave used;
//   whole M tiles a block would be 399 / 132 = 3.02 waves, 4 at 75%), for
//   one more partial M tile a block to quantize (~4 fills a block, 531 in
//   all against 399). fc_audio is 399 one-item M tiles, 3 or 4 a block.
// - K up to 1024 takes 128-row M tiles; K up to 2048 the same design at 64
//   rows (one m64 product a k32 step), so the tile stays 128 KB. Longer
//   rows run in chunks of 2048 through the tile, one launch a chunk, the
//   int32 sums meeting in an [M, N] scratch (the PART instances; the last
//   chunk's epilogue adds them): the int8 sums are exact, so the chunks
//   add to what one pass would. K pads to the tile with zeros (rows
//   quantized as zeros past K, weight boxes past K filled with zeros by
//   TMA), so every k32 step adds only what it should; w's rows are padded
//   to a multiple of 16 bytes once where the layer is built (TMA's row
//   pitch), and x's rows, where K or their strides leave them unaligned,
//   are read one value at a time. Ragged M and N are masked at the
//   stores.
// Where the time goes: `python -m tim_tpu_torch.ablate --kernel 3` and
// PERF.md. Tried on the card and slower, so not kept: the epilogue
// straight from the accumulator layout (quads on 8 rows; with the scales
// read per column group or from shared memory), 128-wide N tiles, the
// GELU compiled into every instance (inline or out of line: registers
// taken from the serving call), cache hints on the stores,
// and TMA stores of 8-row boxes of the output viewed as [M / 8, 8 N]
// (rows permuted at quantize time so that a warp's rows were one box,
// each box shifted to a 16-byte boundary, its 8 edge columns in one
// store a round).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "common.cuh"
#include "flash_attention_sm90.cuh"

namespace tim_i8 {

namespace sm90 = tim_attn::sm90;
using tim_attn::fwd90::desc;
using tim_attn::fwd90::mbar_expect_tx;
using tim_attn::fwd90::mbar_init;
using tim_attn::fwd90::mbar_wait;
using tim_attn::fwd90::tma_load_2d;

constexpr int kThreads = 384;          // producer warpgroup + two consumers
constexpr int kTileBytes = 128 * 1024;  // the resident quantized M tile
constexpr int kRingBytes = 64 * 1024;   // the weight ring
constexpr int kKBlock = 128;            // bytes of K a swizzled row holds
constexpr int kSlabBytes = 8 * 256;     // a staging slab: 8 rows
constexpr int kScaleFloats = 256;       // a warpgroup's tile scales, biases

struct Args {
  const void* x;
  const float* w_scale;   // [N]
  const float* bias;      // [N] or null
  void* out;              // [M, N] row-major
  long long stride_b, stride_r;  // x element strides of (batch, row)
  int rows;               // rows per batch; M = batches * rows
  int m, k, n;
  float inv_sx, sx;
  int x_bf16, out_bf16;
  // x's rows read 16 bytes at a time (K a multiple of the values a load
  // holds, strides and start aligned); else one value at a time
  int vec;
  // K past the resident tile (the PART instances): the int32 sums of one
  // chunk of K at a time meet in partial [M, N]: part 1 writes them, 2
  // adds to them, 3 adds them to this chunk's and runs the epilogue
  int* partial;
  int part;
};

// BN: the N tile (112, or 48 for narrow heads); MR: m64 row groups an M
// tile (2 for K <= 1024, 1 for K <= 2048).
template <int BN, int MR>
struct Shape {
  static constexpr int kRows = 64 * MR;
  static constexpr int kK = kTileBytes / kRows;        // K padded: 1024 / 2048
  static constexpr int kBlocks = kK / kKBlock;         // k-blocks a tile: 8 / 16
  static constexpr int kStageBytes = BN * kKBlock;     // 14 KB / 6 KB
  static constexpr int kStages = kRingBytes / kStageBytes;   // 4 / 10
  static constexpr int kRing = kStages * kStageBytes;
  // tile | ring | 8 warps' staging slabs | 2 warpgroups' scales | full,
  // empty barriers, + alignment slack
  static constexpr int kSmem = kTileBytes + kRing + 8 * kSlabBytes +
                               2 * kScaleFloats * 4 + 16 * kStages + 1024;
};

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
// The two signals given while a warpgroup's products are in flight, each
// predicated inside its instruction: a branch between products and their
// wait makes ptxas serialise them (C7520).
// bar.arrive id, count where pred (the same in every thread of the warp)
__device__ __forceinline__ void bar_arrive_if(int pred, int id, int count) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.s32 p, %0, 0;\n@p bar.arrive %1, %2;\n}\n"
      ::"r"(pred), "r"(id), "r"(count)
      : "memory");
}
// one arrival on the mbarrier bar for the warp, from its lane 0
__device__ __forceinline__ void warp_arrive(uint32_t bar, int lane) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.eq.s32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(bar),
      "r"(lane)
      : "memory");
}

// The TPU kernel's quantization of one value: cvt.rni saturates out of
// range values, then the clip to +-127.
__device__ __forceinline__ uint32_t quant(float v, float inv) {
  const int q = max(-127, min(127, __float2int_rn(__fmul_rn(v, inv))));
  return (uint32_t)(uint8_t)(int8_t)q;
}

// Quantize M tile rows [m0, m0 + kRows) into s_tile: k-block kb of row r at
// kb * kRows * 128 + r * 128, its 16-byte chunk c at (c ^ (r % 8)) * 16 (the
// 128-byte swizzle). A warp takes a row at a time (RPI rows an iteration,
// so that each lane has 16 16-byte loads in flight: the accumulators are
// dead here); rows past M and columns past K are written as zeros.
template <typename T, int BN, int MR>
__device__ __forceinline__ void fill_tile(unsigned char* s_tile,
                                          const Args& a, int m0, int ctid) {
  using Sh = Shape<BN, MR>;
  constexpr int V = 16 / (int)sizeof(T);        // values a 16-byte load
  constexpr int CPL = Sh::kK / V / 32;          // loads a lane a row
  constexpr int RPI = CPL >= 16 ? 1 : 16 / CPL;   // rows a warp an iteration
  const int warp = ctid / 32, lane = ctid % 32;
  const T* x = static_cast<const T*>(a.x);
  for (int r0 = warp * RPI; r0 < Sh::kRows; r0 += 8 * RPI) {
    uint4 v[RPI][CPL];
#pragma unroll
    for (int rr = 0; rr < RPI; ++rr) {
      const int gm = m0 + r0 + rr;
      const T* p = x;
      if (gm < a.m) {
        const int b = gm / a.rows;
        p = x + b * a.stride_b + (long long)(gm - b * a.rows) * a.stride_r;
      }
#pragma unroll
      for (int q = 0; q < CPL; ++q) {
        const int k = (lane + 32 * q) * V;
        v[rr][q] = make_uint4(0u, 0u, 0u, 0u);
        if (gm < a.m && k < a.k) {
          if (a.vec) {
            v[rr][q] = *reinterpret_cast<const uint4*>(p + k);
          } else {   // unaligned rows or K's ragged end: zeros past K
            T* e = reinterpret_cast<T*>(&v[rr][q]);
#pragma unroll
            for (int i = 0; i < V; ++i)
              if (k + i < a.k) e[i] = p[k + i];
          }
        }
      }
    }
#pragma unroll
    for (int rr = 0; rr < RPI; ++rr) {
      const int r = r0 + rr;
#pragma unroll
      for (int q = 0; q < CPL; ++q) {
        const int k = (lane + 32 * q) * V;
        const T* e = reinterpret_cast<const T*>(&v[rr][q]);
        uint32_t w[V / 4];
#pragma unroll
        for (int i = 0; i < V / 4; ++i)
          w[i] = quant(tim::to_f(e[4 * i]), a.inv_sx) |
                 quant(tim::to_f(e[4 * i + 1]), a.inv_sx) << 8 |
                 quant(tim::to_f(e[4 * i + 2]), a.inv_sx) << 16 |
                 quant(tim::to_f(e[4 * i + 3]), a.inv_sx) << 24;
        const int kb = k / kKBlock, c = (k % kKBlock) / 16;
        unsigned char* dst = s_tile + kb * Sh::kRows * kKBlock + r * kKBlock +
                             ((c ^ (r & 7)) << 4) + k % 16;
        if constexpr (V == 8)
          *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
        else
          *reinterpret_cast<uint32_t*>(dst) = w[0];
      }
    }
  }
}

// One output tile's products: kBlocks ring stages from it0 on, each
// 4 k32 steps x MR m64 products; a stage's group is waited for after the
// next stage's products are issued, and its ring slot then released (one
// arrival a warp). Returns with the last group in flight: the caller
// waits for it (finish_tile).
template <int BN, int MR>
__device__ __forceinline__ void issue_tile(int (&acc)[MR][BN / 2],
                                           uint32_t s_tile, uint32_t s_ring,
                                           uint32_t s_bar, int it0,
                                           int lane) {
  using Sh = Shape<BN, MR>;
  constexpr int S = Sh::kStages;
#pragma unroll
  for (int kb = 0; kb < Sh::kBlocks; ++kb) {
    const int it = it0 + kb, st = it % S;
    mbar_wait(s_bar + 8 * st, (it / S) & 1);
    sm90::wg_fence();   // after the wait's branch, or ptxas adds its own
    const uint64_t db = desc<64>(s_ring + st * Sh::kStageBytes);
#pragma unroll
    for (int kk = 0; kk < kKBlock / 32; ++kk)
#pragma unroll
      for (int g = 0; g < MR; ++g) {
        const uint64_t da =
            desc<64>(s_tile + kb * Sh::kRows * kKBlock + g * 64 * kKBlock) +
            2 * kk;
        if (kb == 0 && kk == 0)
          sm90::wgmma_s8(acc[g], da, db, sm90::Acc<false>{});
        else
          sm90::wgmma_s8(acc[g], da, db + 2 * kk, sm90::Acc<true>{});
      }
    sm90::wg_commit();
    if (kb > 0) {
      sm90::wg_wait<1>();
      warp_arrive(s_bar + 8 * (S + (it - 1) % S), lane);
    }
  }
}

template <int BN, int MR>
__device__ __forceinline__ void finish_tile(int (&acc)[MR][BN / 2],
                                            uint32_t s_bar, int it_last,
                                            int lane) {
  constexpr int S = Shape<BN, MR>::kStages;
  sm90::wg_wait<0>();
#pragma unroll
  for (int g = 0; g < MR; ++g) sm90::fence_regs(acc[g]);
  warp_arrive(s_bar + 8 * (S + it_last % S), lane);
}

// y0, y1 into out[0], out[1] (out[1] only where two): one 4- or 8-byte
// store where pairs (an even N: the pair is aligned to its size)
template <typename O>
__device__ __forceinline__ void store_pair(O* p, float y0, float y1,
                                           bool pairs, bool two) {
  if (pairs) {
    if constexpr (sizeof(O) == 2)
      *reinterpret_cast<uint32_t*>(p) = tim_attn::pack_bf16(y0, y1);
    else
      *reinterpret_cast<float2*>(p) = make_float2(y0, y1);
  } else {
    p[0] = tim::from_f<O>(y0);
    if (two) p[1] = tim::from_f<O>(y1);
  }
}

// Byte offset of 4-byte columns (c, c + 1), c even, of row q in a staging
// slab: 256-byte rows, 16-byte chunks swizzled by the row, so that the
// eight rows' writes of one column group, and a row's reads, spread over
// the banks.
__device__ __forceinline__ int slab_at(int q, int c) {
  return q * 256 + (((c >> 2) ^ q) << 4) + (c & 2) * 4;
}

// The epilogue runs in rounds: round R = (s, g, r) takes the warp's 8 rows
// g * 64 + 16 warp + 8 r + (0..7) of the tile and its columns s * SW ..
// s * SW + SW - 1. Accumulator element i of m64 group g is row g * 64 +
// 16 warp + (i / 2) % 2 * 8 + lane / 4, column (i / 4) * 8 + 2 (lane % 4) +
// i % 2.
template <int BN, int MR>
struct Rounds {
  static constexpr int kSW = BN > 64 ? BN / 2 : BN;   // columns a round
  static constexpr int kPerSlab = MR * 2;               // rounds a slab
  static constexpr int kCount = BN / kSW * kPerSlab;
};

// Round R's int32 sums into the warp's staging slab.
template <int BN, int MR, int R>
__device__ __forceinline__ void write_round(const int (&acc)[MR][BN / 2],
                                            unsigned char* slab, int lane) {
  using Ro = Rounds<BN, MR>;
  constexpr int s = R / Ro::kPerSlab, g = R % Ro::kPerSlab / 2, r = R % 2;
  const int q = lane / 4, t = lane % 4;
#pragma unroll
  for (int jj = 0; jj < Ro::kSW / 8; ++jj) {
    constexpr int kJ0 = s * (Ro::kSW / 8);
    const int i = (kJ0 + jj) * 4 + r * 2;
    *reinterpret_cast<int2*>(slab + slab_at(q, jj * 8 + 2 * t)) =
        make_int2(acc[g][i], acc[g][i + 1]);
  }
}

// write_round of a round known only at run time: the epilogue's loop over
// rounds stays a loop, so its store pass (and the GELU's erff) is compiled
// once, not once a round.
template <int BN, int MR, int R = 0>
__device__ __forceinline__ void write_round_at(int round,
                                               const int (&acc)[MR][BN / 2],
                                               unsigned char* slab,
                                               int lane) {
  if (round == R) {
    write_round<BN, MR, R>(acc, slab, lane);
  } else if constexpr (R + 1 < Rounds<BN, MR>::kCount) {
    write_round_at<BN, MR, R + 1>(round, acc, slab, lane);
  }
}

__device__ __forceinline__ float gelu_erf(float y) {
  return __fmul_rn(__fmul_rn(0.5f, y),
                   __fadd_rn(1.f, erff(__fmul_rn(y, 0.70710678118654752f))));
}

// The TPU kernel's epilogue of one sum, each step rounded (no fused
// multiply-add): f32(acc) * (sx * w_scale) [+ bias] [-> the fp32 erf GELU].
// GELU is an instance's constant: compiled in where not called, the GELU
// cost the serving call (no GELU) registers and ~15% of its time.
template <bool GELU>
__device__ __forceinline__ float epilogue_value(int acc, float ws, float b,
                                                const Args& a) {
  float y = __fmul_rn(__int2float_rn(acc), ws);
  if (a.bias) y = __fadd_rn(y, b);
  if constexpr (GELU) y = gelu_erf(y);
  return y;
}

// The epilogue of one output tile at (m0, n0) from a consumer warpgroup's
// accumulators, in rounds: the warp stages a round's int32 sums, then each
// lane takes one column pair of the round's 8 rows (its two columns' sx *
// w_scale and bias, from shared memory, in registers), dequantizes, and
// stores each row's pairs with one instruction, contiguous along the row:
// 112 bytes of bf16 or 224 of fp32, whole 32-byte sectors but at the
// edges, where the quads of the accumulator layout would write 16 bytes of
// each of 8 rows and leave every sector half written. The rows' work is
// independent, so one warp a scheduler keeps several in flight.
template <int BN, int MR, bool GELU, bool PART>
__device__ __forceinline__ void store_tile(const int (&acc)[MR][BN / 2],
                                           const Args& a, int m0, int n0,
                                           int wtid, unsigned char* slab,
                                           const float* s_scale) {
  using Ro = Rounds<BN, MR>;
  const int warp = wtid / 32, lane = wtid % 32;
  const bool pairs = (a.n & 1) == 0;   // a column pair is 2-element aligned
  const int lc = 2 * lane;             // the slab column pair this lane stores
#pragma unroll 1
  for (int round = 0; round < Ro::kCount; ++round) {
    write_round_at<BN, MR>(round, acc, slab, lane);
    __syncwarp();
    const int s = round / Ro::kPerSlab, g = round % Ro::kPerSlab / 2;
    const int c = s * Ro::kSW + lc, col = n0 + c;
    const int row0 = m0 + g * 64 + warp * 16 + round % 2 * 8;
    if (lc < Ro::kSW && col < a.n) {
      const float2 ws = *reinterpret_cast<const float2*>(s_scale + c);
      const float2 bs = *reinterpret_cast<const float2*>(s_scale + 128 + c);
      const bool two = col + 1 < a.n;
#pragma unroll 4
      for (int q = 0; q < 8; ++q) {
        if (row0 + q >= a.m) break;
        int2 v = *reinterpret_cast<const int2*>(slab + slab_at(q, lc));
        const long long at = (long long)(row0 + q) * a.n + col;
        if constexpr (PART) {   // K in chunks: the sums meet in partial
          int* pp = a.partial + at;
          if (a.part >= 2) {
            v.x += pp[0];
            if (two) v.y += pp[1];
          }
          if (a.part < 3) {
            pp[0] = v.x;
            if (two) pp[1] = v.y;
            continue;
          }
        }
        const float y0 = epilogue_value<GELU>(v.x, ws.x, bs.x, a);
        const float y1 = epilogue_value<GELU>(v.y, ws.y, bs.y, a);
        if (a.out_bf16)
          store_pair(static_cast<__nv_bfloat16*>(a.out) + at, y0, y1, pairs,
                     two);
        else
          store_pair(static_cast<float*>(a.out) + at, y0, y1, pairs, two);
      }
    }
    __syncwarp();
  }
}

template <int BN, int MR, bool GELU, bool PART>
__global__ void __launch_bounds__(kThreads, 1)
    int8_matmul_kernel(const __grid_constant__ CUtensorMap tm_w,
                       const Args a) {
  using Sh = Shape<BN, MR>;
  constexpr int S = Sh::kStages, KB = Sh::kBlocks;
  extern __shared__ unsigned char dyn_smem[];
  const uint32_t raw = sm90::smem_u32(dyn_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* g_tile = dyn_smem + (base - raw);
  const uint32_t s_tile = base, s_ring = base + kTileBytes;
  unsigned char* g_slabs = g_tile + kTileBytes + Sh::kRing;
  float* g_scales = reinterpret_cast<float*>(g_slabs + 8 * kSlabBytes);
  const uint32_t s_bar = s_ring + Sh::kRing + 8 * kSlabBytes +
                         2 * kScaleFloats * 4;   // full[S], empty[S]

  const int n_tiles = (a.n + BN - 1) / BN;
  const long long items = (long long)((a.m + Sh::kRows - 1) / Sh::kRows) *
                          n_tiles;
  const int u0 = (int)(items * blockIdx.x / gridDim.x);
  const int u1 = (int)(items * (blockIdx.x + 1) / gridDim.x);
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int st = 0; st < S; ++st) {
      mbar_init(s_bar + 8 * st, 1);
      mbar_init(s_bar + 8 * (S + st), 4);   // a warp of the consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // the producer: one thread keeps the ring full, stage kb of item u in
    // ring step (u - u0) * KB + kb
    if (tid == 0) {
      int it = 0;
      for (int u = u0; u < u1; ++u) {
        const int n0 = u % n_tiles * BN;
        for (int kb = 0; kb < KB; ++kb, ++it) {
          const int st = it % S;
          if (it >= S) mbar_wait(s_bar + 8 * (S + st), (it / S - 1) & 1);
          mbar_expect_tx(s_bar + 8 * st, Sh::kStageBytes);
          tma_load_2d(s_ring + st * Sh::kStageBytes, &tm_w, kb * kKBlock, n0,
                      s_bar + 8 * st);
        }
      }
    }
    __syncwarp();
    return;
  }

  // the consumers: for each M tile of the block's range, both warpgroups
  // quantize it into the resident tile (named barrier 1), then take turns
  // on its items, item j to warpgroup j % 2; warpgroup w waits on barrier
  // 2 + w for its turn, which the other grants once it has issued its
  // products
  const int ctid = tid - 128, wg = ctid / 128, wtid = ctid % 128;
  const int lane = tid % 32;
  unsigned char* slab = g_slabs + ctid / 32 * kSlabBytes;
  float* s_scale = g_scales + wg * kScaleFloats;   // sx * w_scale | bias
  int acc[MR][BN / 2];
  for (int seg = u0; seg < u1;) {
    const int mt = seg / n_tiles;
    const int seg_end = min(u1, (mt + 1) * n_tiles);
    const int m0 = mt * Sh::kRows;
    bar_sync(1, 256);   // the products reading the last tile are done
    if (a.x_bf16)
      fill_tile<__nv_bfloat16, BN, MR>(g_tile, a, m0, ctid);
    else
      fill_tile<float, BN, MR>(g_tile, a, m0, ctid);
    sm90::fence_async_smem();   // st.shared, made visible to wgmma
    bar_sync(1, 256);
    for (int j = wg; seg + j < seg_end; j += 2) {
      const int u = seg + j, n0 = u % n_tiles * BN;
      const int it0 = (u - u0) * KB;
      if (j > 0) bar_sync(2 + wg, 256);   // also: the last epilogue is done
      // this tile's scale and bias, a column a thread, read while the
      // products run
      float ws = 0.f, bs = 0.f;
      if (wtid < BN && n0 + wtid < a.n) {
        ws = __fmul_rn(a.sx, __ldg(a.w_scale + n0 + wtid));
        if (a.bias) bs = __ldg(a.bias + n0 + wtid);
      }
      issue_tile<BN, MR>(acc, s_tile, s_ring, s_bar, it0, lane);
      bar_arrive_if(u + 1 < seg_end, 3 - wg, 256);
      finish_tile<BN, MR>(acc, s_bar, it0 + KB - 1, lane);
      if (wtid < BN) {
        s_scale[wtid] = ws;
        s_scale[128 + wtid] = bs;
      }
      bar_sync(4 + wg, 128);
      store_tile<BN, MR, GELU, PART>(acc, a, m0, n0, wtid, slab, s_scale);
    }
    seg = seg_end;
  }
}

// The dynamic shared memory attribute, set once a device and instance.
// Internal linkage: a static local of a template would be one symbol shared
// by every library that holds this kernel (ablate.py loads several builds).
constexpr int kMaxDevices = 64;
namespace {
template <int BN, int MR, bool GELU, bool PART>
int smem_set[kMaxDevices] = {};
}  // namespace

// w: [N, kw] int8 rows (kw >= a.k a multiple of 16, zeros past a.k), of
// which the first a.k columns are read
template <int BN, int MR, bool GELU, bool PART>
int launch(const Args& a, const void* w, int kw, cudaStream_t stream) {
  using Sh = Shape<BN, MR>;
  CUtensorMap tm_w;
  int err = tim_attn::fwd90::row_major_map(
      &tm_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, a.n, a.k, 1, BN, kw);
  if (err != 0) return err;
  auto kernel = int8_matmul_kernel<BN, MR, GELU, PART>;
  int device = 0;
  err = (int)cudaGetDevice(&device);
  if (err != 0) return err;
  if (device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!smem_set<BN, MR, GELU, PART>[device]) {
    err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::kSmem);
    if (err != 0) return err;
    smem_set<BN, MR, GELU, PART>[device] = 1;
  }
  int sms = 0;
  err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device);
  if (err != 0) return err;
  const long long items = (long long)((a.m + Sh::kRows - 1) / Sh::kRows) *
                          ((a.n + BN - 1) / BN);
  if (items > INT_MAX) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)(items < sms ? items : sms);
  kernel<<<blocks, kThreads, Sh::kSmem, stream>>>(tm_w, a);
  return (int)cudaGetLastError();
}

// K a launch takes at most: the resident tile's 64-row width
constexpr int kMaxChunk = 2048;

// The instance for a's shape: BN 48 for N <= 48, else 112; 128-row M
// tiles for K <= 1024, else 64. K past 2048 runs in chunks of 2048
// through the same tile, one launch each (x and w offset to the chunk),
// the int32 sums meeting in a.partial: the PART instances (64 rows),
// whose last launch adds the earlier chunks' sums before the epilogue.
template <bool GELU>
int launch_any(const Args& a, const void* w, int kw, cudaStream_t stream) {
  if (a.k <= kMaxChunk) {
    if (a.n <= 48)
      return a.k <= 1024 ? launch<48, 2, GELU, false>(a, w, kw, stream)
                         : launch<48, 1, GELU, false>(a, w, kw, stream);
    return a.k <= 1024 ? launch<112, 2, GELU, false>(a, w, kw, stream)
                       : launch<112, 1, GELU, false>(a, w, kw, stream);
  }
  if (a.partial == nullptr) return (int)cudaErrorInvalidValue;
  const int chunks = (a.k + kMaxChunk - 1) / kMaxChunk;
  const int elem = a.x_bf16 ? 2 : 4;
  for (int c = 0; c < chunks; ++c) {
    Args ac = a;
    ac.x = static_cast<const char*>(a.x) + (long long)c * kMaxChunk * elem;
    ac.k = min(kMaxChunk, a.k - c * kMaxChunk);
    ac.part = c == 0 ? 1 : (c + 1 < chunks ? 2 : 3);
    const void* wc = static_cast<const char*>(w) + (long long)c * kMaxChunk;
    const int err = a.n <= 48
                        ? launch<48, 1, GELU, true>(ac, wc, kw, stream)
                        : launch<112, 1, GELU, true>(ac, wc, kw, stream);
    if (err != 0) return err;
  }
  return 0;
}

// The GELU instances, compiled in int8_matmul_fused_gelu.cu beside the
// others (int8_matmul_fused.cu), so that the two build in parallel.
int launch_gelu(const Args& a, const void* w, int kw, cudaStream_t stream);

}  // namespace tim_i8

