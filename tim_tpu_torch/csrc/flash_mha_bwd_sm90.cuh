// Multi-head flash attention, backward, bf16, for Hopper's warpgroup
// tensor-core products (wgmma, sm_90a): the bf16 route of flash_mha_bwd.cu,
// which replaces the backward of tim_tpu/ops/flash.py::flash_mha (the
// Pallas flash kernel's dkv and dq kernels).
//
// With s_ij = (q_i . k_j) * scale and the forward's row statistic lse_i:
//   p_ij = exp(s_ij - lse_i),  dp_ij = do_i . v_j,  D_i = do_i . o_i,
//   ds_ij = p_ij (dp_ij - D_i) * scale,
//   dv_j = sum_i p_ij do_i,  dk_j = sum_i ds_ij q_i,  dq_i = sum_j ds_ij k_j,
// p and ds rounded to bf16 before their products, every product summed in
// fp32 (the arithmetic of flash_attention_bwd.cuh, which kernel 4b keeps).
//
// What bounds it: 5 products of 2 S^2 dh per (batch, head), 201 GFLOP at
// ViT-L's [8, 16, 1568, 64], 0.20 ms at the card's bf16 peak, against
// 0.1 GB of operands: the tensor cores, reached only through wgmma.
//
// Design: one pass, 5 products a score (the first version recomputed the
// scores in a second pass for dq: 7). A block owns 128 keys, two
// warpgroups of 64 keeping their K and V rows in shared memory for the
// block's life, and walks the 64-row query tiles, whose q, do, lse and D
// stream through a three-stage cp.async ring. Per tile each warpgroup
// computes, with its keys as wgmma's M dimension:
//   S^T = K Q^T and dP^T = V dO^T   (both operands from shared memory),
//   P^T and dS^T in registers (exp2 on the fp32 accumulators),
//   dV += P^T dO and dK += dS^T Q    (A from registers, B transposed),
// and stages dS^T in shared memory, where the block's dQ partial dS K
// over its 128 keys is one more product (each warpgroup 32 of the 64
// dims). dq sums over the key blocks: each partial is added to a zeroed
// [B, H, S, 64] fp32 buffer with fp32 atomic adds (red.global.add.v2), and
// a postprocess rounds it into dq. The order of those additions changes
// from run to run, so dq may differ in its last bits between runs (as in
// FlashAttention-2/3 and SDPA's backward); dk and dv are summed in a fixed
// order and do not. The deterministic route (a null dq_accum, taken under
// torch.use_deterministic_algorithms) skips the dQ partials here and
// leaves dq to flash_attention_bwd.cuh's atomic-free dq pass.
//
// What the card showed (H100 80GB HBM3, 700 W; PERF.md): 0.88 ms at
// [8, 16, 1568, 64], 23% of the operations bound, behind SDPA's backward.
// Removing one part at a time: the dq atomic adds 0.20 ms, the softmax
// work 0.11, S/dP 0.09, dV/dK 0.08, the q/do loads 0.08; the two
// warpgroups run in step (two block barriers a tile), so the tensor cores
// idle during the softmax work and the adds. A producer warp feeding an
// mbarrier ring, with the warpgroups taking turns on the tensor cores
// (FlashAttention-3's ping-pong), measured 0.99-1.16 ms here, and 16-byte
// adds no better than 8-byte ones; both are left out.
//
// Shared-memory tiles are [rows][64] bf16 with 128-byte rows in the
// 128-byte swizzle that wgmma descriptors name (16-byte chunk c of row r
// at chunk c ^ (r % 8), tiles 1024-byte aligned). K and Q are read
// K-major for S^T; dO, Q (as B) and dS^T, K (for dQ) MN-major through the
// descriptors' transpose bits, so no tile is copied twice.
//
// Ragged S is not padded: rows past S load as zeros, and a score whose
// query or key lies past S is a probability of 0, so it adds nothing to
// any gradient; dk/dv rows past S are not stored, and dq rows past S are
// not added.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "flash_attention.cuh"
#include "wgmma.cuh"

namespace tim_attn {
namespace sm90 {

constexpr int kDH = 64;           // head dim (128-byte rows)
constexpr int kKeys = 128;        // keys per block (two warpgroups)
constexpr int kBQ = 64;           // query rows per tile
constexpr int kThreads = 256;     // two warpgroups
constexpr int kStages = 3;        // q/do tiles in the cp.async ring
constexpr int kTile = kBQ * kDH * 2;              // 8 KB bf16 tile
constexpr int kKeyTile = kKeys * kDH * 2;         // 16 KB
constexpr int kRowStats = 2 * kBQ * 4;            // lse, D of a tile
// K, V | kStages x (Q, dO) | dS^T | kStages x (lse, D), + alignment slack
constexpr int kSmemBytes = 2 * kKeyTile + 2 * kStages * kTile + kKeyTile +
                           kStages * kRowStats + 1024;

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* o;
  const __nv_bfloat16* dout;
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  Strides sq, sk, sv, so, sdo, sdq, sdk, sdv;
  const float* lse;    // [batch, heads, seq]
  float* delta;        // [batch, heads, seq], written by the preprocess
  float* dq_accum;     // [batch, heads, seq, dh] fp32, zeroed there
  int batch, heads, seq;
  float scale;
  // kernel 4b only (window_attention_bwd_sm90.cuh): bias [heads, seq, seq]
  // fp32, region ids [n_win, seq] int32 or null, dbias [heads, seq, seq]
  // fp32, and the per-group partials [groups, heads, seq, seq] fp32 (null
  // with one group) of `groups` window groups
  const float* bias;
  const int* region;
  int n_win;
  float* dbias;
  float* dbias_groups;
  int groups;
};

// Byte offset of 16-byte chunk c of row r in a swizzled [rows][64] tile.
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)(r * 128 + ((c ^ (r & 7)) << 4));
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// byte offset (unused by these single-atom-wide operands), stride byte
// offset 1024 (8 rows of 128 bytes).
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// rows [row0, row0 + n) of a [S, 64] bf16 operand (row stride ld) into a
// swizzled tile at dst, rows past S zero-filled; nthreads copy together.
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          long long ld, int row0, int n,
                                          int S, int tid, int nthreads) {
  for (int i = tid; i < n * 8; i += nthreads) {
    const int r = i >> 3, c = i & 7;
    const int row = min(row0 + r, S - 1);
    cp16(dst + swz(r, c), src + row * ld + c * 8, row0 + r < S ? 16 : 0);
  }
}

// D = do . o per row, and the row of dq_accum zeroed (when there is one):
// DH / 8 lanes per row, each reading 16 bytes of o and of do. Shared with
// kernel 4b (head dim 32).
template <int DH>
__global__ void __launch_bounds__(256) preprocess_kernel(const Params p) {
  constexpr int kLanes = DH / 8;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long i = t / kLanes;
  const int c = (int)(t % kLanes);
  const bool live = i < (long long)p.batch * p.heads * p.seq;
  const long long r = live ? i : 0;
  const int row = (int)(r % p.seq);
  const long long bh = r / p.seq;
  const int h = (int)(bh % p.heads), b = (int)(bh / p.heads);
  float x[8], y[8];
  tim::load_floats<__nv_bfloat16, 8>(
      p.o + b * p.so.b + h * p.so.h + row * p.so.n + c * 8, x);
  tim::load_floats<__nv_bfloat16, 8>(
      p.dout + b * p.sdo.b + h * p.sdo.h + row * p.sdo.n + c * 8, y);
  float acc = 0.f;
#pragma unroll
  for (int e = 0; e < 8; ++e) acc = fmaf(x[e], y[e], acc);
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (!live) return;
  if (c == 0) p.delta[i] = acc;
  if (p.dq_accum == nullptr) return;
  float4* z = reinterpret_cast<float4*>(p.dq_accum + i * DH + c * 8);
  z[0] = z[1] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// dq = bf16(dq_accum) into dq's strides; one thread per 8 dims of a row.
template <int DH>
__global__ void __launch_bounds__(256) postprocess_kernel(const Params p) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)p.batch * p.heads * p.seq * (DH / 8)) return;
  const int c = (int)(i % (DH / 8));
  const long long r = i / (DH / 8);
  const int row = (int)(r % p.seq);
  const long long bh = r / p.seq;
  const int h = (int)(bh % p.heads), b = (int)(bh / p.heads);
  const float4* src = reinterpret_cast<const float4*>(p.dq_accum + r * DH +
                                                      c * 8);
  const float4 x = src[0], y = src[1];
  uint4 out;
  out.x = pack_bf16(x.x, x.y);
  out.y = pack_bf16(x.z, x.w);
  out.z = pack_bf16(y.x, y.y);
  out.w = pack_bf16(y.z, y.w);
  *reinterpret_cast<uint4*>(p.dq + b * p.sdq.b + h * p.sdq.h +
                            row * p.sdq.n + c * 8) = out;
}

// The preprocess over every row (DH / 8 threads a row); returns the launch
// error.
template <int DH>
inline int launch_preprocess(const Params& p, cudaStream_t stream) {
  const long long threads = (long long)p.batch * p.heads * p.seq * (DH / 8);
  if ((threads + 255) / 256 > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  preprocess_kernel<DH><<<(unsigned)((threads + 255) / 256), 256, 0,
                          stream>>>(p);
  return (int)cudaGetLastError();
}

template <int DH>
inline int launch_postprocess(const Params& p, cudaStream_t stream) {
  const long long threads = (long long)p.batch * p.heads * p.seq * (DH / 8);
  postprocess_kernel<DH><<<(unsigned)((threads + 255) / 256), 256, 0,
                           stream>>>(p);
  return (int)cudaGetLastError();
}

// DQ: the dQ partials and their atomic adds; without them (the
// deterministic route) the kernel writes dk and dv only.
template <bool DQ>
__global__ void __launch_bounds__(kThreads, 1) bwd_kernel(const Params p) {
  extern __shared__ unsigned char dyn_smem[];
  // 1024-byte aligned tiles (the swizzle repeats every 8 rows of 128 B)
  const uint32_t raw = smem_u32(dyn_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = dyn_smem + (base - raw);
  const uint32_t s_k = base, s_v = base + kKeyTile;
  const uint32_t s_ring = base + 2 * kKeyTile;  // stage s: q at + 2s tiles,
  const uint32_t s_ds = s_ring + 2 * kStages * kTile;   // do at + 2s + 1
  const uint32_t s_stat0 = s_ds + kKeyTile;
  unsigned char* g_ds = gbase + (s_ds - base);
  auto s_q = [&](int st) { return s_ring + 2 * st * kTile; };

  const int S = p.seq;
  const int n_kb = (S + kKeys - 1) / kKeys;
  const long long bh = blockIdx.x / n_kb;
  const int h = (int)(bh % p.heads), b = (int)(bh / p.heads);
  const int k0 = (int)(blockIdx.x % n_kb) * kKeys;
  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;
  const int n_qt = (S + kBQ - 1) / kBQ;
  const __nv_bfloat16* q = p.q + b * p.sq.b + h * p.sq.h;
  const __nv_bfloat16* dout = p.dout + b * p.sdo.b + h * p.sdo.h;
  const float* lse = p.lse + bh * S;
  const float* delta = p.delta + bh * S;
  constexpr float kLog2e = 1.4426950408889634f;
  const float scale_log2 = p.scale * kLog2e;

  // q, do, lse and D of query tile `tile` into ring stage st; rows past S
  // load as zeros (masked below)
  auto load_q = [&](int tile, int st) {
    load_tile(s_q(st), q, p.sq.n, tile * kBQ, kBQ, S, tid, kThreads);
    load_tile(s_q(st) + kTile, dout, p.sdo.n, tile * kBQ, kBQ, S, tid,
              kThreads);
    if (tid < 2 * kBQ) {
      const int row = tile * kBQ + tid % kBQ;
      cp_async4(gbase + (s_stat0 - base) + st * kRowStats + tid * 4,
                (tid < kBQ ? lse : delta) + min(row, S - 1),
                row < S ? 4 : 0);
    }
  };
  load_tile(s_k, p.k + b * p.sk.b + h * p.sk.h, p.sk.n, k0, kKeys, S, tid,
            kThreads);
  load_tile(s_v, p.v + b * p.sv.b + h * p.sv.h, p.sv.n, k0, kKeys, S, tid,
            kThreads);
  load_q(0, 0);
  cp_async_commit();
#pragma unroll
  for (int t = 1; t < kStages - 1; ++t) {
    if (t < n_qt) load_q(t, t);
    cp_async_commit();   // one group per tile, possibly empty
  }

  // this warpgroup's 64 keys: A operands of S^T and dP^T
  const uint32_t s_kw = s_k + wg * 64 * 128, s_vw = s_v + wg * 64 * 128;
  // this thread's accumulator rows (keys) within the block's 128
  const int key_r[2] = {wg * 64 + warp * 16 + g, wg * 64 + warp * 16 + g + 8};
  bool key_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) key_ok[r] = k0 + key_r[r] < S;

  float sc[32], dp[32], dv[32], dk[32], dq[16];
  uint32_t pa[4][4], da[4][4];
#pragma unroll
  for (int i = 0; i < 32; ++i) dv[i] = dk[i] = 0.f;

  for (int jt = 0; jt < n_qt; ++jt) {
    const int st = jt % kStages, q0 = jt * kBQ;
    cp_async_wait<kStages - 2>();   // this tile's rows have landed
    fence_async_smem();             // cp.async's writes, seen by wgmma
    // every thread is done with the previous tile (its products waited
    // for), so its stage and the dS^T tile may be written again
    __syncthreads();
    if (jt + kStages - 1 < n_qt)
      load_q(jt + kStages - 1, (jt + kStages - 1) % kStages);
    cp_async_commit();
    const uint32_t sq = s_q(st), sdo = sq + kTile;

    // S^T = K Q^T, dP^T = V dO^T (K-major B: 16 dims = 32 bytes)
    wg_fence();
    wgmma_64x64_ss<0, 0, false>(sc, desc(s_kw), desc(sq));
#pragma unroll
    for (int ks = 1; ks < 4; ++ks)
      wgmma_64x64_ss<0, 0, true>(sc, desc(s_kw) + 2 * ks, desc(sq) + 2 * ks);
    wgmma_64x64_ss<0, 0, false>(dp, desc(s_vw), desc(sdo));
#pragma unroll
    for (int ks = 1; ks < 4; ++ks)
      wgmma_64x64_ss<0, 0, true>(dp, desc(s_vw) + 2 * ks,
                                 desc(sdo) + 2 * ks);
    wg_commit();
    wg_wait<0>();
    fence_regs(sc);
    fence_regs(dp);

    // P^T and dS^T * scale in place of the accumulators; element i of a
    // 64 x 64 accumulator is row (i / 2) % 2 * 8 + g of the warp's 16,
    // column (i / 4) * 8 + 2 tig + i % 2. Scores past S (query or key)
    // are masked only in the tiles that have any.
    const float* stat = reinterpret_cast<const float*>(
        gbase + (s_stat0 - base) + st * kRowStats);
    const bool full = q0 + kBQ <= S && k0 + kKeys <= S;
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int col = (i / 4) * 8 + 2 * tig;
      const float2 l2 = *reinterpret_cast<const float2*>(stat + col);
      const float2 d2 = *reinterpret_cast<const float2*>(stat + kBQ + col);
      const float lv[2] = {l2.x * kLog2e, l2.y * kLog2e};
      const float dl[2] = {d2.x, d2.y};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float pe = ex2(sc[i + e] * scale_log2 - lv[e]);
        if (!full && !(q0 + col + e < S && key_ok[(i / 2) & 1])) pe = 0.f;
        sc[i + e] = pe;
        dp[i + e] = pe * (dp[i + e] - dl[e]) * p.scale;
      }
    }
    // bf16 A fragments: k-step kk takes accumulator columns 16kk..16kk+15
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = kk * 8 + (j / 2) * 4 + (j & 1) * 2;
        pa[kk][j] = pack_bf16(sc[i], sc[i + 1]);
        da[kk][j] = pack_bf16(dp[i], dp[i + 1]);
      }
    }
    // dV += P^T dO, dK += dS^T Q: B is [queries][dims], dims contiguous
    // (MN-major); 16 queries = 2048 bytes
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_64x64_rs<1>(dv, pa[kk], desc(sdo + kk * 2048));
      wgmma_64x64_rs<1>(dk, da[kk], desc(sq + kk * 2048));
    }
    wg_commit();

    // dS^T (keys x queries, bf16) into shared memory for the dQ product:
    // fragment j of k-step kk holds row (j % 2) * 8 + g, columns
    // 16 kk + (j / 2) * 8 + 2 tig + {0, 1}
    // (without DQ the tile ends once dV and dK are done)
    if constexpr (!DQ) {
      wg_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
      fence_regs(pa);
      fence_regs(da);
      continue;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = kk * 16 + (j / 2) * 8 + 2 * tig;
        *reinterpret_cast<uint32_t*>(g_ds + swz(key_r[j & 1], col / 8) +
                                     (col % 8) * 2) = da[kk][j];
      }
    fence_async_smem();
    __syncthreads();

    // dQ partial (64 queries x this warpgroup's 32 dims) = dS K over the
    // block's 128 keys: A = dS^T tile read transposed, B = K rows read
    // transposed from dim 32 * wg (64 bytes into each 128-byte row)
    wg_fence();
    wgmma_64x32_ss<1, 1, false>(dq, desc(s_ds), desc(s_k + wg * 64));
#pragma unroll
    for (int kk = 1; kk < 8; ++kk)
      wgmma_64x32_ss<1, 1, true>(dq, desc(s_ds + kk * 2048),
                                 desc(s_k + kk * 2048 + wg * 64));
    wg_commit();
    wg_wait<0>();
    // every product of the tile is done; the A fragments of dV/dK were
    // kept live until here
    fence_regs(dq);
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(pa);
    fence_regs(da);

    // the partial into dq_accum: fp32 atomic adds of column pairs
    float* dqa = p.dq_accum + (bh * S + q0) * kDH;
#pragma unroll
    for (int i = 0; i < 16; i += 2) {
      const int row = warp * 16 + g + 8 * ((i / 2) & 1);
      const int col = wg * 32 + (i / 4) * 8 + 2 * tig;
      if (q0 + row < S)
        asm volatile("red.global.add.v2.f32 [%0], {%1, %2};\n" ::"l"(
                         dqa + row * kDH + col), "f"(dq[i]), "f"(dq[i + 1])
                     : "memory");
    }
  }

  // dk, dv rows of this thread's keys
  __nv_bfloat16* dkp = p.dk + b * p.sdk.b + h * p.sdk.h;
  __nv_bfloat16* dvp = p.dv + b * p.sdv.b + h * p.sdv.h;
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int r = (i / 2) & 1;
    if (!key_ok[r]) continue;
    const int key = k0 + key_r[r];
    const int col = (i / 4) * 8 + 2 * tig;
    *reinterpret_cast<uint32_t*>(dkp + key * p.sdk.n + col) =
        pack_bf16(dk[i], dk[i + 1]);
    *reinterpret_cast<uint32_t*>(dvp + key * p.sdv.n + col) =
        pack_bf16(dv[i], dv[i + 1]);
  }
}

// Preprocess, main pass, postprocess on one stream; returns the first
// CUDA error of the launches (0 on success). With a null dq_accum (the
// deterministic route) only the preprocess (D) and the main pass without
// dQ run: dk and dv are written, dq is left to the caller's dq pass.
inline int launch(const Params& p, cudaStream_t stream) {
  const long long rows = (long long)p.batch * p.heads * p.seq;
  const long long blocks =
      (long long)p.batch * p.heads * ((p.seq + kKeys - 1) / kKeys);
  if ((rows * (kDH / 8) + 255) / 256 > 0x7fffffffLL || blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  int err = launch_preprocess<kDH>(p, stream);
  if (err != 0) return err;
  auto kernel = p.dq_accum != nullptr ? bwd_kernel<true> : bwd_kernel<false>;
  err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != 0) return err;
  kernel<<<(unsigned)blocks, kThreads, kSmemBytes, stream>>>(p);
  err = (int)cudaGetLastError();
  if (err != 0 || p.dq_accum == nullptr) return err;
  return launch_postprocess<kDH>(p, stream);
}

}  // namespace sm90
}  // namespace tim_attn
