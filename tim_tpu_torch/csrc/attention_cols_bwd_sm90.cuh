// Exact softmax attention, backward, bf16, at head dims past 256 on
// Hopper's warpgroup tensor-core products (wgmma, sm_90a): kernel 5b's
// column-slice route (flash_mha_bwd_cols.cu). The function and the
// two-pass, column-slice design are attention_cols_bwd.cuh's (which keeps
// the fp32 passes and the D preprocess); here the products run on wgmma,
// as PR 22's passes at head dims 80-128 (flash_mha_bwd_wide_sm90.cuh) do,
// with no operand resident, so any head dim fits. A block owns 128 rows
// (two warpgroups of 64) and one slice of output columns:
//
//   dk/dv pass: 128 keys, a slice of 128 columns (dk and dv: 128 sums a
//     thread); it walks 64-query tiles. Per tile, each 64-column chunk of
//     the head dim brings K and V's 128 rows and Q and dO's 64 through a
//     TMA ring (one stage, one transaction), and each warpgroup adds the
//     chunk to S^T = K Q^T and dP^T = V dO^T (both operands from shared
//     memory); then the tile's slices of Q and dO land, P^T and dS^T (each
//     query's lse and D read through L1) become bf16 A fragments, and dV
//     += P^T dO[:, slice], dK += dS^T Q[:, slice] (B read transposed).
//   dq pass: 128 queries, a slice of 256 columns (dq alone: 128 sums a
//     thread); it walks 64-key tiles: S = Q K^T and dP = dO V^T over the
//     chunks, then dQ += dS K[:, slice].
// With n128 and n256 slices, (2 n128 + 2) + (2 n256 + 1) products' worth
// instead of 5 (15 at head dim 512). Nothing is summed across blocks: the
// same bits every run, the deterministic route being this one. A chunk's
// product group is issued before the last chunk's is waited for, as a
// GEMM's main loop does, with a wgmma.fence before each. (A dk/dv pass of
// 64 keys whose warpgroups split S^T and dP^T, handing P^T over in shared
// memory, took 256-column slices, 11 products' worth at 512; on the card
// it was slower at head dims 320 and 512, faster only at 1024: PERF.md.)
// Rows past S read as
// zeros and score probabilities of 0 where they are the summed index;
// columns past dh read as zeros and are not stored.

#pragma once

#include "attention_cols_bwd.cuh"
#include "flash_attention_sm90.cuh"

namespace tim_attn {
namespace colsbwd90 {

using bf = __nv_bfloat16;
using fwd90::mbar_arrive;
using fwd90::mbar_expect_tx;
using fwd90::mbar_init;
using fwd90::mbar_wait;
using fwd90::tma_load_4d;

constexpr int kThreads = 256;        // two warpgroups
constexpr int kRows = 128;           // a block's rows (keys or queries)
constexpr int kTile = 64;            // a walked tile's rows
constexpr int kBlock = 64;           // columns a box (128-byte swizzle)
constexpr int kStages = 4;
constexpr int kAhead = kStages - 2;
constexpr int kABox = kRows * kBlock * 2;    // 16 KB
constexpr int kBox = kTile * kBlock * 2;     // 8 KB
// a chunk's item (the largest: a slice's at most 4 boxes, 32 KB)
constexpr int kStageBytes = 2 * kABox + 2 * kBox;
constexpr int kSmem = kStages * kStageBytes + 16 * kStages + 1024;

// The output columns a block of each pass sums: dk and dv (two sums a
// thread) 128, dq 256.
template <bool DKDV>
constexpr int kSlice = DKDV ? 128 : 256;

struct Params {
  const bf* q;
  const bf* k;
  const bf* v;
  const bf* dout;
  bf* dq;
  bf* dk;
  bf* dv;
  Strides sdq, sdk, sdv;
  const float* lse;     // [batch, heads, seq]
  const float* delta;   // [batch, heads, seq]
  int batch, heads, seq, dh;
  float scale;
};

// This warpgroup's 64 rows x NB 64-column blocks of sums as bf16 into rows
// row0 + .. of dst (row stride ld), columns c0 + .., those below S and dh.
template <int NB>
__device__ __forceinline__ void store_rows(bf* dst, long long ld,
                                           const float (&o)[NB][32], int row0,
                                           int S, int c0, int dh, int tig) {
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int row = row0 + 8 * ((i >> 1) & 1);
      const int col = c0 + j * kBlock + (i / 4) * 8 + 2 * tig;
      if (row < S && col < dh)
        *reinterpret_cast<uint32_t*>(dst + row * ld + col) =
            pack_bf16(o[j][i], o[j][i + 1]);
    }
}

// DKDV: the dk/dv pass (rows: keys; A1, A2 = K, V; walked B1, B2 = Q,
// dO); else the dq pass (rows: queries; A1, A2 = Q, dO; B1, B2 = K, V).
// The slice products' B operands are the walked tile's B boxes at the
// slice's columns: Q and dO, or K.
template <bool DKDV>
__global__ void __launch_bounds__(kThreads, 1)
    bwd_kernel(const Params p, const __grid_constant__ CUtensorMap tm_a1,
               const __grid_constant__ CUtensorMap tm_a2,
               const __grid_constant__ CUtensorMap tm_b1,
               const __grid_constant__ CUtensorMap tm_b2) {
  constexpr int NS = kStages, R = kRows, AB = kABox;
  constexpr int SW = kSlice<DKDV>, NB = SW / kBlock;
  extern __shared__ unsigned char dyn_smem[];
  const uint32_t raw = sm90::smem_u32(dyn_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t s_bar = base + NS * kStageBytes;
  auto stage = [&](int i) { return base + (i % NS) * kStageBytes; };
  auto full = [&](int i) { return s_bar + 8 * (i % NS); };
  auto empty = [&](int i) { return s_bar + 8 * (NS + i % NS); };

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;
  const int S = p.seq;
  const int n_r = (S + R - 1) / R;
  const int bh = blockIdx.x / n_r;
  const int h = bh / p.batch, b = bh % p.batch;   // head-major
  const int r0 = (blockIdx.x % n_r) * R;
  const int c0 = blockIdx.y * SW;
  const int nc = (p.dh + kBlock - 1) / kBlock;
  const int nsb = min(SW, p.dh - c0 + kBlock - 1) / kBlock;   // boxes
  const int per_t = nc + 1;   // items a walked tile
  const int n_t = (S + kTile - 1) / kTile;
  const int total = n_t * per_t;
  const long long bhs = ((long long)b * p.heads + h) * S;

  if (tid == 0) {
    for (int i = 0; i < NS; ++i) {
      mbar_init(full(i), 1);
      mbar_init(empty(i), kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // item i of walked tile t: chunk c < nc (A1, A2 rows r0..; B1, B2 rows
  // t * kTile..), then (c == nc) the slice's boxes at columns c0..: dq K's,
  // dk/dv Q's and dO's
  auto load = [&](int i) {
    if (i >= NS) mbar_wait(empty(i), (i / NS - 1) & 1);
    const uint32_t st = stage(i);
    const int t = i / per_t, c = i % per_t;
    if (c < nc) {
      mbar_expect_tx(full(i), 2 * AB + 2 * kBox);
      tma_load_4d(st, &tm_a1, c * kBlock, r0, h, b, full(i));
      tma_load_4d(st + AB, &tm_a2, c * kBlock, r0, h, b, full(i));
      tma_load_4d(st + 2 * AB, &tm_b1, c * kBlock, t * kTile, h, b,
                  full(i));
      tma_load_4d(st + 2 * AB + kBox, &tm_b2, c * kBlock, t * kTile, h, b,
                  full(i));
    } else {
      mbar_expect_tx(full(i), (DKDV ? 2 : 1) * nsb * kBox);
      for (int j = 0; j < nsb; ++j) {
        tma_load_4d(st + j * kBox, &tm_b1, c0 + j * kBlock, t * kTile, h,
                    b, full(i));
        if (DKDV)
          tma_load_4d(st + (NB + j) * kBox, &tm_b2, c0 + j * kBlock,
                      t * kTile, h, b, full(i));
      }
    }
  };
  int issued = 0, it = 0;
  // item j (it or it + 1) once landed, loads topped up to kAhead past it
  // (a load waits for the item NS before it: j + kAhead - NS < it)
  auto acquire = [&](int j) {
    if (tid == 0)
      while (issued < min(total, j + kAhead + 1)) load(issued++);
    __syncwarp();
    mbar_wait(full(j), (j / NS) & 1);
    return stage(j);
  };
  auto release = [&]() { mbar_arrive(empty(it)); ++it; };

  const int lrow = wg * 64 + warp * 16 + g;   // rows lrow, lrow + 8
  float lse_r[2] = {0.f, 0.f}, delta_r[2] = {0.f, 0.f};
  if constexpr (!DKDV) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = min(r0 + lrow + 8 * r, S - 1);
      lse_r[r] = p.lse[bhs + row];
      delta_r[r] = p.delta[bhs + row];
    }
  }
  float o1[NB][32], o2[DKDV ? NB : 1][32];   // dv, dk | dq
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) o1[j][i] = 0.f;
#pragma unroll
  for (int j = 0; j < (DKDV ? NB : 1); ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) o2[j][i] = 0.f;

  float x1[32], x2[32];
  uint32_t pa1[4][4], pa2[4][4];
  // a chunk's two products for this warpgroup's 64 rows: S (or S^T) and
  // dP (or dP^T)
  auto issue_chunk = [&](uint32_t st) {
    const uint64_t da1 = fwd90::desc<64>(st + wg * 64 * kBlock * 2);
    const uint64_t da2 = fwd90::desc<64>(st + AB + wg * 64 * kBlock * 2);
    const uint64_t db1 = fwd90::desc<64>(st + 2 * AB);
    const uint64_t db2 = fwd90::desc<64>(st + 2 * AB + kBox);
#pragma unroll
    for (int kk = 0; kk < kBlock / 16; ++kk)
      sm90::wgmma_ss<0, 0, true>(x1, da1 + 2 * kk, db1 + 2 * kk);
#pragma unroll
    for (int kk = 0; kk < kBlock / 16; ++kk)
      sm90::wgmma_ss<0, 0, true>(x2, da2 + 2 * kk, db2 + 2 * kk);
  };
  auto fence_x = [&]() {
    sm90::fence_regs(x1);
    sm90::fence_regs(x2);
  };
  for (int t = 0; t < n_t; ++t) {
#pragma unroll
    for (int i = 0; i < 32; ++i) x1[i] = x2[i] = 0.f;
    {
      const uint32_t st0 = acquire(it);
      sm90::wg_fence();
      issue_chunk(st0);
      sm90::wg_commit();
      for (int c = 1; c < nc; ++c) {
        const uint32_t st = acquire(it + 1);
        sm90::wg_fence();   // as a GEMM main loop: before every group
        issue_chunk(st);
        sm90::wg_commit();
        sm90::wg_wait<1>();
        release();
      }
      sm90::wg_wait<0>();
      fence_x();
      release();
    }
    // P (or P^T) in x1, dS * scale in x2: element i at row (i / 2) % 2 * 8
    // + g of the warp's 16, column (i / 4) * 8 + 2 tig + i % 2 of the tile
    const int t0 = t * kTile;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = t0 + (i / 4) * 8 + 2 * tig + (i & 1);
      float lse, delta;
      if constexpr (DKDV) {
        lse = __ldg(p.lse + bhs + min(col, S - 1));
        delta = __ldg(p.delta + bhs + min(col, S - 1));
      } else {
        lse = lse_r[(i >> 1) & 1];
        delta = delta_r[(i >> 1) & 1];
      }
      const float pe = col < S ? __expf(x1[i] * p.scale - lse) : 0.f;
      x2[i] = pe * (x2[i] - delta) * p.scale;
      x1[i] = pe;
    }
    if constexpr (DKDV) fwd90::pack_p<kTile>(x1, pa1);
    fwd90::pack_p<kTile>(x2, pa2);
    const uint32_t st = acquire(it);
    sm90::wg_fence();
    if constexpr (DKDV) {
      // dV += P^T dO[:, slice], dK += dS^T Q[:, slice]
      fwd90::issue_pv<SW, kTile, NB>(o1, pa1,
                                     fwd90::desc<64>(st + NB * kBox));
      fwd90::issue_pv<SW, kTile, NB>(o2, pa2, fwd90::desc<64>(st));
    } else {
      fwd90::issue_pv<SW, kTile, NB>(o1, pa2, fwd90::desc<64>(st));
    }
    sm90::wg_commit();
    sm90::wg_wait<0>();
#pragma unroll
    for (int j = 0; j < NB; ++j) sm90::fence_regs(o1[j]);
    if constexpr (DKDV) {
#pragma unroll
      for (int j = 0; j < NB; ++j) sm90::fence_regs(o2[j]);
      sm90::fence_regs(pa1);
    }
    sm90::fence_regs(pa2);
    release();
  }

  const int row0 = r0 + lrow;
  if constexpr (DKDV) {
    store_rows(p.dv + b * p.sdv.b + h * p.sdv.h, p.sdv.n, o1, row0, S, c0,
               p.dh, tig);
    store_rows(p.dk + b * p.sdk.b + h * p.sdk.h, p.sdk.n, o2, row0, S, c0,
               p.dh, tig);
  } else {
    store_rows(p.dq + b * p.sdq.b + h * p.sdq.h, p.sdq.n, o1, row0, S, c0,
               p.dh, tig);
  }
}

namespace {
template <bool DKDV>
int smem_set[fwd90::kMaxDevices] = {};
}  // namespace

template <bool DKDV>
int launch_pass(const Params& p, const Strides* st, cudaStream_t stream) {
  // st: the strides of q, k, v, do
  const bf* a1 = DKDV ? p.k : p.q;
  const bf* a2 = DKDV ? p.v : p.dout;
  const bf* b1 = DKDV ? p.q : p.k;
  const bf* b2 = DKDV ? p.dout : p.v;
  const Strides& sa1 = DKDV ? st[1] : st[0];
  const Strides& sa2 = DKDV ? st[2] : st[3];
  const Strides& sb1 = DKDV ? st[0] : st[1];
  const Strides& sb2 = DKDV ? st[3] : st[2];
  CUtensorMap m_a1, m_a2, m_b1, m_b2;
  int err = fwd90::kv_map(&m_a1, a1, sa1, p.batch, p.heads, p.seq, p.dh,
                          kRows, kBlock);
  if (err == 0)
    err = fwd90::kv_map(&m_a2, a2, sa2, p.batch, p.heads, p.seq, p.dh,
                        kRows, kBlock);
  if (err == 0)
    err = fwd90::kv_map(&m_b1, b1, sb1, p.batch, p.heads, p.seq, p.dh,
                        kTile, kBlock);
  if (err == 0)
    err = fwd90::kv_map(&m_b2, b2, sb2, p.batch, p.heads, p.seq, p.dh,
                        kTile, kBlock);
  if (err != 0) return err;
  auto kernel = bwd_kernel<DKDV>;
  int device = 0;
  err = (int)cudaGetDevice(&device);
  if (err != 0) return err;
  if (device >= fwd90::kMaxDevices) return (int)cudaErrorInvalidDevice;
  int& allowed = smem_set<DKDV>[device];
  if (allowed < kSmem) {
    err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != 0) return err;
    allowed = kSmem;
  }
  const long long blocks =
      (long long)p.batch * p.heads * ((p.seq + kRows - 1) / kRows);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)blocks,
                  (p.dh + kSlice<DKDV> - 1) / kSlice<DKDV>);
  kernel<<<grid, kThreads, kSmem, stream>>>(p, m_a1, m_a2, m_b1, m_b2);
  return (int)cudaGetLastError();
}

}  // namespace colsbwd90

// The bf16 column-slice backward: D (attention_cols_bwd.cuh), then the
// dk/dv and the dq wgmma passes, on one stream; returns the first launch's
// CUDA error (0 on success).
inline int launch_bwd_cols_bf16(const BwdParams& bp, int dh,
                                cudaStream_t stream) {
  namespace cb = colsbwd;
  const long long rows = (long long)bp.batch * bp.heads * bp.seq;
  if (bp.batch <= 0 || bp.heads <= 0 || bp.seq <= 0 || dh <= 0) return 0;
  if ((rows + 255) / 256 > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  cb::delta_kernel<cb::bf><<<(unsigned)((rows + 255) / 256), 256, 0,
                             stream>>>(bp, dh);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  using colsbwd90::bf;
  colsbwd90::Params p{};
  p.q = static_cast<const bf*>(bp.q); p.k = static_cast<const bf*>(bp.k);
  p.v = static_cast<const bf*>(bp.v);
  p.dout = static_cast<const bf*>(bp.dout);
  p.dq = static_cast<bf*>(bp.dq); p.dk = static_cast<bf*>(bp.dk);
  p.dv = static_cast<bf*>(bp.dv);
  p.sdq = bp.sdq; p.sdk = bp.sdk; p.sdv = bp.sdv;
  p.lse = bp.lse; p.delta = bp.delta;
  p.batch = bp.batch; p.heads = bp.heads; p.seq = bp.seq; p.dh = dh;
  p.scale = bp.scale;
  const Strides st[4] = {bp.sq, bp.sk, bp.sv, bp.sdo};
  err = colsbwd90::launch_pass<true>(p, st, stream);
  if (err != 0) return err;
  return colsbwd90::launch_pass<false>(p, st, stream);
}

}  // namespace tim_attn
