// Multi-head flash attention, backward, bf16, at head dims 129-256 on
// Hopper's warpgroup tensor-core products (wgmma, sm_90a): kernel 5b's
// route there (flash_mha_bwd_256.cu; instances 192 and 256), which replaces
// the backward of tim_tpu/ops/flash.py::flash_mha (the Pallas flash
// kernel's dkv and dq kernels, tiles set at flash.py:71-79) at the widths
// a ViT takes at finetune_cli --num_heads 4 (ViT-L: head dim 256) or
// --embed_dim 1152 / 1200 --num_heads 6 (192, 200).
//
// The function is flash_mha_bwd_wide_sm90.cuh's: with s_ij = (q_i . k_j)
// * scale and the forward's row statistic lse_i,
//   p_ij = exp(s_ij - lse_i),  dp_ij = do_i . v_j,  D_i = do_i . o_i,
//   ds_ij = p_ij (dp_ij - D_i) * scale,
//   dv_j = sum_i p_ij do_i,  dk_j = sum_i ds_ij q_i,  dq_i = sum_j ds_ij k_j,
// p and ds rounded to bf16 before their products, every product summed in
// fp32, each gradient rounded once to bf16.
//
// What bounds it on the H100: the tensor cores. At [8, 4, 1568, 256] the
// five products are 2 S^2 dh flops each per (batch, head), 201 GFLOP,
// 0.20 ms at 989 TFLOP/s, against 0.2 GB of operands.
//
// Why a design of its own: past head dim 128 a warpgroup cannot hold both
// dk and dv of its 64 keys over the head dim (256 fp32 a thread at 256),
// which is how the passes at 80-128 work; the column-slice passes past 256
// (attention_cols_bwd_sm90.cuh) would run 256 as two 128-column dk/dv
// slices, each forming S^T and dP^T again (9 products' worth). Here the
// two warpgroups of a block split the products of one tile instead of its
// rows, so each score product is formed once and each warpgroup keeps one
// full-width sum:
//
//   dk/dv pass: a block owns 64 keys (K and V resident in shared memory)
//     and walks 64-query tiles of Q and dO, with their queries' lse and D,
//     through a TMA ring (two stages at 256, three at 192). Warpgroup 0
//     forms S^T = K Q^T, turns it into P^T, hands P^T (fp32) to warpgroup
//     1 through shared memory and runs dV += P^T dO; warpgroup 1 forms
//     dP^T = V dO^T, takes P^T, forms dS^T and runs dK += dS^T Q. dk or dv
//     of 64 keys x 256 columns: 128 sums a thread.
//   dq pass: a block owns 64 queries (Q and dO resident) and walks 64-key
//     tiles of K and V. Warpgroup 0 forms S = Q K^T and P, hands P to
//     warpgroup 1, which forms dP = dO V^T and dS and hands dS (as bf16 A
//     fragments) back; each then runs dQ += dS K over its half of the
//     column blocks.
//
// That is 4 + 3 = 7 products' worth, against 5 for one pass and 9 for the
// column slices. Nothing is summed across blocks: no atomics, so every
// gradient is the same bits every run (the deterministic route is this
// route). The hand-overs go through mbarriers (arrival counts of one
// warpgroup), so one warpgroup's products overlap the other's softmax
// work up to a tile apart. The dq pass does not read what the dk/dv pass
// writes, so it is launched as its programmatic dependent: its blocks
// start on the SMs the dk/dv pass's last wave leaves idle, and each waits
// for the dk/dv pass only before it exits (so the stream's next work sees
// dk and dv). Tiles are [64][NC x 64] bf16 as NC column blocks of 64 in
// the 128-byte swizzle (flash_attention_sm90.cuh's Cols): instance 192 has
// 3, 256 has 4. The TMA maps span the true head dim dh and fill the
// columns past it with zeros, so every multiple of 8 above the instance's
// 64 below is read in place; columns past dh are not stored.
// Ragged S is not padded: rows past S load as zeros, scores of queries
// (dk/dv pass) or keys (dq pass) past S are probabilities of 0, and rows
// past S are not stored.

#pragma once

#include "attention_cols_bwd_sm90.cuh"
#include "flash_mha_bwd_wide_sm90.cuh"

namespace tim_attn {
namespace split90 {

using bf = __nv_bfloat16;
using fwd90::desc;
using fwd90::mbar_arrive;
using fwd90::mbar_expect_tx;
using fwd90::mbar_init;
using fwd90::mbar_wait;
using fwd90::tma_load_4d;

constexpr int kThreads = 256;        // two warpgroups
constexpr int kRows = 64;            // a block's rows: keys or queries
constexpr int kTile = 64;            // a walked tile's rows
constexpr int kBlock = 64;           // columns a box (128-byte swizzle)
constexpr int kBox = kRows * kBlock * 2;     // 8 KB
constexpr int kStat = 2 * kTile * 4;         // a tile's lse and D
constexpr int kMaxSmem = 232448;             // a block's dynamic limit
constexpr float kLog2e = 1.4426950408889634f;

template <int NC, bool DQ>
struct Shape {
  static constexpr int kTileBytes = NC * kBox;    // a [64][NC x 64] tile
  static constexpr int kXP = 32 * 4 * 128;        // P, fp32: 16 KB
  static constexpr int kXD = DQ ? 16 * 4 * 128 : 0;   // dS fragments: 8 KB
  // a stage: B0, B1 and (dk/dv pass) the walked queries' lse and D, in
  // 1024-byte units (the swizzled tiles' alignment)
  static constexpr int kStageBytes =
      2 * kTileBytes + (DQ ? 0 : (kStat + 1023) / 1024 * 1024);
  // resident A0, A1 | stages | P | dS | barriers, + alignment: as many
  // stages as fit, up to three (three at 192, two at 256)
  static constexpr int kFixed = 2 * kTileBytes + kXP + kXD + 8 * 9 + 1024;
  static constexpr int kStages =
      kFixed + 3 * kStageBytes <= kMaxSmem ? 3 : 2;
  static constexpr int kSmem = kFixed + kStages * kStageBytes;
  // the output column blocks a warpgroup sums: dv or dk all NC; dq half
  static constexpr int kOut = DQ ? (NC + 1) / 2 : NC;
};

struct Params {
  bf* dq;
  bf* dk;
  bf* dv;
  Strides sdq, sdk, sdv;
  // [2][batch * heads][seq_pad]: lse, then D, rows padded to a multiple
  // of 4 (16 bytes, for their TMA boxes) with zeros; written by the
  // wide passes' stats_kernel (flash_mha_bwd_wide_sm90.cuh)
  const float* stats;
  int batch, heads, seq, seq_pad, dh;
  float scale;
};

// The maps a pass reads: A0, A1, B0, B1, and (dk/dv pass) lse and D.
struct Maps {
  CUtensorMap t[4], lse, delta;
};

// One pass over a block of 64 rows. DQ: the dq pass (rows: queries; A0, A1
// = Q, dO resident; walked B0, B1 = K, V); else the dk/dv pass (rows:
// keys; A0, A1 = K, V; B0, B1 = Q, dO). Warpgroup w forms X = A_w B_w^T;
// warpgroup 0's X is S (or S^T), warpgroup 1's dP (or dP^T).
template <int NC, bool DQ>
__global__ void __launch_bounds__(kThreads, 1)
    pass_kernel(const Params p, const __grid_constant__ Maps mp) {
  using Sh = Shape<NC, DQ>;
  constexpr int TB = Sh::kTileBytes, NO = Sh::kOut, NS = Sh::kStages;
  extern __shared__ unsigned char dyn_smem[];
  const uint32_t raw = sm90::smem_u32(dyn_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = dyn_smem + (base - raw);
  const uint32_t s_ring = base + 2 * TB;
  const uint32_t s_xp = s_ring + NS * Sh::kStageBytes;
  const uint32_t s_xd = s_xp + Sh::kXP;
  const uint32_t s_bar = s_xd + Sh::kXD;
  auto stage = [&](int t) { return s_ring + (t % NS) * Sh::kStageBytes; };
  auto full = [&](int t) { return s_bar + 8 * (t % NS); };
  auto empty = [&](int t) { return s_bar + 8 * (NS + t % NS); };
  const uint32_t res = s_bar + 16 * NS;   // A0, A1 landed
  const uint32_t x_fwd = res + 8;    // P written (warpgroup 0 -> 1)
  // dk/dv: P read, its buffer free (1 -> 0); dq: dS written (1 -> 0)
  const uint32_t x_back = res + 16;
  float4* xp = reinterpret_cast<float4*>(gbase + (s_xp - base));
  uint4* xd = reinterpret_cast<uint4*>(gbase + (s_xd - base));

  const int tid = threadIdx.x, wg = tid / 128, wtid = tid % 128;
  const int warp = wtid / 32, lane = tid % 32, g = lane / 4, tig = lane % 4;
  const int S = p.seq;
  const int n_r = (S + kRows - 1) / kRows;
  const int bh = blockIdx.x / n_r;
  const int b = bh / p.heads, h = bh % p.heads;
  const int r0 = (blockIdx.x % n_r) * kRows;
  const int n_t = (S + kTile - 1) / kTile;
  const long long n_stat = (long long)p.batch * p.heads * p.seq_pad;
  const float sl2 = p.scale * kLog2e;

  // dk/dv pass: the dq pass may launch once every block of this one has
  // started
  if constexpr (!DQ)
    asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  if (tid == 0) {
    for (int i = 0; i < NS; ++i) {
      mbar_init(full(i), 1);
      mbar_init(empty(i), kThreads);
    }
    mbar_init(res, 1);
    mbar_init(x_fwd, 128);
    mbar_init(x_back, 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The producer is warpgroup 1's first thread: in the dk/dv pass
  // warpgroup 1 trails (it waits for P), so its thread finds the stage it
  // refills already released by both.
  const bool producer = tid == 128;
  // walked tile t's B0 and B1 (and, dk/dv pass, its queries' lse and D)
  // into stage t % NS, once both warpgroups are done with the tile NS
  // before it
  auto load = [&](int t) {
    const uint32_t st = stage(t);
    if (t >= NS) mbar_wait(empty(t), (t / NS - 1) & 1);
    mbar_expect_tx(full(t), 2 * TB + (DQ ? 0 : kStat));
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      tma_load_4d(st + j * kBox, &mp.t[2], j * kBlock, t * kTile, h, b,
                  full(t));
      tma_load_4d(st + TB + j * kBox, &mp.t[3], j * kBlock, t * kTile, h, b,
                  full(t));
    }
    if constexpr (!DQ) {
      fwd90::tma_load_2d(st + 2 * TB, &mp.lse, t * kTile, bh, full(t));
      fwd90::tma_load_2d(st + 2 * TB + kStat / 2, &mp.delta, t * kTile, bh,
                         full(t));
    }
  };
  if (producer) {
    mbar_expect_tx(res, 2 * TB);
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      tma_load_4d(base + j * kBox, &mp.t[0], j * kBlock, r0, h, b, res);
      tma_load_4d(base + TB + j * kBox, &mp.t[1], j * kBlock, r0, h, b, res);
    }
    for (int t = 0; t < NS && t < n_t; ++t) load(t);
  }
  __syncwarp();   // the warp converges before its next wgmma

  // dq pass: this thread's two query rows' statistic, lse (log2 units)
  // for warpgroup 0, D for warpgroup 1
  float rs[2] = {0.f, 0.f};
  if constexpr (DQ) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long row = (long long)bh * p.seq_pad +
                            min(r0 + warp * 16 + g + 8 * r, S - 1);
      rs[r] = wg == 0 ? p.stats[row] * kLog2e : p.stats[n_stat + row];
    }
  }

  float o[NO][32];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[j][i] = 0.f;
  float x[32];
  uint32_t pa[4][4];
  const uint32_t a_x = base + wg * TB;   // this warpgroup's resident A
  mbar_wait(res, 0);

  for (int t = 0; t < n_t; ++t) {
    const uint32_t st = stage(t);
    mbar_wait(full(t), (t / NS) & 1);
    // dk/dv pass: the walked queries' lse, then D, in the stage
    const float* stat = reinterpret_cast<const float*>(
        gbase + (st - base) + 2 * TB);
    // X = A B^T over the column blocks (S or S^T, dP or dP^T)
    const uint32_t b_x = st + wg * TB;
    sm90::wg_fence();
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const uint64_t da = desc<64>(a_x + j * kBox);
      const uint64_t db = desc<64>(b_x + j * kBox);
      if (j == 0)
        sm90::wgmma_ss<0, 0, false>(x, da, db);
      else
        sm90::wgmma_ss<0, 0, true>(x, da, db);
#pragma unroll
      for (int kk = 1; kk < 4; ++kk)
        sm90::wgmma_ss<0, 0, true>(x, da + 2 * kk, db + 2 * kk);
    }
    sm90::wg_commit();
    sm90::wg_wait<0>();
    sm90::fence_regs(x);

    // element i of x: row (i / 2) % 2 * 8 + g of the warp's 16, column
    // (i / 4) * 8 + 2 tig + i % 2 of the tile (a key in the dq pass, a
    // query in the dk/dv pass); columns past S give P = dS = 0
    const int t0 = t * kTile;
    if (wg == 0) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = t0 + (i / 4) * 8 + 2 * tig + (i & 1);
        const float l2 = DQ ? rs[(i >> 1) & 1]
                            : stat[col - t0] * kLog2e;
        x[i] = col < S ? sm90::ex2(x[i] * sl2 - l2) : 0.f;
      }
      // dk/dv: the buffer is free once warpgroup 1 read the last tile's P
      if (!DQ && t > 0) mbar_wait(x_back, (t - 1) & 1);
#pragma unroll
      for (int c = 0; c < 8; ++c)
        xp[c * 128 + wtid] =
            make_float4(x[4 * c], x[4 * c + 1], x[4 * c + 2], x[4 * c + 3]);
      mbar_arrive(x_fwd);
      if constexpr (DQ) {
        mbar_wait(x_back, t & 1);   // dS of this tile
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint4 u = xd[kk * 128 + wtid];
          pa[kk][0] = u.x; pa[kk][1] = u.y; pa[kk][2] = u.z; pa[kk][3] = u.w;
        }
      } else {
        fwd90::pack_p<kTile>(x, pa);
      }
    } else {
      mbar_wait(x_fwd, t & 1);   // P of this tile
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float4 pv = xp[c * 128 + wtid];
        const float pe[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * c + e;
          const float dl =
              DQ ? rs[(i >> 1) & 1]
                 : stat[kTile + (i / 4) * 8 + 2 * tig + (i & 1)];
          x[i] = pe[e] * (x[i] - dl) * p.scale;
        }
      }
      fwd90::pack_p<kTile>(x, pa);
      if constexpr (DQ) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          xd[kk * 128 + wtid] = make_uint4(pa[kk][0], pa[kk][1], pa[kk][2],
                                           pa[kk][3]);
      }
      mbar_arrive(x_back);
    }

    // the sums: dk/dv warpgroup 0 dV += P^T dO, warpgroup 1 dK += dS^T Q;
    // dq each dQ += dS K over its half of the column blocks (the second
    // half's missing block at NC 3 repeats the last, and is not stored).
    // B is the walked tile read transposed (MN-major), k-steps of 16 rows.
    const uint32_t b_u = DQ ? st : st + (1 - wg) * TB;
    sm90::wg_fence();
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int blk = DQ ? min(wg * NO + j, NC - 1) : j;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::wgmma_rs<1>(o[j], pa[kk],
                          desc<64>(b_u + blk * kBox + kk * 16 * 128));
    }
    sm90::wg_commit();
    sm90::wg_wait<0>();
#pragma unroll
    for (int j = 0; j < NO; ++j) sm90::fence_regs(o[j]);
    sm90::fence_regs(pa);
    mbar_arrive(empty(t));
    if (producer && t + NS < n_t) load(t + NS);
    __syncwarp();
  }

  const int row0 = r0 + warp * 16 + g;
  if constexpr (DQ) {
    colsbwd90::store_rows(p.dq + b * p.sdq.b + h * p.sdq.h, p.sdq.n, o, row0,
                          S, wg * NO * kBlock, p.dh, tig);
    // the dk/dv pass (the grid this one depends on) done before this block
    // ends, its writes visible
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
  } else {
    bf* dst = wg == 0 ? p.dv + b * p.sdv.b + h * p.sdv.h
                      : p.dk + b * p.sdk.b + h * p.sdk.h;
    colsbwd90::store_rows(dst, wg == 0 ? p.sdv.n : p.sdk.n, o, row0, S, 0,
                          p.dh, tig);
  }
}

namespace {
template <int NC, bool DQ>
int smem_set[fwd90::kMaxDevices] = {};
}  // namespace

// One pass: a0, a1 the resident tensors, b0, b1 the walked ones (q, k, v,
// do views and their strides).
template <int NC, bool DQ>
int launch_pass(const Params& p, const void* const (&t)[4],
                const Strides (&s)[4], cudaStream_t stream) {
  Maps m;
  const long long rows = (long long)p.batch * p.heads;
  int err = bwd90::stat_map(&m.lse, p.stats, rows, p.seq_pad);
  if (err == 0)
    err = bwd90::stat_map(&m.delta, p.stats + rows * p.seq_pad, rows,
                          p.seq_pad);
  for (int i = 0; i < 4 && err == 0; ++i)
    err = fwd90::kv_map(&m.t[i], t[i], s[i], p.batch, p.heads, p.seq, p.dh,
                        kRows, kBlock);
  if (err != 0) return err;
  auto kernel = pass_kernel<NC, DQ>;
  constexpr int smem = Shape<NC, DQ>::kSmem;
  int device = 0;
  err = (int)cudaGetDevice(&device);
  if (err != 0) return err;
  if (device >= fwd90::kMaxDevices) return (int)cudaErrorInvalidDevice;
  int& allowed = smem_set<NC, DQ>[device];
  if (allowed < smem) {
    err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != 0) return err;
    allowed = smem;
  }
  const long long blocks =
      (long long)p.batch * p.heads * ((p.seq + kRows - 1) / kRows);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  // the dq pass as the dk/dv pass's programmatic dependent
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = DQ;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = (int)cudaLaunchKernelEx(&cfg, kernel, p, m);
  if (err != 0) return err;
  return (int)cudaGetLastError();
}

// lse and D, then the dk/dv and the dq passes of NC column blocks, on one
// stream; dh (a multiple of 8, at most NC x 64) the head dim read;
// bp.delta is the scratch of stats (Params): 2 x batch x heads x seq
// rounded up to 4 floats. Returns the first launch's CUDA error (0 on
// success).
template <int NC>
int launch(const BwdParams& bp, int dh, cudaStream_t stream) {
  if (bp.batch <= 0 || bp.heads <= 0 || bp.seq <= 0) return 0;
  if (dh % 8 != 0 || dh > NC * kBlock) return (int)cudaErrorInvalidValue;
  const int seq_pad = (bp.seq + 3) / 4 * 4;
  bwd90::Params sp{};
  sp.o = static_cast<const bf*>(bp.o);
  sp.dout = static_cast<const bf*>(bp.dout);
  sp.so = bp.so; sp.sdo = bp.sdo;
  sp.lse = bp.lse; sp.stats = bp.delta;
  sp.batch = bp.batch; sp.heads = bp.heads; sp.seq = bp.seq;
  sp.seq_pad = seq_pad; sp.dh = dh;
  int err = bwd90::launch_stats(
      sp, (long long)bp.batch * bp.heads * seq_pad, stream);
  if (err != 0) return err;
  Params p{};
  p.dq = static_cast<bf*>(bp.dq);
  p.dk = static_cast<bf*>(bp.dk);
  p.dv = static_cast<bf*>(bp.dv);
  p.sdq = bp.sdq; p.sdk = bp.sdk; p.sdv = bp.sdv;
  p.stats = bp.delta;
  p.batch = bp.batch; p.heads = bp.heads; p.seq = bp.seq;
  p.seq_pad = seq_pad; p.dh = dh;
  p.scale = bp.scale;
  const void* const kv_qdo[4] = {bp.k, bp.v, bp.q, bp.dout};
  const Strides s_kv_qdo[4] = {bp.sk, bp.sv, bp.sq, bp.sdo};
  err = launch_pass<NC, false>(p, kv_qdo, s_kv_qdo, stream);
  if (err != 0) return err;
  const void* const qdo_kv[4] = {bp.q, bp.dout, bp.k, bp.v};
  const Strides s_qdo_kv[4] = {bp.sq, bp.sdo, bp.sk, bp.sv};
  return launch_pass<NC, true>(p, qdo_kv, s_qdo_kv, stream);
}

}  // namespace split90
}  // namespace tim_attn
