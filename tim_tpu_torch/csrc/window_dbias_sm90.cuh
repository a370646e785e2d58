// Window attention, backward: the bias gradient of kernel 4b's routes past
// head dim 32 (bf16 on wgmma, sm_90a), beside their dq, dk and dv passes
// (window_attention_bwd_wide.cu, window_attention_bwd_cols.cu), which take
// the bias into their scores but leave dbias to this pass:
//
//   dbias[h, i, j] = sum over the batch's windows w of ds_ij,
//   ds_ij = p_ij (dp_ij - D_i),  p_ij = exp(s_ij - lse_i),  dp_ij = do_i . v_j,
//   s_ij = (q_i . k_j) * scale + bias[h, i, j] - 100 (region[w, i] !=
//   region[w, j]),
//
// fp32 throughout (the plain version's ds before its rounding), D from the
// dq/dk/dv passes' preprocess.
//
// Why a pass of its own: dbias sums over every window, and Hopper blocks
// run in no order, so a sum across the windows needs atomics, a block that
// walks the windows, or a second pass. The head-dim-32 route keeps the
// partial of a block's 64 key columns for every query row in shared memory
// (seq x 64 x 4 bytes, 200 KB at seq 784) beside tiles of 32 columns; past
// 32 the wider Q, dO, K and V tiles leave no room for it. Here a block owns
// (head, 128 query rows, 64 keys, a group of consecutive windows) and walks
// its windows in order: per window it forms S = Q K^T and dP = dO V^T over
// the head dim in 64-column chunks (two warpgroups, 64 rows each; Q, dO,
// K and V's chunks through a four-stage TMA ring, one transaction a chunk)
// and adds ds to a 64 x 64 fp32 sum a warpgroup kept in registers. The
// bias of the block's scores is the same for every window and is read
// once. The cost: two more products a score (4 N^2 dh flops per (window,
// head), as the forward), one more exponential, and Q, dO, K and V read
// again (from L2 when the passes before left them there). The other
// candidate, the dk/dv pass's blocks adding their key columns' partial to
// their slice of the output a window at a time, is one L2 round trip of 8
// bytes a score; PERF.md compares the two.
//
// Groups: when the blocks of one group would not fill the card, the
// windows are cut into `groups` consecutive groups, each summed into its
// slice of a [groups, heads, seq, seq] fp32 scratch, and a short pass adds
// the slices in order. Nothing is summed with atomics: the same bits every
// run. Rows and keys past seq read as zeros and are not stored; columns
// past dh read as zeros.

#pragma once

#include "flash_attention_bwd.cuh"
#include "flash_attention_sm90.cuh"

namespace tim_attn {
namespace dbias90 {

using bf = __nv_bfloat16;
using fwd90::mbar_arrive;
using fwd90::mbar_expect_tx;
using fwd90::mbar_init;
using fwd90::mbar_wait;
using fwd90::tma_load_4d;

constexpr int kThreads = 256;        // two warpgroups
constexpr int kRows = 128;           // query rows a block
constexpr int kKeys = 64;            // keys a block
constexpr int kBlock = 64;           // columns a chunk (128-byte swizzle)
constexpr int kStages = 4;
constexpr int kAhead = kStages - 2;
constexpr int kQBox = kRows * kBlock * 2;    // 16 KB
constexpr int kKBox = kKeys * kBlock * 2;    // 8 KB
constexpr int kStageBytes = 2 * kQBox + 2 * kKBox;
constexpr int kSmem = kStages * kStageBytes + 16 * kStages + 1024;
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const float* lse;     // [batch, heads, seq]
  const float* delta;   // D, row (b * heads + h) at delta + that * pitch
  long long pitch;
  const float* bias;    // [heads, seq, seq]
  const int* region;    // [n_win, seq] or null
  int n_win;
  int batch, heads, seq, dh, groups;
  float scale;
  float* out;           // [groups, heads, seq, seq]
};

__global__ void __launch_bounds__(kThreads, 1)
    dbias_kernel(const Params p, const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_do,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v) {
  constexpr int NS = kStages;
  extern __shared__ unsigned char dyn_smem[];
  const uint32_t raw = sm90::smem_u32(dyn_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t s_bar = base + NS * kStageBytes;
  auto stage = [&](int i) { return base + (i % NS) * kStageBytes; };
  auto full = [&](int i) { return s_bar + 8 * (i % NS); };
  auto empty = [&](int i) { return s_bar + 8 * (NS + i % NS); };

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int tig = lane % 4;
  const int S = p.seq;
  const int n_qb = (S + kRows - 1) / kRows, n_kb = (S + kKeys - 1) / kKeys;
  const int h = blockIdx.x / (n_qb * n_kb);
  const int rem = blockIdx.x % (n_qb * n_kb);
  const int q0 = (rem / n_kb) * kRows, k0 = (rem % n_kb) * kKeys;
  const int per = (p.batch + p.groups - 1) / p.groups;
  const int w0 = blockIdx.y * per;
  const int n_w = max(0, min(p.batch, w0 + per) - w0);
  const int nc = (p.dh + kBlock - 1) / kBlock;
  const int total = n_w * nc;

  if (tid == 0) {
    for (int i = 0; i < NS; ++i) {
      mbar_init(full(i), 1);
      mbar_init(empty(i), kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // item i: chunk i % nc of window w0 + i / nc (Q and dO rows q0.., K and
  // V rows k0..)
  auto load = [&](int i) {
    if (i >= NS) mbar_wait(empty(i), (i / NS - 1) & 1);
    const uint32_t st = stage(i);
    const int w = w0 + i / nc, c = (i % nc) * kBlock;
    mbar_expect_tx(full(i), kStageBytes);
    tma_load_4d(st, &tm_q, c, q0, h, w, full(i));
    tma_load_4d(st + kQBox, &tm_do, c, q0, h, w, full(i));
    tma_load_4d(st + 2 * kQBox, &tm_k, c, k0, h, w, full(i));
    tma_load_4d(st + 2 * kQBox + kKBox, &tm_v, c, k0, h, w, full(i));
  };
  int issued = 0, it = 0;
  // item j (= it) once landed, loads topped up to kAhead past it (a load
  // waits for the item NS before it, which this thread has released)
  auto acquire = [&](int j) {
    if (tid == 0)
      while (issued < min(total, j + kAhead + 1)) load(issued++);
    __syncwarp();
    mbar_wait(full(j), (j / NS) & 1);
    return stage(j);
  };
  auto release = [&]() { mbar_arrive(empty(it)); ++it; };

  // this thread's two query rows and the bias of its 32 scores, the same
  // in every window
  const int row0 = q0 + wg * 64 + warp * 16 + lane / 4;
  int rows[2];
  const int none[2] = {0, 0};
#pragma unroll
  for (int r = 0; r < 2; ++r) rows[r] = min(row0 + 8 * r, S - 1);
  float bv[32];
  fwd90::score_bias<false>(bv, p.bias + (long long)h * S * S, nullptr, rows,
                           none, k0, tig, S);
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

  float sc[32], dp[32];
  // one chunk's S += Q K^T and dP += dO V^T (each chunk waited for before
  // the next: past head dim 64 the chunks' groups are not pipelined)
  auto issue_chunk = [&](uint32_t st) {
    const uint64_t dq = fwd90::desc<64>(st + wg * 64 * kBlock * 2);
    const uint64_t ddo = fwd90::desc<64>(st + kQBox + wg * 64 * kBlock * 2);
    const uint64_t dk = fwd90::desc<64>(st + 2 * kQBox);
    const uint64_t dv = fwd90::desc<64>(st + 2 * kQBox + kKBox);
#pragma unroll
    for (int kk = 0; kk < kBlock / 16; ++kk)
      sm90::wgmma_ss<0, 0, true>(sc, dq + 2 * kk, dk + 2 * kk);
#pragma unroll
    for (int kk = 0; kk < kBlock / 16; ++kk)
      sm90::wgmma_ss<0, 0, true>(dp, ddo + 2 * kk, dv + 2 * kk);
  };
  for (int wi = 0; wi < n_w; ++wi) {
    const int w = w0 + wi;
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
    for (int c = 0; c < nc; ++c) {
      const uint32_t st = acquire(it);
      sm90::wg_fence();
      issue_chunk(st);
      sm90::wg_commit();
      sm90::wg_wait<0>();
      sm90::fence_regs(sc);
      sm90::fence_regs(dp);
      release();
    }
    const long long bh = (long long)w * p.heads + h;
    const int* rw = p.region != nullptr
                        ? p.region + (long long)(w % p.n_win) * S
                        : nullptr;
    float lv[2], dl[2];
    int rr[2] = {0, 0};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lv[r] = __ldg(p.lse + bh * S + rows[r]) * kLog2e;
      dl[r] = __ldg(p.delta + bh * p.pitch + rows[r]);
      if (rw != nullptr) rr[r] = __ldg(rw + rows[r]);
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      const int col = k0 + (i / 4) * 8 + 2 * tig + (i & 1);
      float x = fmaf(sc[i], p.scale, bv[i]);
      if (rw != nullptr && col < S && __ldg(rw + col) != rr[r])
        x += kMaskValue;
      const float pe = sm90::ex2(x * kLog2e - lv[r]);
      acc[i] += col < S ? pe * (dp[i] - dl[r]) : 0.f;
    }
  }

  float* out = p.out + ((long long)blockIdx.y * p.heads + h) * S * S;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int row = row0 + 8 * ((i >> 1) & 1);
    const int col = k0 + (i / 4) * 8 + 2 * tig + (i & 1);
    if (row < S && col < S) out[(long long)row * S + col] = acc[i];
  }
}

// dbias = the groups' slices summed in order (groups > 1).
__global__ void __launch_bounds__(256) sum_kernel(const float* parts,
                                                  float* out, long long n,
                                                  int groups) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = parts[i];
  for (int g = 1; g < groups; ++g) s += parts[g * n + i];
  out[i] = s;
}

}  // namespace dbias90

// The bf16 dbias pass (and, with groups > 1, the groups' sum) on one
// stream: p's q, k, v, dout and strides, lse, bias, region, n_win and
// dbias, D at delta with row pitch `pitch`, head dim dh (a multiple of 8;
// rows 16-byte aligned), scratch [groups, heads, seq, seq] fp32 when
// groups > 1. Returns the first CUDA error of the launches (0 on success).
inline int launch_window_dbias_bf16(const BwdParams& bp, const float* delta,
                                    long long pitch, int dh, float* scratch,
                                    int groups, cudaStream_t stream) {
  namespace d = dbias90;
  if (bp.batch <= 0 || bp.heads <= 0 || bp.seq <= 0) return 0;
  if (groups < 1 || (groups > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  const int S = bp.seq;
  d::Params p{};
  p.lse = bp.lse; p.delta = delta; p.pitch = pitch;
  p.bias = bp.bias; p.region = bp.region; p.n_win = bp.n_win;
  p.batch = bp.batch; p.heads = bp.heads; p.seq = S; p.dh = dh;
  p.groups = groups; p.scale = bp.scale;
  p.out = groups > 1 ? scratch : bp.dbias;
  CUtensorMap m_q, m_do, m_k, m_v;
  int err = fwd90::kv_map(&m_q, bp.q, bp.sq, bp.batch, bp.heads, S, dh,
                          d::kRows, d::kBlock);
  if (err == 0)
    err = fwd90::kv_map(&m_do, bp.dout, bp.sdo, bp.batch, bp.heads, S, dh,
                        d::kRows, d::kBlock);
  if (err == 0)
    err = fwd90::kv_map(&m_k, bp.k, bp.sk, bp.batch, bp.heads, S, dh,
                        d::kKeys, d::kBlock);
  if (err == 0)
    err = fwd90::kv_map(&m_v, bp.v, bp.sv, bp.batch, bp.heads, S, dh,
                        d::kKeys, d::kBlock);
  if (err != 0) return err;
  err = (int)cudaFuncSetAttribute(
      d::dbias_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      d::kSmem);
  if (err != 0) return err;
  const long long blocks = (long long)bp.heads *
                           ((S + d::kRows - 1) / d::kRows) *
                           ((S + d::kKeys - 1) / d::kKeys);
  if (blocks > 0x7fffffffLL || groups > 65535)
    return (int)cudaErrorInvalidConfiguration;
  d::dbias_kernel<<<dim3((unsigned)blocks, groups), d::kThreads, d::kSmem,
                    stream>>>(p, m_q, m_do, m_k, m_v);
  err = (int)cudaGetLastError();
  if (err != 0 || groups == 1) return err;
  const long long n = (long long)bp.heads * S * S;
  d::sum_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      scratch, bp.dbias, n, groups);
  return (int)cudaGetLastError();
}

}  // namespace tim_attn
