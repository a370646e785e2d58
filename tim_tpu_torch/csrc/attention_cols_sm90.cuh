// Exact softmax attention, forward, at head dims past 256: the core of
// kernel 5 (flash_mha_cols.cu, no self key) and kernel 1
// (query_block_attention_cols.cu: each query also attends to its own key,
// kq / vq) past the head dims their other instances take. bf16 on wgmma
// (sm_90a), fp32 on the CUDA cores; the function is the one of
// flash_attention.cuh,
//
//   out[b, h, i] = (sum_j p_ij v_j [+ e_i vq_i]) / (sum_j p_ij [+ e_i]),
//   p_ij = exp(s_ij - m_i), s_ij = (q_i . k_j) * scale,
//   e_i = exp((q_i . kq_i) * scale - m_i)   (kernel 1's self key),
//
// with fp32 scores and running statistics, the unnormalised
// probabilities rounded to bf16 before the PV product (as the other bf16
// instances), and the row log-sum-exp for kernel 5's backward (LSE).
//
// Why column slices: the other instances keep a 64-row tile's fp32 output
// over the whole head dim in one warpgroup's registers (128 floats a
// thread at 256). At 512 that is 256 a thread, past the register file. So
// a block here takes 128 query rows and one slice of kSlice (256) output
// columns (grid axis y); every slice of a query tile forms the scores over
// the full head dim itself. K streams through a TMA ring in 64-column
// boxes: S of a 64-key tile is the sum of one m64n64k64 product a column
// block, then the online softmax step, then O_slice += P V_slice (V's
// slice as four 64-column boxes). Up to head dim 512 (RES) Q's 128 rows
// stay resident in shared memory (128 KB, a 3-stage ring of 32 KB items
// beside them: K four blocks an item); past it Q streams through the ring
// with K, one block an item, so any head dim fits (Q then read from L2
// once a key tile: at 512 that made the call 1.45x slower). Kernel 1's
// self score is a per-row dot product of Q and kq's column blocks before
// the first key tile, and starts the running max.
//
// The cost: Q K^T once per slice, so at head dim 512 (two slices) 1.5x
// the products of one pass. The
// alternative, a first walk for the row statistics and then exact P per
// slice, does one more Q K^T (at 512 2x the products of one pass) and a
// second walk over the keys. In bf16 from head dim 513 to 2048 the cluster
// route below replaces both (cluster_kernel: the slices of a query tile
// as one thread-block cluster that forms Q K^T once, Q resident in four
// blocks' shared memory; at [8, 1, 1568, 1024] 0.63 ms against 0.94 for
// the streamed route, PERF.md); at 512 it is slower (the exchange costs
// more than the half pass it saves) and past 2048 a portable cluster has
// too few blocks, so the streamed kernel stays there.
//
// Ring items (each one stage of kStageBytes, one TMA transaction): kernel
// 1's self items (kq's column block c, and Q's when it streams), then per
// key tile its K (and Q) blocks and its V slice. Rows past nq
// and keys past nk read as zeros (TMA fills boxes past the tensor's end);
// keys past nk score -inf; columns past dh read as zeros and are not
// stored. S's product groups run one column block each, the next block's
// issued before the last one's is waited for.

#pragma once

#include <type_traits>

#include "common.cuh"
#include "flash_attention_sm90.cuh"

namespace tim_attn {

// What the column-slice kernels take. q, k, v, out: [batch, heads, rows,
// dh] views with element strides, the last dim contiguous; kq, vq: kernel
// 1's self keys and values, [batch, heads, nq, dh], or null (kernel 5); a
// batch stride of 0 is a batch-broadcast view (kernel 1's layer-0 query
// block).
struct ColsParams {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  const void* kq;
  const void* vq;
  Strides sq, sk, sv, so, skq, svq;
  int batch, heads, nq, nk, dh;
  float scale;
  float* lse;   // [batch, heads, nq] fp32, or null
  // kernel 4 (BIAS): bias [heads, nq, nk] fp32, contiguous; region [n_win,
  // nq] int32 or null (nq = nk); the window type is batch % n_win
  const float* bias;
  const int* region;
  int n_win;
};

// strides: 18 element strides, (batch, head, row) for q, k, v, out, kq, vq.
inline void set_cols_strides(ColsParams& p, const long long* st) {
  Strides* s[6] = {&p.sq, &p.sk, &p.sv, &p.so, &p.skq, &p.svq};
  for (int i = 0; i < 6; ++i) *s[i] = {st[3 * i], st[3 * i + 1], st[3 * i + 2]};
}

namespace cols90 {

using fwd90::mbar_arrive;
using fwd90::mbar_expect_tx;
using fwd90::mbar_init;
using fwd90::mbar_wait;
using fwd90::tma_load_4d;

constexpr int kThreads = 256;       // two warpgroups
constexpr int kRows = 128;          // query rows a block, 64 a warpgroup
constexpr int kKeys = 64;           // keys a tile
constexpr int kSlice = 256;         // output columns a block
constexpr int kBlock = 64;          // columns a box (128-byte swizzle)
constexpr int kQBox = kRows * kBlock * 2;    // 16 KB
constexpr int kKBox = kKeys * kBlock * 2;    // 8 KB
constexpr int kStageBytes = 2 * kQBox;       // the largest item: 32 KB
// Up to kResBlocks column blocks (head dim 512) Q's 128 rows stay resident
// in shared memory (128 KB), read from L2 once instead of once a key tile,
// and K comes kPerItem column blocks an item; past it Q streams too.
// Kernel 1 up to head dim 256 (bf16 from 161: one slice) keeps Q in a room
// of kSelfResBlocks blocks (160 KB in all): the smaller shared-memory
// carve-out leaves L1 the room that vq's reads use (at [128, 4, 798, 256]
// 11% faster than Q in eight blocks' room, PERF.md).
constexpr int kResBlocks = 8;
constexpr int kSelfResBlocks = 4;
constexpr int kPerItem = kStageBytes / kKBox;
// QB: Q's resident column blocks (0: Q streams)
template <int QB>
struct Ring {
  static constexpr int kStages = QB ? 3 : 5;
  static constexpr int kAhead = kStages - 2;   // items loaded ahead
  static constexpr int kQRes = QB * kQBox;
  // Q | stages | full and empty barriers, Q's barrier | alignment slack
  static constexpr int kSmem =
      kQRes + kStages * kStageBytes + 16 * kStages + 8 + 1024;
};

// Which batch coordinate each map reads: bit t set for a broadcast batch
// (stride 0, its map built with one batch entry), tensor t of q, k, v, kq.
__device__ __forceinline__ int bcoord(int mask, int t, int b) {
  return (mask >> t) & 1 ? 0 : b;
}

template <bool SELF, bool LSE, int QB, bool BIAS>
__global__ void __launch_bounds__(kThreads, 1)
    cols_kernel(const ColsParams p, const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                const __grid_constant__ CUtensorMap tm_kq, const int bmask) {
  using bf = __nv_bfloat16;
  constexpr bool RES = QB > 0;
  constexpr int NS = Ring<QB>::kStages, AHEAD = Ring<QB>::kAhead;
  extern __shared__ unsigned char dyn_smem[];
  const uint32_t raw = sm90::smem_u32(dyn_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = dyn_smem + (base - raw);
  const uint32_t s_q = base;   // RES: Q's column blocks
  const uint32_t s_ring = base + Ring<QB>::kQRes;
  const uint32_t s_bar = s_ring + NS * kStageBytes;
  const uint32_t q_bar = s_bar + 16 * NS;
  auto stage = [&](int i) { return s_ring + (i % NS) * kStageBytes; };
  auto full = [&](int i) { return s_bar + 8 * (i % NS); };
  auto empty = [&](int i) { return s_bar + 8 * (NS + i % NS); };

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int n_q = (p.nq + kRows - 1) / kRows;
  const int bh = blockIdx.x / n_q;
  const int h = bh / p.batch, b = bh % p.batch;   // head-major
  const int q0 = (blockIdx.x % n_q) * kRows;
  const int c0 = blockIdx.y * kSlice;              // this block's columns
  const int nc = (p.dh + kBlock - 1) / kBlock;     // column blocks
  const int nvb = min(kSlice, p.dh - c0 + kBlock - 1) / kBlock;  // of V's
  const int n_kt = (p.nk + kKeys - 1) / kKeys;
  const int n_self = SELF ? nc : 0;
  // a key tile's items: its K (and, streamed, Q) blocks, then its V slice
  const int nki = RES ? (nc + kPerItem - 1) / kPerItem : nc;
  const int total = n_self + n_kt * (nki + 1);
  const int bq = bcoord(bmask, 0, b), bk = bcoord(bmask, 1, b);
  const int bv = bcoord(bmask, 2, b), bkq = bcoord(bmask, 3, b);

  if (tid == 0) {
    for (int i = 0; i < NS; ++i) {
      mbar_init(full(i), 1);
      mbar_init(empty(i), kThreads);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (RES) {
    // zeros in Q's blocks past nc and in the ring, so that a K item's
    // blocks past nc (not loaded: the stage's older data, or these zeros)
    // meet zero Q columns in the products
    for (uint32_t i = tid * 16; i < Ring<QB>::kQRes + NS * kStageBytes;
         i += kThreads * 16)
      if (i >= (uint32_t)(nc * kQBox))
        *reinterpret_cast<uint4*>(gbase + i) = make_uint4(0, 0, 0, 0);
    sm90::fence_async_smem();   // before TMA writes beside them
  }
  __syncthreads();
  if (RES && tid == 0) {
    mbar_expect_tx(q_bar, nc * kQBox);
    for (int c = 0; c < nc; ++c)
      tma_load_4d(s_q + c * kQBox, &tm_q, c * kBlock, q0, h, bq, q_bar);
  }

  // item i into its stage by TMA from thread 0, once every thread is done
  // with the item NS before it
  auto load = [&](int i) {
    if (i >= NS) mbar_wait(empty(i), (i / NS - 1) & 1);
    const uint32_t st = stage(i);
    if (i < n_self) {   // kq's block i (and, streamed, Q's)
      mbar_expect_tx(full(i), (RES ? 1 : 2) * kQBox);
      tma_load_4d(st + kQBox, &tm_kq, i * kBlock, q0, h, bkq, full(i));
      if (!RES) tma_load_4d(st, &tm_q, i * kBlock, q0, h, bq, full(i));
      return;
    }
    const int j = i - n_self, kt = j / (nki + 1), c = j % (nki + 1);
    if (c < nki && RES) {   // K's blocks kPerItem c ..
      const int n = min(kPerItem, nc - c * kPerItem);
      mbar_expect_tx(full(i), n * kKBox);
      for (int cb = 0; cb < n; ++cb)
        tma_load_4d(st + cb * kKBox, &tm_k, (c * kPerItem + cb) * kBlock,
                    kt * kKeys, h, bk, full(i));
    } else if (c < nki) {   // Q's and K's block c
      mbar_expect_tx(full(i), kQBox + kKBox);
      tma_load_4d(st, &tm_q, c * kBlock, q0, h, bq, full(i));
      tma_load_4d(st + kQBox, &tm_k, c * kBlock, kt * kKeys, h, bk, full(i));
    } else {
      mbar_expect_tx(full(i), nvb * kKBox);
      for (int cb = 0; cb < nvb; ++cb)
        tma_load_4d(st + cb * kKBox, &tm_v, c0 + cb * kBlock, kt * kKeys, h,
                    bv, full(i));
    }
  };
  int issued = 0, it = 0;   // items issued (thread 0), items consumed
  // the stage of item j (it or it + 1), once it has landed, with the loads
  // topped up to AHEAD items past it: a load waits for the item NS before
  // it, which this thread has released (j + AHEAD - NS < it)
  auto acquire = [&](int j) {
    if (tid == 0)
      while (issued < min(total, j + AHEAD + 1)) load(issued++);
    __syncwarp();   // the warp converges before its next wgmma
    mbar_wait(full(j), (j / NS) & 1);
    return stage(j);
  };
  if constexpr (RES) mbar_wait(q_bar, 0);
  auto release = [&]() { mbar_arrive(empty(it)); ++it; };

  const int g = lane / 4, tig = lane % 4;
  const int lrow0 = wg * 64 + warp * 16 + g;   // this thread's rows in the
                                               // tile: lrow0, lrow0 + 8
  // kernel 1: the self scores q . kq over every column block (raw dots)
  float self[2] = {0.f, 0.f};
  if constexpr (SELF) {
    for (int c = 0; c < nc; ++c) {
      const uint32_t st = acquire(it);
      const uint32_t sq = RES ? s_q + c * kQBox : st;   // Q's block c
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int ch = 2 * tig; ch < 2 * tig + 2; ++ch) {
          const uint32_t off = fwd90::swz<64>(lrow0 + 8 * r, ch);
          float x[8], y[8];
          tim::load_floats<bf, 8>(
              reinterpret_cast<const bf*>(gbase + (sq - base) + off), x);
          tim::load_floats<bf, 8>(
              reinterpret_cast<const bf*>(gbase + (st - base) + kQBox + off),
              y);
#pragma unroll
          for (int e = 0; e < 8; ++e) self[r] = fmaf(x[e], y[e], self[r]);
        }
      release();
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      self[r] += __shfl_xor_sync(0xffffffffu, self[r], 1);
      self[r] += __shfl_xor_sync(0xffffffffu, self[r], 2);
    }
  }

  fwd90::RowCtx rc;
  rc.scale = p.scale;
  rc.c = p.scale * 1.4426950408889634f;
  rc.tig = tig;
  rc.masked = false;
  rc.pairs = true;
  const float nobias[1] = {0.f};
  // kernel 4: this thread's bias rows and region ids; each key tile's S
  // accumulator starts at (bias + mask) / scale, so that the scores are
  // kernel 5's (q . k + (bias + mask) / scale) * scale
  const float inv_scale = 1.f / p.scale;
  const float* bias_row[2] = {nullptr, nullptr};
  const int* region = BIAS && p.region != nullptr
                          ? p.region + (long long)(b % p.n_win) * p.nk
                          : nullptr;
  int region_row[2] = {0, 0};
  if constexpr (BIAS) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = min(q0 + lrow0 + 8 * r, p.nq - 1);
      bias_row[r] = p.bias + ((long long)h * p.nq + row) * p.nk;
      if (region != nullptr) region_row[r] = region[row];
    }
  }
  float sc[kKeys / 2], o[kSlice / kBlock][kBlock / 2];
  uint32_t pa[kKeys / 16][4];
  // the running max in raw dot units (kernel 1: from its self score)
  float m[2] = {SELF ? self[0] : TIM_NEG_INF, SELF ? self[1] : TIM_NEG_INF};
  float l[2] = {0.f, 0.f}, corr[2];
#pragma unroll
  for (int j = 0; j < kSlice / kBlock; ++j)
#pragma unroll
    for (int i = 0; i < kBlock / 2; ++i) o[j][i] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    // S over the column blocks, one product group a block's item, block
    // c's group issued before block c - 1's is waited for (its item then
    // released), as a GEMM's main loop does (5% faster at [8, 2, 1568,
    // 512] than waiting for each group before the next)
    // (c: the item's first column block / kPerItem when Q is resident)
    auto issue_s = [&](uint32_t st, int c) {
      if constexpr (RES) {
#pragma unroll
        for (int cb = 0; cb < kPerItem; ++cb) {
          const uint64_t dq = fwd90::desc<64>(
              s_q + (c * kPerItem + cb) * kQBox + wg * 64 * kBlock * 2);
          const uint64_t dk = fwd90::desc<64>(st + cb * kKBox);
#pragma unroll
          for (int kk = 0; kk < kBlock / 16; ++kk)
            sm90::wgmma_ss<0, 0, true>(sc, dq + 2 * kk, dk + 2 * kk);
        }
      } else {
        const uint64_t dq = fwd90::desc<64>(st + wg * 64 * kBlock * 2);
        const uint64_t dk = fwd90::desc<64>(st + kQBox);
#pragma unroll
        for (int kk = 0; kk < kBlock / 16; ++kk)
          sm90::wgmma_ss<0, 0, true>(sc, dq + 2 * kk, dk + 2 * kk);
      }
    };
    if constexpr (BIAS) {
#pragma unroll
      for (int i = 0; i < kKeys / 2; ++i) {
        const int col = min(kt * kKeys + (i / 4) * 8 + 2 * tig + (i & 1),
                            p.nk - 1);
        float x = __ldg(bias_row[(i >> 1) & 1] + col);
        if (region != nullptr && __ldg(region + col) != region_row[(i >> 1) & 1])
          x += kMaskValue;
        sc[i] = x * inv_scale;
      }
    } else {
#pragma unroll
      for (int i = 0; i < kKeys / 2; ++i) sc[i] = 0.f;
    }
    {
      const uint32_t st0 = acquire(it);
      sm90::wg_fence();
      issue_s(st0, 0);
      sm90::wg_commit();
      for (int c = 1; c < nki; ++c) {
        const uint32_t st = acquire(it + 1);
        sm90::wg_fence();   // as a GEMM main loop: before every group
        issue_s(st, c);
        sm90::wg_commit();
        sm90::wg_wait<1>();
        release();
      }
      sm90::wg_wait<0>();
      sm90::fence_regs(sc);
      release();
    }
    fwd90::softmax_tile<kKeys, false>(sc, m, l, corr, rc, nobias, nullptr,
                                      kt * kKeys, p.nk);
    fwd90::rescale(o, corr);
    fwd90::pack_p<kKeys>(sc, pa);
    const uint32_t st = acquire(it);
    sm90::wg_fence();
    fwd90::issue_pv<kSlice, kKeys, kSlice / kBlock>(o, pa,
                                                    fwd90::desc<64>(st));
    sm90::wg_commit();
    sm90::wg_wait<0>();
#pragma unroll
    for (int j = 0; j < kSlice / kBlock; ++j) sm90::fence_regs(o[j]);
    sm90::fence_regs(pa);
    release();
  }

  bf* out = static_cast<bf*>(p.out) + b * p.so.b + h * p.so.h;
  const bf* vq = SELF ? static_cast<const bf*>(p.vq) + b * p.svq.b +
                            h * p.svq.h
                      : nullptr;
  float inv[2], w_self[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float e = SELF ? sm90::ex2((self[r] - m[r]) * rc.c) : 0.f;
    inv[r] = 1.f / (l[r] + e);
    w_self[r] = e * inv[r];
    const int row = q0 + lrow0 + 8 * r;
    if constexpr (LSE) {
      if (blockIdx.y == 0 && tig == 0 && row < p.nq)
        p.lse[((long long)b * p.heads + h) * p.nq + row] =
            m[r] * p.scale + logf(l[r]);
    }
  }
#pragma unroll
  for (int j = 0; j < kSlice / kBlock; ++j)
#pragma unroll
    for (int i = 0; i < kBlock / 2; i += 2) {
      const int r = (i >> 1) & 1;
      const int row = q0 + lrow0 + 8 * r;
      const int col = c0 + j * kBlock + (i / 4) * 8 + 2 * tig;
      if (row >= p.nq || col >= p.dh) continue;
      float x0 = o[j][i] * inv[r], x1 = o[j][i + 1] * inv[r];
      if constexpr (SELF) {
        const __nv_bfloat162 v2 = *reinterpret_cast<const __nv_bfloat162*>(
            vq + row * p.svq.n + col);
        x0 = fmaf(w_self[r], __low2float(v2), x0);
        x1 = fmaf(w_self[r], __high2float(v2), x1);
      }
      *reinterpret_cast<uint32_t*>(out + row * p.so.n + col) =
          pack_bf16(x0, x1);
    }
}

// The map of one [batch, heads, rows, dh] operand, boxes of box_rows x 64
// columns; a batch-broadcast view (batch stride 0) is mapped with one batch
// entry, and bit t of *mask set.
inline int operand_map(CUtensorMap* map, const void* base, const Strides& s,
                       int batch, int heads, int rows, int dh, int box_rows,
                       int t, int* mask) {
  if (s.b == 0 && batch > 1) {
    *mask |= 1 << t;
    batch = 1;
  }
  return fwd90::kv_map(map, base, s, batch, heads, rows, dh, box_rows,
                       kBlock);
}

namespace {
template <bool SELF, bool LSE, int QB, bool BIAS>
int smem_set[fwd90::kMaxDevices] = {};
}  // namespace

// QB: Q's resident column blocks (0: streamed)
template <bool SELF, bool LSE, int QB, bool BIAS>
int launch_ring(const ColsParams& p, const CUtensorMap (&maps)[4], int mask,
                cudaStream_t stream) {
  constexpr int smem = Ring<QB>::kSmem;
  auto kernel = cols_kernel<SELF, LSE, QB, BIAS>;
  int device = 0;
  int err = (int)cudaGetDevice(&device);
  if (err != 0) return err;
  if (device >= fwd90::kMaxDevices) return (int)cudaErrorInvalidDevice;
  int& allowed = smem_set<SELF, LSE, QB, BIAS>[device];
  if (allowed < smem) {
    err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != 0) return err;
    allowed = smem;
  }
  const long long blocks =
      (long long)p.batch * p.heads * ((p.nq + kRows - 1) / kRows);
  const dim3 grid((unsigned)blocks, (p.dh + kSlice - 1) / kSlice);
  kernel<<<grid, kThreads, smem, stream>>>(p, maps[0], maps[1], maps[2],
                                           maps[3], mask);
  return (int)cudaGetLastError();
}

template <bool SELF, bool LSE, bool BIAS>
int launch_cluster(const ColsParams& p, const CUtensorMap (&maps)[4],
                   int mask, cudaStream_t stream);

// The bf16 route of head dim dh: the slices of a query tile as one cluster
// from 513 to 2048 (3 to kMaxCluster slices; ops/flash_mha.py's
// CLUSTER_DIMS names it); else one block a slice, Q resident up to head
// dim 512, streamed past 2048. A portable cluster holds 8 blocks.
constexpr int kMaxCluster = 8;
inline bool on_cluster(int dh) {
  const int ns = (dh + kSlice - 1) / kSlice;
  return ns >= 3 && ns <= kMaxCluster;
}

template <bool SELF, bool LSE, bool BIAS = false>
int launch(const ColsParams& p, cudaStream_t stream) {
  const long long blocks =
      (long long)p.batch * p.heads * ((p.nq + kRows - 1) / kRows);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  CUtensorMap tm_q, tm_k, tm_v, tm_kq;
  int mask = 0;
  int err = operand_map(&tm_q, p.q, p.sq, p.batch, p.heads, p.nq, p.dh,
                        kRows, 0, &mask);
  if (err == 0)
    err = operand_map(&tm_k, p.k, p.sk, p.batch, p.heads, p.nk, p.dh, kKeys,
                      1, &mask);
  if (err == 0)
    err = operand_map(&tm_v, p.v, p.sv, p.batch, p.heads, p.nk, p.dh, kKeys,
                      2, &mask);
  if (err == 0 && SELF)
    err = operand_map(&tm_kq, p.kq, p.skq, p.batch, p.heads, p.nq, p.dh,
                      kRows, 3, &mask);
  if (err != 0) return err;
  if (!SELF) tm_kq = tm_q;   // unused
  const CUtensorMap maps[4] = {tm_q, tm_k, tm_v, tm_kq};
  if (on_cluster(p.dh))
    return launch_cluster<SELF, LSE, BIAS>(p, maps, mask, stream);
  const int nc = (p.dh + kBlock - 1) / kBlock;
  if constexpr (SELF) {
    if (nc <= kSelfResBlocks)
      return launch_ring<SELF, LSE, kSelfResBlocks, BIAS>(p, maps, mask,
                                                          stream);
  }
  if (nc <= kResBlocks)
    return launch_ring<SELF, LSE, kResBlocks, BIAS>(p, maps, mask, stream);
  return launch_ring<SELF, LSE, 0, BIAS>(p, maps, mask, stream);
}

// ---- the cluster route (bf16, head dims 513-2048) ----
//
// The slices of one query tile form a thread-block cluster along the grid's
// y axis (ns = ceil(dh / 256) blocks, at most kMaxCluster: a portable
// cluster). Block rank r keeps Q's columns [256 r, 256 r + 256) resident in
// shared memory (64 KB), and per 64-key tile streams K's columns of its
// slice (one 32 KB item) and its V slice (another) through a four-stage
// TMA ring; it forms the partial scores over its columns, P_r = Q_r K_r^T,
// and the blocks sum them through distributed shared memory (`exchange`:
// a reduce-scatter in rank order, P_0 + P_1 + ..., then an all-gather),
// so every slice holds bit-identical scores S, the same probabilities and
// one lse, and Q K^T is formed once per query tile. Kernel 4's bias and
// mask start rank 0's partial (at (bias + mask) / scale); kernel 1's self
// score is summed the same way before the first key tile. The exchange
// and the softmax of tile kt run while the block's PV product of tile
// kt - 1 runs.
// What bounds it on the H100: the products, 4 S^2 dh flops per (batch,
// head) (80.6 GFLOP at [8, 1, 1568, 1024], 0.0815 ms at 989 TFLOP/s),
// which the cluster does once; besides them each block reads 2 (ns - 1) /
// ns of a 32 KB partial from other SMs a key tile (computed).
constexpr int kClStages = 4;
constexpr int kClBlocks = kSlice / kBlock;        // column blocks a slice
constexpr int kXBytes = kThreads * (kKeys / 2) * 4;   // one partial: 32 KB
// Q's slice | X | stages | full and empty barriers, Q's | alignment slack
constexpr int kClSmem = kClBlocks * kQBox + kXBytes +
                        kClStages * kStageBytes + 16 * kClStages + 8 + 1024;

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// the address of the same shared variable in the cluster's block `rank`
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ float4 ld_cluster(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// One exchange of the partials x[N] (N a multiple of 4; each thread's own
// values at the same place in every block): wait until every block has
// read the previous exchange (AFTER), write x into this block's X, make
// it visible to the cluster; then a reduce-scatter (block r sums the
// float4 columns j with j % ns == r over the ns blocks' X in rank order,
// in place) and an all-gather (x = each sum, read from its owner), and
// say this block has read them. Each block reads 2 (ns - 1) / ns of a
// partial from other blocks, with three cluster barriers an exchange; at
// [8, 1, 1568, 1024] 0.64 ms against 0.95 for every block reading every
// partial (`python -m tim_tpu_torch.ablate --kernel 5 --head_dim 1024`).
template <bool AFTER, int N>
__device__ __forceinline__ void exchange(float (&x)[N], unsigned char* x_buf,
                                         uint32_t s_x, int ns, int rank) {
  const int tid = threadIdx.x;
  float4* xb = reinterpret_cast<float4*>(x_buf);
  const uint32_t mine = s_x + (uint32_t)tid * 16;
  __syncwarp();
  if constexpr (AFTER) cluster_wait();
#pragma unroll
  for (int j = 0; j < N / 4; ++j)
    xb[j * kThreads + tid] =
        make_float4(x[4 * j], x[4 * j + 1], x[4 * j + 2], x[4 * j + 3]);
  cluster_arrive();
  cluster_wait();
  // [reduce-scatter]
  // this block's share of the sums, in place (no other block reads these
  // columns of its X)
  for (int j = rank; j < N / 4; j += ns) {
    float4 v = ld_cluster(map_rank(mine + j * kThreads * 16, 0));
    for (int r = 1; r < ns; ++r)
      add4(v, ld_cluster(map_rank(mine + j * kThreads * 16, r)));
    xb[j * kThreads + tid] = v;
  }
  cluster_arrive();
  cluster_wait();
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    const float4 v = ld_cluster(map_rank(mine + j * kThreads * 16, j % ns));
    x[4 * j] = v.x;
    x[4 * j + 1] = v.y;
    x[4 * j + 2] = v.z;
    x[4 * j + 3] = v.w;
  }
  // [/reduce-scatter]
  cluster_arrive();
}
// after the last exchange: every block has read this one's X (so that it
// may exit)
__device__ __forceinline__ void exchange_done() {
  __syncwarp();
  cluster_wait();
}

template <bool SELF, bool LSE, bool BIAS>
__global__ void __launch_bounds__(kThreads, 1)
    cluster_kernel(const ColsParams p,
                   const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_kq,
                   const int bmask) {
  using bf = __nv_bfloat16;
  constexpr int NS = kClStages;
  extern __shared__ unsigned char dyn_smem[];
  const uint32_t raw = sm90::smem_u32(dyn_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = dyn_smem + (base - raw);
  const uint32_t s_q = base;                       // Q's slice, 4 blocks
  const uint32_t s_x = s_q + kClBlocks * kQBox;    // the partial's buffer
  const uint32_t s_ring = s_x + kXBytes;
  const uint32_t s_bar = s_ring + NS * kStageBytes;
  const uint32_t q_bar = s_bar + 16 * NS;
  unsigned char* x_buf = gbase + (s_x - base);
  auto stage = [&](int i) { return s_ring + (i % NS) * kStageBytes; };
  auto full = [&](int i) { return s_bar + 8 * (i % NS); };
  auto empty = [&](int i) { return s_bar + 8 * (NS + i % NS); };

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int n_q = (p.nq + kRows - 1) / kRows;
  const int bh = blockIdx.x / n_q;
  const int h = bh / p.batch, b = bh % p.batch;   // head-major
  const int q0 = (blockIdx.x % n_q) * kRows;
  const int rank = (int)cluster_rank();            // the slice
  const int ns = (int)gridDim.y;                   // blocks a cluster
  const int c0 = rank * kSlice;                    // this block's columns
  const int nc = (p.dh + kBlock - 1) / kBlock;
  const int ncr = min(kClBlocks, nc - rank * kClBlocks);   // its blocks
  const int n_kt = (p.nk + kKeys - 1) / kKeys;
  const int n_self = SELF ? (ncr + 1) / 2 : 0;     // kq items, 2 blocks each
  const int total = n_self + 2 * n_kt;
  const int bq = bcoord(bmask, 0, b), bk = bcoord(bmask, 1, b);
  const int bv = bcoord(bmask, 2, b), bkq = bcoord(bmask, 3, b);

  if (tid == 0) {
    for (int i = 0; i < NS; ++i) {
      mbar_init(full(i), 1);
      mbar_init(empty(i), kThreads);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // zeros in Q's blocks past ncr and in the ring: the blocks of an item
  // past ncr are never loaded and meet zero Q columns in the products
  for (uint32_t i = tid * 16; i < (uint32_t)(s_ring - s_q) + NS * kStageBytes;
       i += kThreads * 16)
    if ((i < (uint32_t)(kClBlocks * kQBox) && i >= (uint32_t)(ncr * kQBox)) ||
        i >= (uint32_t)(s_ring - s_q))
      *reinterpret_cast<uint4*>(gbase + i) = make_uint4(0, 0, 0, 0);
  sm90::fence_async_smem();   // before TMA writes beside them
  __syncthreads();

  // item i: kq's blocks 2i, 2i + 1 of the slice (SELF), then per key tile
  // its K blocks of the slice and its V slice
  auto load = [&](int i) {
    if (i >= NS) mbar_wait(empty(i), (i / NS - 1) & 1);
    const uint32_t st = stage(i);
    if (i < n_self) {
      const int n = min(2, ncr - 2 * i);
      mbar_expect_tx(full(i), n * kQBox);
      for (int cb = 0; cb < n; ++cb)
        tma_load_4d(st + cb * kQBox, &tm_kq, c0 + (2 * i + cb) * kBlock, q0,
                    h, bkq, full(i));
      return;
    }
    const int j = i - n_self, kt = j / 2;
    const CUtensorMap* map = j % 2 == 0 ? &tm_k : &tm_v;
    mbar_expect_tx(full(i), ncr * kKBox);
    for (int cb = 0; cb < ncr; ++cb)
      tma_load_4d(st + cb * kKBox, map, c0 + cb * kBlock, kt * kKeys, h,
                  j % 2 == 0 ? bk : bv, full(i));
  };
  int issued = 0;
  // thread 0 keeps the ring full: items up to `upto` (each waits for the
  // item NS before it, which this thread has released)
  auto topup = [&](int upto) {
    if (tid == 0)
      while (issued < min(total, upto + 1)) load(issued++);
    __syncwarp();   // the warp converges before its next wgmma
  };
  if (tid == 0) {
    mbar_expect_tx(q_bar, ncr * kQBox);
    for (int cb = 0; cb < ncr; ++cb)
      tma_load_4d(s_q + cb * kQBox, &tm_q, c0 + cb * kBlock, q0, h, bq,
                  q_bar);
  }
  topup(NS - 1);
  auto acquire = [&](int i) {
    mbar_wait(full(i), (i / NS) & 1);
    return stage(i);
  };
  auto release = [&](int i) {
    mbar_arrive(empty(i));
    topup(i + NS);
  };
  mbar_wait(q_bar, 0);

  const int g = lane / 4, tig = lane % 4;
  const int lrow0 = wg * 64 + warp * 16 + g;   // rows lrow0, lrow0 + 8
  // kernel 1: the self scores q . kq over every column (raw dots): this
  // slice's share, summed over the cluster
  float self[4] = {0.f, 0.f, 0.f, 0.f};
  if constexpr (SELF) {
    for (int i = 0; i < n_self; ++i) {
      const uint32_t st = acquire(i);
      for (int cb = 0; cb < min(2, ncr - 2 * i); ++cb) {
        const uint32_t sq = s_q + (2 * i + cb) * kQBox;
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int ch = 2 * tig; ch < 2 * tig + 2; ++ch) {
            const uint32_t off = fwd90::swz<64>(lrow0 + 8 * r, ch);
            float x[8], y[8];
            tim::load_floats<bf, 8>(
                reinterpret_cast<const bf*>(gbase + (sq - base) + off), x);
            tim::load_floats<bf, 8>(
                reinterpret_cast<const bf*>(gbase + (st - base) +
                                            cb * kQBox + off),
                y);
#pragma unroll
            for (int e = 0; e < 8; ++e) self[r] = fmaf(x[e], y[e], self[r]);
          }
      }
      release(i);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      self[r] += __shfl_xor_sync(0xffffffffu, self[r], 1);
      self[r] += __shfl_xor_sync(0xffffffffu, self[r], 2);
    }
    exchange<false>(self, x_buf, s_x, ns, rank);
  }

  fwd90::RowCtx rc;
  rc.scale = p.scale;
  rc.c = p.scale * 1.4426950408889634f;
  rc.tig = tig;
  rc.masked = false;
  rc.pairs = true;
  const float nobias[1] = {0.f};
  // kernel 4 (rank 0): the head's bias, the rows and their region ids;
  // its partial starts at (bias + mask) / scale
  const float inv_scale = 1.f / p.scale;
  const float* head_bias =
      BIAS ? p.bias + (long long)h * p.nq * p.nk : nullptr;
  const int* region = BIAS && p.region != nullptr
                          ? p.region + (long long)(b % p.n_win) * p.nk
                          : nullptr;
  int bias_rows[2] = {0, 0}, region_row[2] = {0, 0};
  if constexpr (BIAS) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      bias_rows[r] = min(q0 + lrow0 + 8 * r, p.nq - 1);
      if (region != nullptr) region_row[r] = region[bias_rows[r]];
    }
  }
  float sc[kKeys / 2], o[kClBlocks][kBlock / 2];
  uint32_t pa[kKeys / 16][4];
  float m[2] = {SELF ? self[0] : TIM_NEG_INF, SELF ? self[1] : TIM_NEG_INF};
  float l[2] = {0.f, 0.f}, corr[2];
#pragma unroll
  for (int j = 0; j < kClBlocks; ++j)
#pragma unroll
    for (int i = 0; i < kBlock / 2; ++i) o[j][i] = 0.f;
  auto k_item = [&](int kt) { return n_self + 2 * kt; };

  // one key tile: its partial scores (rank 0's starting at kernel 4's
  // (bias + mask) / scale) and, past the first, the PV product of the
  // tile before, which runs while the partials are exchanged and the
  // softmax step works (FIRST: tile 0, peeled so that no product is
  // issued on a branch)
  auto tile = [&](int kt, auto first) {
    constexpr bool FIRST = decltype(first)::value;
    if (BIAS && rank == 0) {
      fwd90::score_bias<false>(sc, head_bias, region, bias_rows, region_row,
                               kt * kKeys, tig, p.nk, inv_scale);
    } else {
#pragma unroll
      for (int i = 0; i < kKeys / 2; ++i) sc[i] = 0.f;
    }
    // K of tile kt, and V of tile kt - 1
    const uint32_t sk = acquire(k_item(kt));
    const uint32_t sv = FIRST ? 0u : acquire(k_item(kt - 1) + 1);
    sm90::wg_fence();
    // [partial products]
#pragma unroll
    for (int cb = 0; cb < kClBlocks; ++cb) {
      const uint64_t dq =
          fwd90::desc<64>(s_q + cb * kQBox + wg * 64 * kBlock * 2);
      const uint64_t dk = fwd90::desc<64>(sk + cb * kKBox);
#pragma unroll
      for (int kk = 0; kk < kBlock / 16; ++kk)
        sm90::wgmma_ss<0, 0, true>(sc, dq + 2 * kk, dk + 2 * kk);
    }
    sm90::wg_commit();
    // [/partial products]
    if constexpr (!FIRST) {
      // [pv product]
      fwd90::issue_pv<kSlice, kKeys, kClBlocks>(o, pa, fwd90::desc<64>(sv));
      // [/pv product]
      sm90::wg_commit();
      sm90::wg_wait<1>();   // the partial done; the PV product still runs
    } else {
      sm90::wg_wait<0>();
    }
    sm90::fence_regs(sc);
    // [exchange]
    exchange<SELF || !FIRST>(sc, x_buf, s_x, ns, rank);
    // [/exchange]
    fwd90::softmax_tile<kKeys, false>(sc, m, l, corr, rc, nobias, nullptr,
                                      kt * kKeys, p.nk);
    if constexpr (!FIRST) {
      sm90::wg_wait<0>();
#pragma unroll
      for (int j = 0; j < kClBlocks; ++j) sm90::fence_regs(o[j]);
      sm90::fence_regs(pa);
      release(k_item(kt - 1) + 1);   // V of tile kt - 1
    }
    release(k_item(kt));             // K of tile kt
    fwd90::rescale(o, corr);
    fwd90::pack_p<kKeys>(sc, pa);
  };
  tile(0, std::true_type{});
  for (int kt = 1; kt < n_kt; ++kt) tile(kt, std::false_type{});
  {
    const uint32_t sv = acquire(k_item(n_kt - 1) + 1);
    sm90::wg_fence();
    // [last pv product]
    fwd90::issue_pv<kSlice, kKeys, kClBlocks>(o, pa, fwd90::desc<64>(sv));
    // [/last pv product]
    sm90::wg_commit();
    sm90::wg_wait<0>();
#pragma unroll
    for (int j = 0; j < kClBlocks; ++j) sm90::fence_regs(o[j]);
    sm90::fence_regs(pa);
  }

  bf* out = static_cast<bf*>(p.out) + b * p.so.b + h * p.so.h;
  const bf* vq = SELF ? static_cast<const bf*>(p.vq) + b * p.svq.b +
                            h * p.svq.h
                      : nullptr;
  float inv[2], w_self[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float e = SELF ? sm90::ex2((self[r] - m[r]) * rc.c) : 0.f;
    inv[r] = 1.f / (l[r] + e);
    w_self[r] = e * inv[r];
    const int row = q0 + lrow0 + 8 * r;
    if constexpr (LSE) {
      if (rank == 0 && tig == 0 && row < p.nq)
        p.lse[((long long)b * p.heads + h) * p.nq + row] =
            m[r] * p.scale + logf(l[r]);
    }
  }
#pragma unroll
  for (int j = 0; j < kClBlocks; ++j)
#pragma unroll
    for (int i = 0; i < kBlock / 2; i += 2) {
      const int r = (i >> 1) & 1;
      const int row = q0 + lrow0 + 8 * r;
      const int col = c0 + j * kBlock + (i / 4) * 8 + 2 * tig;
      if (row >= p.nq || col >= p.dh) continue;
      float x0 = o[j][i] * inv[r], x1 = o[j][i + 1] * inv[r];
      if constexpr (SELF) {
        const __nv_bfloat162 v2 = *reinterpret_cast<const __nv_bfloat162*>(
            vq + row * p.svq.n + col);
        x0 = fmaf(w_self[r], __low2float(v2), x0);
        x1 = fmaf(w_self[r], __high2float(v2), x1);
      }
      *reinterpret_cast<uint32_t*>(out + row * p.so.n + col) =
          pack_bf16(x0, x1);
    }
  // [exchange done]
  exchange_done();
  // [/exchange done]
}

namespace {
template <bool SELF, bool LSE, bool BIAS>
int cluster_smem_set[fwd90::kMaxDevices] = {};
}  // namespace

// The slices of each query tile as one cluster (ns = ceil(dh / 256)
// blocks, `on_cluster`). A launch the card refuses returns its error.
template <bool SELF, bool LSE, bool BIAS>
int launch_cluster(const ColsParams& p, const CUtensorMap (&maps)[4],
                   int mask, cudaStream_t stream) {
  const int ns = (p.dh + kSlice - 1) / kSlice;
  auto kernel = cluster_kernel<SELF, LSE, BIAS>;
  int device = 0;
  int err = (int)cudaGetDevice(&device);
  if (err != 0) return err;
  if (device >= fwd90::kMaxDevices) return (int)cudaErrorInvalidDevice;
  int& allowed = cluster_smem_set<SELF, LSE, BIAS>[device];
  if (allowed < kClSmem) {
    err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kClSmem);
    if (err != 0) return err;
    allowed = kClSmem;
  }
  const long long blocks =
      (long long)p.batch * p.heads * ((p.nq + kRows - 1) / kRows);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks, (unsigned)ns, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = kClSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = (unsigned)ns;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = (int)cudaLaunchKernelEx(&cfg, kernel, p, maps[0], maps[1], maps[2],
                                maps[3], mask);
  if (err != 0) return err;
  return (int)cudaGetLastError();
}

}  // namespace cols90

// ---- fp32 (CUDA cores) ----
//
// One thread a query row, 128 rows a block, 64 output columns a block
// (grid axis y); each 32-key tile's scores sum over 64-column chunks of q
// (in shared memory, rows padded to 65 floats: a warp's 32 rows in 32
// banks) and of k, so any head dim fits; then the online softmax step and
// the block's 64 output columns. Kernel 1's self score comes first, from q
// and kq's chunks, and starts the running max.
constexpr int kColsF32Rows = 128, kColsF32Keys = 32, kColsF32Dims = 64;
constexpr int kColsF32Smem =
    (2 * kColsF32Rows * (kColsF32Dims + 1) +
     2 * kColsF32Keys * kColsF32Dims) * 4;

// rows [row0, row0 + n) x columns [col0, col0 + 64) of a [rows, dh] fp32
// operand (row stride ld) into dst (row pitch pitch); rows past `end` and
// columns past dh are zeros
__device__ __forceinline__ void load_f32_block(float* dst, int pitch,
                                               const float* src,
                                               long long ld, int row0, int n,
                                               int end, int col0, int dh,
                                               int tid, int threads) {
  for (int i = tid; i < n * kColsF32Dims; i += threads) {
    const int r = i / kColsF32Dims, c = i % kColsF32Dims;
    const int row = row0 + r, col = col0 + c;
    dst[r * pitch + c] = row < end && col < dh ? src[row * ld + col] : 0.f;
  }
}

template <bool SELF, bool LSE, bool BIAS = false>
__global__ void __launch_bounds__(128) cols_f32_kernel(const ColsParams p) {
  constexpr int BQ = kColsF32Rows, BK = kColsF32Keys, DC = kColsF32Dims;
  constexpr int LQ = DC + 1;
  extern __shared__ __align__(16) float cols_smem[];
  float* s_q = cols_smem;          // [BQ][LQ]: a chunk of the rows' q
  float* s_x = s_q + BQ * LQ;      // [BQ][LQ]: kq's chunk (SELF)
  float* s_k = s_x + BQ * LQ;      // [BK][DC]: a chunk of the key tile
  float* s_v = s_k + BK * DC;      // [BK][DC]: the block's columns of v

  const int n_q = (p.nq + BQ - 1) / BQ;
  const int bh = blockIdx.x / n_q;
  const int h = bh / p.batch, b = bh % p.batch;
  const int q0 = (blockIdx.x % n_q) * BQ, d0 = blockIdx.y * DC;
  const int tid = threadIdx.x, row = q0 + tid;
  const float* q = static_cast<const float*>(p.q) + b * p.sq.b + h * p.sq.h;
  const float* k = static_cast<const float*>(p.k) + b * p.sk.b + h * p.sk.h;
  const float* v = static_cast<const float*>(p.v) + b * p.sv.b + h * p.sv.h;
  const float* qs = s_q + tid * LQ;
  // kernel 4: the row's bias and region id
  const int rc = min(row, p.nq - 1);
  const int* region = BIAS && p.region != nullptr
                          ? p.region + (long long)(b % p.n_win) * p.nk
                          : nullptr;
  const float* bias_row =
      BIAS ? p.bias + ((long long)h * p.nq + rc) * p.nk : nullptr;
  const int region_row = region != nullptr ? region[rc] : 0;

  float self = 0.f;
  if constexpr (SELF) {
    const float* kq =
        static_cast<const float*>(p.kq) + b * p.skq.b + h * p.skq.h;
    for (int c = 0; c < p.dh; c += DC) {
      __syncthreads();
      load_f32_block(s_q, LQ, q, p.sq.n, q0, BQ, p.nq, c, p.dh, tid, 128);
      load_f32_block(s_x, LQ, kq, p.skq.n, q0, BQ, p.nq, c, p.dh, tid, 128);
      __syncthreads();
#pragma unroll 8
      for (int d = 0; d < DC; ++d) self = fmaf(qs[d], s_x[tid * LQ + d], self);
    }
    self *= p.scale;
  }
  float acc[DC];
#pragma unroll
  for (int d = 0; d < DC; ++d) acc[d] = 0.f;
  float m = SELF ? self : TIM_NEG_INF, l = 0.f;

  for (int k0 = 0; k0 < p.nk; k0 += BK) {
    float s[BK];
#pragma unroll
    for (int j = 0; j < BK; ++j) s[j] = 0.f;
    for (int c = 0; c < p.dh; c += DC) {
      __syncthreads();
      load_f32_block(s_q, LQ, q, p.sq.n, q0, BQ, p.nq, c, p.dh, tid, 128);
      load_f32_block(s_k, DC, k, p.sk.n, k0, BK, p.nk, c, p.dh, tid, 128);
      __syncthreads();
#pragma unroll
      for (int j = 0; j < BK; ++j) {
        float dot = s[j];
#pragma unroll 16
        for (int d = 0; d < DC; ++d) dot = fmaf(qs[d], s_k[j * DC + d], dot);
        s[j] = dot;
      }
    }
    __syncthreads();
    load_f32_block(s_v, DC, v, p.sv.n, k0, BK, p.nk, d0, p.dh, tid, 128);
    __syncthreads();
    float mx = TIM_NEG_INF;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float x = TIM_NEG_INF;
      if (k0 + j < p.nk) {
        x = s[j] * p.scale;
        if constexpr (BIAS) {
          x += bias_row[k0 + j];
          if (region != nullptr && region[k0 + j] != region_row)
            x += kMaskValue;
        }
      }
      s[j] = x;
      mx = fmaxf(mx, s[j]);
    }
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    m = m_new;
    l *= corr;
#pragma unroll
    for (int d = 0; d < DC; ++d) acc[d] *= corr;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float pj = expf(s[j] - m);
      l += pj;
#pragma unroll
      for (int d = 0; d < DC; ++d) acc[d] = fmaf(pj, s_v[j * DC + d], acc[d]);
    }
  }

  if (row < p.nq) {
    const float e = SELF ? expf(self - m) : 0.f;
    const float inv = 1.f / (l + e);
    if constexpr (LSE) {
      if (blockIdx.y == 0)
        p.lse[((long long)b * p.heads + h) * p.nq + row] = m + logf(l);
    }
    float* out = static_cast<float*>(p.out) + b * p.so.b + h * p.so.h +
                 row * p.so.n;
    const float* vq = SELF ? static_cast<const float*>(p.vq) + b * p.svq.b +
                                 h * p.svq.h + row * p.svq.n
                           : nullptr;
#pragma unroll
    for (int d = 0; d < DC; ++d) {
      const int col = d0 + d;
      if (col < p.dh)
        out[col] = SELF ? fmaf(e * inv, vq[col], acc[d] * inv) : acc[d] * inv;
    }
  }
}

template <bool SELF, bool LSE, bool BIAS = false>
int launch_cols_f32(const ColsParams& p, cudaStream_t stream) {
  const long long blocks = (long long)p.batch * p.heads *
                           ((p.nq + kColsF32Rows - 1) / kColsF32Rows);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  auto kernel = cols_f32_kernel<SELF, LSE, BIAS>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kColsF32Smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)blocks,
                  (p.dh + kColsF32Dims - 1) / kColsF32Dims);
  kernel<<<grid, kColsF32Rows, kColsF32Smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// One launch of the column-slice route: bf16 on the wgmma kernels (the
// slices of a query tile as one cluster at the head dims `on_cluster`
// takes, else one block a slice), fp32 on the CUDA cores; SELF (kernel 1)
// when kq is given, the lse store when lse is; BIAS: kernel 4's bias and
// region ids (no SELF). Returns cudaGetLastError() after the launch (0 on
// success).
template <bool SELF, bool BIAS = false>
int launch_cols(const ColsParams& p, bool bf16, cudaStream_t stream) {
  if (p.batch <= 0 || p.heads <= 0 || p.nq <= 0 || p.nk <= 0 || p.dh <= 0)
    return 0;
  const bool lse = p.lse != nullptr;
  if constexpr (SELF) {
    if (lse) return (int)cudaErrorInvalidValue;
    return bf16 ? cols90::launch<true, false>(p, stream)
                : launch_cols_f32<true, false>(p, stream);
  } else {
    if (bf16)
      return lse ? cols90::launch<false, true, BIAS>(p, stream)
                 : cols90::launch<false, false, BIAS>(p, stream);
    return lse ? launch_cols_f32<false, true, BIAS>(p, stream)
               : launch_cols_f32<false, false, BIAS>(p, stream);
  }
}

}  // namespace tim_attn
