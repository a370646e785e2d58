// Swin3D (shifted-)window attention, forward, bf16, at head dims 33-64 on
// Hopper (sm_90a): kernel 4's own design past head dim 32 (instances 48
// and 64, window_attention_64.cu), in place of kernel 5's core given the
// bias. The function is flash_attention_sm90.cuh's with kernel 4's terms:
//
//   s_ij = (q_i . k_j) * scale + bias[h, i, j]
//          - 100 * (region[w, i] != region[w, j]),  w = b % n_win,
//
// fp32 scores and running statistics, the unnormalised probabilities
// rounded to bf16 before the PV product, the output in bf16, the row
// log-sum-exp for the backward in a compile-time variant (LSE).
//
// What bounds it on the H100: at a Swin-B-shaped trunk's stage 1 with
// head dim 64 ([512, 2, 784, 64], batch 8) the products are 161 GFLOP
// (0.163 ms at 989 TFLOP/s) and the 629 M scores take one exponential
// each (0.15 ms of the SM's 16-a-clock unit), computed from shapes. Each
// score also adds an fp32 bias: 2.5 GB if every window read its bias
// rows, 1.26 GB with one read for each pair of windows.
//
// What the core it replaces did about it, and why that lost: kernel 5's
// core given the bias read each thread's bias values from L2 into
// registers a tile ahead (32 more registers a thread, 214-252 in all at
// head dim 64: one block an SM, whose per-block start and per-score
// stalls nothing hid), and sent head dims 40, 48 and 56 through a
// zero-padded copy to its 64 instance.
//
// Design: a block takes 64 query rows of a pair of windows (the same rows
// of both, so the same bias rows), one warpgroup a window, Q (both
// windows' rows) loaded once into shared memory. One ring of NS stages
// feeds both warpgroups: a stage holds key tile kt of both windows' K and
// V and the [64 rows x BK keys] fp32 bias tile they share, all brought by
// TMA from one thread (the bias as 32-column boxes in the 128-byte
// swizzle, so that a warp's 8-byte reads of its score pairs meet no bank
// conflict), one mbarrier that says the stage landed and one that both
// warpgroups are done with it. The softmax step reads each score's bias
// from shared memory as it adds it (x * scale + bias, as the other bf16
// instances compute it), so no register holds bias values across the
// products. Per key tile each warpgroup issues S_kt = Q K_kt^T and O +=
// P_{kt-1} V_{kt-1} (wgmma), runs tile kt's softmax while the PV product
// runs, then rescales O and repacks P (flash_attention_sm90.cuh's
// overlap). A shifted window whose tokens lie in one region skips the
// region compare. Head dims 40 and 48 run on the 48 instance (a 32- and a
// 16-column block per tile, Cols), 56 and 64 on the 64 instance; the TMA
// maps span the head dim passed and fill the columns past it with zeros,
// so those head dims are read in place.
//
// The bias map needs rows of a multiple of 16 bytes: the wrapper passes
// the bias's row pitch (the sequence rounded up to 4 floats; a sequence
// off a multiple of 4 gets a padded copy of the bias from the wrapper).

#pragma once

#include "flash_attention_sm90.cuh"

namespace tim_attn {
namespace win90 {

using fwd90::Cols;
using fwd90::desc;
using fwd90::mbar_arrive;
using fwd90::mbar_expect_tx;
using fwd90::mbar_init;
using fwd90::mbar_wait;
using fwd90::tile_at;
using fwd90::tma_load_4d;

constexpr int kThreads = 256;   // two warpgroups, one window of the pair each
constexpr int kRows = 64;       // query rows a window a block
constexpr int kQRows = 128;     // Q's rows in shared memory: both windows'

// a box of a 3-d tensor map into shared memory, completing on bar
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

// The tiles and ring of an instance: BK keys a tile, NS ring stages,
// MINB blocks an SM (the register cap __launch_bounds__ gives ptxas).
template <int DH, int BK, int NS, int MINB>
struct Shape {
  static_assert(BK == 32 || BK == 64, "bias boxes are 32 keys wide");
  static constexpr int kQBytes = kQRows * DH * 2;
  static constexpr int kKVBytes = BK * DH * 2;         // one window's K or V
  static constexpr int kBiasBytes = kRows * BK * 4;    // the shared bias tile
  static constexpr int kBiasBox = kRows * 32 * 4;      // one 32-key box
  // a stage: K and V of window 0, K and V of window 1, the bias tile
  static constexpr int kStageBytes = 4 * kKVBytes + kBiasBytes;
  // tiles loaded ahead of the one in use: a load waits for the stage
  // released one iteration before (two with three or more stages)
  static constexpr int kAhead = NS > 2 ? NS - 2 : NS - 1;
  // Q | stages | full and empty barriers | alignment slack; the windows'
  // region ids are added at launch
  static constexpr int kSmem = kQBytes + NS * kStageBytes + 16 * NS + 1024;
};

// The softmax step of one key tile, in place on the fp32 scores (thread
// layout of flash_attention_sm90.cuh's softmax_tile): x * scale + the
// bias of the stage's tile (s_bias: [64][BK] fp32 as 32-column boxes in
// the 128-byte swizzle; lrow: this thread's first row in it), -100 where
// region ids differ (masked windows; sr: the window's ids, region_row: the
// thread's rows'), -inf past S, then the running max, its correction and
// the unnormalised probabilities with their running sums.
template <int BK>
__device__ __forceinline__ void softmax_bias(
    float (&sc)[BK / 2], float (&m)[2], float (&l)[2], float (&corr)[2],
    float scale, int tig, int lrow, const unsigned char* s_bias,
    bool masked, const int* sr, const int (&region_row)[2], int k0, int S) {
  constexpr float kLog2e = 1.4426950408889634f;
  const bool ragged = k0 + BK > S;
  float mx[2] = {TIM_NEG_INF, TIM_NEG_INF};
#pragma unroll
  for (int i = 0; i < BK / 2; i += 2) {
    const int r = (i >> 1) & 1;
    const int col = (i / 4) * 8 + 2 * tig;
    const int br = lrow + 8 * r;
    const float2 b2 = *reinterpret_cast<const float2*>(
        s_bias + (col / 32) * (kRows * 128) + br * 128 +
        ((((col % 32) >> 2) ^ (br & 7)) << 4) + (col & 3) * 4);
    float x0 = fmaf(sc[i], scale, b2.x);
    float x1 = fmaf(sc[i + 1], scale, b2.y);
    if (masked) {
      const int2 rr = *reinterpret_cast<const int2*>(sr + k0 + col);
      x0 += rr.x != region_row[r] ? kMaskValue : 0.f;
      x1 += rr.y != region_row[r] ? kMaskValue : 0.f;
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
    const float m_new = fmaxf(m[r], mx[r]);   // finite: key k0 < S
    corr[r] = sm90::ex2((m[r] - m_new) * kLog2e);
    m[r] = m_new;
    l[r] *= corr[r];
    mc[r] = m_new * kLog2e;
  }
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const int r = (i >> 1) & 1;
    const float pe = sm90::ex2(fmaf(sc[i], kLog2e, -mc[r]));   // -inf -> 0
    sc[i] = pe;
    l[r] += pe;
  }
}

template <int DH, int BK, int NS, int MINB, bool LSE>
__global__ void __launch_bounds__(kThreads, MINB)
    window_kernel(const Params p, const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  const __grid_constant__ fwd90::TailMaps<DH> tm_tail,
                  const __grid_constant__ CUtensorMap tm_bias) {
  using Sh = Shape<DH, BK, NS, MINB>;
  using Co = Cols<DH>;
  using bf = __nv_bfloat16;
  constexpr int NC = Co::kNC, BW = Co::kBW;
  constexpr int QB = kQRows * BW * 2, KVB = BK * BW * 2;
  constexpr int CH = DH * 2 / 16;   // 16-byte chunks of a row
  constexpr int AHEAD = Sh::kAhead;
  extern __shared__ unsigned char dyn_smem[];
  // 1024-byte aligned tiles (the swizzles repeat every 1024 bytes or less)
  const uint32_t raw = sm90::smem_u32(dyn_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = dyn_smem + (base - raw);
  const int S = p.seq, dh = p.dh;
  const int n_tiles = (S + BK - 1) / BK;
  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const uint32_t s_q = base;
  const uint32_t s_ring = base + Sh::kQBytes;
  const uint32_t s_bar = s_ring + NS * Sh::kStageBytes;
  auto stage = [&](int kt) { return s_ring + (kt % NS) * Sh::kStageBytes; };
  auto full = [&](int kt) { return s_bar + 8 * (kt % NS); };
  auto empty = [&](int kt) { return s_bar + 8 * (NS + kt % NS); };
  // after the barriers: each window's region ids, n_tiles * BK apiece
  int* s_region = reinterpret_cast<int*>(gbase + (s_bar + 16 * NS - base)) +
                  wg * n_tiles * BK;

  // the block: head-major, then window pair and 64-row tiles
  const int n_q = (S + kRows - 1) / kRows;
  const int n_b = (p.batch + 1) / 2;
  const long long bh = blockIdx.x / n_q;
  const int h = (int)(bh / n_b);
  const int q0 = (int)(blockIdx.x % n_q) * kRows;
  const int b0 = 2 * (int)(bh % n_b);
  const int b = b0 + wg;                 // this warpgroup's window
  const bool live = b < p.batch;         // an odd last pair: one window
  const int n_live = b0 + 1 < p.batch ? 2 : 1;
  const int* region = p.region != nullptr && live
                          ? p.region + (long long)(b % p.n_win) * S
                          : nullptr;

  if (tid == 0) {
    for (int st = 0; st < NS; ++st) {
      mbar_init(s_bar + 8 * st, 1);                       // full
      mbar_init(s_bar + 8 * (NS + st), n_live * 128);     // empty
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // key tile j of both windows and its bias tile into stage j % NS, by
  // TMA from thread 0 once every live thread is done with tile j - NS;
  // keys and rows past S read as zeros
  auto load = [&](int j) {
    if (tid == 0) {
      const uint32_t st = stage(j);
      if (j >= NS) mbar_wait(empty(j), (j / NS - 1) & 1);
      mbar_expect_tx(full(j), n_live * 2 * Sh::kKVBytes + Sh::kBiasBytes);
      for (int w = 0; w < n_live; ++w) {
        const uint32_t sk = st + w * 2 * Sh::kKVBytes;
        const uint32_t sv = sk + Sh::kKVBytes;
#pragma unroll
        for (int cb = 0; cb < NC; ++cb) {
          tma_load_4d(sk + cb * KVB, &tm_k, cb * BW, j * BK, h, b0 + w,
                      full(j));
          tma_load_4d(sv + cb * KVB, &tm_v, cb * BW, j * BK, h, b0 + w,
                      full(j));
        }
        if constexpr (Co::kT32) {
          tma_load_4d(sk + BK * Co::kC32 * 2, &tm_tail.m[0], Co::kC32,
                      j * BK, h, b0 + w, full(j));
          tma_load_4d(sv + BK * Co::kC32 * 2, &tm_tail.m[1], Co::kC32,
                      j * BK, h, b0 + w, full(j));
        }
        if constexpr (Co::kT16) {
          constexpr int m16 = Co::kT32 ? 2 : 0;
          tma_load_4d(sk + BK * Co::kC16 * 2, &tm_tail.m[m16], Co::kC16,
                      j * BK, h, b0 + w, full(j));
          tma_load_4d(sv + BK * Co::kC16 * 2, &tm_tail.m[m16 + 1],
                      Co::kC16, j * BK, h, b0 + w, full(j));
        }
      }
#pragma unroll
      for (int cb = 0; cb < BK / 32; ++cb)
        tma_load_3d(st + 4 * Sh::kKVBytes + cb * Sh::kBiasBox, &tm_bias,
                    j * BK + cb * 32, q0, h, full(j));
    }
    __syncwarp();   // the warp converges before its next wgmma
  };

  // the first tiles' loads go out before Q's and the region ids' (thread
  // 0 initialised the barriers, so it may use them at once)
#pragma unroll
  for (int j = 0; j < AHEAD; ++j)
    if (j < n_tiles) load(j);
  // Q: each window's 64 rows from q0 (rows past S and an absent window's
  // as zeros; columns past dh as zeros)
  for (int i = tid; i < kQRows * CH; i += kThreads) {
    const int r = i / CH, c = i % CH;
    const int rb = b0 + r / kRows, row = q0 + r % kRows;
    const bf* qr = static_cast<const bf*>(p.q) +
                   min(rb, p.batch - 1) * p.sq.b + h * p.sq.h +
                   min(row, S - 1) * p.sq.n;
    const bool in = c * 8 < dh;
    sm90::cp16(s_q + tile_at<DH, kQRows>(r, c), qr + (in ? c * 8 : 0),
               row < S && rb < p.batch && in ? 16 : 0);
  }
  // the windows' region ids, and whether each holds more than one region
  // (most shifted windows hold one: their mask is 0 and is skipped)
  int mixed = 0;
  if (region != nullptr) {
    const int first = region[0];
    for (int i = tid % 128; i < S; i += 128) {
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

  const float scale = p.scale;
  const int tig = lane % 4;
  const bool masked = (wg == 0 ? mixed0 : mixed1) != 0;
  // this thread's two rows: lrow and lrow + 8 of the tile's 64
  const int lrow = warp * 16 + lane / 4;
  const int row0 = q0 + lrow;
  int region_row[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    region_row[r] = region != nullptr ? region[min(row0 + 8 * r, S - 1)] : 0;

  float sc[BK / 2], o[NC][BW / 2];
  fwd90::TailAcc<DH> ot;
  uint32_t pa[BK / 16][4];
  float m[2] = {TIM_NEG_INF, TIM_NEG_INF}, l[2] = {0.f, 0.f}, corr[2];
#pragma unroll
  for (int j = 0; j < NC; ++j)
#pragma unroll
    for (int i = 0; i < BW / 2; ++i) o[j][i] = 0.f;
  ot.zero();
  const uint64_t dq = desc<BW>(s_q + wg * 64 * BW * 2);
  auto stage_k = [&](int kt) { return stage(kt) + wg * 2 * Sh::kKVBytes; };
  auto stage_v = [&](int kt) { return stage_k(kt) + Sh::kKVBytes; };
  auto bias_tile = [&](int kt) {
    return gbase + (stage(kt) + 4 * Sh::kKVBytes - base);
  };
  auto arrived = [&](int kt) { mbar_wait(full(kt), (kt / NS) & 1); };

  // tile 0: its scores and probabilities (O is still zero)
  arrived(0);
  sm90::wg_fence();
  fwd90::issue_s<DH, BK, QB, KVB>(sc, dq, desc<BW>(stage_k(0)));
  fwd90::issue_s_tail<DH, BK>(sc, s_q, wg, stage_k(0));
  sm90::wg_commit();
  sm90::wg_wait<0>();
  sm90::fence_regs(sc);
  softmax_bias<BK>(sc, m, l, corr, scale, tig, lrow, bias_tile(0), masked,
                   s_region, region_row, 0, S);
  fwd90::pack_p<BK>(sc, pa);
  if (AHEAD < n_tiles) load(AHEAD);

  for (int kt = 1; kt < n_tiles; ++kt) {
    arrived(kt);
    sm90::wg_fence();
    fwd90::issue_s<DH, BK, QB, KVB>(sc, dq, desc<BW>(stage_k(kt)));
    fwd90::issue_s_tail<DH, BK>(sc, s_q, wg, stage_k(kt));
    sm90::wg_commit();
    fwd90::issue_pv<DH, BK, NC>(o, pa, desc<BW>(stage_v(kt - 1)));
    fwd90::issue_pv_tail<DH, BK>(ot, pa, stage_v(kt - 1));
    sm90::wg_commit();
    sm90::wg_wait<1>();   // S_kt done; the PV product still runs
    sm90::fence_regs(sc);
    softmax_bias<BK>(sc, m, l, corr, scale, tig, lrow, bias_tile(kt),
                     masked, s_region, region_row, kt * BK, S);
    sm90::wg_wait<0>();
#pragma unroll
    for (int j = 0; j < NC; ++j) sm90::fence_regs(o[j]);
    fwd90::fence_tail(ot);
    sm90::fence_regs(pa);
    mbar_arrive(empty(kt - 1));   // done with tile kt - 1
    fwd90::rescale(o, corr);
    fwd90::rescale(ot, corr);
    fwd90::pack_p<BK>(sc, pa);
    if (kt + AHEAD < n_tiles) load(kt + AHEAD);
  }
  sm90::wg_fence();
  fwd90::issue_pv<DH, BK, NC>(o, pa, desc<BW>(stage_v(n_tiles - 1)));
  fwd90::issue_pv_tail<DH, BK>(ot, pa, stage_v(n_tiles - 1));
  sm90::wg_commit();
  sm90::wg_wait<0>();
#pragma unroll
  for (int j = 0; j < NC; ++j) sm90::fence_regs(o[j]);
  fwd90::fence_tail(ot);
  sm90::fence_regs(pa);

  bf* out = static_cast<bf*>(p.out) + b * p.so.b + h * p.so.h;
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / l[r];
    const int row = row0 + 8 * r;
    if constexpr (LSE) {
      if (tig == 0 && row < S)
        p.lse[((long long)b * p.heads + h) * S + row] = m[r] + logf(l[r]);
    }
  }
  // a column pair of an accumulator's element i: only those below the
  // head dim read are stored
  auto store = [&](int c0, int i, float x0, float x1) {
    const int r = (i >> 1) & 1;
    const int row = row0 + 8 * r;
    const int col = c0 + (i / 4) * 8 + 2 * tig;
    if (row < S && col < dh)
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

// The TMA map of the fp32 bias [heads, seq, seq] (rows `pitch` floats
// apart, a multiple of 4), boxes of 64 rows x 32 keys in the 128-byte
// swizzle; rows and keys past seq read as zeros. Returns a CUDA error code.
inline int bias_map(CUtensorMap* map, const float* bias, int heads, int seq,
                    int pitch) {
  const fwd90::EncodeTiled encode = fwd90::encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  if (pitch % 4 != 0 || pitch < seq) return (int)cudaErrorInvalidValue;
  cuuint64_t dims[3] = {(cuuint64_t)seq, (cuuint64_t)seq, (cuuint64_t)heads};
  cuuint64_t strides[2] = {(cuuint64_t)pitch * 4,
                           (cuuint64_t)pitch * seq * 4};
  cuuint32_t box[3] = {32, (cuuint32_t)kRows, 1};
  cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(bias),
      dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The dynamic shared memory each instance was allowed, per device (an
// anonymous-namespace variable: another build of this kernel, loaded
// beside this one, needs its own attribute).
namespace {
template <int DH, int BK, int NS, int MINB, bool LSE>
int smem_set[fwd90::kMaxDevices] = {};
}  // namespace

template <int DH, int BK, int NS, int MINB, bool LSE>
int launch(const Params& p, int bias_pitch, cudaStream_t stream) {
  using Sh = Shape<DH, BK, NS, MINB>;
  const int n_keys = (p.seq + BK - 1) / BK * BK;
  const int smem = Sh::kSmem + 4 * 2 * n_keys;
  const long long blocks = (long long)(p.batch + 1) / 2 * p.heads *
                           ((p.seq + kRows - 1) / kRows);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  CUtensorMap tm_k, tm_v, tm_bias;
  fwd90::TailMaps<DH> tm_tail;
  int err = fwd90::block_maps<DH>(&tm_k, &tm_tail.m[0], 2, p.k, p.sk,
                                  p.batch, p.heads, p.seq, p.dh, BK);
  if (err == 0)
    err = fwd90::block_maps<DH>(&tm_v, &tm_tail.m[1], 2, p.v, p.sv,
                                p.batch, p.heads, p.seq, p.dh, BK);
  if (err == 0) err = bias_map(&tm_bias, p.bias, p.heads, p.seq, bias_pitch);
  if (err != 0) return err;
  auto kernel = window_kernel<DH, BK, NS, MINB, LSE>;
  int device = 0;
  err = (int)cudaGetDevice(&device);
  if (err != 0) return err;
  if (device >= fwd90::kMaxDevices) return (int)cudaErrorInvalidDevice;
  int& allowed = smem_set<DH, BK, NS, MINB, LSE>[device];
  if (smem > allowed) {
    err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != 0) return err;
    allowed = smem;
  }
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(p, tm_k, tm_v,
                                                      tm_tail, tm_bias);
  return (int)cudaGetLastError();
}

}  // namespace win90

// Kernel 4 at bf16 instance DH (48 or 64) with its tiles (BK keys, NS
// stages, MINB blocks an SM), reading any head dim past 32 up to DH that
// is a multiple of 8 in place; lse written when given. Returns
// cudaGetLastError() after the launch (0 on success).
template <int DH, int BK, int NS, int MINB>
int launch_window_pair(const Params& p, int bias_pitch,
                       cudaStream_t stream) {
  if (p.batch <= 0 || p.heads <= 0 || p.seq <= 0) return 0;
  if (p.dh <= 32 || p.dh > DH || p.dh % 8 != 0)
    return (int)cudaErrorInvalidValue;
  return p.lse != nullptr
             ? win90::launch<DH, BK, NS, MINB, true>(p, bias_pitch, stream)
             : win90::launch<DH, BK, NS, MINB, false>(p, bias_pitch, stream);
}

}  // namespace tim_attn
