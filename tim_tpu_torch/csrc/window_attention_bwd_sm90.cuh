// Window attention, backward, bf16, for Hopper's warpgroup tensor-core
// products (wgmma, sm_90a): the bf16 route of window_attention_bwd.cu
// (kernel 4b), which replaces tim_tpu/ops/pallas_swin.py's _bwd_kernel.
//
// With s_ij = (q_i . k_j) * scale + bias[h, i, j] - 100 (region[w, i] !=
// region[w, j]), w = window % n_win, and the forward's row statistic lse_i:
//   p_ij = exp(s_ij - lse_i),  dp_ij = do_i . v_j,  D_i = do_i . o_i,
//   ds_ij = p_ij (dp_ij - D_i),
//   dv_j = sum_i p_ij do_i,  dk_j = sum_i (ds_ij scale) q_i,
//   dq_i = sum_j (ds_ij scale) k_j,  dbias[h, i, j] = sum over windows ds_ij,
// p and ds * scale rounded to bf16 before their products, every product
// summed in fp32 (the arithmetic of flash_attention_bwd.cuh, whose fp32
// kernels stay the parity path).
//
// What bounds it: at dh 32 a score carries 5 products of 64 flops (320),
// against one exponential, an fp32 bias read and (shifted windows) a
// region compare; at Swin-B's stage 1 ([512, 4, 784, 32]) that is 403
// GFLOP, 0.41 ms at the bf16 peak, and 1.26 G exponentials, 0.30 ms at 16
// a clock on 132 SMs. The per-score work, not the tensor cores, is the
// floor; the previous design paid it three times (three passes, 9
// products, 3 exponentials and 3 bias reads a score).
//
// Design: one pass, 5 products, one exponential and one bias read a
// score. A block owns one head, 64 keys and a group of consecutive
// windows, which it walks one after the other; its two warpgroups take
// alternate 64-row query tiles of each window (K and V of the window's 64
// keys in shared memory for both). Per query tile a warpgroup computes,
// with its keys as wgmma's M dimension:
//   S^T = K Q^T and dP^T = V dO^T   (both operands from shared memory),
//   P^T and dS^T in registers (one FMA and ex2 a score; S^T's
//   accumulator starts at the bias over the scale),
//   dV += P^T dO and dK += dS^T Q    (A from registers),
// stages dS^T (bf16, scaled) in its own buffer, where its dQ partial
// dS K over the 64 keys is one more product, added to a zeroed fp32
// [windows, heads, seq, dh] buffer with fp32 atomic adds and rounded by a
// postprocess (as kernel 5b: the order of the adds changes from run to
// run, so dq's last bits may; dk, dv and dbias are summed in a fixed order
// and do not). At the end of a window the two warpgroups' dK and dV are
// added through shared memory (warpgroup 1's into warpgroup 0's) and
// stored.
//
// dbias is summed without atomics: the block keeps the fp32 partial of its
// 64 key columns for every query row, each warpgroup adding its own query
// rows (so one thread adds to each element, in window order), and its
// slice of the output holds it at the end: dbias itself when one group
// covers the batch, else a [groups, heads, seq, seq] scratch that a short
// pass sums in a fixed order. The partial lives in shared memory (seq x
// 64 x 4 bytes, 200 KB at seq 784) and is written out once; a window of
// more tokens than that allows (791) keeps it in its output slice
// instead, read and written in place (a round trip to L2 a score: slower,
// and taken by no shipped configuration). The number of groups is chosen
// per shape so that the blocks fill the card in whole waves with little
// scratch (window_bwd_groups).
//
// The deterministic route (a null dq_accum, taken under
// torch.use_deterministic_algorithms) skips the dQ partials and leaves dq
// to flash_attention_bwd.cuh's atomic-free dq pass.
//
// Tiles: Q, dO, K, V are [rows][dh] bf16, 64-byte rows in the 64-byte
// swizzle (dh 32), and dS^T [64 keys][64 queries] in the 128-byte swizzle,
// as the forward core's (flash_attention_sm90.cuh) swizzles and
// descriptors name them. Ragged seq is not padded: rows past seq load as
// zeros and their probabilities are 0.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_attention_sm90.cuh"
#include "flash_mha_bwd_sm90.cuh"

namespace tim_attn {
namespace wbwd90 {

using sm90::Params;

constexpr int kKeys = 64;       // keys a block (the products' M)
constexpr int kBQ = 64;         // query rows a tile
constexpr int kThreads = 256;   // two warpgroups
constexpr int kSmemLimit = 232448;

// The block's shared memory for head dim DH and seq tokens: K, V | two
// query-tile buffers (Q and dO, later dS^T) | the dbias partial (SP) |
// two warpgroups' (lse, D) | the window's region ids, + alignment slack.
template <int DH, bool SP>
struct Layout {
  static constexpr int kRowTile = kKeys * DH * 2;              // K or V
  static constexpr int kBuf =
      2 * kBQ * DH * 2 > kKeys * kBQ * 2 ? 2 * kBQ * DH * 2 : kKeys * kBQ * 2;
  static constexpr int kK = 0, kV = kRowTile, kBuf0 = 2 * kRowTile;
  static constexpr int kPartial = kBuf0 + 2 * kBuf;
  __host__ __device__ static constexpr int stats(int seq) {
    return kPartial + (SP ? seq * kKeys * 4 : 0);
  }
  __host__ __device__ static constexpr int region(int seq) {
    return stats(seq) + 2 * 2 * kBQ * 4;
  }
  // the region ids, padded to whole query tiles (read in pairs unclamped)
  __host__ __device__ static constexpr int bytes(int seq) {
    return region(seq) + 4 * ((seq + kBQ - 1) / kBQ * kBQ) + 1024;
  }
};

// The partial's element (query row q, key column j): rows of 64 floats,
// the column XOR-ed with (q / 2) % 4 * 8, so that the four column pairs a
// warp's lanes touch at once fall in distinct banks.
__device__ __forceinline__ int partial_at(int q, int j) {
  return q * kKeys + (j ^ (((q >> 1) & 3) << 3));
}

__device__ __forceinline__ void wg_bar(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

// rows [row0, row0 + 64) of a [seq, DH] bf16 operand (row stride ld) into
// a swizzled tile, rows past seq zero-filled; nthreads copy together.
template <int DH>
__device__ __forceinline__ void load_rows(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          long long ld, int row0, int S,
                                          int tid, int nthreads) {
  constexpr int CH = DH / 8;
  for (int i = tid; i < 64 * CH; i += nthreads) {
    const int r = i / CH, c = i % CH;
    const int row = min(row0 + r, S - 1);
    sm90::cp16(dst + fwd90::swz<DH>(r, c), src + row * ld + c * 8,
               row0 + r < S ? 16 : 0);
  }
}

// DQ: the dQ partials and their atomic adds (off in the deterministic
// route); SP: the dbias partial in shared memory (else in its output).
template <int DH, bool DQ, bool SP>
__global__ void __launch_bounds__(kThreads, 1) bwd_kernel(const Params p) {
  using L = Layout<DH, SP>;
  using bf = __nv_bfloat16;
  extern __shared__ unsigned char dyn_smem[];
  const uint32_t raw = sm90::smem_u32(dyn_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = dyn_smem + (base - raw);
  const int S = p.seq;
  const uint32_t s_k = base + L::kK, s_v = base + L::kV;
  int* s_region = reinterpret_cast<int*>(gbase + L::region(S));

  const int n_kt = (S + kKeys - 1) / kKeys;
  const int n_qt = (S + kBQ - 1) / kBQ;
  const int group = (int)(blockIdx.x % p.groups);
  const int kt = (int)((blockIdx.x / p.groups) % n_kt);
  const int h = (int)(blockIdx.x / p.groups / n_kt);
  const int k0 = kt * kKeys;
  const int per_group = (p.batch + p.groups - 1) / p.groups;
  const int b_begin = group * per_group;
  const int b_end = min(p.batch, b_begin + per_group);
  const int tid = threadIdx.x;
  const int wg = tid / 128, wtid = tid % 128;
  const int warp = wtid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;
  const uint32_t s_buf = base + L::kBuf0 + wg * L::kBuf;   // Q, dO | dS^T
  const uint32_t s_q = s_buf, s_do = s_buf + kBQ * DH * 2;
  float* stat = reinterpret_cast<float*>(gbase + L::stats(S)) + wg * 2 * kBQ;
  constexpr float kLog2e = 1.4426950408889634f;
  const float* hbias = p.bias + (long long)h * S * S;

  // this thread's accumulator rows (keys) within the block's 64
  const int key_r[2] = {warp * 16 + g, warp * 16 + g + 8};
  bool key_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) key_ok[r] = k0 + key_r[r] < S;

  // the block's dbias slice: its 64 key columns of the group's [seq,
  // seq], and the partial's elements (query row q, key column j) at
  // q * pld + j (shared memory: partial_at)
  auto out_slice = [&]() {
    return (p.groups > 1 ? p.dbias_groups +
                               ((long long)group * p.heads + h) * S * S
                         : p.dbias + (long long)h * S * S) + k0;
  };
  float* partial =
      SP ? reinterpret_cast<float*>(gbase + L::kPartial) : out_slice();
  const int pld = SP ? kKeys : S;
  if constexpr (SP) {
    for (int i = tid; i < S * kKeys / 4; i += kThreads)
      reinterpret_cast<float4*>(partial)[i] =
          make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    for (int i = tid; i < S * kKeys; i += kThreads)
      if (k0 + i % kKeys < S) partial[i / kKeys * pld + i % kKeys] = 0.f;
  }

  // q, do, lse and D of query tile `qt` of window b into this warpgroup's
  // buffer (its 128 threads)
  auto load_q = [&](int b, int qt) {
    const int q0 = qt * kBQ;
    load_rows<DH>(s_q, p.q + b * p.sq.b + h * p.sq.h, p.sq.n, q0, S, wtid,
                  128);
    load_rows<DH>(s_do, p.dout + b * p.sdo.b + h * p.sdo.h, p.sdo.n, q0, S,
                  wtid, 128);
    const long long bh = ((long long)b * p.heads + h) * S;
    const int row = q0 + wtid % kBQ;
    cp_async4(stat + wtid, (wtid < kBQ ? p.lse : p.delta) + bh +
                               min(row, S - 1), row < S ? 4 : 0);
  };

  float sc[32], dp[32], dv[DH / 2], dk[DH / 2], dq[DH / 2];
  uint32_t pa[4][4], da[4][4];
  // the bias of query tile qt's scores, divided by the scale, as the S^T
  // accumulator's start (S^T + bias / scale, times the scale, is the
  // score; no registers of its own), read when the tile's load is issued
  // (its L2 latency hides behind the tile's copy): element i is key row
  // key_r[(i / 2) % 2], query column (i / 4) * 8 + 2 tig + i % 2
  const float inv_scale = 1.f / p.scale;
  auto load_bias = [&](int qt) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = min(qt * kBQ + (i / 4) * 8 + 2 * tig + (i & 1), S - 1);
      const int key = min(k0 + key_r[(i >> 1) & 1], S - 1);
      sc[i] = __ldg(hbias + (long long)col * S + key) * inv_scale;
    }
  };

  for (int b = b_begin; b < b_end; ++b) {
    // K, V of the window's 64 keys and its region ids for both warpgroups,
    // this warpgroup's first query tile
    load_rows<DH>(s_k, p.k + b * p.sk.b + h * p.sk.h, p.sk.n, k0, S, tid,
                  kThreads);
    load_rows<DH>(s_v, p.v + b * p.sv.b + h * p.sv.h, p.sv.n, k0, S, tid,
                  kThreads);
    const int* region = p.region != nullptr
                            ? p.region + (long long)(b % p.n_win) * S
                            : nullptr;
    int mixed = 0;
    if (region != nullptr) {
      const int first = __ldg(region);
      for (int i = tid; i < S; i += kThreads) {
        cp_async4(s_region + i, region + i, 4);
        mixed |= __ldg(region + i) != first;
      }
    }
    if (wg < n_qt) {
      load_q(b, wg);
      load_bias(wg);
    }
    cp_async_commit();
    cp_async_wait<0>();
    sm90::fence_async_smem();
    // every thread's copies have landed; the mask flag of the window (a
    // window of one region has none)
    const bool masked = __syncthreads_or(mixed) != 0;
    int region_key[2] = {0, 0};
    if (masked)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        region_key[r] = s_region[min(k0 + key_r[r], S - 1)];

#pragma unroll
    for (int i = 0; i < DH / 2; ++i) dv[i] = dk[i] = 0.f;

    for (int qt = wg; qt < n_qt; qt += 2) {
      const int q0 = qt * kBQ;
      if (qt != wg) {   // the tile loaded at the end of the previous one
        cp_async_wait<0>();
        sm90::fence_async_smem();
        wg_bar(wg);
      }
      // S^T = K Q^T, dP^T = V dO^T (K-major, 16 dims = 32 bytes a k-step)
      sm90::wg_fence();
#pragma unroll
      for (int ks = 0; ks < DH / 16; ++ks)
        sm90::wgmma_ss<0, 0, true>(sc, fwd90::desc<DH>(s_k) + 2 * ks,
                                   fwd90::desc<DH>(s_q) + 2 * ks);
      sm90::wgmma_ss<0, 0, false>(dp, fwd90::desc<DH>(s_v),
                                  fwd90::desc<DH>(s_do));
#pragma unroll
      for (int ks = 1; ks < DH / 16; ++ks)
        sm90::wgmma_ss<0, 0, true>(dp, fwd90::desc<DH>(s_v) + 2 * ks,
                                   fwd90::desc<DH>(s_do) + 2 * ks);
      sm90::wg_commit();
      sm90::wg_wait<0>();
      sm90::fence_regs(sc);
      sm90::fence_regs(dp);

      // P^T and dS^T * scale in place of the accumulators, dS^T summed
      // into the partial; scores past seq (query or key) are masked only
      // in the tiles that have any
      const bool full = q0 + kBQ <= S && k0 + kKeys <= S;
      const bool q_full = q0 + kBQ <= S;
      // this thread's partial elements: query row q0 + (i / 4) * 8 + 2 tig
      // + e, key column key_r[r], whose XOR term partial_at takes from
      // (q / 2) % 4 = tig, so each is a fixed offset from one of two rows
      int prow[2];
#pragma unroll
      for (int r = 0; r < 2; ++r)
        prow[r] = (q0 + 2 * tig) * pld + (SP ? key_r[r] ^ (tig << 3)
                                             : key_r[r]);
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int col = (i / 4) * 8 + 2 * tig;
        const int r = (i >> 1) & 1;
        const float2 l2 = *reinterpret_cast<const float2*>(stat + col);
        const float2 d2 = *reinterpret_cast<const float2*>(stat + kBQ + col);
        const float lv[2] = {l2.x * kLog2e, l2.y * kLog2e};
        const float dl[2] = {d2.x, d2.y};
        int2 rq = make_int2(0, 0);
        if (masked) rq = *reinterpret_cast<const int2*>(s_region + q0 + col);
        const int rqe[2] = {rq.x, rq.y};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = sc[i + e] * p.scale;
          if (masked && rqe[e] != region_key[r]) x += kMaskValue;
          float pe = sm90::ex2(fmaf(x, kLog2e, -lv[e]));
          if (!full && !(q0 + col + e < S && key_ok[r])) pe = 0.f;
          const float ds = pe * (dp[i + e] - dl[e]);
          sc[i + e] = pe;
          dp[i + e] = ds * p.scale;
          if ((q_full || q0 + col + e < S) && (SP || key_ok[r]))
            partial[prow[r] + ((i / 4) * 8 + e) * pld] += ds;
        }
      }
      fwd90::pack_p<64>(sc, pa);
      fwd90::pack_p<64>(dp, da);
      // dV += P^T dO, dK += dS^T Q: B is [queries][dims] read transposed
      // (MN-major); 16 queries = 16 * DH * 2 bytes
      sm90::wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        sm90::wgmma_rs<1>(dv, pa[kk], fwd90::desc<DH>(s_do + kk * 32 * DH));
        sm90::wgmma_rs<1>(dk, da[kk], fwd90::desc<DH>(s_q + kk * 32 * DH));
      }
      sm90::wg_commit();
      sm90::wg_wait<0>();
      sm90::fence_regs(dv);
      sm90::fence_regs(dk);
      sm90::fence_regs(pa);
      sm90::fence_regs(da);

      if constexpr (DQ) {
        // dS^T (keys x queries, bf16) over Q and dO, which every product
        // of the warpgroup is done with: fragment j of k-step kk holds row
        // (j % 2) * 8 + g, columns 16 kk + (j / 2) * 8 + 2 tig + {0, 1}
        wg_bar(wg);
        unsigned char* g_ds = gbase + (s_buf - base);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int col = kk * 16 + (j / 2) * 8 + 2 * tig;
            *reinterpret_cast<uint32_t*>(
                g_ds + fwd90::swz<64>(key_r[j & 1], col / 8) +
                (col % 8) * 2) = da[kk][j];
          }
        sm90::fence_async_smem();
        wg_bar(wg);
        // dQ partial (64 queries x DH) = dS K over the block's 64 keys: A
        // = dS^T read transposed (16 keys = 2048 bytes a k-step), B = K
        // read transposed (16 keys = 32 DH bytes)
        sm90::wg_fence();
        sm90::wgmma_ss<1, 1, false>(dq, fwd90::desc<64>(s_buf),
                                    fwd90::desc<DH>(s_k));
#pragma unroll
        for (int kk = 1; kk < 4; ++kk)
          sm90::wgmma_ss<1, 1, true>(dq, fwd90::desc<64>(s_buf + kk * 2048),
                                     fwd90::desc<DH>(s_k + kk * 32 * DH));
        sm90::wg_commit();
        sm90::wg_wait<0>();
        sm90::fence_regs(dq);
        float* dqa = p.dq_accum + (((long long)b * p.heads + h) * S + q0) * DH;
#pragma unroll
        for (int i = 0; i < DH / 2; i += 2) {
          const int row = warp * 16 + g + 8 * ((i / 2) & 1);
          const int col = (i / 4) * 8 + 2 * tig;
          if (q0 + row < S)
            asm volatile("red.global.add.v2.f32 [%0], {%1, %2};\n" ::"l"(
                             dqa + row * DH + col), "f"(dq[i]), "f"(dq[i + 1])
                         : "memory");
        }
      }
      // every thread of the warpgroup is done with the buffer
      wg_bar(wg);
      if (qt + 2 < n_qt) {
        load_q(b, qt + 2);
        cp_async_commit();
        load_bias(qt + 2);
      }
    }

    // dK, dV: warpgroup 1's sums into warpgroup 0's through the (now
    // free) query-tile buffers, element j of thread t at j * 128 + t
    __syncthreads();
    float* xfer = reinterpret_cast<float*>(gbase + L::kBuf0);
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) {
        xfer[i * 128 + wtid] = dk[i];
        xfer[(DH / 2 + i) * 128 + wtid] = dv[i];
      }
    }
    __syncthreads();
    if (wg == 0) {
      bf* dkp = p.dk + b * p.sdk.b + h * p.sdk.h;
      bf* dvp = p.dv + b * p.sdv.b + h * p.sdv.h;
#pragma unroll
      for (int i = 0; i < DH / 2; i += 2) {
        const int r = (i / 2) & 1;
        const int col = (i / 4) * 8 + 2 * tig;
        const float k0v = dk[i] + xfer[i * 128 + wtid];
        const float k1v = dk[i + 1] + xfer[(i + 1) * 128 + wtid];
        const float v0v = dv[i] + xfer[(DH / 2 + i) * 128 + wtid];
        const float v1v = dv[i + 1] + xfer[(DH / 2 + i + 1) * 128 + wtid];
        if (!key_ok[r]) continue;
        const int key = k0 + key_r[r];
        *reinterpret_cast<uint32_t*>(dkp + key * p.sdk.n + col) =
            pack_bf16(k0v, k1v);
        *reinterpret_cast<uint32_t*>(dvp + key * p.sdv.n + col) =
            pack_bf16(v0v, v1v);
      }
    }
    __syncthreads();   // the buffers are free for the next window
  }

  // the shared partial, once: rows of 64 key columns (256 bytes a row)
  if constexpr (SP) {
    float* out = out_slice();
    for (int i = tid; i < S * kKeys; i += kThreads) {
      const int q = i / kKeys, j = i % kKeys;
      if (k0 + j < S) out[(long long)q * S + j] = partial[partial_at(q, j)];
    }
  }
}

// dbias = the groups' partials summed in group order, a float a thread.
__global__ void __launch_bounds__(256) sum_groups_kernel(const Params p) {
  const long long n = (long long)p.heads * p.seq * p.seq;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = p.dbias_groups[i];
  for (int g = 1; g < p.groups; ++g) acc += p.dbias_groups[g * n + i];
  p.dbias[i] = acc;
}

// The number of window groups for (batch windows, heads, seq): the blocks
// (heads x key tiles x groups) should fill the card's SMs in whole waves,
// each block walking batch / groups windows, while every group but a
// single one costs a [heads, seq, seq] fp32 partial written and read back.
// Minimises waves x windows a block + that traffic in units of one
// window's walk (~10 us at seq 784; ~3 TB/s both ways).
inline int window_bwd_groups(int batch, int heads, int seq, int sms) {
  const int n_kt = (seq + kKeys - 1) / kKeys;
  const double scratch_units =
      (double)heads * seq * seq * 8.0 / 3e12 / 10e-6;
  int best = 1;
  double best_cost = 0.0;
  for (int g = 1; g <= (batch < 64 ? batch : 64); ++g) {
    const long long blocks = (long long)heads * n_kt * g;
    const double cost = (double)((blocks + sms - 1) / sms) *
                            ((batch + g - 1) / g) +
                        (g > 1 ? g * scratch_units : 0.0);
    if (g == 1 || cost < best_cost) {
      best = g;
      best_cost = cost;
    }
  }
  return best;
}

constexpr int kMaxDevices = 64;
namespace {
template <int DH, bool DQ, bool SP>
int smem_set[kMaxDevices] = {};
}  // namespace

template <int DH, bool DQ, bool SP>
int launch_kernel(const Params& p, long long blocks, cudaStream_t stream) {
  const int smem = Layout<DH, SP>::bytes(p.seq);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  auto kernel = bwd_kernel<DH, DQ, SP>;
  int device = 0;
  int err = (int)cudaGetDevice(&device);
  if (err != 0) return err;
  if (device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  int& allowed = smem_set<DH, DQ, SP>[device];
  if (smem > allowed) {
    err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != 0) return err;
    allowed = smem;
  }
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// The main pass (after launch_preprocess) and the groups' sum; returns the
// first launch error. p.groups and p.dbias_groups set by the caller.
template <int DH>
int launch(const Params& p, cudaStream_t stream) {
  const long long blocks = (long long)p.heads *
                           ((p.seq + kKeys - 1) / kKeys) * p.groups;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  // the dbias partial in shared memory where it fits
  const bool sp = Layout<DH, true>::bytes(p.seq) <= kSmemLimit;
  int err;
  if (p.dq_accum != nullptr)
    err = sp ? launch_kernel<DH, true, true>(p, blocks, stream)
             : launch_kernel<DH, true, false>(p, blocks, stream);
  else
    err = sp ? launch_kernel<DH, false, true>(p, blocks, stream)
             : launch_kernel<DH, false, false>(p, blocks, stream);
  if (err != 0 || p.groups == 1) return err;
  const long long n = (long long)p.heads * p.seq * p.seq;
  sum_groups_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace wbwd90
}  // namespace tim_attn
