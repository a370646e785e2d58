// TIM query-block attention for Hopper (sm_90a).
//
// Replaces: tim_tpu/ops/pallas_attention.py::query_block_attention
// (kernel body _query_block_kernel, pl.pallas_call at :89). Each of the Nq
// interval-query tokens of one (batch, head) takes a softmax over its F
// context keys plus its own key, scaled by 1/sqrt(dh), and returns the
// weighted sum of the context values and its own value. Internals fp32,
// output in the input dtype, forward only.
//
// What bounds it on the H100: at TIM's detection shapes (Nq 798, F 100,
// dh 128, 8 heads, batch 128, bf16) every query row of q/k/v is read once
// and the output written once: 0.89 GB and 53 GFLOP, about 60 operations
// a byte, far below the card's ~295 ridge, so device-memory bytes bound it
// (0.27 ms at 3.35 TB/s). The XLA/einsum formulation also writes and
// re-reads a [B, H, Nq, F] fp32 score tensor; this kernel never
// materialises it.
//
// bf16 design (head dims 32, 64, 128): tensor cores take the two products
// off the issue path, and an asynchronous copy ring keeps the memory busy.
// One block of four warps per (batch * head, run of 64-row query tiles).
//   - Context: kc and vc ([F, dh]) are copied into shared memory once per
//     block with 16-byte cp.async, F padded to a multiple of 16 with zero
//     rows (never read past F), and stay resident while the block walks
//     its query tiles, whose qq, kq and vq rows stream through a ring of
//     three stages of 16-byte cp.async copies: 48 KB a tile at
//     dh 128, so 96 KB are in flight while a tile computes.
//   - Scores: each warp holds 16 query rows as mma.sync m16n8k16 A
//     fragments; S = Q Kc^T accumulates in fp32 and is scaled in fp32. The
//     self score q . kq is a per-row fp32 dot product of the rows the block
//     already holds, and starts the row max.
//   - Softmax: over 64-key chunks of the context with an online max and
//     sum (for F <= 64 a single chunk: max, exp, sum). The unnormalised
//     probabilities are repacked in registers as bf16 A fragments for
//     P Vc, fp32 accumulators; the epilogue divides by the fp32 row sum and
//     adds e_self / sum * vq in fp32, stages the warp's 16 output rows in
//     shared memory and writes them with 16-byte stores into the contiguous
//     [B, H, Nq, dh] output.
//   - When the context does not fit beside the ring (large F), one block
//     per (batch * head, query tile) streams 64-key context tiles through a
//     two-stage ring instead: the same chunk code, no F refused.
// Rounding P to bf16 before P V (the plain version keeps it fp32) is this
// design's one new error source. Measured (H100 80GB HBM3, 700 W): 0.63 ms
// at the detection shape, 42% of the bytes bound, against 3.96 ms for the
// CUDA-core design and 1.42 ms for masked scaled_dot_product_attention.
//
// Head dims: the bf16 tensor-core instances are 32, 64, 128 and 160 (the
// wide TIM's 2560 / 16 heads: its 160 x 168 rows do not fit the resident
// ring, so it streams the context); ops/query_block_attention.py copies
// bf16 inputs at other head dims up to 160, or with rows cp.async cannot
// copy, zero-padded onto the next of them. Past 160 a thread's fp32 output
// accumulators do not fit the register file beside its A fragments, and
// bf16 takes the column-slice wgmma design of
// query_block_attention_cols.cu (one 256-column slice up to head dim 256).
//
// fp32 (the parity path) keeps the CUDA-core design up to head dim 256:
// one block per (batch * head, 128 queries), kc and vc in shared memory,
// each warp walking its queries one at a time, context scores by
// warp-shuffle reductions 32 keys at a time, fp32 softmax and value sums.
// It is bound by issuing shared-memory loads and shuffles per key (in bf16
// it took 3.96 ms at the shape above, H100 80GB HBM3, 700 W). Head dims
// other than 32, 64, 128 and 256 take its TAIL instances: a lane's DPL
// dims past dh are masked, and shared-memory rows are dh rounded up to 8
// values.
//
// q/k/v arrive as strided views of the packed projection (and, in layer 0,
// a batch-broadcast query block): both designs take (batch, head, row)
// element strides per tensor, so no copy is made and a stride-0 batch is
// read as what it is. Nq is not padded to a tile: rows past Nq load as
// zeros and are not stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"
#include "flash_attention.cuh"

namespace tim_qba {

using tim::from_f;
using tim::load_floats;
using tim::to_f;
using tim::warp_max;
using tim::warp_sum;

constexpr int kWarps = 8;
constexpr int kQueriesPerBlock = 128;

struct Strides {
  long long b, h, n;  // element strides; the last (dh) dim is contiguous
};

struct Args {
  const void* qq;
  const void* kc;
  const void* kq;
  const void* vc;
  const void* vq;
  void* out;  // contiguous [B, H, Nq, dh]
  Strides s_qq, s_kc, s_kq, s_vc, s_vq;
  int heads, nq, f;
  int dh;   // the head dim (the TAIL instances' row length)
  float scale;
};

template <typename T>
__device__ __forceinline__ const T* head_ptr(const void* p, const Strides& s,
                                             int b, int h) {
  return static_cast<const T*>(p) + b * s.b + h * s.h;
}

// The CUDA-core instances' row length in shared memory: dh, rounded up to
// 8 values in the TAIL instances (16-byte rows).
template <bool TAIL>
__host__ __device__ __forceinline__ int row_len(int dpl, int dh) {
  return TAIL ? (dh + 7) / 8 * 8 : dpl * 32;
}

// DPL of this lane's dims from p (already offset to them) into x: a vector
// load where the row holds them all (dh = 32 DPL), else one value at a
// time, the dims past dh read as zeros (TAIL: any dh <= 32 DPL).
template <typename T, int DPL, bool TAIL>
__device__ __forceinline__ void lane_dims(const T* p, int d0, int dh,
                                          float (&x)[DPL]) {
  if constexpr (TAIL) {
#pragma unroll
    for (int i = 0; i < DPL; ++i) x[i] = d0 + i < dh ? to_f(p[i]) : 0.f;
  } else {
    load_floats<T, DPL>(p, x);
  }
}

// DPL = dims per lane: dh / 32, or (TAIL) any dh up to 32 DPL, the lanes'
// dims past dh masked
template <typename T, int DPL, bool TAIL>
__global__ void __launch_bounds__(kWarps * 32)
    query_block_kernel(const Args a) {
  const int dh = TAIL ? a.dh : DPL * 32;
  const int DH = row_len<TAIL>(DPL, dh);
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_kc = reinterpret_cast<T*>(smem);
  T* s_vc = s_kc + a.f * DH;
  float* s_p = reinterpret_cast<float*>(s_vc + a.f * DH);  // [kWarps][F]

  const int bh = blockIdx.y;
  const int b = bh / a.heads, h = bh % a.heads;
  const T* kc = head_ptr<T>(a.kc, a.s_kc, b, h);
  const T* vc = head_ptr<T>(a.vc, a.s_vc, b, h);
  for (int i = threadIdx.x; i < a.f * DH; i += blockDim.x) {
    const int j = i / DH, d = i % DH;
    s_kc[i] = d < dh ? kc[j * a.s_kc.n + d] : from_f<T>(0.f);
    s_vc[i] = d < dh ? vc[j * a.s_vc.n + d] : from_f<T>(0.f);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* p = s_p + warp * a.f;
  const T* qq = head_ptr<T>(a.qq, a.s_qq, b, h);
  const T* kq = head_ptr<T>(a.kq, a.s_kq, b, h);
  const T* vq = head_ptr<T>(a.vq, a.s_vq, b, h);
  T* out = static_cast<T*>(a.out) + (long long)bh * a.nq * dh;

  const int q0 = blockIdx.x * kQueriesPerBlock;
  const int q1 = min(a.nq, q0 + kQueriesPerBlock);
  const int d0 = lane * DPL;  // this lane's dims: [d0, d0 + DPL)
  for (int n = q0 + warp; n < q1; n += kWarps) {
    float q[DPL];
    float self = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const bool in = !TAIL || d0 + i < dh;
      q[i] = in ? to_f(qq[n * a.s_qq.n + d0 + i]) * a.scale : 0.f;
      self += in ? q[i] * to_f(kq[n * a.s_kq.n + d0 + i]) : 0.f;
    }
    self = warp_sum(self);

    // Context scores 32 keys at a time: each lane sums its dims' products
    // for all 32 keys, then a transposing butterfly (31 shuffles, not
    // 32 x 5) leaves the full score of key j0 + lane in lane `lane`.
    float m = self;
    for (int j0 = 0; j0 < a.f; j0 += 32) {
      float part[32];
#pragma unroll
      for (int t = 0; t < 32; ++t) {
        float k[DPL];
        // rows past F repeat row F-1; their scores are dropped below
        lane_dims<T, DPL, TAIL>(s_kc + min(j0 + t, a.f - 1) * DH + d0, d0,
                                dh, k);
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < DPL; ++i) s += q[i] * k[i];
        part[t] = s;
      }
      // fixed trip counts, so that part[] stays in registers
#pragma unroll
      for (int step = 0; step < 5; ++step) {
        const int o = 16 >> step;
        const bool upper = lane & o;  // keep keys [o, 2o) of the set, else [0, o)
#pragma unroll
        for (int t = 0; t < 16; ++t) {
          if (t < o) {
            const float send = upper ? part[t] : part[t + o];
            const float keep = upper ? part[t + o] : part[t];
            part[t] = keep + __shfl_xor_sync(0xffffffffu, send, o);
          }
        }
      }
      if (j0 + lane < a.f) {
        p[j0 + lane] = part[0];
        m = fmaxf(m, part[0]);
      }
    }
    m = warp_max(m);
    __syncwarp();

    float sum = 0.f;
    for (int j = lane; j < a.f; j += 32) {
      const float e = expf(p[j] - m);
      p[j] = e;
      sum += e;
    }
    const float e_self = expf(self - m);
    const float inv = 1.f / (warp_sum(sum) + e_self);
    __syncwarp();

    float acc[DPL];
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[i] = 0.f;
    for (int j = 0; j < a.f; ++j) {
      const float w = p[j] * inv;
      float v[DPL];
      lane_dims<T, DPL, TAIL>(s_vc + j * DH + d0, d0, dh, v);
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[i] += w * v[i];
    }
    const float w_self = e_self * inv;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      if (!TAIL || d0 + i < dh)
        out[(long long)n * dh + d0 + i] =
            from_f<T>(acc[i] + w_self * to_f(vq[n * a.s_vq.n + d0 + i]));
    }
    __syncwarp();  // p is rewritten by this warp's next query
  }
}

template <typename T, int DPL, bool TAIL = false>
int launch(const Args& a, int bh, cudaStream_t stream) {
  const size_t smem =
      2 * (size_t)a.f * row_len<TAIL>(DPL, a.dh) * sizeof(T) +
      (size_t)kWarps * a.f * sizeof(float);
  auto kernel = query_block_kernel<T, DPL, TAIL>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.nq + kQueriesPerBlock - 1) / kQueriesPerBlock, bh);
  kernel<<<grid, kWarps * 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}


// ---- bf16 tensor-core design (head dims 32, 64, 128) ----

using tim_attn::cp_async16;
using tim_attn::cp_async_commit;
using tim_attn::cp_async_wait;
using tim_attn::ldmatrix_x4;
using tim_attn::ldmatrix_x4_trans;
using tim_attn::mma_bf16;
using tim_attn::pack_bf16;
using bf16 = __nv_bfloat16;

constexpr int kTcWarps = 4;
constexpr int kTcRows = 16 * kTcWarps;   // query rows per tile
constexpr int kChunk = 64;               // context keys per softmax step
constexpr int kStages = 3;               // query tiles in the resident ring

// Shared-memory row pitch: dh + 8 elements, so that the 8 rows of an
// ldmatrix fall in distinct banks.
template <int DH> __host__ __device__ constexpr int pitch() { return DH + 8; }

__device__ __forceinline__ const bf16* head(const void* p, const Strides& s,
                                            int b, int h) {
  return static_cast<const bf16*>(p) + b * s.b + h * s.h;
}

// rows [row0, row0 + n) of a [rows, DH] operand (row stride ld) into a
// shared tile of pitch DH + 8; rows past `end` are zero-filled
template <int DH>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          long long ld, int row0, int n,
                                          int end, int tid) {
  constexpr int CH = DH / 8, LD = pitch<DH>();
  for (int i = tid; i < n * CH; i += kTcWarps * 32) {
    const int r = i / CH, c = i % CH;
    const int row = min(row0 + r, end - 1);
    cp_async16(dst + r * LD + c * 8, src + row * ld + c * 8,
               row0 + r < end ? 16 : 0);
  }
}

// One query tile's running state in this thread: the warp's 16 rows as A
// fragments, the self score, row max and partial sum of rows g and g + 8,
// and the fp32 P V accumulators.
template <int DH>
struct TileState {
  uint32_t qa[DH / 16][4];
  float o[DH / 8][4];
  float self[2], m[2], l[2];
};

// A fragments and self scores from the tile's q and kq rows (in shared
// memory); m starts at the self score, which keeps it finite.
template <int DH>
__device__ __forceinline__ void tile_init(TileState<DH>& t, const bf16* s_q,
                                          const bf16* s_kq, float scale,
                                          int warp, int lane) {
  constexpr int LD = pitch<DH>(), PER = DH / 4;
  const int g = lane / 4, tig = lane % 4, mi = lane / 8, mr = lane % 8;
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks)
    ldmatrix_x4(t.qa[ks], s_q + (warp * 16 + (mi & 1) * 8 + mr) * LD +
                              ks * 16 + (mi >> 1) * 8);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = warp * 16 + g + 8 * r;
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < PER; c += 8) {
      float x[8], y[8];
      load_floats<bf16, 8>(s_q + row * LD + tig * PER + c, x);
      load_floats<bf16, 8>(s_kq + row * LD + tig * PER + c, y);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc = fmaf(x[e], y[e], acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    t.self[r] = acc * scale;
    t.m[r] = t.self[r];
    t.l[r] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < DH / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) t.o[i][e] = 0.f;
}

// One chunk of nk <= 64 context keys (rows of s_k / s_v, zero beyond nk up
// to the next multiple of 16): scores, online softmax step, P V.
template <int DH>
__device__ __forceinline__ void tile_chunk(TileState<DH>& t, const bf16* s_k,
                                           const bf16* s_v, int nk,
                                           float scale, int lane) {
  constexpr int LD = pitch<DH>();
  const int tig = lane % 4, mi = lane / 8, mr = lane % 8;
  const int n16 = (nk + 15) / 16;
  float s[kChunk / 8][4];
#pragma unroll
  for (int nt = 0; nt < kChunk / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    if (nt < 2 * n16) {
#pragma unroll
      for (int ks = 0; ks < DH / 16; ks += 2) {
        uint32_t b[4];
        ldmatrix_x4(b, s_k + (nt * 8 + mr) * LD + ks * 16 + mi * 8);
        mma_bf16(s[nt], t.qa[ks], b[0], b[1]);
        mma_bf16(s[nt], t.qa[ks + 1], b[2], b[3]);
      }
    }
  }
  float mx[2] = {t.m[0], t.m[1]};
#pragma unroll
  for (int nt = 0; nt < kChunk / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = nt * 8 + 2 * tig + (e & 1);
      const float x = col < nk ? s[nt][e] * scale : TIM_NEG_INF;
      s[nt][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  float corr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    corr[r] = __expf(t.m[r] - mx[r]);
    t.m[r] = mx[r];
    t.l[r] *= corr[r];
  }
#pragma unroll
  for (int i = 0; i < DH / 8; ++i) {
    t.o[i][0] *= corr[0];
    t.o[i][1] *= corr[0];
    t.o[i][2] *= corr[1];
    t.o[i][3] *= corr[1];
  }
#pragma unroll
  for (int nt = 0; nt < kChunk / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float pe = __expf(s[nt][e] - t.m[e >> 1]);   // exp(-inf) = 0
      s[nt][e] = pe;
      t.l[e >> 1] += pe;
    }
  // P V: score fragments of key tiles 2kk, 2kk + 1 are the A fragment of
  // keys [16kk, 16kk + 16); B from v rows through ldmatrix.trans
#pragma unroll
  for (int kk = 0; kk < kChunk / 16; ++kk) {
    if (kk >= n16) break;
    uint32_t pa[4];
    pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
    for (int dt = 0; dt < DH / 8; dt += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, s_v + (kk * 16 + (mi & 1) * 8 + mr) * LD +
                               (dt + (mi >> 1)) * 8);
      mma_bf16(t.o[dt], pa, b[0], b[1]);
      mma_bf16(t.o[dt + 1], pa, b[2], b[3]);
    }
  }
}

// Normalise, add the self term (vq from shared memory), stage the warp's
// 16 rows in s_out (its q rows, no longer read) and store them with
// 16-byte writes: rows q0 + warp * 16 .. of the contiguous [Nq, DH] out.
template <int DH>
__device__ __forceinline__ void tile_store(TileState<DH>& t, bf16* s_out,
                                           const bf16* s_vq, bf16* out,
                                           int q0, int nq, int warp,
                                           int lane) {
  constexpr int LD = pitch<DH>(), CH = DH / 8;
  const int g = lane / 4, tig = lane % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = t.l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float e_self = __expf(t.self[r] - t.m[r]);
    const float inv = 1.f / (sum + e_self), w_self = e_self * inv;
    const int row = warp * 16 + g + 8 * r;
#pragma unroll
    for (int dt = 0; dt < DH / 8; ++dt) {
      const int col = dt * 8 + 2 * tig;
      const __nv_bfloat162 vq =
          *reinterpret_cast<const __nv_bfloat162*>(s_vq + row * LD + col);
      *reinterpret_cast<uint32_t*>(s_out + row * LD + col) = pack_bf16(
          t.o[dt][2 * r] * inv + w_self * __low2float(vq),
          t.o[dt][2 * r + 1] * inv + w_self * __high2float(vq));
    }
  }
  __syncwarp();
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = i / CH, c = i % CH, row = q0 + warp * 16 + r;
    if (row < nq)
      *reinterpret_cast<uint4*>(out + (long long)row * DH + c * 8) =
          *reinterpret_cast<const uint4*>(s_out + (warp * 16 + r) * LD +
                                          c * 8);
  }
}

// Resident context, a kStages-deep ring of query tiles. Grid: (runs,
// B * H); run x takes query tiles x, x + runs, ...
template <int DH>
__global__ void __launch_bounds__(kTcWarps * 32, 1)
    qba_resident_kernel(const Args a) {
  constexpr int LD = pitch<DH>();
  extern __shared__ __align__(16) unsigned char smem[];
  const int fp = (a.f + 15) / 16 * 16;
  bf16* s_kc = reinterpret_cast<bf16*>(smem);
  bf16* s_vc = s_kc + fp * LD;
  // stage st: qq, kq, vq tiles of kTcRows rows
  auto stage = [&](int st, int i) {
    return s_vc + fp * LD + (3 * st + i) * kTcRows * LD;
  };
  const int bh = blockIdx.y, b = bh / a.heads, h = bh % a.heads;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_tiles = (a.nq + kTcRows - 1) / kTcRows;
  const bf16* qq = head(a.qq, a.s_qq, b, h);
  const bf16* kq = head(a.kq, a.s_kq, b, h);
  const bf16* vq = head(a.vq, a.s_vq, b, h);
  bf16* out = static_cast<bf16*>(a.out) + (long long)bh * a.nq * DH;

  auto load_tile = [&](int it) {   // it-th tile of this run, if any
    const int tile = blockIdx.x + it * gridDim.x;
    if (tile < n_tiles) {
      const int st = it % kStages, q0 = tile * kTcRows;
      load_rows<DH>(stage(st, 0), qq, a.s_qq.n, q0, kTcRows, a.nq, tid);
      load_rows<DH>(stage(st, 1), kq, a.s_kq.n, q0, kTcRows, a.nq, tid);
      load_rows<DH>(stage(st, 2), vq, a.s_vq.n, q0, kTcRows, a.nq, tid);
    }
    cp_async_commit();   // possibly empty: one group per tile slot
  };
  load_rows<DH>(s_kc, head(a.kc, a.s_kc, b, h), a.s_kc.n, 0, fp, a.f, tid);
  load_rows<DH>(s_vc, head(a.vc, a.s_vc, b, h), a.s_vc.n, 0, fp, a.f, tid);
#pragma unroll
  for (int it = 0; it < kStages - 1; ++it) load_tile(it);

  for (int it = 0; blockIdx.x + it * gridDim.x < n_tiles; ++it) {
    load_tile(it + kStages - 1);   // into the stage the last tile released
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const int st = it % kStages;
    const int q0 = (blockIdx.x + it * gridDim.x) * kTcRows;
    TileState<DH> t;
    tile_init<DH>(t, stage(st, 0), stage(st, 1), a.scale, warp, lane);
    for (int c0 = 0; c0 < a.f; c0 += kChunk)
      tile_chunk<DH>(t, s_kc + c0 * LD, s_vc + c0 * LD,
                     min(kChunk, a.f - c0), a.scale, lane);
    tile_store<DH>(t, stage(st, 0), stage(st, 2), out, q0, a.nq, warp, lane);
    __syncthreads();   // the stage is free for the tile kStages - 1 ahead
  }
}

// Streamed context: one block per (query tile, batch * head); 64-key
// context tiles through a two-stage ring.
template <int DH>
__global__ void __launch_bounds__(kTcWarps * 32, 1)
    qba_streamed_kernel(const Args a) {
  constexpr int LD = pitch<DH>();
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_qq = reinterpret_cast<bf16*>(smem);
  bf16* s_kq = s_qq + kTcRows * LD;
  bf16* s_vq = s_kq + kTcRows * LD;
  auto ctx = [&](int st, int i) {
    return s_vq + kTcRows * LD + (2 * st + i) * kChunk * LD;
  };
  const int bh = blockIdx.y, b = bh / a.heads, h = bh % a.heads;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * kTcRows;
  const bf16* kc = head(a.kc, a.s_kc, b, h);
  const bf16* vc = head(a.vc, a.s_vc, b, h);
  const int n_chunks = (a.f + kChunk - 1) / kChunk;

  auto load_chunk = [&](int c) {
    if (c < n_chunks) {
      load_rows<DH>(ctx(c & 1, 0), kc, a.s_kc.n, c * kChunk, kChunk, a.f,
                    tid);
      load_rows<DH>(ctx(c & 1, 1), vc, a.s_vc.n, c * kChunk, kChunk, a.f,
                    tid);
    }
    cp_async_commit();
  };
  load_rows<DH>(s_qq, head(a.qq, a.s_qq, b, h), a.s_qq.n, q0, kTcRows, a.nq,
                tid);
  load_rows<DH>(s_kq, head(a.kq, a.s_kq, b, h), a.s_kq.n, q0, kTcRows, a.nq,
                tid);
  load_rows<DH>(s_vq, head(a.vq, a.s_vq, b, h), a.s_vq.n, q0, kTcRows, a.nq,
                tid);
  load_chunk(0);
  TileState<DH> t;
  for (int c = 0; c < n_chunks; ++c) {
    load_chunk(c + 1);
    cp_async_wait<1>();
    __syncthreads();
    if (c == 0) tile_init<DH>(t, s_qq, s_kq, a.scale, warp, lane);
    tile_chunk<DH>(t, ctx(c & 1, 0), ctx(c & 1, 1),
                   min(kChunk, a.f - c * kChunk), a.scale, lane);
    __syncthreads();   // the stage is free for the chunk after next
  }
  tile_store<DH>(t, s_qq, s_vq,
                 static_cast<bf16*>(a.out) + (long long)bh * a.nq * DH, q0,
                 a.nq, warp, lane);
}

template <typename Kernel>
int launch_tc(Kernel kernel, dim3 grid, size_t smem, const Args& a,
              cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kTcWarps * 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The resident design where the context fits beside the ring's stages,
// else the streamed design.
template <int DH>
int launch_bf16_tc(const Args& a, int bh, cudaStream_t stream) {
  constexpr size_t tile = (size_t)kTcRows * pitch<DH>() * sizeof(bf16);
  const size_t ctx = 2 * (size_t)((a.f + 15) / 16 * 16) * pitch<DH>() *
                     sizeof(bf16);
  int dev = 0, max_smem = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (a.nq + kTcRows - 1) / kTcRows;
  // runs per (batch, head): one where B * H alone fills the card twice
  const int runs = max(1, min(n_tiles, (2 * n_sm + bh - 1) / bh));
  const dim3 grid(runs, bh);
  const size_t resident = ctx + 3 * kStages * tile;
  if (resident <= (size_t)max_smem)
    return launch_tc(qba_resident_kernel<DH>, grid, resident, a, stream);
  return launch_tc(qba_streamed_kernel<DH>, dim3(n_tiles, bh),
                   3 * tile + 4 * (size_t)kChunk * pitch<DH>() * sizeof(bf16),
                   a, stream);
}

// The fp32 CUDA-core design at any head dim up to 256: DPL the least
// power of two with 32 DPL >= dh, masked (TAIL) where 32 DPL != dh.
int launch_f32_tail(const Args& a, int bh, int dh, cudaStream_t stream) {
  if (dh <= 32) return launch<float, 1, true>(a, bh, stream);
  if (dh <= 64) return launch<float, 2, true>(a, bh, stream);
  if (dh <= 128) return launch<float, 4, true>(a, bh, stream);
  if (dh <= 256) return launch<float, 8, true>(a, bh, stream);
  return (int)cudaErrorInvalidValue;
}

// bf16 on the tensor-core design (the wrapper copies other head dims up
// to 160 and unaligned rows onto its instances, zero-padded), fp32 on the
// CUDA-core design.
int dispatch(const Args& a, int bh, int dh, bool bf16_in,
             cudaStream_t stream) {
  if (bf16_in) {
    switch (dh) {
      case 32: return launch_bf16_tc<32>(a, bh, stream);
      case 64: return launch_bf16_tc<64>(a, bh, stream);
      case 128: return launch_bf16_tc<128>(a, bh, stream);
      case 160: return launch_bf16_tc<160>(a, bh, stream);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (dh) {
    case 32: return launch<float, 1>(a, bh, stream);
    case 64: return launch<float, 2>(a, bh, stream);
    case 128: return launch<float, 4>(a, bh, stream);
    case 256: return launch<float, 8>(a, bh, stream);
    default: return launch_f32_tail(a, bh, dh, stream);
  }
}

}  // namespace tim_qba

// strides: 15 element strides, (batch, head, row) for qq, kc, kq, vc, vq.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int tim_query_block_attention(
    const void* qq, const void* kc, const void* kq, const void* vc,
    const void* vq, void* out, const long long* strides, int batch,
    int heads, int nq, int f, int dh, int is_bf16, float scale,
    void* stream) {
  tim_qba::Args a;
  a.qq = qq; a.kc = kc; a.kq = kq; a.vc = vc; a.vq = vq; a.out = out;
  tim_qba::Strides* s[5] = {&a.s_qq, &a.s_kc, &a.s_kq, &a.s_vc, &a.s_vq};
  for (int t = 0; t < 5; ++t) {
    s[t]->b = strides[3 * t];
    s[t]->h = strides[3 * t + 1];
    s[t]->n = strides[3 * t + 2];
  }
  a.heads = heads; a.nq = nq; a.f = f; a.dh = dh; a.scale = scale;
  const int bh = batch * heads;
  if (nq <= 0 || bh <= 0) return 0;
  return tim_qba::dispatch(a, bh, dh, is_bf16 != 0,
                           static_cast<cudaStream_t>(stream));
}
