// The post-attention encoder tail, bf16, for Hopper (sm_90a): the bf16
// route of fused_post_attention.cu (kernel 2), on warpgroup tensor-core
// products (wgmma) fed by TMA.
//
// What it computes (tim_tpu/ops/pallas_fused.py::_fused_kernel, the same
// rounding points):
//   s = bf16(x + attn), y = bf16(LN1(s));
//   h = bf16(gelu_fp32(bf16(y W1^T + b1)));
//   o = bf16(h W2^T + b2), z = bf16(LN2(bf16(y + o))),
// LayerNorms with fp32 fast-variance statistics, eps given (1e-5).
//
// What bounds it: the two products, 4 N C FF flops (0.96 TFLOP at
// [128 x 898, C 1024, FF 2048], 0.975 ms at 989 TFLOP/s), against ~1.65
// GB of HBM traffic with h written and read back (~0.49 ms at 3.35 TB/s):
// the tensor cores, reached only through wgmma.
//
// Design: four launches.
//   1. ln1: one warp a row, kept in registers (C a multiple of 128 up to
//      2048): y = bf16(LN1(bf16(x + attn))).
//   2. GEMM1 y W1^T with b1 + GELU in its epilogue, h into device memory.
//   3. GEMM2 h W2^T with b2 and the residual y in its epilogue (through a
//      staging tile in shared memory, stored 16 bytes a thread), writing
//      bf16(y + o);
//   4. ln2: the row pass of step 1 over that, in place: z.
// Each GEMM block computes 128 x 256 output tiles: a producer warpgroup
// (one thread) keeps a four-stage ring of 128 x 64 A and 256 x 64 B tiles
// filled by TMA (128-byte swizzle, full/empty mbarriers), two consumer
// warpgroups each run two m64n128k16 wgmma a k16 step on 64 of the rows,
// both operands K-major from shared memory (the weights stay in
// nn.Linear's [out, in] layout), and take their epilogue from the fp32
// accumulators (167 registers a thread, no spill). Every product
// group is waited for inside the k-step that issued it (C7515). GEMM1's
// blocks are persistent (one an SM, walking tiles), so the producer loads
// the next tile while the consumers run the last one's epilogue.
// Tried and measured slower on the card, so not kept (PERF.md, kernel
// 2): LN2 in a cluster's epilogue (the 4 blocks of a row tile exchanging
// each row's partial sums through distributed shared memory), 128 x 128
// tiles, one GEMM1 tile a block, two blocks of a cluster sharing each B
// tile by TMA multicast, one product group kept in flight across k-steps,
// and setmaxnreg (40 registers for the producer, 232 for the consumers:
// ptxas still caps the kernel at 168, spills and serialises the products,
// C7512).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "flash_attention_sm90.cuh"

namespace tim_fpa {

using tim_attn::fwd90::mbar_arrive;
using tim_attn::fwd90::mbar_expect_tx;
using tim_attn::fwd90::mbar_init;
using tim_attn::fwd90::mbar_wait;

// output tiles of 128 x 256: two m64n128 products a consumer a k-step
constexpr int kBM = 128, kBN = 256, kBK = 64;
constexpr int kHalves = kBN / 128;          // n128 products a k16 step
constexpr int kStages = 4;
constexpr int kThreads = 384;    // producer warpgroup + two consumers
constexpr int kABytes = kBM * kBK * 2;      // an A stage, 16 KB
constexpr int kBBytes = kBN * kBK * 2;      // a B stage, 32 KB
// stages x (A, B) | full, empty barriers, + alignment slack; GEMM2's
// epilogue stages its tile in the ring ([128][256] bf16, rows padded to
// 264 so a quad's rows fall in distinct banks)
constexpr int kSmem = kStages * (kABytes + kBBytes) + 16 * kStages + 1024;
constexpr int kStageLd = kBN + 8;
static_assert(kBM * kStageLd * 2 <= kStages * (kABytes + kBBytes),
              "the staging tile fits in the ring");

enum Epilogue { kGelu = 0, kResidual = 1 };

struct EpiParams {
  int m, n, k;              // out [m, n] = A [m, k] . B [n, k]^T
  const float* bias;        // [n]
  __nv_bfloat16* out;       // [m, n]
  const __nv_bfloat16* y;   // the residual [m, n] (GEMM2)
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// The epilogue EPI of a consumer thread's accumulators for the output
// tile at (m0, n0) (halves: its 128-column halves that lie inside n).
// Element i of half hf is row (i / 2) % 2 * 8 + lane / 4 of the warp's 16,
// column hf * 128 + (i / 4) * 8 + 2 (lane % 4) + i % 2.
template <int EPI>
__device__ __forceinline__ void epilogue(float (&acc)[kHalves][64],
                                         const EpiParams& e, int m0, int n0,
                                         int halves, unsigned char* s_stage,
                                         int tid) {
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;
  const int lrow = (wg - 1) * 64 + warp * 16 + g;   // r = 0; r = 1: + 8
  if constexpr (EPI == kGelu) {
#pragma unroll
    for (int hf = 0; hf < kHalves; ++hf) {
      if (hf >= halves) break;
#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        const int row = m0 + lrow + 8 * ((i / 2) & 1);
        const int col = n0 + hf * 128 + (i / 4) * 8 + 2 * tig;
        const float2 b =
            __ldg(reinterpret_cast<const float2*>(e.bias + col));
        const float v0 = gelu_erf(round_bf16(acc[hf][i] + b.x));
        const float v1 = gelu_erf(round_bf16(acc[hf][i + 1] + b.y));
        if (row < e.m)
          *reinterpret_cast<uint32_t*>(e.out + (long long)row * e.n + col) =
              tim_attn::pack_bf16(v0, v1);
      }
    }
    return;
  }
  // kResidual: o = bf16(acc + b2) into the staging tile (the ring, free
  // once the block's only tile is done: GEMM2 takes one tile a block)
  __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(s_stage);
  // both consumer warpgroups' last products are done with the ring
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
#pragma unroll
  for (int hf = 0; hf < kHalves; ++hf) {
    if (hf >= halves) break;
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int r = (i / 2) & 1;
      const int col = hf * 128 + (i / 4) * 8 + 2 * tig;
      const float2 b =
          __ldg(reinterpret_cast<const float2*>(e.bias + n0 + col));
      *reinterpret_cast<uint32_t*>(stage + (lrow + 8 * r) * kStageLd + col) =
          tim_attn::pack_bf16(acc[hf][i] + b.x, acc[hf][i + 1] + b.y);
    }
  }
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  // then a warp a row, 8 columns (16 bytes) a lane a step: bf16(y + o)
  // into out
  const int cols = halves * 128;
  const int cw = (tid - 128) / 32;   // the consumers' warp, 0..7
  for (int r = cw; r < kBM; r += 8) {
    if (m0 + r >= e.m) break;
    const int row = m0 + r;
    for (int col = lane * 8; col < cols; col += 256) {
      float v[8], y[8];
      tim::load_floats<__nv_bfloat16, 8>(stage + r * kStageLd + col, v);
      tim::load_floats<__nv_bfloat16, 8>(e.y + (long long)row * e.n + n0 +
                                         col, y);
#pragma unroll
      for (int t = 0; t < 8; ++t) v[t] = round_bf16(y[t] + v[t]);
      uint4 w;
      w.x = tim_attn::pack_bf16(v[0], v[1]);
      w.y = tim_attn::pack_bf16(v[2], v[3]);
      w.z = tim_attn::pack_bf16(v[4], v[5]);
      w.w = tim_attn::pack_bf16(v[6], v[7]);
      *reinterpret_cast<uint4*>(e.out + (long long)row * e.n + n0 + col) = w;
    }
  }
}

// Output tiles (the column tile fastest) of A . B^T over k, each with the
// epilogue EPI. A block walks tiles blockIdx.x, + gridDim.x, ...: GEMM1
// (kGelu) is launched one block an SM, so its producer loads the next
// tile while the consumers take the last one's epilogue; GEMM2 (kResidual
// stages its tile in the ring) one block a tile. n is a multiple of 128: a
// 256-wide tile whose second half lies past n stores only its first.
template <int EPI>
__global__ void __launch_bounds__(kThreads, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap tm_a,
                const __grid_constant__ CUtensorMap tm_b, const EpiParams e) {
  extern __shared__ unsigned char dyn_smem[];
  const uint32_t raw = tim_attn::sm90::smem_u32(dyn_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = dyn_smem + (base - raw);
  const uint32_t s_a = base, s_b = base + kStages * kABytes;
  const uint32_t s_bar = base + kStages * (kABytes + kBBytes);
  auto full = [&](int st) { return s_bar + 8 * st; };
  auto empty = [&](int st) { return s_bar + 8 * (kStages + st); };

  const int n_tiles = (e.n + kBN - 1) / kBN;
  const int units = (e.m + kBM - 1) / kBM * n_tiles;
  const int nk = e.k / kBK;
  const int tid = threadIdx.x, wg = tid / 128;

  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), 256);   // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // the producer: one thread keeps the ring full, k-step `it` of the
    // block's walk in stage it % kStages
    if (tid == 0) {
      int it = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const int m0 = u / n_tiles * kBM, n0 = u % n_tiles * kBN;
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int st = it % kStages;
          if (it >= kStages) mbar_wait(empty(st), (it / kStages - 1) & 1);
          mbar_expect_tx(full(st), kABytes + kBBytes);
          tma_load_2d(s_a + st * kABytes, &tm_a, kt * kBK, m0, full(st));
#pragma unroll
          for (int hf = 0; hf < kHalves; ++hf)
            tma_load_2d(s_b + st * kBBytes + hf * 128 * 128, &tm_b,
                        kt * kBK, n0 + hf * 128, full(st));
        }
      }
    }
    __syncwarp();
    return;
  }

  const int c = wg - 1;   // this consumer's 64 rows
  float acc[kHalves][64];
  int it = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int m0 = u / n_tiles * kBM, n0 = u % n_tiles * kBN;
#pragma unroll
    for (int hf = 0; hf < kHalves; ++hf)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[hf][i] = 0.f;
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int st = it % kStages;
      mbar_wait(full(st), (it / kStages) & 1);
      const uint64_t da =
          tim_attn::fwd90::desc<64>(s_a + st * kABytes + c * 64 * 128);
      const uint64_t db = tim_attn::fwd90::desc<64>(s_b + st * kBBytes);
      tim_attn::sm90::wg_fence();
      // half hf's B rows start 128 rows of 128 bytes on (a half past n
      // reads the zeros TMA wrote there)
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
        for (int hf = 0; hf < kHalves; ++hf)
          tim_attn::sm90::wgmma_ss<0, 0, true>(acc[hf], da + 2 * kk,
                                               db + hf * 1024 + 2 * kk);
      tim_attn::sm90::wg_commit();
      tim_attn::sm90::wg_wait<0>();
#pragma unroll
      for (int hf = 0; hf < kHalves; ++hf)
        tim_attn::sm90::fence_regs(acc[hf]);
      mbar_arrive(empty(st));   // the stage is free for the producer
    }
    epilogue<EPI>(acc, e, m0, n0, min(kHalves, (e.n - n0) / 128), gbase,
                  tid);
  }
}

// out = bf16(LN(bf16(a + b))) per row (b null: LN(a)), one warp a row,
// 4 columns (8 bytes) a lane a step, the row kept in registers: NC steps
// of 128 columns (cols = 128 NC); out may be a.
template <int NC>
__global__ void __launch_bounds__(256)
    ln_rows_kernel(const __nv_bfloat16* a, const __nv_bfloat16* b,
                   const float* gamma, const float* beta,
                   __nv_bfloat16* out, int rows, float eps) {
  constexpr int cols = 128 * NC;
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float v[NC][4];
  float sum = 0.f, sq = 0.f;
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int c = j * 128 + lane * 4;
    tim::load_floats<__nv_bfloat16, 4>(a + row * cols + c, v[j]);
    if (b != nullptr) {
      float y[4];
      tim::load_floats<__nv_bfloat16, 4>(b + row * cols + c, y);
#pragma unroll
      for (int t = 0; t < 4; ++t) v[j][t] = round_bf16(v[j][t] + y[t]);
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      sum += v[j][t];
      sq += v[j][t] * v[j][t];
    }
  }
  const float mu = tim::warp_sum(sum) / cols;
  const float rstd =
      rsqrtf(fmaxf(tim::warp_sum(sq) / cols - mu * mu, 0.f) + eps);
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int c = j * 128 + lane * 4;
    const float4 ga = __ldg(reinterpret_cast<const float4*>(gamma + c));
    const float4 be = __ldg(reinterpret_cast<const float4*>(beta + c));
    uint2 w;
    w.x = tim_attn::pack_bf16((v[j][0] - mu) * rstd * ga.x + be.x,
                              (v[j][1] - mu) * rstd * ga.y + be.y);
    w.y = tim_attn::pack_bf16((v[j][2] - mu) * rstd * ga.z + be.z,
                              (v[j][3] - mu) * rstd * ga.w + be.w);
    *reinterpret_cast<uint2*>(out + row * cols + c) = w;
  }
}

// The row pass for cols a multiple of 128 up to 2048 (the tail's C);
// returns the launch error.
inline int launch_ln_rows(const __nv_bfloat16* a, const __nv_bfloat16* b,
                          const float* gamma, const float* beta,
                          __nv_bfloat16* out, int rows, int cols, float eps,
                          cudaStream_t stream) {
  const unsigned blocks = (unsigned)((rows + 7) / 8);
  switch (cols / 128 * (cols % 128 == 0)) {
#define TIM_LN_ROWS(NC)                                               \
  case NC:                                                            \
    ln_rows_kernel<NC><<<blocks, 256, 0, stream>>>(a, b, gamma, beta, \
                                                   out, rows, eps);   \
    break;
    TIM_LN_ROWS(1) TIM_LN_ROWS(2) TIM_LN_ROWS(3) TIM_LN_ROWS(4)
    TIM_LN_ROWS(5) TIM_LN_ROWS(6) TIM_LN_ROWS(7) TIM_LN_ROWS(8)
    TIM_LN_ROWS(9) TIM_LN_ROWS(10) TIM_LN_ROWS(11) TIM_LN_ROWS(12)
    TIM_LN_ROWS(13) TIM_LN_ROWS(14) TIM_LN_ROWS(15) TIM_LN_ROWS(16)
#undef TIM_LN_ROWS
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The TMA map of a row-major [rows, cols] bf16 matrix, boxes of 128 rows x
// 64 columns (128 bytes) in the 128-byte swizzle; rows past the end read
// as zeros.
inline int tile_map(CUtensorMap* map, const void* base, long long rows,
                    int cols) {
  // boxes of 128 rows (a 256-row B tile is two of them)
  const auto encode = tim_attn::fwd90::encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  cuuint32_t box[2] = {kBK, kBM};
  cuuint32_t step[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
      dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

constexpr int kMaxDevices = 64;
namespace {
template <int EPI>
int smem_set[kMaxDevices] = {};
}  // namespace

template <int EPI>
int launch_gemm(const CUtensorMap& tm_a, const CUtensorMap& tm_b,
                const EpiParams& e, cudaStream_t stream) {
  auto kernel = gemm_kernel<EPI>;
  int device = 0;
  int err = (int)cudaGetDevice(&device);
  if (err != 0) return err;
  if (device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!smem_set<EPI>[device]) {
    err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != 0) return err;
    smem_set<EPI>[device] = 1;
  }
  const long long units =
      (long long)((e.m + kBM - 1) / kBM) * ((e.n + kBN - 1) / kBN);
  if (units > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  long long blocks = units;
  if (EPI == kGelu) {   // one block an SM
    int sms = 0;
    err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      device);
    if (err != 0) return err;
    blocks = units < sms ? units : sms;
  }
  kernel<<<(unsigned)blocks, kThreads, kSmem, stream>>>(tm_a, tm_b, e);
  return (int)cudaGetLastError();
}

// The bf16 tail: x, attn, y, out [n, c], h [n, ff], w1 [ff, c], w2 [c, ff]
// bf16, contiguous; the rest fp32. c and ff multiples of 128. Returns the
// first launch error.
inline int launch(const __nv_bfloat16* x, const __nv_bfloat16* attn,
                  const float* g1, const float* be1, const __nv_bfloat16* w1,
                  const float* b1, const __nv_bfloat16* w2, const float* b2,
                  const float* g2, const float* be2, __nv_bfloat16* y,
                  __nv_bfloat16* h, __nv_bfloat16* out, int n, int c, int ff,
                  float eps, cudaStream_t stream) {
  int err = launch_ln_rows(x, attn, g1, be1, y, n, c, eps, stream);
  if (err != 0) return err;
  CUtensorMap tm_y, tm_w1, tm_h, tm_w2;
  err = tile_map(&tm_y, y, n, c);
  if (err == 0) err = tile_map(&tm_w1, w1, ff, c);
  if (err == 0) err = tile_map(&tm_h, h, n, ff);
  if (err == 0) err = tile_map(&tm_w2, w2, c, ff);
  if (err != 0) return err;
  EpiParams e1{n, ff, c, b1, h, nullptr};
  err = launch_gemm<kGelu>(tm_y, tm_w1, e1, stream);
  if (err != 0) return err;
  EpiParams e2{n, c, ff, b2, out, y};
  err = launch_gemm<kResidual>(tm_h, tm_w2, e2, stream);
  if (err != 0) return err;
  return launch_ln_rows(out, nullptr, g2, be2, out, n, c, eps, stream);
}

}  // namespace tim_fpa
