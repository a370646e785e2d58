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
// dh 128, 8 heads) every query row of q/k/v is read once and the output
// written once, at about 50 flop per byte, far below the card's
// tensor-core ridge, so the roofline bound is device-memory bytes (about
// 0.84 GB per call at batch 128 in bf16: 0.25 ms at 3.35 TB/s). The
// XLA/einsum formulation also writes and re-reads a [B, H, Nq, F] fp32
// score tensor; this kernel never materialises it. This CUDA-core design
// is instead bound by issuing shared-memory loads and shuffles per key:
// 3.95 ms at that shape against 6.34 ms for the plain PyTorch version
// (H100 80GB HBM3, 700 W power limit). Tensor-core QK^T/PV tiles are the
// next step.
//
// Design: one block per (batch*head, tile of 128 queries). The block copies
// that head's kc and vc ([F, dh], 51 KB in bf16, 102 KB in fp32 -- more
// than 48 KB, hence dynamic shared memory and cudaFuncSetAttribute) into
// shared memory once, then each warp walks its queries one at a time: lane
// l holds dims [l*dh/32, (l+1)*dh/32) of the scaled query (one vector load
// per key row from shared memory), the F context scores are warp-shuffle
// reductions done 32 keys at a time, the max/exp/sum is the stable
// softmax over all F+1 scores in fp32, and the context values are
// accumulated from shared memory in fp32. Nq is not padded to a tile (a
// TPU tiling contract): the ragged last tile is bounded by q1 below, and
// F needs no power of two.
// q/k/v arrive as strided views of the packed projection (and, in layer 0,
// a batch-broadcast query block): the kernel takes (batch, head, row)
// element strides per tensor, so no copy is made and a stride-0 batch is
// read as what it is.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

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
  float scale;
};

template <typename T>
__device__ __forceinline__ const T* head_ptr(const void* p, const Strides& s,
                                             int b, int h) {
  return static_cast<const T*>(p) + b * s.b + h * s.h;
}

template <typename T, int DPL>  // DPL = dh / 32 dims per lane
__global__ void __launch_bounds__(kWarps * 32)
    query_block_kernel(const Args a) {
  constexpr int DH = DPL * 32;
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
    s_kc[i] = kc[j * a.s_kc.n + d];
    s_vc[i] = vc[j * a.s_vc.n + d];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* p = s_p + warp * a.f;
  const T* qq = head_ptr<T>(a.qq, a.s_qq, b, h);
  const T* kq = head_ptr<T>(a.kq, a.s_kq, b, h);
  const T* vq = head_ptr<T>(a.vq, a.s_vq, b, h);
  T* out = static_cast<T*>(a.out) + (long long)bh * a.nq * DH;

  const int q0 = blockIdx.x * kQueriesPerBlock;
  const int q1 = min(a.nq, q0 + kQueriesPerBlock);
  const int d0 = lane * DPL;  // this lane's dims: [d0, d0 + DPL)
  for (int n = q0 + warp; n < q1; n += kWarps) {
    float q[DPL];
    float self = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      q[i] = to_f(qq[n * a.s_qq.n + d0 + i]) * a.scale;
      self += q[i] * to_f(kq[n * a.s_kq.n + d0 + i]);
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
        load_floats<T, DPL>(s_kc + min(j0 + t, a.f - 1) * DH + d0, k);
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
      load_floats<T, DPL>(s_vc + j * DH + d0, v);
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[i] += w * v[i];
    }
    const float w_self = e_self * inv;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      out[(long long)n * DH + d0 + i] =
          from_f<T>(acc[i] + w_self * to_f(vq[n * a.s_vq.n + d0 + i]));
    }
    __syncwarp();  // p is rewritten by this warp's next query
  }
}

template <typename T, int DPL>
int launch(const Args& a, int bh, cudaStream_t stream) {
  const size_t smem = 2 * (size_t)a.f * DPL * 32 * sizeof(T) +
                      (size_t)kWarps * a.f * sizeof(float);
  auto kernel = query_block_kernel<T, DPL>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.nq + kQueriesPerBlock - 1) / kQueriesPerBlock, bh);
  kernel<<<grid, kWarps * 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Args& a, int bh, int dh, cudaStream_t stream) {
  switch (dh) {
    case 32: return launch<T, 1>(a, bh, stream);
    case 64: return launch<T, 2>(a, bh, stream);
    case 128: return launch<T, 4>(a, bh, stream);
    case 256: return launch<T, 8>(a, bh, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// strides: 15 element strides, (batch, head, row) for qq, kc, kq, vc, vq.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int tim_query_block_attention(
    const void* qq, const void* kc, const void* kq, const void* vc,
    const void* vq, void* out, const long long* strides, int batch,
    int heads, int nq, int f, int dh, int is_bf16, float scale,
    void* stream) {
  Args a;
  a.qq = qq; a.kc = kc; a.kq = kq; a.vc = vc; a.vq = vq; a.out = out;
  Strides* s[5] = {&a.s_qq, &a.s_kc, &a.s_kq, &a.s_vc, &a.s_vq};
  for (int t = 0; t < 5; ++t) {
    s[t]->b = strides[3 * t];
    s[t]->h = strides[3 * t + 1];
    s[t]->n = strides[3 * t + 2];
  }
  a.heads = heads; a.nq = nq; a.f = f; a.scale = scale;
  const int bh = batch * heads;
  if (nq <= 0 || bh <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<__nv_bfloat16>(a, bh, dh, st)
                 : dispatch<float>(a, bh, dh, st);
}
