// Multi-head flash attention for Hopper (sm_90a), backward.
//
// Replaces: the backward of tim_tpu/ops/flash.py::flash_mha, i.e. the
// public Pallas TPU flash kernel's dkv and dq kernels (tiles set at
// flash.py:71-79; the JAX wrapper pads S to a multiple of 128 because
// those tiles must be multiples of 128). Here, as in the forward, the
// ragged last tile is masked and nothing is padded (S = 1568, 160, 37).
// Given q, k, v, the forward's output o and row statistic lse, and the
// output gradient do, it writes dq, dk and dv in the input dtype.
//
// What bounds it on the H100: at ViT-L's shapes ([8, 16, 1568, 64] bf16)
// the gradient is 5 products of 2 S^2 dh per (batch, head): 201 GFLOP,
// 0.20 ms at 989 TFLOP/s, against 0.1 GB of q/k/v/o/do/dq/dk/dv, so the
// tensor cores bound it, not memory. The bf16 route (flash_mha_bwd_sm90.cuh)
// is one pass with those 5 products on wgmma, the only route to the
// card's full tensor-core rate; dq sums across key blocks with fp32
// atomic adds, so its last bits may change from run to run. The fp32
// route (CUDA cores, no TF32, two passes, deterministic) is the parity
// path, from flash_attention_bwd.cuh, as is the deterministic route's dq.
//
// Past head dim 64 the one-pass sums do not fit in registers: bf16 head
// dims 80, 96, 112 and 128 (ViT-H/16's 80, ViT-g/14's 88 and ViT-G/14's 104
// read in place) take flash_mha_bwd_wide.cu's two atomic-free wgmma passes
// (dk/dv, then dq); bf16 256 the two mma.sync passes of
// flash_attention_bwd.cuh.

#include "flash_attention_bwd.cuh"
#include "flash_mha_bwd_sm90.cuh"

namespace tim_attn {
// flash_mha_bwd_wide.cu: bf16 at instances 80, 96, 112 and 128, the
// arguments of tim_flash_mha_bwd below
int launch_mha_bwd_bf16_wide(const void* q, const void* k, const void* v,
                             const void* o, const void* dout, void* dq,
                             void* dk, void* dv, const long long* strides,
                             const float* lse, float* delta, int batch,
                             int heads, int seq, int dh, int inst,
                             float scale, cudaStream_t stream);
}  // namespace tim_attn

namespace {

constexpr int kDH = 64;

// The deterministic route's dq: the atomic-free pass of
// flash_attention_bwd.cuh (one block per 64 queries walks the key tiles,
// recomputing p from lse), reading the D that the main pass's
// preprocess wrote.
int launch_dq_bf16(const void* q, const void* k, const void* v,
                   const void* dout, void* dq, const long long* strides,
                   const float* lse, float* delta, int batch, int heads,
                   int seq, float scale, cudaStream_t stream) {
  using namespace tim_attn;
  BwdParams p{};
  p.q = q; p.k = k; p.v = v; p.dout = dout; p.dq = dq;
  set_bwd_strides(p, strides);
  p.lse = lse; p.delta = delta;
  p.batch = batch; p.heads = heads; p.seq = seq; p.scale = scale;
  p.n_win = 1;
  const long long blocks = (long long)batch * heads * ((seq + 63) / 64);
  return launch_smem(dq_bf16_kernel<kDH, false>, blocks,
                     dq_smem_bytes<kDH, false>(), stream, p);
}

}  // namespace

// The instance `inst` as the forward's (64, 128, 256; in bf16 also 80, 96,
// 112): bf16 64 on the one-pass wgmma core, bf16 80-128 on the two wgmma
// passes of flash_mha_bwd_wide.cu (atomic-free), bf16 256 on the wide
// mma.sync passes (atomic-free), fp32 on the CUDA-core passes. dh: the
// head dim of every operand, the instance's, or in bf16 at 80-128 8 less
// (read in place, as the forward). strides: 24 element strides, (batch,
// head, row) for q, k, v, o, do, dq, dk and dv. lse: the forward's [batch,
// heads, seq] fp32 row statistic; delta: [batch, heads, seq] fp32 scratch
// (bf16 at 80-128: 2 x batch x heads x seq rounded up to 4 floats);
// dq_accum: [batch, heads, seq, 64] fp32 scratch (bf16 at 64 only; zeroed
// here), or null for the deterministic route (dq without atomic adds).
// Returns the first CUDA error of the launches (0 on success).
extern "C" int tim_flash_mha_bwd(const void* q, const void* k, const void* v,
                                 const void* o, const void* dout, void* dq,
                                 void* dk, void* dv, const long long* strides,
                                 const float* lse, float* delta,
                                 float* dq_accum, int batch, int heads,
                                 int seq, int dh, int inst, int is_bf16,
                                 float scale, void* stream) {
  const bool wgmma_wide = is_bf16 && inst > kDH && inst <= 128 &&
                          inst % 16 == 0;
  if (dh != inst && !(wgmma_wide && dh == inst - 8))
    return (int)cudaErrorInvalidValue;
  if (inst != kDH && inst != 128 && inst != 256 && !wgmma_wide)
    return (int)cudaErrorInvalidValue;
  if (batch <= 0 || heads <= 0 || seq <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  if (wgmma_wide)
    return tim_attn::launch_mha_bwd_bf16_wide(q, k, v, o, dout, dq, dk, dv,
                                              strides, lse, delta, batch,
                                              heads, seq, dh, inst, scale,
                                              st);
  if (inst != kDH) {
    tim_attn::BwdParams p{};
    p.q = q; p.k = k; p.v = v; p.o = o; p.dout = dout;
    p.dq = dq; p.dk = dk; p.dv = dv;
    tim_attn::set_bwd_strides(p, strides);
    p.lse = lse; p.delta = delta;
    p.batch = batch; p.heads = heads; p.seq = seq; p.scale = scale;
    p.bias = nullptr; p.region = nullptr; p.n_win = 1; p.dbias = nullptr;
    if (is_bf16) return tim_attn::launch_bwd_bf16_wide<256>(p, st);
    return inst == 128 ? tim_attn::launch_bwd_f32<128, false>(p, st)
                       : tim_attn::launch_bwd_f32<256, false>(p, st);
  }
  if (is_bf16) {
    tim_attn::sm90::Params p{};
    p.q = static_cast<const bf*>(q); p.k = static_cast<const bf*>(k);
    p.v = static_cast<const bf*>(v); p.o = static_cast<const bf*>(o);
    p.dout = static_cast<const bf*>(dout);
    p.dq = static_cast<bf*>(dq); p.dk = static_cast<bf*>(dk);
    p.dv = static_cast<bf*>(dv);
    tim_attn::Strides* s[8] = {&p.sq, &p.sk, &p.sv, &p.so,
                               &p.sdo, &p.sdq, &p.sdk, &p.sdv};
    for (int i = 0; i < 8; ++i)
      *s[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
    p.lse = lse; p.delta = delta; p.dq_accum = dq_accum;
    p.batch = batch; p.heads = heads; p.seq = seq; p.scale = scale;
    const int err = tim_attn::sm90::launch(p, st);
    if (err != 0 || dq_accum != nullptr) return err;
    return launch_dq_bf16(q, k, v, dout, dq, strides, lse, delta, batch,
                          heads, seq, scale, st);
  }
  tim_attn::BwdParams p{};
  p.q = q; p.k = k; p.v = v; p.o = o; p.dout = dout;
  p.dq = dq; p.dk = dk; p.dv = dv;
  tim_attn::set_bwd_strides(p, strides);
  p.lse = lse; p.delta = delta;
  p.batch = batch; p.heads = heads; p.seq = seq; p.scale = scale;
  p.bias = nullptr; p.region = nullptr; p.n_win = 1; p.dbias = nullptr;
  return tim_attn::launch_bwd_f32<kDH, false>(p, st);
}
