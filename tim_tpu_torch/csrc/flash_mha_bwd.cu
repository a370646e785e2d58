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

#include "flash_attention_bwd.cuh"
#include "flash_mha_bwd_sm90.cuh"

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

// Head dims 64, 128 and 256, as the forward (bf16 past 64 takes the wide
// mma.sync passes of flash_attention_bwd.cuh, atomic-free). strides: 24
// element strides, (batch, head, row) for q, k, v, o, do, dq, dk and dv. lse: the forward's [batch, heads,
// seq] fp32 row statistic; delta: [batch, heads, seq] fp32 scratch;
// dq_accum: [batch, heads, seq, 64] fp32 scratch (bf16 only; zeroed
// here), or null for bf16's deterministic route (dq without atomic adds).
// Returns the first CUDA error of the launches (0 on success).
extern "C" int tim_flash_mha_bwd(const void* q, const void* k, const void* v,
                                 const void* o, const void* dout, void* dq,
                                 void* dk, void* dv, const long long* strides,
                                 const float* lse, float* delta,
                                 float* dq_accum, int batch, int heads,
                                 int seq, int dh, int is_bf16, float scale,
                                 void* stream) {
  if (dh != kDH && dh != 128 && dh != 256) return (int)cudaErrorInvalidValue;
  if (batch <= 0 || heads <= 0 || seq <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dh != kDH) {
    tim_attn::BwdParams p{};
    p.q = q; p.k = k; p.v = v; p.o = o; p.dout = dout;
    p.dq = dq; p.dk = dk; p.dv = dv;
    tim_attn::set_bwd_strides(p, strides);
    p.lse = lse; p.delta = delta;
    p.batch = batch; p.heads = heads; p.seq = seq; p.scale = scale;
    p.bias = nullptr; p.region = nullptr; p.n_win = 1; p.dbias = nullptr;
    if (is_bf16)
      return dh == 128 ? tim_attn::launch_bwd_bf16_wide<128>(p, st)
                       : tim_attn::launch_bwd_bf16_wide<256>(p, st);
    return dh == 128 ? tim_attn::launch_bwd_f32<128, false>(p, st)
                     : tim_attn::launch_bwd_f32<256, false>(p, st);
  }
  if (is_bf16) {
    using bf = __nv_bfloat16;
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
