// Multi-head flash attention for Hopper (sm_90a), backward, bf16 at head
// dims 80, 96, 112 and 128: the instances of the two wgmma passes of
// flash_mha_bwd_wide_sm90.cuh (whose comment gives the function, the bound
// and the design), which flash_mha_bwd.cu's entry dispatches to. Kept in a
// source of their own so that nvcc builds them beside flash_mha_bwd.cu's.
//
// Replaces: the backward of tim_tpu/ops/flash.py::flash_mha (the public
// Pallas TPU flash kernel's dkv and dq kernels, tiles set at
// flash.py:71-79) between head dims 64 and 128.

#include "flash_mha_bwd_wide_sm90.cuh"

namespace tim_attn {

int launch_mha_bwd_bf16_wide(const void* q, const void* k, const void* v,
                             const void* o, const void* dout, void* dq,
                             void* dk, void* dv, const long long* strides,
                             const float* lse, float* delta, int batch,
                             int heads, int seq, int dh, int inst,
                             float scale, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  bwd90::Params p{};
  p.q = static_cast<const bf*>(q); p.k = static_cast<const bf*>(k);
  p.v = static_cast<const bf*>(v); p.o = static_cast<const bf*>(o);
  p.dout = static_cast<const bf*>(dout);
  p.dq = static_cast<bf*>(dq); p.dk = static_cast<bf*>(dk);
  p.dv = static_cast<bf*>(dv);
  Strides* s[8] = {&p.sq, &p.sk, &p.sv, &p.so, &p.sdo, &p.sdq, &p.sdk,
                   &p.sdv};
  for (int i = 0; i < 8; ++i)
    *s[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  p.lse = lse; p.stats = delta;
  p.batch = batch; p.heads = heads; p.seq = seq; p.dh = dh;
  p.seq_pad = (seq + 3) / 4 * 4;
  p.scale = scale;
  switch (inst) {
    case 80: return bwd90::launch<80>(p, stream);
    case 96: return bwd90::launch<96>(p, stream);
    case 112: return bwd90::launch<112>(p, stream);
    case 128: return bwd90::launch<128>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace tim_attn
