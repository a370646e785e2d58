// Swin3D (shifted-)window attention for Hopper (sm_90a), backward, bf16
// dq, dk and dv at head dims 64, 80, 96, 112 and 128: the two atomic-free
// wgmma passes of flash_mha_bwd_wide_sm90.cuh (dk/dv by 128-key blocks,
// then dq by 128-query blocks; whose comment gives the design) with kernel
// 4b's bias and shift mask in every score. dbias is the pass of
// window_dbias_sm90.cuh. window_attention_bwd.cu's entry dispatches here
// (a source of its own, built beside the others).
//
// Replaces: tim_tpu/ops/pallas_swin.py::window_attention_flash's backward
// (_bwd_kernel :109, pl.pallas_call :173) at head dims 33-128 (a Swin-B
// trunk at num_heads (2, 4, 8, 16): 64 at every stage).
//
// What bounds it on the H100: 5 products of 2 N^2 dh per (window, head)
// (403 GFLOP a Swin-B stage at batch 8, 0.41 ms at 989 TFLOP/s); these
// two passes do 7.

#include "flash_attention_bwd.cuh"
#include "flash_mha_bwd_wide_sm90.cuh"

namespace tim_attn {

// bp: the launch's operands (dbias untouched); stats: bp.delta, the
// [2][batch * heads][seq rounded up to 4] lse and D rows of the passes.
int launch_window_bwd_wide(const BwdParams& bp, int dh, int inst,
                           cudaStream_t stream) {
  using bf = __nv_bfloat16;
  bwd90::Params p{};
  p.q = static_cast<const bf*>(bp.q); p.k = static_cast<const bf*>(bp.k);
  p.v = static_cast<const bf*>(bp.v); p.o = static_cast<const bf*>(bp.o);
  p.dout = static_cast<const bf*>(bp.dout);
  p.dq = static_cast<bf*>(bp.dq); p.dk = static_cast<bf*>(bp.dk);
  p.dv = static_cast<bf*>(bp.dv);
  p.sq = bp.sq; p.sk = bp.sk; p.sv = bp.sv; p.so = bp.so;
  p.sdo = bp.sdo; p.sdq = bp.sdq; p.sdk = bp.sdk; p.sdv = bp.sdv;
  p.lse = bp.lse; p.stats = bp.delta;
  p.batch = bp.batch; p.heads = bp.heads; p.seq = bp.seq; p.dh = dh;
  p.seq_pad = (bp.seq + 3) / 4 * 4;
  p.scale = bp.scale;
  p.bias = bp.bias; p.region = bp.region; p.n_win = bp.n_win;
  switch (inst) {
    case 64: return bwd90::launch<64, true>(p, stream);
    case 80: return bwd90::launch<80, true>(p, stream);
    case 96: return bwd90::launch<96, true>(p, stream);
    case 112: return bwd90::launch<112, true>(p, stream);
    case 128: return bwd90::launch<128, true>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace tim_attn
