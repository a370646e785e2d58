// Multi-head flash attention for Hopper (sm_90a), backward, bf16 at head
// dims 129-256: the instances 192 and 256 of the two split wgmma passes of
// flash_mha_bwd_256_sm90.cuh (whose comment gives the function, the bound
// and the design), which flash_mha_bwd.cu's entry dispatches to. Kept in a
// source of their own so that nvcc builds them beside flash_mha_bwd.cu's.
//
// Replaces: the backward of tim_tpu/ops/flash.py::flash_mha (the public
// Pallas TPU flash kernel's dkv and dq kernels, tiles set at
// flash.py:71-79) between head dims 128 and 256.

#include "flash_mha_bwd_256_sm90.cuh"

namespace tim_attn {

// inst 192 or 256; dh a multiple of 8 above inst - 64, up to inst.
int launch_mha_bwd_bf16_256(const BwdParams& p, int dh, int inst,
                            cudaStream_t stream) {
  switch (inst) {
    case 192: return split90::launch<3>(p, dh, stream);
    case 256: return split90::launch<4>(p, dh, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace tim_attn
