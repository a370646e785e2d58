// Swin3D (shifted-)window attention for Hopper (sm_90a), backward, fp32 at
// head dim 64: flash_attention_bwd.cuh's CUDA-core passes (the parity
// path: D, dk/dv, dq and dbias, each recomputing the scores it needs, one
// thread a row, no TF32, no atomics) at kernel 4b's 64 instance. From 128
// the fp32 backward takes the column-chunk passes of attention_cols_bwd.cuh
// (window_attention_bwd_cols.cu), which keep a thread's sums in registers
// at any head dim. A source of its own, built beside the others.
//
// Replaces: tim_tpu/ops/pallas_swin.py::window_attention_flash's backward
// (_bwd_kernel :109, pl.pallas_call :173) in fp32 at head dims 33-64.

#include "flash_attention_bwd.cuh"

namespace tim_attn {

int launch_window_bwd_f32(const BwdParams& p, cudaStream_t stream) {
  return launch_bwd_f32<64, true>(p, stream);
}

}  // namespace tim_attn
