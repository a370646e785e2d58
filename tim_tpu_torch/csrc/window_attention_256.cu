// Swin3D (shifted-)window attention for Hopper (sm_90a), forward: kernel
// 4's bf16 instances 128 and 256 of the wgmma core of
// flash_attention_sm90.cuh (whose comment gives the function and the
// design), which window_attention.cu's entry dispatches to (a source of
// their own, built beside the others).
//
// Replaces: tim_tpu/ops/pallas_swin.py::window_attention_flash (forward
// _kernel :71, pl.pallas_call :99) at bf16 head dims 113-256 (a Swin-B
// trunk at num_heads (1, 1, 1, 1): 128 at stage 1, 256 at stage 2).
//
// What bounds it on the H100: as window_attention_wide.cu, the products
// (161 GFLOP a Swin-B stage at batch 8, 0.16 ms at 989 TFLOP/s).

#include "flash_attention_sm90.cuh"

namespace tim_attn {

int launch_window_256(const Params& p, int inst, cudaStream_t stream) {
  switch (inst) {
    case 128: return launch_bf16<128, true>(p, stream);
    case 256: return launch_bf16<256, true>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace tim_attn
