// Swin3D (shifted-)window attention for Hopper (sm_90a), forward, fp32 past
// head dim 32: kernel 4's instances 64 (flash_attention.cuh's
// one-row-a-thread kernel) and 128 and 256 (its wide kernel, 64 output
// columns a block), each with the bias and the region ids, on the CUDA
// cores without TF32 (the parity path); window_attention.cu's entry
// dispatches here (a source of their own, built beside the others).
//
// Replaces: tim_tpu/ops/pallas_swin.py::window_attention_flash (forward
// _kernel :71, pl.pallas_call :99) in fp32 at head dims 33-256.

#include "flash_attention.cuh"

namespace tim_attn {

int launch_window_f32(const Params& p, int inst, cudaStream_t stream) {
  if (p.batch <= 0 || p.heads <= 0 || p.seq <= 0) return 0;
  const bool lse = p.lse != nullptr;
  switch (inst) {
    case 64: return lse ? launch_f32<64, true, true>(p, stream)
                        : launch_f32<64, true, false>(p, stream);
    case 128: return lse ? launch_f32<128, true, true>(p, stream)
                         : launch_f32<128, true, false>(p, stream);
    case 256: return lse ? launch_f32<256, true, true>(p, stream)
                         : launch_f32<256, true, false>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace tim_attn
