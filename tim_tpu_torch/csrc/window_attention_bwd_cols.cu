// Swin3D (shifted-)window attention for Hopper (sm_90a), backward, by the
// column-chunk passes: the column-slice passes of
// attention_cols_bwd_sm90.cuh (bf16, wgmma) and attention_cols_bwd.cuh
// (fp32 on the CUDA cores, and D; whose comments give the design) with
// kernel 4b's bias and shift mask in every score, any head dim,
// atomic-free; bf16 at 256 and past it, fp32 at 128 and past it. dS is the
// same in every column slice; dbias is summed once, by window_dbias_sm90.cuh's
// pass in bf16 and by attention_cols_bwd.cuh's dbias kernel in fp32. A
// source of its own, built beside the others.
//
// Replaces: tim_tpu/ops/pallas_swin.py::window_attention_flash's backward
// (_bwd_kernel :109, pl.pallas_call :173) at bf16 head dims 129 and up and
// fp32 65 and up (a Swin-B trunk at num_heads (1, 1, 1, 1): 256 at stage
// 2, 512 at stage 3, 1024 at stage 4).
//
// What bounds it on the H100: 5 products of 2 N^2 dh per (window, head)
// (403 GFLOP a Swin-B stage at batch 8); the bf16 route recomputes S and
// dP in each output slice of each pass (9 products' worth at 256, 15 at
// 512).

#include "attention_cols_bwd_sm90.cuh"

namespace tim_attn {

int launch_window_bwd_cols(const BwdParams& p, int dh, bool bf16,
                           cudaStream_t stream) {
  if (bf16) return launch_bwd_cols_bf16<true>(p, dh, stream);
  const int err = launch_bwd_cols_f32<true>(p, dh, stream);
  return err != 0 ? err : launch_dbias_cols_f32(p, dh, stream);
}

}  // namespace tim_attn
