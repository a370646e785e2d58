// Swin3D (shifted-)window attention for Hopper (sm_90a), forward, bf16 at
// head dims 80, 96 and 112: kernel 4's instances of the wgmma core of
// flash_attention_sm90.cuh (whose comment gives the function and the
// design) past its own design's head dims (48 and 64,
// window_attention_64.cu), which window_attention.cu's entry dispatches to
// (kept in a source of their own so that nvcc builds them beside the
// others).
//
// Replaces: tim_tpu/ops/pallas_swin.py::window_attention_flash (forward
// _kernel :71, pl.pallas_call :99) at the head dims a Swin trunk built
// with other heads gives (SwinTransformer3D(embed_dim, num_heads):
// dh = embed_dim / num_heads per stage; embed_dim 160 at num_heads (2, 4,
// 8, 16): 80 at every stage).
//
// What bounds it on the H100: the products, 4 N^2 dh flops per (window,
// head), whose sum over a stage does not change with the heads (H dh = C:
// 161 GFLOP at Swin-B's stage 1, batch 8, 0.16 ms at 989 TFLOP/s), and
// one exponential a score (at dh 64 half of dh 32's: 0.63 G, 0.15 ms).
// The instance is the head dim rounded up to 16 past 64, as kernel 5's: a
// head dim 8 below it (72, 88, 104) is read in place by TMA.

#include "flash_attention_sm90.cuh"

namespace tim_attn {

int launch_window_wide(const Params& p, int inst, cudaStream_t stream) {
  switch (inst) {
    case 80: return launch_bf16<80, true>(p, stream);
    case 96: return launch_bf16<96, true>(p, stream);
    case 112: return launch_bf16<112, true>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace tim_attn
