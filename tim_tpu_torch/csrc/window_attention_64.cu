// Swin3D (shifted-)window attention for Hopper (sm_90a), forward, bf16 at
// head dims 33-64: kernel 4's window-pair design with the bias brought by
// TMA (window_attention_sm90.cuh, whose comment gives the function, the
// bound and the design), which window_attention.cu's entry dispatches to.
// Instance 48 reads head dims 40 and 48 in place, instance 64 56 and 64;
// any other head dim in 33-64 comes zero-padded to the next of them
// (ops/window_attention.py::launch_plan).
//
// Replaces: tim_tpu/ops/pallas_swin.py::window_attention_flash (forward
// _kernel :71, pl.pallas_call :99) at the head dims a Swin trunk built
// with other heads gives (SwinTransformer3D(embed_dim, num_heads):
// Swin-B at num_heads (2, 4, 8, 16): 64 at every stage; embed_dim 120,
// num_heads (3, 6, 12, 24): 40).

#include "window_attention_sm90.cuh"

namespace tim_attn {

// Each instance's tiles: keys a tile, ring stages, blocks an SM, the
// fastest of those `python -m tim_tpu_torch.ablate --kernel 4 --head_dim
// 64 | 48` builds and times. At 64, 64-key tiles in a four-stage ring (215
// KB of shared memory at N = 784, one block an SM) beat 32-key tiles in
// three stages at two blocks an SM (95 KB, 128 registers) by 11% and 32
// keys in four stages or 64 in three by 25-35%; at 48, whose 32- and
// 16-column blocks make twice the product instructions of a tile, 32-key
// tiles in four stages beat 64 by 12%.
constexpr int kKeys64 = 64, kStages64 = 4, kBlocks64 = 1;
constexpr int kKeys48 = 32, kStages48 = 4, kBlocks48 = 1;

int launch_window_64(const Params& p, int inst, int bias_pitch,
                     cudaStream_t stream) {
  switch (inst) {
    case 48:
      return launch_window_pair<48, kKeys48, kStages48, kBlocks48>(
          p, bias_pitch, stream);
    case 64:
      return launch_window_pair<64, kKeys64, kStages64, kBlocks64>(
          p, bias_pitch, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace tim_attn
