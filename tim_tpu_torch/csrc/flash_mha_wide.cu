// Multi-head flash attention for Hopper (sm_90a), forward, bf16 at head
// dims 80, 96 and 112: the instances of flash_attention_sm90.cuh's wgmma
// core between 64 and 128 that flash_mha.cu's entry dispatches to (kept in
// a source of their own so that nvcc builds them beside flash_mha.cu's).
//
// Replaces: tim_tpu/ops/flash.py::flash_mha (the public Pallas TPU flash
// kernel, fa.flash_attention at :104) at the public VideoMAE widths past
// 64: ViT-H/16 (head dim 80), ViT-g/14 (88, on the 96 instance) and
// ViT-G/14 (104, on the 112 instance).
//
// What bounds it on the H100: as at head dim 64, the products (4 S^2 dh
// flops per (batch, head): 100.7 GFLOP at [8, 16, 1568, 80], 0.10 ms at
// 989 TFLOP/s) and one exponential a score (0.08 ms), not memory. The
// instance is the head dim rounded up to 16 (a wgmma k-step): a tile is a
// 64-column block in the 128-byte swizzle plus a 32- and / or 16-column
// block in the 64- / 32-byte swizzle (no swizzle is 48 or 96 bytes wide),
// each its own TMA box and wgmma operand, so the products do only the
// instance's columns (an 80-wide head on the 128 instance did 1.6x the
// products). The TMA maps span the true head dim, and TMA fills the
// columns past it with zeros: a head dim that is a multiple of 8 with
// 16-byte aligned rows (80, 88, 104) is read in place, with no copy.

#include "flash_attention_sm90.cuh"

namespace tim_attn {

int launch_mha_bf16_wide(const Params& p, int inst, cudaStream_t stream) {
  switch (inst) {
    case 80: return launch_bf16<80, false>(p, stream);
    case 96: return launch_bf16<96, false>(p, stream);
    case 112: return launch_bf16<112, false>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace tim_attn
