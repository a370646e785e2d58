// The bf16 route of fused_post_attention.cu (kernel 2), in a source of its
// own so that nvcc builds it beside the fp32 route: the LayerNorm row
// passes and the two wgmma GEMMs of fused_post_attention_sm90.cuh.

#include "fused_post_attention_sm90.cuh"

// x, attn, y, out [n, c], h [n, ff], w1 [ff, c], w2 [c, ff] bf16,
// contiguous; LayerNorm parameters and biases fp32. Returns the first CUDA
// error of the launches (0 on success).
extern "C" int tim_fused_post_attention_sm90(
    const void* x, const void* attn, const void* ln1_w, const void* ln1_b,
    const void* w1, const void* b1, const void* w2, const void* b2,
    const void* ln2_w, const void* ln2_b, void* y, void* h, void* out, int n,
    int c, int ff, float eps, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto cb = [](const void* p) { return static_cast<const bf*>(p); };
  return tim_fpa::launch(cb(x), cb(attn), f(ln1_w), f(ln1_b), cb(w1), f(b1),
                         cb(w2), f(b2), f(ln2_w), f(ln2_b),
                         static_cast<bf*>(y), static_cast<bf*>(h),
                         static_cast<bf*>(out), n, c, ff, eps, stream);
}
