// The bf16 route of window_attention_bwd.cu (kernel 4b), in a source of its
// own so that nvcc builds it beside the fp32 route: D and the zeroed dq
// sum, the one-pass wgmma kernel of window_attention_bwd_sm90.cuh with the
// window groups' dbias sum, and, with a dq_accum, dq rounded out of it.

#include "window_attention_bwd_sm90.cuh"

// p: the launch's parameters (head dim 32). Returns the first CUDA error
// of the launches (0 on success).
extern "C" int tim_window_attention_bwd_sm90(
    const tim_attn::sm90::Params* p, cudaStream_t stream) {
  constexpr int kDH = 32;
  int err = tim_attn::sm90::launch_preprocess<kDH>(*p, stream);
  if (err == 0) err = tim_attn::wbwd90::launch<kDH>(*p, stream);
  if (err != 0 || p->dq_accum == nullptr) return err;
  return tim_attn::sm90::launch_postprocess<kDH>(*p, stream);
}

// The number of window groups the bf16 route sums dbias over for these
// shapes on the current device (1: no scratch needed), or -1 on a CUDA
// error.
extern "C" int tim_window_attention_bwd_groups(int batch, int heads,
                                               int seq) {
  int device = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                             device) != cudaSuccess)
    return -1;
  return tim_attn::wbwd90::window_bwd_groups(batch, heads, seq, sms);
}
