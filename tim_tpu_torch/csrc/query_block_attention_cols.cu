// TIM query-block attention for Hopper (sm_90a) at bf16 head dims past 160
// and fp32 past 256: the column-slice route of attention_cols_sm90.cuh with
// the self key (each query token's softmax over its F context keys and its
// own key), bf16 on wgmma and fp32 on the CUDA cores, any head dim and any
// F.
//
// Replaces: tim_tpu/ops/pallas_attention.py::query_block_attention
// (kernel body _query_block_kernel, pl.pallas_call at :89) past the head
// dims of query_block_attention.cu's designs: TIM at cli --nhead 4 (an
// encoder 1024 wide: head dim 256), --d_model 600 / 540 --nhead 6 (200,
// 180), --nhead 2 (512) or 1 (1024), or --d_model 450 --nhead 3 (300).
//
// What bounds it on the H100: as at head dim 128, device-memory bytes
// (q/k/v read once, the output written once: 0.889 GB at [128, 4, 798,
// 256] or [128, 2, 798, 512], F 100; 0.27 ms at 3.35 TB/s), since H dh is
// the same. A block takes 128 query rows and one 256-column output slice,
// and forms the scores over the full head dim from 64-column boxes of q
// and the context keys (TMA, a five-stage ring), the self score from q and
// kq's boxes first. Up to head dim 256 that is the whole head in one
// slice: Q K^T once, on wgmma, where the tensor-core design of
// query_block_attention.cu runs out of registers past 160 and the CUDA-core
// design issued a shared-memory load and a shuffle per key (3.96 ms at
// [128, 8, 798, 128]). At 512 the slices of one query tile read q and the
// context twice, the second time mostly from L2. From 513 to 2048 in bf16
// the slices of a query tile run as one thread-block cluster: each keeps
// its 256 columns of q resident and forms its share of the scores and of
// the self score, summed across the cluster in rank order
// (attention_cols_sm90.cuh).

#include "attention_cols_sm90.cuh"

// qq, kq, vq: [batch, heads, nq, dh]; kc, vc: [batch, heads, f, dh]; views
// with the last dim contiguous (bf16: rows 16-byte aligned, dh a multiple
// of 8; the wrapper, ops/query_block_attention.py, copies other inputs
// into zero-padded rows); a batch stride of 0 reads one entry for every
// batch. out: contiguous [batch, heads, nq, dh]. strides: 15 element
// strides, (batch, head, row) for qq, kc, kq, vc, vq. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int tim_query_block_attention_cols(
    const void* qq, const void* kc, const void* kq, const void* vc,
    const void* vq, void* out, const long long* strides, int batch,
    int heads, int nq, int f, int dh, int is_bf16, float scale,
    void* stream) {
  tim_attn::ColsParams p{};
  p.q = qq; p.k = kc; p.v = vc; p.out = out; p.kq = kq; p.vq = vq;
  // q, k, v, out, kq, vq: out contiguous
  const long long st[18] = {
      strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
      strides[9], strides[10], strides[11],
      (long long)heads * nq * dh, (long long)nq * dh, dh,
      strides[6], strides[7], strides[8], strides[12], strides[13],
      strides[14]};
  tim_attn::set_cols_strides(p, st);
  p.batch = batch; p.heads = heads; p.nq = nq; p.nk = f; p.dh = dh;
  p.scale = scale; p.lse = nullptr;
  return tim_attn::launch_cols<true>(p, is_bf16 != 0,
                                     static_cast<cudaStream_t>(stream));
}
