"""The CUDA kernels of ``tim_tpu_torch`` against their plain PyTorch
versions, on the card. Imports no JAX, so it runs where only the port is
installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

(``--noconftest``: the repo's conftest configures JAX.) Without a CUDA
card every test skips."""

import numpy as np
import pytest
import torch

from chip_smoke import (LSE_TOL, SWIN_STAGES, ULP_ENVELOPE, attention_close,
                        emulated_attention_bwd, flash_bwd_case, fused_close,
                        grad_close, int8_close, int8_head_args, kernel_close,
                        launch_counters,
                        swin_bias, swin_qkv, swin_scores, tail_args,
                        tail_with_ln2_over_half, vit_qkv, vit_scores,
                        window_bwd_case)
from tim_tpu_torch import config as C
from tim_tpu_torch.models import TimDetection
from tim_tpu_torch.ops.fused_post_attention import (
    fused_post_attention, fused_post_attention_plain)
from tim_tpu_torch.ops.int8_matmul_fused import (
    int8_matmul_fused, int8_matmul_fused_plain)
from tim_tpu_torch.models.common import (
    DENSE, TORCH_LINEAR, exact_gelu, linear)
from tim_tpu_torch.ops.bias_act import bias_act, bias_act_plain
from tim_tpu_torch.ops.flash_mha import (
    flash_mha, flash_mha_bwd, flash_mha_bwd_plain, flash_mha_plain,
    flash_mha_qkv, flash_mha_with_lse)
from tim_tpu_torch.ops.query_block_attention import (
    query_block_attention, query_block_attention_plain)
from tim_tpu_torch.ops.window_attention import (
    window_attention, window_attention_bwd, window_attention_bwd_plain,
    window_attention_plain, window_attention_qkv, window_attention_with_lse)

# Kernel 1 in fp32: the same function with sums in another order; in
# bf16 it is held to attention_close, scaled to its output. Kernel 2 is
# held to chip_smoke's fused_close (tests/test_pallas_fused.py's bound for
# the TPU kernel, and in bf16 a relative RMS).
TOL = {("qba", torch.float32): 1e-4}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def query_block_close(got, want):
    """Kernel 1 against its plain version: fp32 within TOL; bf16 by
    attention_close (a flat bound would pass a kernel that drops the self
    term, whose weight is about 1 / (F + 1))."""
    if got.dtype == torch.bfloat16:
        return attention_close(got, want)[0]
    return kernel_close(got, want, TOL[("qba", got.dtype)])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,h,s,f,dh,shared", [
    (2, 8, 898, 100, 128, False),   # the detection layer's shapes
    (3, 8, 898, 100, 128, True),    # layer 0: batch-broadcast query rows
    (2, 2, 48, 11, 32, False),      # ragged tile, odd F, narrow heads
    (64, 8, 104, 100, 128, False),  # recognition serving: 4 queries
    (64, 8, 152, 100, 128, False),  # recognition validation: 3 nv + na
])
def test_query_block_kernel_matches_plain(gen, dtype, b, h, s, f, dh,
                                          shared):
    _check_query_block(gen, dtype, b, h, s, f, dh, shared)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,b,h,s,f,dh,shared", [
    # F > 128: the bf16 kernel's context in 64-key chunks
    (torch.bfloat16, 2, 4, 330, 130, 128, False),
    (torch.float32, 2, 4, 330, 130, 128, False),
    # F = 300: at head dim 128 the bf16 kernel streams the context (it
    # does not fit beside two query stages); the fp32 instance holds it
    # whole in shared memory, which fits at head dim 64, not at 128
    (torch.bfloat16, 2, 4, 700, 300, 128, False),
    (torch.bfloat16, 2, 4, 700, 300, 64, False),
    (torch.float32, 2, 4, 700, 300, 64, False),
    # head dim 64, broadcast query block, ragged Nq
    (torch.bfloat16, 2, 4, 333, 100, 64, True),
    (torch.float32, 2, 4, 333, 100, 64, True),
    # head dim 256: the CUDA-core instance in both dtypes
    (torch.bfloat16, 2, 2, 237, 100, 256, False),
    (torch.float32, 2, 2, 237, 100, 256, False),
    # the wide TIM's 160 (bf16 on its tensor-core instance); 91 (bf16
    # copied to the 128 instance, fp32 on masked CUDA-core lanes); 200
    # (bf16 past 160: the CUDA-core design, lanes masked); 13, 48
    (torch.bfloat16, 2, 4, 330, 100, 160, False),
    (torch.float32, 2, 4, 330, 100, 160, True),
    (torch.bfloat16, 2, 4, 330, 100, 91, True),
    (torch.float32, 2, 4, 330, 100, 91, False),
    (torch.bfloat16, 2, 2, 237, 100, 200, False),
    (torch.bfloat16, 2, 2, 237, 50, 13, False),
    (torch.float32, 2, 2, 237, 50, 48, False),
    # past 256 the column-slice design: 512 with the broadcast query block,
    # 264 (in place), 300 (bf16 through the copy to 320), F past a tile
    (torch.bfloat16, 2, 2, 237, 100, 512, True),
    (torch.float32, 2, 2, 237, 100, 512, True),
    (torch.bfloat16, 2, 1, 237, 130, 264, False),
    (torch.float32, 2, 1, 237, 130, 264, False),
    (torch.bfloat16, 2, 3, 237, 50, 300, False),
])
def test_query_block_kernel_wide_context_and_head_dims(gen, dtype, b, h, s,
                                                       f, dh, shared):
    _check_query_block(gen, dtype, b, h, s, f, dh, shared)


def _check_query_block(gen, dtype, b, h, s, f, dh, shared):
    width = h * dh
    qkv = torch.randn(b, s, 3 * width, generator=gen, device="cuda")
    if shared:
        qkv[:, f:] = qkv[:1, f:]
    q, k, v = qkv.to(dtype).view(b, s, 3, h, dh).permute(2, 0, 3, 1, 4)
    args = (q[:, :, f:], k[:, :, :f], k[:, :, f:], v[:, :, :f], v[:, :, f:])
    if shared:   # the query block as a stride-0 batch broadcast
        args = (args[0][:1].expand(b, -1, -1, -1), args[1],
                args[2][:1].expand(b, -1, -1, -1), args[3],
                args[4][:1].expand(b, -1, -1, -1))
    before = query_block_attention.launches
    got = query_block_attention(*args)
    assert query_block_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == (b, h, s - f, dh)
    assert query_block_close(got, query_block_attention_plain(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,s,c,ff", [
    (2, 898, 1024, 2048),   # the detection layer's shapes, ragged block
    (1, 37, 128, 256),      # a single partial row block
])
def test_fused_kernel_matches_plain(gen, dtype, b, s, c, ff):
    args = tail_args(b, dtype, gen, seq=s, c=c, ff=ff)
    before = fused_post_attention.launches
    got = fused_post_attention(*args)
    assert fused_post_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == args[0].shape
    assert fused_close(got, fused_post_attention_plain(*args))[0]


@pytest.mark.gpu
def test_fused_kernel_gate_rejects_faulty_controls(gen):
    """The bf16 gate passes the kernel and rejects a tail without b2 and
    one whose LN2 takes its statistics over half of each row."""
    args = tail_args(2, torch.bfloat16, gen)
    want = fused_post_attention_plain(*args)
    assert fused_close(fused_post_attention(*args), want)[0]
    no_b2 = list(args)
    no_b2[7] = torch.zeros_like(args[7])
    assert not fused_close(fused_post_attention_plain(*no_b2), want)[0]
    assert not fused_close(tail_with_ln2_over_half(*args), want)[0]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_kernel_rejects_untiled_widths(gen, dtype):
    """Widths off the 128-column tiles (C 64, FF 128; C 52, FF 104, which
    bf16 pads to multiples of 8) run and agree with the plain version;
    weights that do not fit C are still refused."""
    for c, ff in ((64, 128), (52, 104)):
        args = tail_args(2, dtype, gen, seq=40, c=c, ff=ff)
        assert fused_close(fused_post_attention(*args),
                           fused_post_attention_plain(*args))[0]
    bad = list(args)
    bad[4] = bad[4][:, :-1]
    with pytest.raises(ValueError, match="do not fit"):
        fused_post_attention(*bad)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bias,activation", [(False, None), (True, None),
                                             (True, "gelu")])
@pytest.mark.parametrize("b,n,rows", [
    (2, 3806, (100, 499)),   # fc_action: the strided query rows
    (2, 44, (499, 898)),     # fc_audio
    (1, 256, (3, 40)),       # a single ragged row tile
])
def test_int8_kernel_matches_plain(gen, dtype, bias, activation, b, n, rows):
    x, w_q, w_scale, sx, bias_t = int8_head_args(b, n, dtype, gen,
                                                 bias=bias, rows=rows)
    before = int8_matmul_fused.launches
    got = int8_matmul_fused(x, w_q, w_scale, sx, bias_t, activation,
                            out_dtype=dtype)
    assert int8_matmul_fused.launches == before + 1
    assert got.dtype == dtype and got.shape == (b, rows[1] - rows[0], n)
    assert int8_close(got, int8_matmul_fused_plain(
        x, w_q, w_scale, sx, bias_t, activation, out_dtype=dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [8, 48, 256, 264, 3806])
@pytest.mark.parametrize("rows", [1, 63, 65, 399])
def test_int8_kernel_tile_edges(gen, dtype, n, rows):
    """N on both tile widths (48 for N <= 48, else 112) and past their
    edges; 3 windows of 1 to 399 rows of a strided [3, 898, 1024] view, so
    that M tiles of 128 rows cross window boundaries and end ragged; bias
    and GELU where n is even. One launch a call."""
    x, w_q, w_scale, sx, bias_t = int8_head_args(3, n, dtype, gen,
                                                 rows=(5, 5 + rows))
    act = "gelu" if n % 2 == 0 else None
    before = int8_matmul_fused.launches
    got = int8_matmul_fused(x, w_q, w_scale, sx, bias_t, act,
                            out_dtype=dtype)
    assert int8_matmul_fused.launches == before + 1
    assert got.shape == (3, rows, n) and got.is_contiguous()
    assert int8_close(got, int8_matmul_fused_plain(
        x, w_q, w_scale, sx, bias_t, act, out_dtype=dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k,n", [
    (16, 300),     # a k32 step half filled with zeros
    (48, 44),      # the same on the narrow tile
    (1040, 300),   # past 1024: 64-row M tiles
    (2048, 37),    # the longest rows the tile takes; odd N, single stores
])
def test_int8_kernel_k_tails(gen, dtype, k, n):
    x, w_q, w_scale, sx, bias_t = int8_head_args(2, n, dtype, gen,
                                                 rows=(10, 140), k=k)
    got = int8_matmul_fused(x, w_q, w_scale, sx, bias_t, out_dtype=dtype)
    assert int8_close(got, int8_matmul_fused_plain(
        x, w_q, w_scale, sx, bias_t, out_dtype=dtype))


@pytest.mark.gpu
def test_int8_kernel_rejects_rows_past_its_tile(gen):
    """K past the tile's 2048 runs in chunks (two launches, the int32 sums
    met in a scratch) and agrees with the plain version; a w_q of another
    width is refused."""
    for k in (2064, 4160):
        x, w_q, w_scale, sx, b = int8_head_args(1, 50, torch.float32, gen,
                                                k=k)
        assert int8_close(int8_matmul_fused(x, w_q, w_scale, sx, b),
                          int8_matmul_fused_plain(x, w_q, w_scale, sx, b))
    with pytest.raises(ValueError, match="w_q must be int8"):
        int8_matmul_fused(x, w_q[:, :-32], w_scale, sx, b)


@pytest.mark.gpu
def test_int8_kernel_rejects_unaligned_k(gen):
    """K off 16 (40) and off 8 (38, x's rows unaligned): w_q padded to a
    multiple of 16, given padded or not, agrees with the plain version."""
    from tim_tpu_torch.ops.int8_matmul_fused import pad_weight
    for k in (40, 38):
        x, w_q, w_scale, sx, b = int8_head_args(1, 16, torch.float32, gen,
                                                k=k)
        want = int8_matmul_fused_plain(x, w_q, w_scale, sx, b)
        for w in (w_q, pad_weight(w_q)):
            assert int8_close(int8_matmul_fused(x, w, w_scale, sx, b), want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_recognition_eval_step_on_the_card_matches_the_cpu(gen, dtype):
    """A small ``TimRecognition``'s eval step: the card (kernel 1 once a
    layer) against the CPU's plain versions, fp32 within 1e-4 of the
    largest logit, bf16 within 2e-2."""
    import copy
    from tim_tpu_torch.models import TimRecognition
    from tim_tpu_torch.train.recognition import make_eval_step
    cfg = C.epic_recognition(d_model=64, num_layers=2, nhead=2, num_feats=6,
                             visual_input_dim=16, audio_input_dim=8,
                             visual_classes=(5, 6, 9), audio_classes=4,
                             compute_dtype=dtype)
    cpu = TimRecognition(cfg, device="cpu")
    card = copy.deepcopy(cpu).to("cuda")
    tcfg = C.TrainConfig()
    nv, na = 3, 2
    g = torch.Generator().manual_seed(1)
    batch = {"v_feats": torch.randn(4, 6, 16, generator=g),
             "a_feats": torch.randn(4, 6, 8, generator=g),
             "times": torch.rand(4, 12 + nv + na, 2, generator=g).sort(-1)[0],
             "verb": torch.randint(0, 5, (4, nv), generator=g),
             "noun": torch.randint(0, 6, (4, nv), generator=g),
             "action": torch.randint(0, 9, (4, nv), generator=g),
             "class_id": torch.randint(0, 4, (4, na), generator=g)}
    before = query_block_attention.launches
    got, got_loss = make_eval_step(card, cfg, tcfg, nv, na)(
        {k: v.cuda() for k, v in batch.items()})
    assert query_block_attention.launches == before + cfg.num_layers
    want, want_loss = make_eval_step(cpu, cfg, tcfg, nv, na)(batch)
    tol = 1e-4 if dtype == "float32" else 2e-2
    for k in want:
        w = want[k].float()
        assert (got[k].float().cpu() - w).abs().max() <= tol * w.abs().max()
    for k in want_loss:
        assert abs(float(got_loss[k]) - float(want_loss[k])) <= (
            tol * abs(float(want_loss[k])))


@pytest.mark.gpu
def test_models_default_to_the_card(gen):
    cfg = C.epic_detection(d_model=32, num_layers=1, nhead=2, num_feats=4,
                           visual_input_dim=16, audio_input_dim=8,
                           visual_classes=(5,), audio_classes=3)
    from tim_tpu_torch.serve import DetectionServer
    model = TimDetection(cfg)
    assert next(model.parameters()).device.type == "cuda"
    server = DetectionServer(cfg, model.state_dict())
    assert server.device.type == "cuda"
    assert next(server.model.parameters()).device.type == "cuda"
    from tim_tpu_torch.models import TimRecognition
    from tim_tpu_torch.serve import RecognitionServer
    rcfg = C.epic_recognition(d_model=32, num_layers=1, nhead=2, num_feats=4,
                              visual_input_dim=16, audio_input_dim=8,
                              visual_classes=(5, 6, 7), audio_classes=3)
    rmodel = TimRecognition(rcfg)
    assert next(rmodel.parameters()).device.type == "cuda"
    for server in (RecognitionServer(rcfg, rmodel.state_dict()),
                   RecognitionServer.quantized(rcfg, rmodel.state_dict(),
                                               [None])):
        assert next(server.model.parameters()).device.type == "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("batch,n_win,heads,dims,shifted", [
    (1, 64, 4, (16, 56, 56), True),    # Swin-B stage 1, shifted
    (2, 16, 8, (16, 28, 28), False),   # stage 2, unshifted
    (1, 4, 16, (16, 14, 14), True),    # stage 3, shifted
    (2, 1, 32, (16, 7, 7), False),     # stage 4: one window type
])
def test_window_attention_kernel_matches_plain(gen, dtype, batch, n_win,
                                               heads, dims, shifted):
    q, k, v = swin_qkv(batch, n_win, heads, dtype, gen)
    bias, region = swin_bias(heads, dims, shifted, gen)
    assert (region is None) == (not shifted)
    before = window_attention.launches
    got = window_attention(q, k, v, bias, region, sm_scale=32 ** -0.5)
    assert window_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    assert attention_close(got, window_attention_plain(
        q, k, v, bias, region, sm_scale=32 ** -0.5))[0]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("batch,seq", [(2, 1568), (2, 200), (3, 37)])
def test_flash_mha_kernel_matches_plain(gen, dtype, batch, seq):
    q, k, v = vit_qkv(batch, seq, dtype, gen)
    before = flash_mha.launches
    got = flash_mha(q, k, v, sm_scale=0.125)
    assert flash_mha.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    assert attention_close(got, flash_mha_plain(q, k, v,
                                                sm_scale=0.125))[0]


def _check_both_launches(kernel, with_lse, plain, scores, args, kw):
    """The inference and the training (lse) launch of a forward kernel
    against its plain version, and the row log-sum-exp against
    torch.logsumexp of the plain fp32 scores."""
    want = plain(*args, **kw)
    got = kernel(*args, **kw)
    got_lse, lse = with_lse(*args, **kw)
    for out in (got, got_lse):
        assert out.dtype == want.dtype and out.shape == want.shape
        assert attention_close(out, want)[0]
    assert lse.shape == want.shape[:3] and lse.dtype == torch.float32
    lse_want = torch.logsumexp(scores(*args, **kw), -1)
    assert (lse - lse_want).abs().max().item() <= LSE_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,h,s", [(2, 16, 1568), (2, 16, 160), (3, 16, 37),
                                   (2, 8, 1568)])
def test_flash_mha_launches_and_lse_match_plain(gen, dtype, b, h, s):
    """Kernel 5 (bf16: the wgmma core) at ViT-L's S, the MAE encoder's 160
    tokens, a ragged S and the MAE decoder's 8 heads."""
    _check_both_launches(flash_mha, flash_mha_with_lse, flash_mha_plain,
                         vit_scores, vit_qkv(b, s, dtype, gen, heads=h),
                         {"sm_scale": 0.125})


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n_win,heads,dims", SWIN_STAGES)
@pytest.mark.parametrize("shifted", [False, True])
def test_window_attention_launches_and_lse_match_plain(gen, dtype, n_win,
                                                       heads, dims, shifted):
    """Kernel 4 (bf16: the wgmma core) at every Swin-B stage of one clip,
    shifted and unshifted (stage 4's one window needs no shift mask)."""
    q, k, v = swin_qkv(1, n_win, heads, dtype, gen)
    bias, region = swin_bias(heads, dims, shifted, gen)
    _check_both_launches(window_attention, window_attention_with_lse,
                         window_attention_plain, swin_scores,
                         (q, k, v, bias, region), {"sm_scale": 32 ** -0.5})


@pytest.mark.gpu
def test_attention_kernels_refuse_other_head_dims(gen):
    """No head dim is refused any more: kernel 5 takes 48 through the
    zero-padded copy to the 64 instance and 257 through the copy to the
    column-slice route at 320; kernel 4 takes 48 through the copy to its
    64 instance, held to its plain version."""
    q = torch.randn(1, 2, 40, 48, generator=gen, device="cuda")
    assert attention_close(flash_mha(q, q, q, sm_scale=0.1),
                           flash_mha_plain(q, q, q, sm_scale=0.1))[0]
    big = torch.randn(1, 2, 40, 257, generator=gen, device="cuda")
    assert attention_close(flash_mha(big, big, big, sm_scale=0.1),
                           flash_mha_plain(big, big, big, sm_scale=0.1))[0]
    bias = torch.randn(2, 40, 40, generator=gen, device="cuda")
    assert attention_close(window_attention(q, q, q, bias, sm_scale=0.1),
                           window_attention_plain(q, q, q, bias,
                                                  sm_scale=0.1))[0]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dh", [16, 40, 48, 64, 80, 96, 128, 200, 256, 264,
                                512])
@pytest.mark.parametrize("shifted", [False, True])
def test_window_attention_at_other_head_dims(gen, dtype, dh, shifted):
    """Kernels 4 and 4b at head dims on and off their instances (32, 64,
    128, 256, bf16 80, 96, 112; past 256 the column-slice routes), shifted
    (3 window types) and unshifted, on strided views of a packed
    projection at a ragged N: both forward launches and the lse against
    the plain version, the backward (dbias included) against the plain
    backward's gates, one launch a call on the plan's route (the counts),
    and in bf16 the backward's bits equal call to call, under
    torch.use_deterministic_algorithms and through the autograd Function
    on the packed projection."""
    from tim_tpu_torch.ops import window_attention as wa
    n, heads, n_win = 150, 2, 3
    qkv = torch.randn(2 * n_win, n, 3, heads, dh, generator=gen,
                      device="cuda").to(dtype)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    bias = torch.randn(heads, n, n, generator=gen, device="cuda")
    region = (torch.randint(0, 3, (n_win, n), generator=gen, device="cuda",
                            dtype=torch.int32) if shifted else None)
    kw = {"sm_scale": dh ** -0.5}
    args = (q, k, v, bias, region)
    inst, copied = wa.launch_plan(dh, dtype, q, k, v)
    wa.window_attention.routes.clear()
    wa.window_attention_bwd.routes.clear()
    _check_both_launches(window_attention, window_attention_with_lse,
                         window_attention_plain, swin_scores, args, kw)
    out, lse = window_attention_with_lse(*args, **kw)
    do = torch.randn(out.shape, generator=gen, device="cuda").to(dtype)
    first = [g.clone() for g in window_attention_bwd(*args, out, lse, do,
                                                     **kw)]
    want = window_attention_bwd_plain(*args, do, **kw)
    for g, w in zip(first, want):
        assert g.shape == w.shape
        assert grad_close(g, w, dtype == torch.bfloat16)[0]
    assert dict(wa.window_attention.routes) == {
        wa.route(dtype, inst, copied): 3}
    assert dict(wa.window_attention_bwd.routes) == {
        wa.route(dtype, inst, copied, backward=True): 1}
    if dtype != torch.bfloat16:
        return
    second = window_attention_bwd(*args, out, lse, do, **kw)
    torch.use_deterministic_algorithms(True)
    try:
        third = window_attention_bwd(*args, out, lse, do, **kw)
    finally:
        torch.use_deterministic_algorithms(False)
    # the one-pass route of the 32 instance sums dq with atomics (its
    # deterministic route takes another dq pass); every route past 32 is
    # atomic-free
    exact = range(1, 4) if inst == 32 else range(4)
    for i in exact:
        assert torch.equal(first[i], second[i])
        assert torch.equal(first[i], third[i])
    leaf = qkv.detach().requires_grad_()
    table = bias.detach().requires_grad_()
    (window_attention_qkv(leaf, table, region, **kw).float()
     * do.float()).sum().backward()
    for i in exact:
        got = table.grad if i == 3 else leaf.grad[:, :, i].transpose(1, 2)
        assert torch.equal(got, first[i])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dh", [16, 80, 88, 91, 104, 120, 128, 200, 256,
                                264, 320, 512])
def test_flash_mha_at_other_head_dims(gen, dtype, dh):
    """Kernel 5 and 5b at head dims on and off their instances (64, 128,
    256; bf16 80, 96, 112, which read 88 and 104 in place; past 256 the
    column-slice route), both launches, the lse, and the backward against
    the plain backward's gates."""
    q, k, v = vit_qkv(2, 150, dtype, gen, heads=3, dh=dh)
    kw = {"sm_scale": dh ** -0.5}
    _check_both_launches(flash_mha, flash_mha_with_lse, flash_mha_plain,
                         vit_scores, (q, k, v), kw)
    out, lse = flash_mha_with_lse(q, k, v, **kw)
    do = torch.randn(out.shape, generator=gen, device="cuda").to(dtype)
    got = flash_mha_bwd(q, k, v, out, lse, do, **kw)
    want = flash_mha_bwd_plain(q, k, v, do, **kw)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert grad_close(g, w, dtype == torch.bfloat16)[0]


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [80, 88, 104, 120, 128, 264, 512])
@pytest.mark.parametrize("s", [37, 150])
def test_flash_mha_wide_routes_read_in_place_and_repeat(gen, dh, s):
    """bf16 past 64: each call launches the plan's instance (up to 128) or
    column-slice route (past 256) with no copy (the route counts), and the
    two-pass backward gives the same bits call to call and under
    torch.use_deterministic_algorithms."""
    from tim_tpu_torch.ops import flash_mha as fm
    q, k, v = vit_qkv(3, s, torch.bfloat16, gen, heads=4, dh=dh)
    kw = {"sm_scale": dh ** -0.5}
    inst = fm.instance_dim(dh, torch.bfloat16)
    fm.flash_mha.routes.clear()
    fm.flash_mha_bwd.routes.clear()
    out, lse = flash_mha_with_lse(q, k, v, **kw)
    do = torch.randn(out.shape, generator=gen, device="cuda").to(q.dtype)
    first = [g.clone() for g in flash_mha_bwd(q, k, v, out, lse, do, **kw)]
    second = flash_mha_bwd(q, k, v, out, lse, do, **kw)
    torch.use_deterministic_algorithms(True)
    try:
        third = flash_mha_bwd(q, k, v, out, lse, do, **kw)
    finally:
        torch.use_deterministic_algorithms(False)
    # the models' route: the autograd Function on the packed projection
    packed = torch.stack([t.transpose(1, 2) for t in (q, k, v)], 2)
    leaf = packed.detach().requires_grad_()
    (flash_mha_qkv(leaf, **kw).float() * do.float()).sum().backward()
    assert dict(fm.flash_mha.routes) == {
        fm.route(torch.bfloat16, inst, False): 2}
    assert dict(fm.flash_mha_bwd.routes) == {
        fm.route(torch.bfloat16, inst, False, backward=True): 4}
    for a, b, c in zip(first, second, third):
        assert torch.equal(a, b) and torch.equal(a, c)
    for i, g in enumerate(first):
        assert torch.equal(leaf.grad[:, :, i].transpose(1, 2), g)
    for g, w in zip(first, flash_mha_bwd_plain(q, k, v, do, **kw)):
        assert grad_close(g, w, True)[0]


@pytest.mark.gpu
def test_fp32_patch_embed_stays_fp32(gen):
    """cuDNN runs fp32 convolutions in TF32 by default; the patch embed
    turns that off, so the card matches the CPU to fp32 rounding."""
    from tim_tpu_torch.models.common import conv3d_patch_embed
    assert torch.backends.cudnn.allow_tf32   # PyTorch's default
    video = torch.randn(2, 16, 224, 224, 3, generator=gen, device="cuda")
    weight = torch.randn(1024, 3, 2, 16, 16, generator=gen, device="cuda")
    bias = torch.randn(1024, generator=gen, device="cuda")
    got = conv3d_patch_embed(video, weight, bias, torch.float32)
    want = conv3d_patch_embed(video.cpu(), weight.cpu(), bias.cpu(),
                              torch.float32)
    assert torch.backends.cudnn.allow_tf32
    assert (got.cpu() - want).abs().max().item() <= 1e-3


@pytest.mark.gpu
def test_backbones_default_to_the_card(gen):
    from tim_tpu_torch.models.backbones import SwinTransformer3D, VideoMAEViT
    swin = SwinTransformer3D(embed_dim=32, depths=(2,), num_heads=(1,),
                             window_size=(4, 3, 3))
    vit = VideoMAEViT(embed_dim=64, depth=1, num_heads=1, patch_size=8)
    for model in (swin, vit):
        assert next(model.parameters()).device.type == "cuda"
    clip = torch.randn(1, 4, 24, 24, 3, device="cuda")
    counts = window_attention.launches, flash_mha.launches
    assert swin(clip).shape == (1, 32) and vit(clip).shape == (1, 64)
    assert (window_attention.launches, flash_mha.launches) == (
        counts[0] + 2, counts[1] + 1)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n_win,heads,dims,shifted", [
    (64, 4, (16, 56, 56), True),    # Swin-B stage 1, shifted
    (16, 8, (16, 28, 28), False),   # stage 2, unshifted
    (1, 32, (16, 7, 7), False),     # stage 4: one window type
])
def test_window_attention_bwd_kernel_matches_plain(gen, dtype, n_win, heads,
                                                   dims, shifted):
    args, out, lse, do = window_bwd_case(1, n_win, heads, dims, shifted,
                                         dtype, gen)
    before = window_attention_bwd.launches
    got = window_attention_bwd(*args, out, lse, do, sm_scale=32 ** -0.5)
    assert window_attention_bwd.launches == before + 1
    want = window_attention_bwd_plain(*args, do, sm_scale=32 ** -0.5)
    assert got[3].dtype == torch.float32 and got[3].shape == args[3].shape
    for g, w in zip(got, want):
        assert grad_close(g, w, dtype == torch.bfloat16)[0]


@pytest.mark.gpu
@pytest.mark.parametrize("n_win,heads,dims,shifted", [
    (64, 4, (16, 56, 56), True),    # stage 1: dbias over window groups
    (1, 32, (16, 7, 7), False),     # stage 4
])
def test_window_attention_bwd_run_to_run_and_deterministic_route(
        gen, n_win, heads, dims, shifted):
    """bf16: dk, dv and dbias are summed in a fixed order (the same bits
    every call), dq with fp32 atomics (within the gate); under
    torch.use_deterministic_algorithms(True) dq comes from the atomic-free
    pass and all four agree bit for bit between calls, dk, dv and dbias
    with the default route's."""
    args, out, lse, do = window_bwd_case(2, n_win, heads, dims, shifted,
                                         torch.bfloat16, gen)
    kw = {"sm_scale": 32 ** -0.5}
    first = [t.clone() for t in window_attention_bwd(*args, out, lse, do,
                                                     **kw)]
    second = window_attention_bwd(*args, out, lse, do, **kw)
    assert grad_close(second[0], first[0], True)[0]
    for i in (1, 2, 3):
        assert torch.equal(second[i], first[i])
    torch.use_deterministic_algorithms(True)
    try:
        det = [t.clone() for t in window_attention_bwd(*args, out, lse, do,
                                                       **kw)]
        again = window_attention_bwd(*args, out, lse, do, **kw)
    finally:
        torch.use_deterministic_algorithms(False)
    for a, b_ in zip(det, again):
        assert torch.equal(a, b_)
    for i in (1, 2, 3):
        assert torch.equal(det[i], first[i])
    for got, want in zip(det, window_attention_bwd_plain(*args, do, **kw)):
        assert grad_close(got, want, True)[0]


@pytest.mark.gpu
@pytest.mark.parametrize("bw,n_win,heads,n", [
    (8, 4, 2, 1568),   # a (8, 14, 14) window
    (3, 3, 3, 1000),   # ragged: 1000 is no multiple of the 64-key tile
])
def test_window_attention_bwd_windows_past_the_shared_partial(gen, bw, n_win,
                                                             heads, n):
    """bf16 windows of more than 791 tokens, whose dbias partial does not
    fit in shared memory (the kernel keeps it in its output slice): held to
    the plain backward by the bf16 gate, dk/dv/dbias bit-equal between
    calls."""
    qkv = torch.randn(bw, n, 3, heads, 32, generator=gen,
                      device="cuda").to(torch.bfloat16)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    bias = torch.randn(heads, n, n, generator=gen, device="cuda")
    region = torch.randint(0, 4, (n_win, n), generator=gen, device="cuda",
                           dtype=torch.int32)
    kw = {"sm_scale": 32 ** -0.5}
    out, lse = window_attention_with_lse(q, k, v, bias, region, **kw)
    do = torch.randn(out.shape, generator=gen, device="cuda").to(
        torch.bfloat16)
    args = (q, k, v, bias, region)
    first = [t.clone() for t in window_attention_bwd(*args, out, lse, do,
                                                     **kw)]
    again = window_attention_bwd(*args, out, lse, do, **kw)
    for i in (1, 2, 3):
        assert torch.equal(again[i], first[i])
    for got, want in zip(first, window_attention_bwd_plain(*args, do, **kw)):
        assert grad_close(got, want, True)[0]


@pytest.mark.gpu
def test_window_attention_bwd_gate_rejects_a_dropped_window_group(gen):
    """dbias summed without the first of the kernel's window groups (or
    from one window, or without D) fails the bf16 gate."""
    from tim_tpu_torch.ops.window_attention import bwd_groups, window_scores
    args, out, lse, do = window_bwd_case(2, 64, 4, (16, 56, 56), True,
                                         torch.bfloat16, gen)
    kw = {"sm_scale": 32 ** -0.5}
    want = window_attention_bwd_plain(*args, do, **kw)
    s = window_scores(args[0], args[1], args[3], args[4], **kw)
    ds = emulated_attention_bwd(s, *args[:3], do, **kw)[3]
    per_group = -(-args[0].shape[0] // bwd_groups(*args[0].shape[:3]))
    assert not grad_close(ds[per_group:].sum(0), want[3], True)[0]
    assert not grad_close(ds[0], want[3], True)[0]
    bad = emulated_attention_bwd(s, *args[:3], do, drop_delta=True, **kw)
    assert not grad_close(bad[0], want[0], True)[0]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,h,s", [(2, 16, 1568), (2, 16, 160), (3, 16, 37),
                                   (2, 8, 1568)])
def test_flash_mha_bwd_kernel_matches_plain(gen, dtype, b, h, s):
    args, out, lse, do = flash_bwd_case(b, h, s, dtype, gen)
    before = flash_mha_bwd.launches
    got = flash_mha_bwd(*args, out, lse, do, sm_scale=0.125)
    assert flash_mha_bwd.launches == before + 1
    for g, w in zip(got, flash_mha_bwd_plain(*args, do, sm_scale=0.125)):
        assert g.dtype == dtype
        assert grad_close(g, w, dtype == torch.bfloat16)[0]


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,s", [(2, 16, 1568), (3, 16, 37)])
def test_flash_mha_bwd_run_to_run(gen, b, h, s):
    """Two bf16 backward calls on the same inputs: dk and dv are summed in
    a fixed order and agree bit for bit; dq is summed across key blocks
    with fp32 atomics, so it may differ in its last bits, within
    grad_close."""
    args, out, lse, do = flash_bwd_case(b, h, s, torch.bfloat16, gen)
    first = [t.clone() for t in flash_mha_bwd(*args, out, lse, do,
                                              sm_scale=0.125)]
    second = flash_mha_bwd(*args, out, lse, do, sm_scale=0.125)
    assert grad_close(second[0], first[0], True)[0]
    assert torch.equal(second[1], first[1])
    assert torch.equal(second[2], first[2])


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,s", [(2, 16, 1568), (3, 16, 37), (2, 8, 1568)])
def test_flash_mha_bwd_deterministic_route(gen, b, h, s):
    """Under torch.use_deterministic_algorithms(True), bf16 dq comes from
    the atomic-free pass: two calls agree bit for bit in dq, dk and dv,
    dk and dv equal the default route's, and every gradient passes the
    gate against the plain backward."""
    args, out, lse, do = flash_bwd_case(b, h, s, torch.bfloat16, gen)
    default = [t.clone() for t in flash_mha_bwd(*args, out, lse, do,
                                                sm_scale=0.125)]
    torch.use_deterministic_algorithms(True)
    try:
        first = [t.clone() for t in flash_mha_bwd(*args, out, lse, do,
                                                  sm_scale=0.125)]
        second = flash_mha_bwd(*args, out, lse, do, sm_scale=0.125)
    finally:
        torch.use_deterministic_algorithms(False)
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)
    assert torch.equal(first[1], default[1])
    assert torch.equal(first[2], default[2])
    for got, want in zip(first, flash_mha_bwd_plain(*args, do,
                                                    sm_scale=0.125)):
        assert grad_close(got, want, True)[0]


@pytest.mark.gpu
@pytest.mark.parametrize("rounding", [TORCH_LINEAR, DENSE])
def test_bf16_linear_rounds_per_kind_on_the_card(gen, rounding):
    """The bf16 linear against its own fp32-accumulator reference rounded
    per kind, bit for bit where every fp32 sum is exact (signed powers of
    two); gradients reach the fp32 parameters."""
    def pow2(*shape, lo):
        e = torch.randint(lo, 1, shape, generator=gen, device="cuda")
        sign = torch.randint(-1, 2, shape, generator=gen, device="cuda")
        return torch.exp2(e.float()) * sign

    x, w = pow2(3, 37, 64, lo=-3), pow2(96, 64, lo=-4)
    b = torch.rand(96, generator=gen, device="cuda") * 4 - 2
    acc = x @ w.t()
    want = ((acc + b).to(torch.bfloat16) if rounding == TORCH_LINEAR
            else acc.to(torch.bfloat16) + b.to(torch.bfloat16))
    w.requires_grad_()
    b.requires_grad_()
    got = linear(x, w, b, torch.bfloat16, rounding=rounding)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    got.float().sum().backward()
    assert w.grad.dtype == torch.float32 and b.grad.dtype == torch.float32
    assert torch.isfinite(w.grad).all() and torch.isfinite(b.grad).all()
    # with the GELU fused into the bias pass: the plain composition's value
    # (JAX's bf16 steps, erfc from the same CUDA library: bit for bit),
    # and its gradients
    fused = linear(x, w, b, torch.bfloat16, rounding=rounding, gelu=True)
    assert torch.equal(fused, exact_gelu(want))
    w.grad = b.grad = None
    fused.float().sum().backward()
    assert torch.isfinite(w.grad).all() and torch.isfinite(b.grad).all()


@pytest.mark.gpu
@pytest.mark.parametrize("rows,cols,dtype,gelu,with_bias", [
    (1568, 3072, torch.float32, False, True),   # ViT-L qkv (TORCH_LINEAR)
    (1568, 4096, torch.bfloat16, True, True),   # ViT-L fc1 (DENSE + GELU)
    (1568, 4096, torch.float32, True, True),
    (1596, 2, torch.float32, False, True),      # a regression head: scalar
    (37, 12, torch.bfloat16, False, True),
    (1568, 1024, torch.bfloat16, True, False),  # exact_gelu: no bias
    (37, 12, torch.bfloat16, True, False),
])
def test_bias_act_kernel_matches_plain(gen, rows, cols, dtype, gelu,
                                       with_bias):
    """The bias epilogue kernel against its plain version, bit-equal, the
    GELU (JAX's bf16 steps, erfc from the same CUDA library), the route
    without a bias and the kept pre-activation included."""
    y = (torch.randn(rows, cols, generator=gen, device="cuda") * 3).to(dtype)
    b = (torch.randn(cols, generator=gen, device="cuda") if with_bias
         else None)
    before = bias_act.launches
    got, pre = bias_act(y, b, gelu=gelu, keep_pre=True)
    assert bias_act.launches == before + 1
    want, h = bias_act_plain(y, b, gelu=gelu)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert torch.equal(got, want)
    if gelu:
        assert torch.equal(pre, h)
    else:
        assert pre is None


def _unpacked(fn):
    """``fn`` of separate q/k/v views taken from a packed qkv."""
    return lambda qkv, *rest, **kw: fn(
        *(qkv[:, :, i].transpose(1, 2) for i in range(3)), *rest, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("packed", [True, False])
def test_autograd_launches_each_kernel_once(gen, packed):
    """Autograd through the packed entry points and through the ones that
    take separate q, k, v: one forward and one backward launch each, the
    gradient shaped like its input and equal to the plain version's
    autograd on the CPU."""
    bias = torch.randn(2, 37, 37, generator=gen, device="cuda")
    fns = ((flash_mha_qkv, ()), (window_attention_qkv, (bias,))) if packed \
        else ((_unpacked(flash_mha), ()), (_unpacked(window_attention),
                                           (bias,)))
    for (fn, extra), dh in zip(fns, (64, 32)):   # each kernel's head dim
        qkv = torch.randn(2, 37, 3, 2, dh, generator=gen, device="cuda")
        do = torch.randn(2, 2, 37, dh, generator=gen, device="cuda")
        leaves = [qkv.clone().requires_grad_(),
                  *(t.clone().requires_grad_() for t in extra)]
        cpu = [t.detach().cpu().requires_grad_() for t in leaves]
        counts = (flash_mha.launches, flash_mha_bwd.launches,
                  window_attention.launches, window_attention_bwd.launches)
        (fn(*leaves, sm_scale=0.2) * do).sum().backward()
        (fn(*cpu, sm_scale=0.2) * do.cpu()).sum().backward()
        after = (flash_mha.launches, flash_mha_bwd.launches,
                 window_attention.launches, window_attention_bwd.launches)
        assert sum(after) - sum(counts) == 2
        for t, c in zip(leaves, cpu):
            assert t.grad.shape == t.shape
            err = (t.grad.cpu() - c.grad).abs().max().item()
            assert err <= 1e-4 * c.grad.abs().max().item()


@pytest.mark.gpu
def test_fp32_patch_embed_weight_grad_stays_fp32(gen):
    """The patch embed's backward runs with TF32 off as its forward does:
    a ViT-L-sized fp32 weight gradient on the card matches the CPU under
    PyTorch's default flags."""
    from tim_tpu_torch.models.common import conv3d_patch_embed
    assert torch.backends.cudnn.allow_tf32   # PyTorch's default
    video = torch.randn(2, 16, 224, 224, 3, generator=gen, device="cuda")
    weight = torch.randn(1024, 3, 2, 16, 16, generator=gen,
                         device="cuda").requires_grad_()
    bias = torch.randn(1024, generator=gen, device="cuda").requires_grad_()
    dy = torch.randn(2, 8, 14, 14, 1024, generator=gen, device="cuda")
    (conv3d_patch_embed(video, weight, bias, torch.float32) * dy).sum() \
        .backward()
    w_cpu = weight.detach().cpu().requires_grad_()
    b_cpu = bias.detach().cpu().requires_grad_()
    (conv3d_patch_embed(video.cpu(), w_cpu, b_cpu, torch.float32)
     * dy.cpu()).sum().backward()
    assert torch.backends.cudnn.allow_tf32
    for g, c in ((weight.grad, w_cpu.grad), (bias.grad, b_cpu.grad)):
        assert (g.cpu() - c).abs().max().item() <= 1e-4 * c.abs().max().item()


def _det_cfg(**kw):
    """A small detection configuration whose widths every kernel takes
    (encoder width 128, head dim 64, FFN 256)."""
    base = dict(d_model=64, num_layers=2, nhead=2, num_feats=8,
                visual_input_dim=32, audio_input_dim=24,
                visual_classes=(11,), audio_classes=5,
                train_query_size=0.05, inference_query_size=0.1)
    base.update(kw)
    return C.epic_detection(**base)


def _det_launches(run):
    from chip_smoke import launch_counters
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    out = run()
    torch.cuda.synchronize()
    return out, {n: fn.launches for n, fn in counters.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_detection_train_step_launches_neither_kernel_1_nor_2(gen, dtype):
    """A train step (dropout on, ``use_fused_ffn`` on) runs the plain
    attention with dropout and the unfused tail: kernels 1 and 2 are
    never launched, as in JAX; bf16 linears launch the bias epilogue."""
    import numpy as np
    from chip_smoke import det_batch, det_split, det_state
    from tim_tpu_torch.train.detection import make_train_step
    cfg = _det_cfg(compute_dtype=dtype, use_fused_ffn=True)
    tcfg = C.TrainConfig(batch_size=4)
    model = TimDetection(cfg)
    state = det_state(model, tcfg)
    batch = det_batch(det_split(cfg, 1, np.random.default_rng(0),
                                seconds=40.0), 4, "cuda")
    step = make_train_step(model, cfg, tcfg)
    metrics, launches = _det_launches(lambda: step(state, batch))
    assert launches["query_block_attention"] == 0
    assert launches["fused_post_attention"] == 0
    assert (launches["bias_act"] > 0) == (dtype == "bfloat16")
    assert torch.isfinite(metrics["loss"]) and torch.isfinite(
        metrics["grad_norm"])
    assert state.step == 1 and float(state.normaliser) != 250.0


@pytest.mark.gpu
@pytest.mark.parametrize("fused", [False, True])
def test_detection_val_step_launches_kernel_1_per_layer(gen, fused):
    """The validation step is deterministic: kernel 1 once per encoder
    layer, kernel 2 once per layer with ``use_fused_ffn``, else never."""
    import numpy as np
    from chip_smoke import det_batch, det_split, det_state
    from tim_tpu_torch.train.detection import make_val_step
    cfg = _det_cfg(use_fused_ffn=fused)
    model = TimDetection(cfg)
    state = det_state(model, C.TrainConfig())
    batch = det_batch(det_split(cfg, 1, np.random.default_rng(0),
                                seconds=40.0), 4, "cuda")
    step = make_val_step(model, cfg, C.TrainConfig())
    metrics, launches = _det_launches(lambda: step(state, batch))
    assert launches["query_block_attention"] == cfg.num_layers
    assert launches["fused_post_attention"] == (cfg.num_layers if fused
                                                else 0)
    assert all(torch.isfinite(v) for v in metrics.values())


@pytest.mark.gpu
def test_kernels_without_a_backward_raise_on_grad_inputs(gen):
    """Kernel 1 on inputs that require grad, with grad mode on, raises
    instead of returning a result without ``grad_fn``; under no_grad it
    runs."""
    q = torch.randn(1, 2, 8, 64, generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    args = [q, q.clone(), q.clone(), q.clone(), q.clone()]
    args[1].requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        query_block_attention(*args)
    with torch.no_grad():
        assert query_block_attention(*args).grad_fn is None


def _small_slowfast(device):
    from tim_tpu_torch.models.backbones.slowfast import AuditorySlowFast
    return AuditorySlowFast(num_classes=5, width=8, alpha=4, beta_inv=4,
                            device=device,
                            generator=torch.Generator().manual_seed(0))


@pytest.mark.gpu
def test_slowfast_on_the_card_matches_the_cpu_with_tf32_off(gen):
    """A small Auditory SlowFast (R50 depths, width 8) in fp32 on the card
    against the CPU: features and softmaxed logits within 1e-4 of the
    largest (TF32 convolutions, cuDNN's default, would miss it); cuDNN's
    flag is as it was after the forward."""
    from tim_tpu_torch.models.backbones.slowfast import pack_pathways
    assert torch.backends.cudnn.allow_tf32   # PyTorch's default
    cpu, card = _small_slowfast("cpu"), _small_slowfast("cuda")
    spec = torch.randn(4, 1, 200, 128, generator=gen, device="cuda")
    got = card(*pack_pathways(spec, 4))
    want = cpu(*pack_pathways(spec.cpu(), 4))
    assert torch.backends.cudnn.allow_tf32
    for g, w in zip(got, want):
        assert (g.cpu() - w).abs().max() <= 1e-4 * w.abs().max()


@pytest.mark.gpu
def test_small_gate_on_the_card_launches_kernels_3_and_1(gen, tmp_path,
                                                          capsys):
    """The checkpoint gate on a small detection checkpoint: load, infer,
    convert and contract PASS, parity SKIPs (no reference tree); the
    contract launches kernel 3 twice (the two fused int8 class heads) and
    kernel 1 once a layer (the fp32 server's batch)."""
    from tim_tpu_torch import validate_checkpoint as VC
    cfg = C.epic_detection(d_model=32, num_layers=2, nhead=2, num_feats=6,
                           visual_input_dim=16, audio_input_dim=8,
                           visual_classes=(7,), audio_classes=3,
                           compute_dtype="float32")
    path = tmp_path / "det.pth"
    torch.save({"state_dict": TimDetection(cfg, device="cpu").state_dict(),
                "epoch": 1}, path)
    before = int8_matmul_fused.launches, query_block_attention.launches
    gate = VC.validate([str(path), "--task", "detection", "--nhead", "2",
                        "--num_feats", "6"])
    out = capsys.readouterr().out
    assert not gate.failed, out
    assert "parity     SKIP" in out and "(cuda" in out
    assert (int8_matmul_fused.launches - before[0],
            query_block_attention.launches - before[1]) == (2, 2)


@pytest.mark.gpu
def test_slowfast_extraction_through_the_cli_on_the_card(gen, tmp_path,
                                                         monkeypatch):
    """``--backbone slowfast`` through ``extract.cli.main`` on the card (a
    small model, one WAV of 3 s, 10 records, two augmentation sets): the
    bank is finite, [10, 2, 320], and its clean set equals the CPU's
    forward of the same spectrograms within 1e-4 of the largest."""
    import functools
    import importlib.util
    import os

    import numpy as np
    from scipy.io import wavfile

    from tim_tpu_torch.data.table import Table
    from tim_tpu_torch.extract import cli as pcli
    from tim_tpu_torch.extract.audio import (
        extract_clip_spectrogram, record_clip_bounds)
    from tim_tpu_torch.models.backbones import slowfast as psf
    sr = 24000
    wave = np.random.default_rng(0).normal(scale=0.2, size=3 * sr)
    wavfile.write(tmp_path / "v1.wav", sr, (wave * 32767).astype(np.int16))
    starts = np.arange(10, dtype=np.float64) * 0.2
    # the feature-time table as a DataFrame pickle in pandas 1.x's layout,
    # written with numpy alone (tests/data/torch_tables/make_fixture.py)
    spec = importlib.util.spec_from_file_location(
        "torch_tables_fixture", os.path.join(
            os.path.dirname(__file__), "data", "torch_tables",
            "make_fixture.py"))
    fixture = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fixture)
    fixture.write_pandas1_pickle(
        Table({"video_id": ["v1"] * 10, "start_sec": starts,
               "stop_sec": starts + 1.1},
              index=[f"v1_{i}" for i in range(10)],
              index_name="narration_id"), tmp_path / "ctx.pkl")
    monkeypatch.setattr(psf, "AuditorySlowFast", functools.partial(
        psf.AuditorySlowFast, num_classes=5, width=8, alpha=4, beta_inv=4))
    pcli.main(["--backbone", "slowfast", "--audio_dir", str(tmp_path),
               "--feature_times", str(tmp_path / "ctx.pkl"),
               "--out_dir", str(tmp_path / "out"), "--split", "val",
               "--num_aug", "2"])
    bank = np.load(tmp_path / "out" / "val" / "v1.npy")
    assert bank.shape == (10, 2, 320) and np.isfinite(bank).all()
    data = wavfile.read(tmp_path / "v1.wav")[1].astype(np.float32) / 32767
    specs = []
    for s, e in zip(starts, starts + 1.1):
        lo, hi = record_clip_bounds(int(round(s * sr)), int(round(e * sr)),
                                    int(round(0.999 * sr)), 0, 2)
        specs.append(extract_clip_spectrogram(data, lo, min(hi, len(data)),
                                              sampling_rate=sr))
    cpu = psf.AuditorySlowFast(device="cpu",
                               generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.stack(specs))[:, None]
    _, want = cpu(*psf.pack_pathways(x, 4))
    assert np.abs(bank[:, 0] - want.numpy()).max() <= (
        1e-4 * want.abs().max().item())


def _small_media_models(device, dtype="float32"):
    """A small Swin (head dim 32, a shifted block) and ViT (head dim 64),
    the kernels' head dims, seeded alike on every device."""
    from tim_tpu_torch.models.backbones.swin3d import SwinTransformer3D
    from tim_tpu_torch.models.backbones.vit import VideoMAEViT
    swin = SwinTransformer3D(patch_size=(2, 4, 4), embed_dim=32,
                             depths=(2, 2), num_heads=(1, 2),
                             window_size=(2, 3, 3), dtype=dtype,
                             device=device,
                             generator=torch.Generator().manual_seed(1))
    vit = VideoMAEViT(img_size=32, patch_size=16, embed_dim=64, depth=1,
                      num_heads=1, num_frames=8, dtype=dtype, device=device,
                      generator=torch.Generator().manual_seed(2))
    return [swin, vit]


@pytest.mark.gpu
def test_stream_mode_serving_on_the_card_matches_the_cpu(gen):
    """``detect_video_frames`` in stream mode (pinned ring, side-stream
    uploads) on a small fp32 detector over a uint8 video, card against
    CPU: equal labels, segments and scores within 1e-3; kernels 4 and 5
    launch for every forward, kernel 1 once a layer a batch."""
    from tim_tpu_torch.extract.dense_media import uint8_normalizer
    from tim_tpu_torch.serve import DetectionServer
    cfg = C.epic_detection(d_model=64, num_layers=2, nhead=2, num_feats=6,
                           visual_input_dim=64 + 64, audio_input_dim=12,
                           visual_classes=(11,), audio_classes=5,
                           compute_dtype="float32", inference_query_size=0.2)
    state = TimDetection(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(0)
                         ).state_dict()
    rng = np.random.default_rng(0)
    n_steps = 50
    table = np.stack([np.arange(8) + 2 * t for t in range(n_steps)])
    frames = rng.integers(0, 256, (table.max() + 1, 32, 32, 3),
                          dtype=np.uint8)
    starts = (np.arange(n_steps) * 0.2).astype(np.float32)
    feat_times = np.stack([starts, starts + 1.1], -1)
    specs = rng.normal(size=(n_steps, 8, 12)).astype(np.float32)
    w = torch.from_numpy(rng.normal(size=(8 * 12, 12)).astype(np.float32)
                         * 0.1)

    def audio(s):
        return s.reshape(len(s), -1) @ w.to(s.device)
    dets, launches = {}, None
    for device in ("cuda", "cpu"):
        server = DetectionServer(cfg, state, device=device, feat_stride=2,
                                 batch_size=4)
        counters = launch_counters()
        for fn in counters.values():
            fn.launches = 0
        dets[device] = server.detect_video_frames(
            frames, [table, table], feat_times, n_steps * 0.2,
            visual_model=_small_media_models(device), audio_specs=specs,
            audio_extractor=audio, extract_batch=4, mode="stream",
            frame_transform=uint8_normalizer(dtype="float32"),
            score_threshold=0.005)
        if device == "cuda":
            torch.cuda.synchronize()
            launches = {n: fn.launches for n, fn in counters.items()}
    forwards = -(-n_steps // 4)
    assert launches["window_attention"] == 4 * forwards
    assert launches["flash_mha"] == forwards
    n_batches = -(-len(server._window_starts(n_steps * 0.2)) // 4)
    assert launches["query_block_attention"] == 2 * n_batches
    g, c = dets["cuda"], dets["cpu"]
    assert len(c["scores"]) > 0
    np.testing.assert_array_equal(g["labels"], c["labels"])
    np.testing.assert_allclose(g["segments"], c["segments"], atol=1e-3)
    np.testing.assert_allclose(g["scores"], c["scores"], atol=1e-3)


@pytest.mark.gpu
def test_quantized_small_vit_on_the_card_matches_the_cpu(gen):
    """A small int8 ViT (head dim 64, dynamic scales) in fp32, card
    (``torch._int_mm`` products, kernel 5) against CPU: within 1e-3 of the
    largest feature, or ULP_ENVELOPE times the CPU's own spread under a
    one-ulp input change where that is larger (chip_smoke phase 6's rule
    for int8 rounding ties)."""
    from tim_tpu_torch.models.backbones.vit import VideoMAEViT
    from tim_tpu_torch.ops.quant import quantize_backbone_state_dict
    kw = dict(img_size=32, patch_size=16, embed_dim=128, depth=2,
              num_heads=2, num_frames=8)
    fp = VideoMAEViT(**kw, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    state = quantize_backbone_state_dict(fp.state_dict())
    models = {}
    for device in ("cpu", "cuda"):
        models[device] = VideoMAEViT(**kw, device=device, quantized=True)
        models[device].load_state_dict(state, strict=True)
    x = torch.randn(3, 8, 32, 32, 3, generator=gen, device="cuda")
    counters = launch_counters()
    counters["flash_mha"].launches = 0
    got = models["cuda"](x).cpu()
    assert counters["flash_mha"].launches == 2
    want = models["cpu"](x.cpu())
    up = models["cpu"](x.cpu() * (1 + 2.0 ** -23))
    scale = want.abs().max()
    spread = ((up - want).abs().max() / scale).item()
    err = ((got - want).abs().max() / scale).item()
    assert err <= max(1e-3, ULP_ENVELOPE * spread), (err, spread)


def _tiny_finetune_args(mode, out, *extra):
    """The finetune CLI's flags for a small ViT whose head dim kernel 5
    takes (64)."""
    from tim_tpu_torch.extract import finetune_cli
    return finetune_cli.build_parser().parse_args(
        ["--mode", mode, "--anno_train", "x.csv", "--data_path", "x",
         "--output_dir", str(out), "--input_size", "32", "--patch_size",
         "8", "--embed_dim", "128", "--depth", "2", "--num_heads", "2",
         "--num_frames", "4", "--epochs", "1", "--warmup_epochs", "0", "--batch_size", "2",
         *extra])


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["pretrain", "finetune"])
def test_finetune_cli_on_the_card_launches_kernels_5_and_5b(gen, tmp_path,
                                                             mode):
    """``finetune_cli.run`` on the card: kernel 5 and its backward once a
    block a step (the MAE's 12 decoder blocks too), kernel 5 once a block
    a validation batch; finite statistics and a checkpoint."""
    import inspect
    from chip_smoke import ft_annotations, ft_reader
    from tim_tpu_torch.extract import finetune_cli
    from tim_tpu_torch.models.backbones.mae import PretrainVideoMAE
    args = _tiny_finetune_args(mode, tmp_path)
    train_ds, val_ds = finetune_cli.datasets(
        args, ft_annotations(6, 0), None, ft_reader,
        rand_augment=finetune_cli.identity_augment)
    stats, launches = _det_launches(
        lambda: finetune_cli.run(args, train_ds, val_ds))
    steps = 3
    blocks = args.depth
    if mode == "pretrain":
        blocks += inspect.signature(PretrainVideoMAE).parameters[
            "decoder_depth"].default
    val = 0 if val_ds is None else 3 * args.depth
    assert launches["flash_mha"] == blocks * steps + val
    assert launches["flash_mha_bwd"] == blocks * steps
    assert all(np.isfinite(v) for v in stats.values())
    assert (tmp_path / "checkpoint.pt").exists()


@pytest.mark.gpu
def test_finetune_cli_refuses_plain_attention_on_the_card(gen, tmp_path):
    from tim_tpu_torch.extract import finetune_cli
    args = _tiny_finetune_args("finetune", tmp_path, "--flash_attention",
                               "off")
    with pytest.raises(ValueError, match="kernel 5"):
        finetune_cli.run(args, None, None)


@pytest.mark.gpu
def test_one_rank_nccl_group_leaves_a_detection_run_bit_equal(gen):
    """Through the data-parallel path (collectives over NCCL) with one
    rank: one epoch, validation and the top-2 dump bit-equal to the run
    without a group."""
    from chip_smoke import det_split
    from tests import torch_parallel_worker as worker
    from tim_tpu_torch.parallel import multihost
    from tim_tpu_torch.runner.detection import DetectionRunner
    cfg = _det_cfg()
    rng = np.random.default_rng(0)
    train_ds, val_ds = (det_split(cfg, 1, rng, seconds=40.0)
                        for _ in range(2))

    def run():
        runner = DetectionRunner(cfg, C.TrainConfig(batch_size=4, epochs=1),
                                 train_ds, val_ds, print_freq=1000,
                                 use_device_bank=True)
        runner.init_state()
        runner.train_epoch(0)
        stats = runner.validate()
        dump = runner.extract_dense_predictions(top_k=2)
        return stats, {k: v.cpu() for k, v in
                       runner.model.state_dict().items()}, dump

    want = run()
    multihost.collective.calls = 0
    worker.join_group_of_one("nccl")
    try:
        got = run()
        calls = multihost.collective.calls
    finally:
        multihost.finalize()
    assert calls > 0
    assert got[0] == want[0]
    assert all(torch.equal(got[1][k], want[1][k]) for k in want[1])
    for k, v in want[2].items():
        np.testing.assert_array_equal(got[2][k], v, err_msg=k)


@pytest.mark.gpu
def test_device_memory_on_the_card(gen):
    from tim_tpu_torch.utils.memory import device_memory_gb, memory_summary
    x = torch.ones(1 << 20, device="cuda")
    mem = device_memory_gb()
    assert sorted(mem) == ["in_use_gb", "limit_gb", "peak_gb"]
    assert 0 < mem["in_use_gb"] <= mem["peak_gb"] < mem["limit_gb"]
    assert " hbm " in memory_summary() and x.numel()
