"""The CUDA kernels of ``tim_tpu_torch`` against their plain PyTorch
versions, on the card. Imports no JAX, so it runs where only the port is
installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

(``--noconftest``: the repo's conftest configures JAX.) Without a CUDA
card every test skips."""

import pytest
import torch

from chip_smoke import (attention_close, int8_close, int8_head_args,
                        kernel_close, swin_bias, swin_qkv, tail_args, vit_qkv)
from tim_tpu_torch import config as C
from tim_tpu_torch.models import TimDetection
from tim_tpu_torch.ops.fused_post_attention import (
    fused_post_attention, fused_post_attention_plain)
from tim_tpu_torch.ops.int8_matmul_fused import (
    int8_matmul_fused, int8_matmul_fused_plain)
from tim_tpu_torch.ops.flash_mha import flash_mha, flash_mha_plain
from tim_tpu_torch.ops.query_block_attention import (
    query_block_attention, query_block_attention_plain)
from tim_tpu_torch.ops.window_attention import (
    window_attention, window_attention_plain)

# fp32: the same function with sums in another order; bf16: the bound
# tests/test_pallas_fused.py holds the TPU kernel to (see kernel_close)
TOL = {("qba", torch.float32): 1e-4, ("fused", torch.float32): 2e-4,
       ("qba", torch.bfloat16): 5e-2, ("fused", torch.bfloat16): 5e-2}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,h,s,f,dh,shared", [
    (2, 8, 898, 100, 128, False),   # the detection layer's shapes
    (3, 8, 898, 100, 128, True),    # layer 0: batch-broadcast query rows
    (2, 2, 48, 11, 32, False),      # ragged tile, odd F, narrow heads
])
def test_query_block_kernel_matches_plain(gen, dtype, b, h, s, f, dh,
                                          shared):
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
    assert kernel_close(got, query_block_attention_plain(*args),
                        TOL[("qba", dtype)])


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
    assert kernel_close(got, fused_post_attention_plain(*args),
                        TOL[("fused", dtype)])


@pytest.mark.gpu
def test_fused_kernel_rejects_untiled_widths(gen):
    args = tail_args(1, torch.float32, gen, seq=8, c=64, ff=128)
    with pytest.raises(ValueError, match="multiples"):
        fused_post_attention(*args)


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
def test_int8_kernel_rejects_unaligned_k(gen):
    x, w_q, w_scale, sx, b = int8_head_args(1, 16, torch.float32, gen, k=40)
    with pytest.raises(ValueError, match="multiple of 16"):
        int8_matmul_fused(x, w_q, w_scale, sx, b)


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


@pytest.mark.gpu
def test_attention_kernels_refuse_other_head_dims(gen):
    q = torch.randn(1, 2, 40, 48, generator=gen, device="cuda")
    with pytest.raises(ValueError, match="head dim 48"):
        flash_mha(q, q, q, sm_scale=0.1)
    bias = torch.zeros(2, 40, 40, device="cuda")
    with pytest.raises(ValueError, match="head dim 48"):
        window_attention(q, q, q, bias, sm_scale=0.1)


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
