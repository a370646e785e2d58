"""The port past head dim 256, and from 129 to 256 where the card's bf16
routes are the column-slice forward of kernel 1 and the split passes of
kernel 5b, against the JAX package on the CPU (the card takes these head
dims on the column-slice routes of kernels 1, 5 and 5b; their kernels run
on the card only, ``tests/test_torch_gpu.py`` and chip_smoke phases 31d
and 31f):

- ``query_block_attention_plain`` against the Pallas kernel
  (``tim_tpu/ops/pallas_attention.py``) in interpret mode at head dims
  192, 256, 264 and 512, Nq 37 (no tile multiple): within 1e-5 of the
  largest value;
- ``flash_mha_plain`` / ``flash_mha_bwd_plain`` and ``flash_mha_qkv``'s
  packed gradient against the einsum branch of
  ``tim_tpu/models/backbones/vit.py:107-112`` and its ``jax.grad``, at
  head dims 192, 256, 264 and 512: within 1e-5 of each output's largest
  value;
- TIM detection inference at head dim 264 (``--d_model 132 --nhead 1``):
  within 1e-4 of each output's largest value;
- three ``TwoHeadViT`` LLRD steps at ``--embed_dim 528 --num_heads 2``
  (head dim 264) against JAX's, every parameter within 1e-4 of its
  largest value;
- the wrappers' plans and route names for head dims 257-1024, and for
  kernel 1 at 161-256 and kernels 5 / 5b at 129-256.

Inputs are seeded numpy arrays, fp32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_flash_wide import _close, _jax_core, _packed
from tests.test_torch_train import _labels, assert_state_close
from tests.torch_port_helpers import (
    inference_batch, jax_variables, perturbed, port_cfg, port_model,
    small_cfg)
from tim_tpu.models import TimDetection as JaxTimDetection
from tim_tpu.models.backbones import vit as jvit
from tim_tpu.ops.pallas_attention import (
    query_block_attention as jax_query_block_attention)
from tim_tpu.runner import backbone as jrunner
from tim_tpu.train import backbone_finetune as jft
from tim_tpu.train.detection import make_inference_step as jax_inference_step
from tim_tpu.train.state import create_train_state
from tim_tpu_torch.convert import two_head_state_dict_from_jax
from tim_tpu_torch.models.backbones import vit as pvit
from tim_tpu_torch.ops import flash_mha as fm
from tim_tpu_torch.ops import query_block_attention as qba
from tim_tpu_torch.runner import backbone as prunner
from tim_tpu_torch.train import backbone_finetune as pft
from tim_tpu_torch.train.detection import make_inference_step
from tim_tpu_torch.train.state import TrainState

TOL = 1e-4   # fp32 model outputs and parameters, of each largest (the
             # attention cores: ``_close``'s 1e-5)
BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dh", [192, 256, 264, 512])
def test_query_block_plain_matches_pallas_past_256(dh):
    rng = np.random.default_rng(dh)
    b, h, nq, f = 2, 2, 37, 20
    arrs = [rng.normal(size=shape).astype(np.float32)
            for shape in ((b, h, nq, dh), (b, h, f, dh), (b, h, nq, dh),
                          (b, h, f, dh), (b, h, nq, dh))]
    want = np.asarray(jax_query_block_attention(
        *[jnp.asarray(a) for a in arrs], tile_q=16, interpret=True))
    got = qba.query_block_attention(*[torch.from_numpy(a) for a in arrs])
    _close(got.numpy(), want, "query_block_attention")
    assert qba.launch_plan(dh, F32) == (qba.COLS if dh > 256
                                        else qba.CUDA_CORES)
    assert qba.launch_plan(dh, BF16) == qba.COLS


@pytest.mark.parametrize("dh", [192, 256, 264, 512])
def test_flash_plain_matches_jax_attention_past_256(dh):
    qkv, _ = _packed(dh, dh)
    scale = dh ** -0.5
    want = _jax_core(*(jnp.asarray(qkv[:, :, i]) for i in range(3)), scale)
    packed = torch.from_numpy(qkv)
    plain = fm.flash_mha_plain(*fm.unpack_qkv(packed), sm_scale=scale)
    _close(plain.transpose(1, 2).numpy(), want, "flash_mha_plain")
    got = fm.flash_mha_qkv(packed, sm_scale=scale)
    _close(got.transpose(1, 2).numpy(), want, "flash_mha_qkv")


@pytest.mark.parametrize("dh", [192, 256, 264, 512])
def test_flash_bwd_plain_matches_jax_grad_past_256(dh):
    qkv, do = _packed(dh, 100 + dh)
    scale = dh ** -0.5

    def f(q, k, v):
        return jnp.sum(_jax_core(q, k, v, scale) * do)

    want = jax.grad(f, argnums=(0, 1, 2))(
        *(jnp.asarray(qkv[:, :, i]) for i in range(3)))
    packed = torch.from_numpy(qkv)
    do_t = torch.from_numpy(do).transpose(1, 2)
    plain = fm.flash_mha_bwd_plain(*fm.unpack_qkv(packed), do_t,
                                   sm_scale=scale)
    leaf = packed.clone().requires_grad_()
    (fm.flash_mha_qkv(leaf, sm_scale=scale) * do_t).sum().backward()
    for i, name in enumerate(("dq", "dk", "dv")):
        w = np.asarray(want[i])
        _close(plain[i].transpose(1, 2).numpy(), w, f"plain {name}")
        _close(leaf.grad[:, :, i].numpy(), w, f"packed autograd {name}")


def test_detection_inference_at_head_dim_264_matches_jax():
    """``cli --d_model 132 --nhead 1`` at 2 layers: an encoder 264 wide in
    one head, kernel 1's column-slice head dim on the card."""
    cfg = small_cfg(d_model=132, nhead=1, use_fused_ffn=True)
    assert cfg.encoder_width // cfg.nhead == 264
    variables = jax_variables(cfg)
    batch = inference_batch(cfg, batch=3)
    want = jax.jit(jax_inference_step(JaxTimDetection(cfg), cfg))(
        variables["params"], {k: jnp.asarray(v) for k, v in batch.items()})
    got = make_inference_step(port_model(cfg, variables), port_cfg(cfg))(
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        w = np.asarray(w)
        g = got[key].numpy()
        assert g.shape == w.shape, key
        scale = max(np.abs(w).max(), 1e-30)
        assert np.abs(g - w).max() <= TOL * scale, key


VIT_HD264 = dict(img_size=24, patch_size=8, embed_dim=528, depth=2,
                 num_heads=2, num_frames=4, tubelet_size=2)


def test_two_head_vit_at_head_dim_264_steps_match_jax():
    """3 steps of ``make_two_head_step`` + ``make_llrd_optimizer`` at head
    dim 264 (``finetune_cli --embed_dim 528 --num_heads 2``; the card takes
    it on the column-slice routes, in place)."""
    jmodel = jrunner.TwoHeadViT(trunk=jvit.VideoMAEViT(**VIT_HD264),
                                num_verbs=5, num_nouns=7)
    clip = np.random.default_rng(5).normal(
        size=(2, 4, 24, 24, 3)).astype(np.float32)
    variables = perturbed(jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                               jnp.asarray(clip)), 0)
    model = prunner.TwoHeadViT(pvit.VideoMAEViT(**VIT_HD264, device="cpu"),
                               num_verbs=5, num_nouns=7)
    model.load_state_dict(two_head_state_dict_from_jax(variables),
                          strict=True)
    assert fm.launch_plan(264, BF16) == (264, False)
    batch = {"video": clip, "verb": _labels(2)[0], "noun": _labels(2)[1]}
    kw = dict(depth=2, lr=1e-3, total_steps=3, warmup_steps=2)
    state = create_train_state(variables["params"], jft.make_llrd_optimizer(
        variables["params"], **kw))
    step = jax.jit(jrunner.make_two_head_step(jmodel, mixup_alpha=0.0))
    optimizer, schedule = pft.make_llrd_optimizer(model, **kw)
    pstate = TrainState(model, optimizer, schedule)
    pstep = prunner.make_two_head_step(model, mixup_alpha=0.0)
    pbatch = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    rng = jax.random.PRNGKey(1)
    for i in range(3):
        state, metrics = step(state, {k: jnp.asarray(v)
                                      for k, v in batch.items()}, rng)
        pmetrics = pstep(pstate, pbatch)
        np.testing.assert_allclose(pmetrics["loss"].item(),
                                   float(metrics["loss"]), rtol=1e-5)
        assert_state_close(dict(model.named_parameters()),
                           two_head_state_dict_from_jax(
                               {"params": state.params}),
                           TOL, "param", 2e-3 * (i + 1))
    assert pstate.step == 3


def test_flash_plan_and_routes_past_256():
    """257-1024 in both dtypes: the column-slice route at dh where a row of
    dh fills 16-byte words (bf16 multiples of 8, fp32 of 4), else at the
    next multiple of 64 through the copy; strided rows off 16 bytes take
    the copy too; one route name a (dtype, width, direction, copy); the
    bf16 forward's slices of a query tile as one cluster from 513 to 2048
    (``CLUSTER_DIMS``), Q streamed past it."""
    for dtype, per in ((BF16, 8), (F32, 4)):
        for dh in range(257, 1025):
            w, copied = fm.launch_plan(dh, dtype)
            assert copied == (dh % per != 0), (dh, dtype)
            assert w == (dh if dh % per == 0 else -(-dh // 64) * 64)
    q = torch.zeros(1, 2, 5, 512, dtype=BF16)
    assert fm.launch_plan(512, BF16, q, q, q) == (512, False)
    shifted = torch.zeros(2 * 5 * 512 + 4, dtype=BF16)[4:].view(1, 2, 5, 512)
    assert fm.launch_plan(512, BF16, q, shifted, q) == (512, True)
    assert fm.route(BF16, 512, False) == "wgmma slices 512"
    assert fm.route(BF16, 320, True) == "wgmma slices 320 via copy"
    for dh in range(257, 2400, 8):
        assert fm.cluster(dh, BF16) == (512 < dh <= 2048)
        assert not fm.cluster(dh, F32)
    assert fm.route(BF16, 520, False) == "wgmma cluster slices 520"
    assert fm.route(BF16, 1024, False) == "wgmma cluster slices 1024"
    assert fm.route(BF16, 2048, False) == "wgmma cluster slices 2048"
    assert fm.route(BF16, 2112, True) == "wgmma streamed slices 2112 via copy"
    assert fm.route(BF16, 1024, False, backward=True) \
        == "wgmma two passes slices 1024"
    assert fm.route(F32, 1024, False) == "fp32 cuda cores slices 1024"
    assert fm.route(BF16, 512, False, backward=True) \
        == "wgmma two passes slices 512"
    # the backward is atomic-free either way: one route, deterministic or not
    assert fm.route(BF16, 1024, False, backward=True, deterministic=True) \
        == "wgmma two passes slices 1024"
    assert fm.route(F32, 300, False) == "fp32 cuda cores slices 300"
    assert fm.route(F32, 300, False, backward=True) \
        == "fp32 cuda cores slices 300"
    # every head dim from 1 up passes the check
    for dh in (257, 300, 512, 1024):
        t = torch.zeros(1, 2, 3, dh)
        fm.check_args("flash_mha", t, t, t)


@pytest.mark.parametrize("dh,aligned,width", [
    (257, True, 320), (264, True, None), (300, True, 320), (320, True, None),
    (512, True, None), (512, False, 512), (1000, True, None),
    (1024, True, None), (1020, True, 1024)])
def test_query_block_plan_and_copy_past_256(dh, aligned, width):
    """Kernel 1 past 256: the column-slice design in both dtypes; bf16 read
    in place where dh is a multiple of 8 and every row is 16-byte aligned,
    else copied zero-padded to the next multiple of 64; fp32 never
    copied; bf16 past 512 the slices of a query tile as one cluster."""
    b, h, nq, f = 1, 2, 24, 10
    qkv = torch.zeros(b, nq + f, 3, h, dh + (0 if aligned else 1),
                      dtype=BF16)[..., :dh]
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    args = (q[:, :, f:], k[:, :, :f], k[:, :, f:], v[:, :, :f], v[:, :, f:])
    qba._check(*args)
    assert qba.launch_plan(dh, BF16) == qba.COLS
    assert qba.copy_width(dh, BF16, *args) == width
    f32 = [t.float() for t in args]
    assert qba.launch_plan(dh, F32) == qba.COLS
    assert qba.copy_width(dh, F32, *f32) is None
    cluster = " cluster" if (width or dh) > 512 else ""
    assert qba.route(width or dh, BF16, qba.COLS, width is not None) == (
        f"wgmma{cluster} slices {width or dh}"
        + (" via copy" if width else ""))
    assert qba.route(dh, F32, qba.COLS) == f"fp32 cuda cores slices {dh}"
    assert qba.route(128, BF16, qba.TENSOR_CORES) == "tensor cores 128"
    assert qba.route(256, BF16, qba.COLS) == "wgmma slices 256"
    # fp32 keeps its CUDA-core design up to 256
    assert qba.route(256, F32, qba.CUDA_CORES) == "fp32 cuda cores 256"


@pytest.mark.parametrize("dh,aligned,width", [
    (168, True, None), (180, True, 192), (180, False, 192),
    (200, True, None), (200, False, 256), (256, True, None),
    (256, False, 256)])
def test_query_block_plan_and_copy_161_to_256(dh, aligned, width):
    """Kernel 1 from 161 to 256: bf16 on the column-slice design (one
    256-column slice), read in place where dh is a multiple of 8 and every
    row is 16-byte aligned, else copied zero-padded to the next multiple
    of 64; fp32 on its CUDA-core design, never copied; no bf16 launch on
    the CUDA cores."""
    b, h, nq, f = 1, 2, 24, 10
    qkv = torch.zeros(b, nq + f, 3, h, dh + (0 if aligned else 1),
                      dtype=BF16)[..., :dh]
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    args = (q[:, :, f:], k[:, :, :f], k[:, :, f:], v[:, :, :f], v[:, :, f:])
    qba._check(*args)
    assert qba.launch_plan(dh, BF16) == qba.COLS
    assert qba.copy_width(dh, BF16, *args) == width
    assert qba.route(width or dh, BF16, qba.COLS, width is not None) == (
        f"wgmma slices {width or dh}" + (" via copy" if width else ""))
    f32 = [t.float() for t in args]
    assert qba.launch_plan(dh, F32) == qba.CUDA_CORES
    assert qba.copy_width(dh, F32, *f32) is None
    assert qba.route(dh, F32, qba.CUDA_CORES) == f"fp32 cuda cores {dh}"
    for dims in range(1, 257):
        assert qba.launch_plan(dims, BF16) != qba.CUDA_CORES


@pytest.mark.parametrize("dh,inst,copied,bwd_inst,bwd_copied", [
    (136, 256, True, 192, False), (144, 256, True, 192, False),
    (180, 256, True, 192, True), (192, 256, True, 192, False),
    (200, 256, True, 256, False), (204, 256, True, 256, True),
    (256, 256, False, 256, False)])
def test_flash_plans_129_to_256(dh, inst, copied, bwd_inst, bwd_copied):
    """Kernels 5 / 5b from 129 to 256 in bf16: the forward on instance 256
    (through the zero-padded copy below 256), the backward on the split
    passes' instances 192 and 256, each reading a multiple of 8 up to 56
    below it in place (else the copy); strided rows off 16 bytes take the
    copy; fp32 both ways on 256 through the copy; no route named
    mma.sync."""
    q = torch.zeros(2, 3, 5, dh, dtype=BF16)
    assert fm.launch_plan(dh, BF16, q, q, q) == (inst, copied)
    assert fm.launch_plan(dh, BF16, q, q, q, backward=True) == (
        bwd_inst, bwd_copied)
    shifted = torch.zeros(2 * 3 * 5 * dh + 4, dtype=BF16)[4:].view(
        2, 3, 5, dh)
    assert fm.launch_plan(dh, BF16, q, shifted, q, backward=True) == (
        bwd_inst, True)
    assert fm.route(BF16, inst, copied) == "wgmma 256" + (
        " via copy" if copied else "")
    want = f"wgmma split passes {bwd_inst}" + (
        " via copy" if bwd_copied else "")
    for deterministic in (False, True):
        assert fm.route(BF16, bwd_inst, bwd_copied, backward=True,
                        deterministic=deterministic) == want
    for backward in (False, True):
        assert fm.launch_plan(dh, F32, backward=backward) == (
            256, dh != 256)
        assert fm.route(F32, 256, dh != 256, backward=backward) == (
            "fp32 cuda cores 256" + (" via copy" if dh != 256 else ""))
    for dims in range(1, 257):
        for backward in (False, True):
            w, c = fm.launch_plan(dims, BF16, backward=backward)
            assert "mma.sync" not in fm.route(BF16, w, c, backward=backward)
