"""Kernel 4 / 4b at every head dim (CPU): the plain versions of Swin window
attention against ``tim_tpu/ops/pallas_swin.py::window_attention_flash``
(Pallas interpret mode) and its custom VJP at head dims on and off the
card's instances; the zero-padded route's arithmetic; the launch plan and
route names of every head dim from 1 to 1100; and a port
``SwinTransformer3D`` whose heads give head dims 40 and 264 against JAX's
flash route, forward and three finetune steps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_train import GRAD_TOL, assert_state_close
from tests.torch_port_helpers import perturbed
from tim_tpu.models.backbones import swin3d as jswin
from tim_tpu.ops.pallas_swin import (window_attention_flash,
                                     window_type_major,
                                     window_type_major_inverse)
from tim_tpu.runner import backbone as jrunner
from tim_tpu.train.state import create_train_state
from tim_tpu_torch.convert import two_head_state_dict_from_jax
from tim_tpu_torch.models.backbones import swin3d as pswin
from tim_tpu_torch.ops import flash_mha as fm
from tim_tpu_torch.ops import window_attention as wa
from tim_tpu_torch.runner import backbone as prunner
from tim_tpu_torch.train.state import TrainState

# of each output's or gradient's largest value: fp32 sums in another order
KERNEL_TOL = 1e-5
MODEL_TOL = 1e-4


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _close(got, want, tol, name):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"{name}: max abs err {err} > {tol} x {scale}"


def _case(n_types, dh, n, seed):
    """q, k, v, do [BW, H, N, dh], bias [H, N, N] and region ids (None
    unshifted) from numpy, BW = 2 windows of each type, H = 2."""
    rng = np.random.default_rng(seed)
    bw, h = 2 * n_types, 2
    q, k, v, do = (rng.normal(size=(bw, h, n, dh)).astype(np.float32)
                   for _ in range(4))
    bias = (rng.normal(size=(h, n, n)) * 2).astype(np.float32)
    region = (torch.from_numpy(rng.integers(0, 3, size=(n_types, n))
                               .astype(np.int32)) if n_types > 1 else None)
    return q, k, v, do, bias, region


@pytest.mark.parametrize("n_types,n", [(1, 18), (3, 50)])
@pytest.mark.parametrize("dh", [16, 40, 64, 128, 264])
def test_plain_backward_matches_jax_kernel(n_types, n, dh):
    """dq, dk, dv and dbias of ``window_attention_bwd_plain`` against
    ``jax.grad`` of the Pallas kernel (its custom VJP; dab summed over the
    window types), shifted (3 types) and unshifted."""
    q, k, v, do, bias, region = _case(n_types, dh, n, dh + n)
    scale = dh ** -0.5
    ab = wa.attention_bias(_t(bias), region).numpy()

    def f(q, k, v, ab):
        out = window_attention_flash(
            *(window_type_major(t, n_types) for t in (q, k, v)), ab,
            sm_scale=scale, interpret=True)
        return jnp.sum(window_type_major_inverse(out, n_types) * do)

    want = jax.grad(f, argnums=(0, 1, 2, 3))(*map(jnp.asarray,
                                                  (q, k, v, ab)))
    want = [np.asarray(w) for w in want[:3]] + [np.asarray(want[3]).sum(0)]
    got = wa.window_attention_bwd_plain(_t(q), _t(k), _t(v), _t(bias),
                                        region, _t(do), sm_scale=scale)
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        _close(g.numpy(), w, KERNEL_TOL, f"dh {dh} {name}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [16, 40, 91, 200, 302])
def test_padded_route_arithmetic(dtype, dh):
    """The plain version on q, k, v (and out, do) zero-padded to the
    instance the plan picks, then sliced, equals the plain version at dh:
    forward, dq, dk, dv and dbias."""
    w, copied = wa.launch_plan(dh, dtype)
    assert copied and w > dh
    q, k, v, do, bias, region = _case(3, dh, 27, dh)
    q, k, v, do = (_t(x).to(dtype) for x in (q, k, v, do))
    bias, scale = _t(bias), dh ** -0.5
    pq, pk, pv = fm.unpack_qkv(fm.padded_qkv(q, k, v, w))
    want = wa.window_attention_plain(q, k, v, bias, region, sm_scale=scale)
    got = wa.window_attention_plain(pq, pk, pv, bias, region, sm_scale=scale)
    assert not got[..., dh:].float().abs().any()
    _close(got[..., :dh].float(), want.float(), 1e-6, "forward")
    want_b = wa.window_attention_bwd_plain(q, k, v, bias, region, do,
                                           sm_scale=scale)
    got_b = wa.window_attention_bwd_plain(pq, pk, pv, bias, region,
                                          fm.pad_last(do, w), sm_scale=scale)
    for name, g, x in zip(("dq", "dk", "dv"), got_b[:3], want_b[:3]):
        assert not g[..., dh:].float().abs().any(), name
        _close(g[..., :dh].float(), x.float(), 1e-6, name)
    _close(got_b[3], want_b[3], 1e-6, "dbias")


def test_plan_and_routes_of_every_head_dim():
    """Every head dim from 1 to 1100 in both dtypes has an instance (none
    refused); the instance, the copy and the route names are as PERF.md's
    table gives them."""
    bf16, f32 = torch.bfloat16, torch.float32
    for dtype in (f32, bf16):
        for dh in range(1, 1101):
            w, copied = wa.launch_plan(dh, dtype)
            assert w >= dh
            if dh <= 32:
                assert w == 32 and copied == (dh != 32)
            elif dh <= fm.SLICED:
                assert w in (fm.HEAD_DIMS if dtype == bf16
                             else fm.F32_HEAD_DIMS)
                assert copied == (not fm.reads_in_place(dh, dtype, w))
            else:
                size = 2 if dtype == bf16 else 4
                assert copied == (dh * size % 16 != 0)
                assert w == (dh if not copied else -(-dh // 64) * 64)
            name = wa.route(dtype, w, copied)
            bwd = wa.route(dtype, w, copied, backward=True)
            assert name.endswith(" via copy") == copied
            assert bwd.endswith(" via copy") == copied
            if dtype == f32:
                assert name.startswith("fp32 cuda cores ")
                assert bwd.startswith("fp32 cuda cores " if w <= 64
                                      else "fp32 cuda cores slices ")
            elif w == 32:
                assert name.startswith("wgmma 32")
                assert bwd.startswith("wgmma one pass 32")
            else:
                assert " + dbias pass" in bwd
    # the table's rows
    table = {
        (16, bf16): (32, True, "wgmma 32 via copy",
                     "wgmma one pass 32 via copy"),
        (32, bf16): (32, False, "wgmma 32", "wgmma one pass 32"),
        (40, bf16): (64, True, "wgmma 64 via copy",
                     "wgmma two passes 64 + dbias pass via copy"),
        (64, bf16): (64, False, "wgmma 64", "wgmma two passes 64 + dbias pass"),
        (72, bf16): (80, False, "wgmma 80", "wgmma two passes 80 + dbias pass"),
        (91, bf16): (96, True, "wgmma 96 via copy",
                     "wgmma two passes 96 + dbias pass via copy"),
        (128, bf16): (128, False, "wgmma 128",
                      "wgmma two passes 128 + dbias pass"),
        (200, bf16): (256, True, "wgmma 256 via copy",
                      "wgmma two passes slices 256 + dbias pass via copy"),
        (256, bf16): (256, False, "wgmma 256",
                      "wgmma two passes slices 256 + dbias pass"),
        (264, bf16): (264, False, "wgmma slices 264",
                      "wgmma two passes slices 264 + dbias pass"),
        (1024, bf16): (1024, False, "wgmma slices 1024",
                       "wgmma two passes slices 1024 + dbias pass"),
        (300, bf16): (320, True, "wgmma slices 320 via copy",
                      "wgmma two passes slices 320 + dbias pass via copy"),
        (40, f32): (64, True, "fp32 cuda cores 64 via copy",
                    "fp32 cuda cores 64 via copy"),
        (80, f32): (128, True, "fp32 cuda cores 128 via copy",
                    "fp32 cuda cores slices 128 via copy"),
        (264, f32): (264, False, "fp32 cuda cores slices 264",
                     "fp32 cuda cores slices 264"),
    }
    for (dh, dtype), (w, copied, fwd, bwd) in table.items():
        assert wa.launch_plan(dh, dtype) == (w, copied), dh
        assert wa.route(dtype, w, copied) == fwd
        assert wa.route(dtype, w, copied, backward=True) == bwd
    assert wa.route(bf16, 32, False, backward=True, deterministic=True) == \
        "wgmma one pass 32 + dq pass"
    assert wa.route(bf16, 64, False, backward=True, deterministic=True) == \
        "wgmma two passes 64 + dbias pass"


def test_dbias_groups():
    """The bf16 dbias pass's window groups: enough blocks for two waves,
    never more groups than windows."""
    assert wa.dbias_groups(512, 2, 784, 132) == 2     # 182 blocks a group
    assert wa.dbias_groups(8, 16, 784, 132) == 1      # 1456 blocks
    assert wa.dbias_groups(8, 1, 784, 132) == 3
    assert wa.dbias_groups(1, 1, 50, 132) == 1
    for bw, h, n in ((4, 2, 18), (512, 3, 784), (2, 1, 1000)):
        g = wa.dbias_groups(bw, h, n, 132)
        assert 1 <= g <= bw


# A small Swin whose heads give head dims 40 (embed 80, 2 heads) and 264
# (embed 264, 1 head): one stage of two blocks, the second shifted
HEADS = {40: dict(embed_dim=80, num_heads=(2,)),
         264: dict(embed_dim=264, num_heads=(1,))}
SMALL = dict(patch_size=(2, 4, 4), depths=(2,), window_size=(2, 3, 3))
CLASSES = dict(num_verbs=5, num_nouns=7)


@pytest.fixture
def flash_interpret(monkeypatch):
    """JAX's Swin attention through its Pallas kernel in interpret mode."""
    import tim_tpu.ops.pallas_swin as ps
    real = ps.window_attention_flash
    monkeypatch.setattr(
        ps, "window_attention_flash",
        lambda *a, **kw: real(*a, **{**kw, "interpret": True}))


@pytest.mark.parametrize("dh", sorted(HEADS))
def test_swin_at_other_head_dims_matches_jax_flash(flash_interpret, dh):
    """The port's ``SwinTransformer3D(device="cpu")`` at head dim ``dh``
    against JAX's flash route: the forward of two clips within MODEL_TOL
    of its largest value, then three two-head finetune steps (AdamW, mixup
    off): each step's loss, and every parameter after it held as
    ``tests/test_torch_train.py`` holds the Swin trunk at head dim 8
    (GRAD_TOL of each tensor's largest value, Adam's budget of 2 lr a
    step where a gradient is within rounding of zero)."""
    kw = dict(SMALL, **HEADS[dh])
    clip = np.random.default_rng(dh).normal(
        size=(2, 4, 24, 24, 3)).astype(np.float32)
    jtrunk = jswin.SwinTransformer3D(use_flash=True, **kw)
    jmodel = jrunner.TwoHeadViT(trunk=jtrunk, **CLASSES)
    variables = perturbed(jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                               jnp.asarray(clip)), 0)
    ptrunk = pswin.SwinTransformer3D(**kw, device="cpu")
    model = prunner.TwoHeadViT(ptrunk, **CLASSES)
    model.load_state_dict(two_head_state_dict_from_jax(variables),
                          strict=True)
    trunk_params = {"params": variables["params"]["trunk"]}
    want = np.asarray(jtrunk.apply(trunk_params, jnp.asarray(clip)))
    with torch.no_grad():
        got = ptrunk(_t(clip)).numpy()
    _close(got, want, MODEL_TOL, f"dh {dh} forward")

    import optax
    rng = np.random.default_rng(5)
    batch = {"video": clip,
             "verb": rng.integers(0, 5, 2).astype(np.int32),
             "noun": rng.integers(0, 7, 2).astype(np.int32)}
    state = create_train_state(variables["params"],
                               optax.adamw(1e-4, weight_decay=0.05))
    step = jax.jit(jrunner.make_two_head_step(jmodel, mixup_alpha=0.0))
    pstate = TrainState(model, torch.optim.AdamW(
        model.parameters(), lr=1e-4, weight_decay=0.05))
    pstep = prunner.make_two_head_step(model, mixup_alpha=0.0)
    for i in range(3):
        state, metrics = step(state, {k: jnp.asarray(v)
                                      for k, v in batch.items()},
                              jax.random.PRNGKey(0))
        pmetrics = pstep(pstate, {k: torch.from_numpy(np.asarray(v))
                                  for k, v in batch.items()})
        np.testing.assert_allclose(pmetrics["loss"].item(),
                                   float(metrics["loss"]), rtol=1e-5)
        assert_state_close(dict(model.named_parameters()),
                           two_head_state_dict_from_jax(
                               {"params": state.params}),
                           GRAD_TOL, f"dh {dh} step {i + 1} param",
                           2e-4 * (i + 1))
