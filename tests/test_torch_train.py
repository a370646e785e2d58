"""Backbone training in the port against the JAX package on the CPU, fp32,
at small sizes; both packages get the same numpy inputs and weights.

- kernel backwards: ``window_attention_bwd_plain`` and autograd through
  ``window_attention`` against ``jax.grad`` of ``window_attention_flash``
  (interpret mode, shift-mask ``ab``; dbias against ``dab`` summed over
  the window types), ``flash_mha``'s against the JAX einsum core: to 1e-5
  of each gradient's largest value (the same fp32 function, summed in
  another order);
- tiny ``TwoHeadViT`` (ViT and shifted-window Swin trunks) and
  ``PretrainVideoMAE`` losses and gradients, per parameter tensor to 1e-4
  of its largest gradient;
- 3 LLRD AdamW steps, ``make_finetune_step`` and both runners' ``fit``:
  parameters to 1e-4 of each tensor's largest value, except where Adam is
  ill-conditioned (see ``assert_state_close``);
- the LLRD layer index and decay mask per parameter, the schedule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import emulated_attention_bwd, grad_close
from tests.torch_port_helpers import perturbed
from tim_tpu.extract import masking as jmasking
from tim_tpu.models.backbones import mae as jmae
from tim_tpu.models.backbones import swin3d as jswin
from tim_tpu.models.backbones import vit as jvit
from tim_tpu.ops.pallas_swin import (
    window_attention_flash, window_type_major, window_type_major_inverse)
from tim_tpu.runner import backbone as jrunner
from tim_tpu.train import backbone_finetune as jft
from tim_tpu.train.optim import warmup_cosine_schedule as jax_schedule
from tim_tpu.train.state import create_train_state
from tim_tpu_torch.convert import (
    mae_state_dict_from_jax, two_head_state_dict_from_jax,
    vit_state_dict_from_jax)
from tim_tpu_torch.extract import masking
from tim_tpu_torch.models.backbones import mae as pmae
from tim_tpu_torch.models.backbones import swin3d as pswin
from tim_tpu_torch.models.backbones import vit as pvit
from tim_tpu_torch.ops.flash_mha import flash_mha, flash_mha_bwd_plain
from tim_tpu_torch.ops.window_attention import (
    attention_bias, window_attention, window_attention_bwd_plain)
from tim_tpu_torch.runner import backbone as prunner
from tim_tpu_torch.train import backbone_finetune as pft
from tim_tpu_torch.train.optim import warmup_cosine_schedule
from tim_tpu_torch.train.state import TrainState

VIT = dict(img_size=24, patch_size=8, embed_dim=32, depth=2, num_heads=4,
           num_frames=4, tubelet_size=2)
SWIN = dict(patch_size=(2, 4, 4), embed_dim=16, depths=(2, 2),
            num_heads=(2, 4), window_size=(8, 3, 3))
MAE = dict(img_size=24, patch_size=8, embed_dim=64, depth=2, num_heads=2,
           decoder_dim=32, decoder_depth=2, decoder_heads=1, num_frames=4,
           tubelet_size=2)
CLASSES = dict(num_verbs=5, num_nouns=7)
GRAD_TOL = 1e-4       # models: of each tensor's largest gradient
KERNEL_TOL = 1e-5     # kernel backwards: of each gradient's largest value


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def assert_close_scaled(got, want, tol, name=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"{name}: max abs err {err} > {tol} x {scale}"


def assert_state_close(got: dict, want: dict, tol, what="grad",
                       budget=None):
    """Every tensor of ``want`` (name -> tensor) against ``got``: within
    ``tol`` of its largest value. Parameters after Adam steps
    (``budget``, 2 lr per step taken) are held so only where Adam's update
    is well conditioned: it divides each element's gradient by its own
    size, so an element whose gradient is within fp32 rounding of zero
    moves by up to lr in either package. There, every element stays
    within ``budget`` and all but one in a thousand (at least one) within
    ``tol``. Swin's qkv k bias gets a gradient that is 0 in exact
    arithmetic (a constant added to each row of scores), so the whole of
    its third is held to the budget."""
    assert set(got) == set(want)
    for name in sorted(want):
        assert got[name] is not None, f"{name}: no {what}"
        g, w = got[name].detach().numpy(), want[name].numpy()
        if budget is None:
            assert_close_scaled(g, w, tol, f"{what} {name}")
            continue
        err = np.abs(g.astype(np.float64) - w)
        assert err.max() <= budget, f"{what} {name}: {err.max()} > {budget}"
        if name.endswith("attn.qkv.bias"):
            c = len(w) // 3
            err, w = np.delete(err, np.s_[c:2 * c]), \
                np.delete(w, np.s_[c:2 * c])
        loose = int((err > tol * np.abs(w).max()).sum())
        assert loose <= max(1, err.size // 1000), \
            f"{what} {name}: {loose} of {err.size} elements beyond {tol}"


@pytest.mark.parametrize("n_types,batch,h,n,dh", [
    (1, 3, 2, 27, 32),    # unshifted: one bias for every window
    (3, 2, 2, 36, 32),    # shifted: region ids per window type
    (4, 2, 2, 18, 64),
])
def test_window_attention_bwd_matches_jax_kernel(n_types, batch, h, n, dh):
    rng = np.random.default_rng(n)
    bw = batch * n_types
    q, k, v, do = (rng.normal(size=(bw, h, n, dh)).astype(np.float32)
                   for _ in range(4))
    bias = (rng.normal(size=(h, n, n)) * 2).astype(np.float32)
    region = (torch.from_numpy(rng.integers(0, 3, size=(n_types, n))
                               .astype(np.int32)) if n_types > 1 else None)
    scale = dh ** -0.5
    ab = attention_bias(_t(bias), region).numpy()

    def f(q, k, v, ab):
        out = window_attention_flash(
            *(window_type_major(t, n_types) for t in (q, k, v)), ab,
            sm_scale=scale, interpret=True)
        return jnp.sum(window_type_major_inverse(out, n_types) * do)

    want = jax.grad(f, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (q, k, v, ab)))
    want = [np.asarray(w) for w in want[:3]] + [np.asarray(want[3]).sum(0)]
    plain = window_attention_bwd_plain(_t(q), _t(k), _t(v), _t(bias), region,
                                       _t(do), sm_scale=scale)
    leaves = [_t(x).requires_grad_() for x in (q, k, v, bias)]
    out = window_attention(*leaves[:3], leaves[3], region, sm_scale=scale)
    (out * _t(do)).sum().backward()
    for name, p, a, w in zip(("dq", "dk", "dv", "dbias"), plain, leaves,
                             want):
        assert_close_scaled(p.numpy(), w, KERNEL_TOL, f"plain {name}")
        assert_close_scaled(a.grad.numpy(), w, KERNEL_TOL, f"autograd {name}")


def _jax_attention_core(q, k, v, scale):
    """The einsum branch of ``vit.py:108-113`` on [B, S, H, dh]."""
    attn = jnp.einsum("bqhd,bkhd->bhqk", q * scale, k,
                      preferred_element_type=jnp.float32)
    attn = jax.nn.softmax(attn, axis=-1).astype(q.dtype)
    return jnp.einsum("bhqk,bkhd->bqhd", attn, v,
                      preferred_element_type=jnp.float32)


@pytest.mark.parametrize("s", [37, 200])
def test_flash_mha_grads_match_jax_core(s):
    rng = np.random.default_rng(s)
    q, k, v, do = (rng.normal(size=(2, s, 2, 64)).astype(np.float32)
                   for _ in range(4))
    scale = 0.125

    def f(q, k, v):
        return jnp.sum(_jax_attention_core(q, k, v, scale) * do)

    want = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    bhsd = [_t(x).transpose(1, 2) for x in (q, k, v, do)]
    plain = flash_mha_bwd_plain(*bhsd[:3], bhsd[3], sm_scale=scale)
    leaves = [x.clone().requires_grad_() for x in bhsd[:3]]
    (flash_mha(*leaves, sm_scale=scale) * bhsd[3]).sum().backward()
    for name, p, a, w in zip(("dq", "dk", "dv"), plain, leaves, want):
        w = np.asarray(w).transpose(0, 2, 1, 3)
        assert_close_scaled(p.numpy(), w, KERNEL_TOL, f"plain {name}")
        assert_close_scaled(a.grad.numpy(), w, KERNEL_TOL, f"autograd {name}")


def _clip(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _two_head_pair(trunk_kind, seed=0):
    """(flax TwoHeadViT, perturbed variables, port TwoHeadViT with the
    same weights, clip batch)."""
    if trunk_kind == "vit":
        jtrunk = jvit.VideoMAEViT(**VIT)
        ptrunk = pvit.VideoMAEViT(**VIT, device="cpu")
        clip = _clip(4, (2, 4, 24, 24, 3))
    else:
        jtrunk = jswin.SwinTransformer3D(**SWIN)
        ptrunk = pswin.SwinTransformer3D(**SWIN, device="cpu")
        clip = _clip(3, (2, 8, 24, 24, 3))
    jmodel = jrunner.TwoHeadViT(trunk=jtrunk, **CLASSES)
    variables = perturbed(jax.jit(jmodel.init)(jax.random.PRNGKey(seed),
                                               jnp.asarray(clip)), seed)
    model = prunner.TwoHeadViT(ptrunk, **CLASSES)
    model.load_state_dict(two_head_state_dict_from_jax(variables),
                          strict=True)
    return jmodel, variables, model, clip


def _labels(b, seed=5):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, CLASSES["num_verbs"], b).astype(np.int32),
            rng.integers(0, CLASSES["num_nouns"], b).astype(np.int32))


def _jax_two_head_loss(jmodel, params, video, verbs, nouns, lam, perm):
    tv = jft.mixup_targets(verbs, perm, lam, jmodel.num_verbs, 0.1)
    tn = jft.mixup_targets(nouns, perm, lam, jmodel.num_nouns, 0.1)
    lv, ln_ = jmodel.apply({"params": params}, video)
    return (jft.soft_target_cross_entropy(lv, tv)
            + jft.soft_target_cross_entropy(ln_, tn))


@pytest.mark.parametrize("trunk_kind", ["vit", "swin"])
def test_two_head_loss_and_grads_match_jax(trunk_kind):
    """Loss and every parameter gradient of the finetune objective (mixup
    targets with lam 0.7 over a permutation, label smoothing 0.1); the
    Swin trunk has shifted blocks and a clamped window."""
    jmodel, variables, model, clip = _two_head_pair(trunk_kind)
    verbs, nouns = _labels(2)
    lam, perm = 0.7, np.array([1, 0])
    video = lam * clip + (1 - lam) * clip[perm]
    loss, grads = jax.jit(jax.value_and_grad(
        lambda params: _jax_two_head_loss(jmodel, params, jnp.asarray(video),
                                          verbs, nouns, lam, perm)))(
        variables["params"])
    lv, ln_ = model(_t(video))
    tp = torch.from_numpy(perm)
    got = (pft.soft_target_cross_entropy(lv, pft.mixup_targets(
        torch.from_numpy(verbs), tp, lam, 5, 0.1))
        + pft.soft_target_cross_entropy(ln_, pft.mixup_targets(
            torch.from_numpy(nouns), tp, lam, 7, 0.1)))
    got.backward()
    np.testing.assert_allclose(got.item(), float(loss), rtol=1e-5)
    assert_state_close(dict((n, p.grad) for n, p in model.named_parameters()),
                       two_head_state_dict_from_jax({"params": grads}),
                       GRAD_TOL)


def _params_close(model, jparams, budget):
    assert_state_close(dict(model.named_parameters()),
                       two_head_state_dict_from_jax({"params": jparams}),
                       GRAD_TOL, "param", budget)


@pytest.mark.parametrize("mixup", [False, True])
def test_llrd_adamw_steps_match_jax(mixup):
    """3 steps of ``make_two_head_step`` + ``make_llrd_optimizer`` (warmup
    2 of 3 steps, clip 5): the loss of each step and every parameter after
    it. With mixup, the port is given the lam and permutation that JAX's
    step draws from its key."""
    jmodel, variables, model, clip = _two_head_pair("vit")
    batch = {"video": clip, "verb": _labels(2)[0], "noun": _labels(2)[1]}
    kw = dict(depth=2, lr=1e-3, total_steps=3, warmup_steps=2)
    alpha = 0.8 if mixup else 0.0
    state = create_train_state(variables["params"], jft.make_llrd_optimizer(
        variables["params"], **kw))
    step = jax.jit(jrunner.make_two_head_step(jmodel, mixup_alpha=alpha))
    optimizer, schedule = pft.make_llrd_optimizer(model, **kw)
    pstate = TrainState(model, optimizer, schedule)
    pstep = prunner.make_two_head_step(model, mixup_alpha=alpha)
    pbatch = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    rng = jax.random.PRNGKey(1)
    for i in range(3):
        given = {}
        if mixup:   # the draws of tim_tpu/runner/backbone.py:63-70
            rng_mix, rng_lam = jax.random.split(jax.random.fold_in(rng, i))
            given = {"lam": float(jax.random.beta(rng_lam, alpha, alpha)),
                     "perm": torch.from_numpy(np.array(
                         jax.random.permutation(rng_mix, 2)))}
        state, metrics = step(state, {k: jnp.asarray(v)
                                      for k, v in batch.items()}, rng)
        pmetrics = pstep(pstate, pbatch, **given)
        np.testing.assert_allclose(pmetrics["loss"].item(),
                                   float(metrics["loss"]), rtol=1e-5)
        _params_close(model, state.params, 2e-3 * (i + 1))
    assert pstate.step == 3


@pytest.mark.parametrize("kind", ["vit", "mae"])
def test_layer_index_and_decay_mask_match_jax(kind):
    """Per parameter: the LLRD scale decay^(depth + 1 - layer) and whether
    it decays, from the JAX package's functions on its param tree against
    the port's on the reference names (TwoHeadViT, and the MAE model's
    encoder/decoder names)."""
    if kind == "vit":
        jmodel, variables, model, _ = _two_head_pair("vit")
        convert = two_head_state_dict_from_jax
    else:
        jmodel, variables, model = _mae_pair()[:3]
        convert = mae_state_dict_from_jax

    def names(path):
        return tuple(getattr(p, "key", getattr(p, "name", str(p)))
                     for p in path)

    def jax_tree(fn):
        return {"params": jax.tree_util.tree_map_with_path(
            lambda path, leaf: np.full(leaf.shape, float(fn(names(path),
                                                            leaf))),
            variables["params"])}

    scales = convert(jax_tree(
        lambda p, _: 0.75 ** (3 - jft.vit_layer_index(p, 2))))
    decays = convert(jax_tree(lambda p, leaf: not jft._no_decay(p, leaf)))
    params = dict(model.named_parameters())
    assert set(scales) == set(params)
    for name, param in params.items():
        assert 0.75 ** (3 - pft.vit_layer_index(name, 2)) == pytest.approx(
            scales[name].flatten()[0].item()), name
        assert (not pft.no_weight_decay(name, param)) == bool(
            decays[name].flatten()[0].item()), name
    if kind == "vit":
        optimizer, _ = pft.make_llrd_optimizer(model, depth=2, lr=1e-3)
        for group in optimizer.param_groups:
            for p in group["params"]:
                name = next(n for n, q in params.items() if q is p)
                assert group["lr_scale"] == pytest.approx(
                    scales[name].flatten()[0].item())
                assert (group["weight_decay"] > 0) == bool(
                    decays[name].flatten()[0].item())


@pytest.mark.parametrize("lr,min_lr,total,warmup", [
    (1e-3, 1e-6, 10, 3), (1e-3, 1e-6, 10, 0), (5e-4, 0.0, 0, 0),
    (2e-3, 1e-5, 7, 12)])
def test_warmup_cosine_schedule_matches_jax(lr, min_lr, total, warmup):
    want, got = jax_schedule(lr, min_lr, total, warmup), \
        warmup_cosine_schedule(lr, min_lr, total, warmup)
    for step in range(15):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6,
                                   atol=1e-12)


def _mae_pair(seed=0):
    jmodel = jmae.PretrainVideoMAE(**MAE)
    clip = _clip(6, (2, 4, 24, 24, 3))
    gen = masking.TubeMasking((2, 3, 3), 0.5)
    vis, msk = masking.batch_mask_indices(gen, 2, np.random.default_rng(7))
    jvis, jmsk = jmasking.batch_mask_indices(
        jmasking.TubeMasking((2, 3, 3), 0.5), 2, np.random.default_rng(7))
    np.testing.assert_array_equal(vis, jvis)
    np.testing.assert_array_equal(msk, jmsk)
    variables = perturbed(jax.jit(jmodel.init)(
        jax.random.PRNGKey(seed), jnp.asarray(clip), vis, msk), seed)
    model = pmae.PretrainVideoMAE(**MAE, device="cpu")
    model.load_state_dict(mae_state_dict_from_jax(variables), strict=True)
    return jmodel, variables, model, clip, vis, msk


def test_pretrain_mae_loss_and_grads_match_jax():
    jmodel, variables, model, clip, vis, msk = _mae_pair()

    def loss_fn(params):
        pred = jmodel.apply({"params": params}, jnp.asarray(clip), vis, msk)
        return jmae.pretrain_loss(pred, jnp.asarray(clip), msk, 2, 8)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    pred = model(_t(clip), torch.from_numpy(vis), torch.from_numpy(msk))
    assert pred.shape == (2, msk.shape[1], 2 * 8 * 8 * 3)
    got = pmae.pretrain_loss(pred, _t(clip), torch.from_numpy(msk), 2, 8)
    got.backward()
    np.testing.assert_allclose(got.item(), float(loss), rtol=1e-5)
    np.testing.assert_array_equal(
        pmae.patchify(_t(clip), 2, 8).numpy(),
        np.asarray(jmae.patchify(jnp.asarray(clip), 2, 8)))
    assert_state_close(dict((n, p.grad) for n, p in model.named_parameters()),
                       mae_state_dict_from_jax({"params": grads}), GRAD_TOL)


def _finetune_ds(n=6):
    verbs, nouns = _labels(n, seed=8)
    return [{"video": _clip(20 + i, (4, 24, 24, 3)), "verb": verbs[i],
             "noun": nouns[i]} for i in range(n)]


def test_finetune_runner_fit_matches_jax():
    """``BackboneFinetuneRunner.fit`` over 3 steps (batch 2, one epoch,
    mixup off, LLRD AdamW): the last loss and the parameters after."""
    jmodel, variables, model, _ = _two_head_pair("vit")
    ds = _finetune_ds()
    kw = dict(batch_size=2, epochs=1, lr=1e-3, mixup_alpha=0.0, seed=0)
    jr = jrunner.BackboneFinetuneRunner(jmodel, ds, None, **kw)
    jr.init_state()
    jr.state = jr.state.replace(params=jax.tree_util.tree_map(
        jnp.asarray, variables["params"]))
    pr = prunner.BackboneFinetuneRunner(model, ds, None, **kw)
    pr.init_state()
    want, got = jr.fit(), pr.fit()
    assert pr.state.step == 3
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    _params_close(model, jr.state.params, 2e-3 * 3)


def test_pretrain_runner_fit_matches_jax():
    """``BackbonePretrainRunner.fit`` over 3 steps (batch 2, tube masks at
    ratio 0.5 drawn from the epoch's generator after the shuffle, AdamW)."""
    jmodel, variables, model = _mae_pair()[:3]
    ds = [{"video": _clip(30 + i, (4, 24, 24, 3))} for i in range(6)]
    kw = dict(mask_ratio=0.5, batch_size=2, epochs=1, seed=0)
    jr = jrunner.BackbonePretrainRunner(jmodel, ds, **kw)
    jr.init_state()
    jr.state = jr.state.replace(params=jax.tree_util.tree_map(
        jnp.asarray, variables["params"]))
    pr = prunner.BackbonePretrainRunner(model, ds, **kw)
    pr.init_state()
    want, got = jr.fit(), pr.fit()
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    assert_state_close(dict(model.named_parameters()),
                       mae_state_dict_from_jax({"params": jr.state.params}),
                       GRAD_TOL, "param", 2 * 1.5e-4 * 3)


def test_finetune_runner_cannot_take_a_swin_trunk_as_in_jax():
    """Both runners read ``trunk.depth`` in ``init_state``
    (``tim_tpu/runner/backbone.py:183``), which a Swin trunk lacks; Swin
    trains through ``make_two_head_step`` instead."""
    jmodel, _, model, clip = _two_head_pair("swin")
    ds = [{"video": clip[0], "verb": 0, "noun": 0}] * 2
    with pytest.raises(AttributeError, match="depth"):
        jrunner.BackboneFinetuneRunner(jmodel, ds, None).init_state()
    with pytest.raises(AttributeError, match="depth"):
        prunner.BackboneFinetuneRunner(model, ds, None).init_state()


def test_swin_step_with_plain_adamw_matches_jax():
    """Swin-B's recipe (``scripts/bench_finetune_swin.py:55-70``):
    ``make_two_head_step`` with mixup off and AdamW(1e-4, wd 0.05) on every
    parameter, 2 steps."""
    import optax
    jmodel, variables, model, clip = _two_head_pair("swin")
    verbs, nouns = _labels(2)
    batch = {"video": clip, "verb": verbs, "noun": nouns}
    state = create_train_state(variables["params"],
                               optax.adamw(1e-4, weight_decay=0.05))
    step = jax.jit(jrunner.make_two_head_step(jmodel, mixup_alpha=0.0))
    pstate = TrainState(model, torch.optim.AdamW(
        model.parameters(), lr=1e-4, weight_decay=0.05))
    pstep = prunner.make_two_head_step(model, mixup_alpha=0.0)
    for i in range(2):
        state, metrics = step(state, {k: jnp.asarray(v)
                                      for k, v in batch.items()},
                              jax.random.PRNGKey(0))
        pmetrics = pstep(pstate, {k: torch.from_numpy(np.asarray(v))
                                  for k, v in batch.items()})
        np.testing.assert_allclose(pmetrics["loss"].item(),
                                   float(metrics["loss"]), rtol=1e-5)
        _params_close(model, state.params, 2e-4 * (i + 1))


def test_backbone_extraction_keeps_inference_mode():
    """Built for extraction (eval mode), a backbone's forward records no
    autograd; in training mode it does, and its constant caches, first
    made under inference mode, can be saved for the backward."""
    model = pswin.SwinTransformer3D(**SWIN, device="cpu")
    clip = _t(_clip(3, (1, 8, 24, 24, 3)))
    assert not model.training and not model(clip).requires_grad
    model.train()
    out = model(clip)
    assert out.requires_grad
    out.sum().backward()
    table = model.layers[0].blocks[1].attn.relative_position_bias_table
    assert table.grad is not None and table.grad.abs().sum() > 0


@pytest.mark.parametrize("core", ["flash_mha", "window_attention"])
def test_bf16_grad_gate_passes_only_the_kernels_arithmetic(core):
    """chip_smoke's bf16 gate for the backward kernels: the kernels'
    arithmetic (D from the bf16 output of the online-softmax forward,
    p from the row log-sum-exp, p and ds * scale rounded to bf16) passes
    against the plain backward at ViT-L's S and a shifted Swin-B window;
    the backward without D fails it, and so does a dbias from one window
    only."""
    rng = np.random.default_rng(1)

    def bf16(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).bfloat16()

    if core == "flash_mha":
        q, k, v, do = (bf16(1, 2, 1568, 64) for _ in range(4))
        scale = 0.125
        s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
        want = flash_mha_bwd_plain(q, k, v, do, sm_scale=scale)
    else:
        dims = (16, 14, 14)
        window, shift = pswin.effective_window(dims, (16, 7, 7), (8, 3, 3))
        region = torch.from_numpy(pswin.shift_region_ids(dims, window, shift))
        q, k, v, do = (bf16(4, 2, 784, 32) for _ in range(4))
        bias = bf16(2, 784, 784).float()
        scale = 32 ** -0.5
        from tim_tpu_torch.ops.window_attention import window_scores
        s = window_scores(q, k, bias, region, sm_scale=scale)
        want = window_attention_bwd_plain(q, k, v, bias, region, do,
                                          sm_scale=scale)
    dq, dk, dv, ds = emulated_attention_bwd(s, q, k, v, do, sm_scale=scale)
    got = [dq, dk, dv] + ([ds.sum(0)] if core != "flash_mha" else [])
    for g, w in zip(got, want):
        assert grad_close(g, w, True)[0]
    bad = emulated_attention_bwd(s, q, k, v, do, sm_scale=scale,
                                 drop_delta=True)
    assert not grad_close(bad[0], want[0], True)[0]
    assert not grad_close(bad[1], want[1], True)[0]
    if core != "flash_mha":
        assert not grad_close(ds[0], want[3], True)[0]


def test_finetune_step_matches_jax():
    """``make_finetune_step`` (one head over a trunk, as
    ``tests/test_finetune.py`` drives the JAX one) with
    ``make_llrd_optimizer``: 3 steps, mixup off, no smoothing; loss of each
    step and the parameters after it."""
    jtrunk = jvit.VideoMAEViT(**VIT)
    clip = _clip(9, (2, 4, 24, 24, 3))
    labels = np.array([1, 2], np.int32)
    variables = perturbed({"params": {
        "backbone": jax.jit(jtrunk.init)(jax.random.PRNGKey(0),
                                         jnp.asarray(clip))["params"],
        "head": np.zeros((32, 3), np.float32)}}, 1)

    def apply_fn(p, v, drop_rng):
        return jtrunk.apply({"params": p["backbone"]}, v) @ p["head"]

    kw = dict(depth=2, lr=3e-3, total_steps=3, warmup_steps=1)
    tx = jft.make_llrd_optimizer(variables["params"], **kw)
    state = create_train_state(variables["params"], tx)
    step = jax.jit(jft.make_finetune_step(apply_fn, 3, tx, mixup_alpha=0.0,
                                          smoothing=0.0))

    model = torch.nn.Module()
    model.backbone = pvit.VideoMAEViT(**VIT, device="cpu").train()
    model.backbone.load_state_dict(vit_state_dict_from_jax(
        {"params": variables["params"]["backbone"]}, 2))
    model.head = torch.nn.Parameter(_t(variables["params"]["head"]))
    optimizer, schedule = pft.make_llrd_optimizer(model, **kw)
    pstate = TrainState(model, optimizer, schedule)
    pstep = pft.make_finetune_step(lambda v: model.backbone(v) @ model.head,
                                   3, mixup_alpha=0.0, smoothing=0.0)
    batch = {"video": clip, "label": labels}
    for i in range(3):
        state, metrics = step(state, {k: jnp.asarray(v)
                                      for k, v in batch.items()},
                              jax.random.PRNGKey(0))
        pmetrics = pstep(pstate, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
        np.testing.assert_allclose(pmetrics["loss"].item(),
                                   float(metrics["loss"]), rtol=1e-5)
        want = vit_state_dict_from_jax({"params": state.params["backbone"]},
                                       2)
        want["head"] = _t(state.params["head"])
        assert_state_close(
            {**dict(model.backbone.named_parameters()), "head": model.head},
            want, GRAD_TOL, "param", 2 * 3e-3 * (i + 1))


@pytest.mark.parametrize("knob", ["remat", "remat_mlp"])
def test_remat_grads_match_plain(knob):
    """``remat`` (whole blocks) and ``remat_mlp`` (norm2 + MLP) recompute
    activations in the backward through ``torch.utils.checkpoint``: the
    same loss and gradients as the plain trunk."""
    clip = _t(_clip(10, (2, 4, 24, 24, 3)))
    grads = []
    for kw in ({}, {knob: True}):
        model = pvit.VideoMAEViT(**VIT, **kw, device="cpu").train()
        loss = (model(clip) ** 2).sum()
        loss.backward()
        grads.append((loss.item(), {n: p.grad for n, p in
                                    model.named_parameters()}))
    assert grads[0][0] == grads[1][0]
    for name, g in grads[0][1].items():
        torch.testing.assert_close(grads[1][1][name], g, rtol=0, atol=0)
