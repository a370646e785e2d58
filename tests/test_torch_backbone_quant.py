"""The int8 backbones of the port against the JAX package on the CPU, at
``tests/test_backbone_quant.py``'s small sizes (a Swin with a shifted
block):

- ``quantize_backbone_state_dict`` gives int8 weights bit-equal to
  ``quantize_backbone_params`` (scales within 1e-7 relative) and leaves
  the patch embeds, norms, the rel-pos table and the patch-merging
  reduction as they are;
- the quantized forwards, dynamic and calibrated, within 1e-3 of the
  largest output of JAX's; the calibrated scales (named by JAX's param
  paths) within 1e-6 relative. An activation whose x / scale lies within
  TIE of k + 1/2 gets its int8 code from the last bits of an fp32 sum,
  which the two packages order differently, and one flipped code moves
  the small Swin's pooled output by ~1.4e-3. So the forward is held to
  JAX as computed, or with exactly those codes rounded the other way
  (``_forward``); a fault in the int8 layers moves every code;
- JAX's accuracy contracts on the port alone: against fp32, max-rel
  < 0.08 dynamic and < 0.12 static;
- a non-empty scale tuple that misses a layer warns and keeps that layer
  dynamic, as JAX's ``scale_for`` does."""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tim_tpu.models.backbones.swin3d import SwinTransformer3D as JSwin
from tim_tpu.models.backbones.vit import VideoMAEViT as JViT
from tim_tpu.ops import quant as jquant
from tim_tpu_torch.convert import swin_state_dict_from_jax, vit_state_dict_from_jax
from tim_tpu_torch.models.backbones.swin3d import SwinTransformer3D as PSwin
from tim_tpu_torch.models.backbones.vit import VideoMAEViT as PViT
from tim_tpu_torch.ops import quant as pquant

VIT = dict(img_size=16, patch_size=8, embed_dim=32, depth=2, num_heads=4,
           num_frames=4, tubelet_size=2)
# a 2 x 4 x 4 token grid in windows of 2: block 1 of stage 0 shifts
SWIN = dict(patch_size=(2, 4, 4), embed_dim=8, depths=(2, 2),
            num_heads=(2, 2), window_size=(2, 2, 2))
TOL = 1e-3          # of the largest output
SCALE_RTOL = 1e-6
# x / scale within this of a rounding tie: |x / scale| <= 127 carries
# fp32 sums' relative error of ~1e-7, ~1.3e-5 at the top of the range
TIE = 2e-5


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + rng.normal(scale=0.05, size=x.shape))
        .astype(np.float32), params)


def _setup(which):
    """JAX fp32 params (perturbed), the video, and the port's quantized
    model loaded from ``quantize_backbone_state_dict`` of the converted
    fp32 state dict, plus its fp32 twin."""
    if which == "vit":
        jcls, pcls, kw, shape = JViT, PViT, VIT, (2, 4, 16, 16, 3)
        to_sd = lambda v: vit_state_dict_from_jax(v, VIT["depth"])  # noqa
    else:
        jcls, pcls, kw, shape = JSwin, PSwin, SWIN, (2, 4, 16, 16, 3)
        to_sd = lambda v: swin_state_dict_from_jax(v, SWIN["depths"])  # noqa
    video = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    params = _perturbed(jax.jit(jcls(**kw).init)(
        jax.random.PRNGKey(0), jnp.asarray(video))["params"], 2)
    sd = to_sd({"params": params})
    fp = pcls(**kw, device="cpu")
    fp.load_state_dict(sd, strict=True)
    qsd = pquant.quantize_backbone_state_dict(sd)
    q = pcls(**kw, device="cpu", quantized=True)
    q.load_state_dict(qsd, strict=True)
    return dict(jcls=jcls, pcls=pcls, kw=kw, params=params, video=video,
                fp=fp, q=q, qsd=qsd, sd=sd,
                qparams=jquant.quantize_backbone_params(params))


@pytest.fixture(scope="module")
def setups():
    return {which: _setup(which) for which in ("vit", "swin")}


def _jax_node(tree, path):
    for key in path.split("/"):
        tree = tree[key]
    return tree


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("which", ["vit", "swin"])
def test_int8_weights_bit_equal_jax(setups, which):
    s = setups[which]
    layers = s["q"].int8_layers()
    depth = 2 * (VIT["depth"] if which == "vit" else sum(SWIN["depths"]))
    assert len(layers) == 2 * depth
    for path, layer in layers.items():
        node = _jax_node(s["qparams"], path)
        np.testing.assert_array_equal(layer.weight_q.numpy(),
                                      np.asarray(node["kernel_q"]).T, path)
        np.testing.assert_allclose(layer.weight_scale.numpy(),
                                   np.asarray(node["kernel_scale"]),
                                   rtol=1e-7, atol=0, err_msg=path)
        if path.endswith("attn/qkv") and which == "vit":
            assert layer.bias is None and "bias" not in node
        else:
            np.testing.assert_array_equal(layer.bias.detach().numpy(),
                                          np.asarray(node["bias"]))
    # what stays as it was
    kept = [k for k in s["qsd"] if not k.endswith(("weight_q",
                                                   "weight_scale"))]
    for k in kept:
        assert torch.equal(s["qsd"][k], s["sd"][k]), k
    assert "patch_embed.proj.weight" in kept
    if which == "swin":
        assert "layers.0.downsample.reduction.weight" in kept
        assert "layers.0.blocks.1.attn.relative_position_bias_table" in kept
    else:
        assert {"blocks.0.attn.q_bias", "blocks.0.attn.v_bias"} <= set(kept)


def _forward(model, video, monkeypatch, flip_ties: bool):
    """The port's forward; with ``flip_ties`` every int8 code whose
    x / scale lies within TIE of a rounding tie rounds the other way."""
    if flip_ties:
        def quantize(x32, s_x):
            r = x32 / s_x
            lo = torch.floor(r)
            near = (r - lo - 0.5).abs() < TIE
            q = torch.round(r)
            q = torch.where(near, torch.where(q == lo, lo + 1, lo), q)
            return torch.clamp(q, -127, 127)
        monkeypatch.setattr(pquant, "_quantize", quantize)
    try:
        return model(torch.from_numpy(video)).numpy()
    finally:
        monkeypatch.undo()


def _matches_jax(model, video, want, monkeypatch) -> float:
    """The port's error against JAX's output, relative to its largest:
    as computed, or with the tie codes rounded the other way."""
    return min(_rel(_forward(model, video, monkeypatch, flip), want)
               for flip in (False, True))


def _jax_forward(s, act_scales=()):
    model = s["jcls"](**s["kw"], quantized=True, act_scales=act_scales)
    return np.asarray(model.apply({"params": s["qparams"]},
                                  jnp.asarray(s["video"])), np.float32)


@pytest.mark.parametrize("which", ["vit", "swin"])
def test_dynamic_forward_matches_jax(setups, which, monkeypatch):
    s = setups[which]
    got = s["q"](torch.from_numpy(s["video"])).numpy()
    want = _jax_forward(s)
    assert got.shape == want.shape
    assert _matches_jax(s["q"], s["video"], want, monkeypatch) <= TOL
    fp32 = s["fp"](torch.from_numpy(s["video"])).numpy()
    assert _rel(got, fp32) < 0.08        # JAX's dynamic int8 contract


@pytest.mark.parametrize("which", ["vit", "swin"])
def test_calibrated_static_forward_matches_jax(setups, which, monkeypatch):
    """Calibrate on the video (both packages), compare the scales by
    JAX's paths, then serve with static scales."""
    s = setups[which]
    jmodel = s["jcls"](**s["kw"], quantized=True)
    calibrated = jquant.calibrate_act_scales(
        lambda vs, batch, mutable: jmodel.apply(vs, batch, mutable=mutable),
        {"params": s["qparams"]}, [jnp.asarray(s["video"])])
    want_scales = jquant.act_scales_tuple(calibrated)

    q = s["pcls"](**s["kw"], device="cpu", quantized=True)
    q.load_state_dict(s["qsd"], strict=True)
    got_scales = pquant.calibrate_act_scales(
        q.int8_layers(), q, [torch.from_numpy(s["video"])])
    assert [p for p, _ in got_scales] == [p for p, _ in want_scales]
    np.testing.assert_allclose([v for _, v in got_scales],
                               [v for _, v in want_scales],
                               rtol=SCALE_RTOL)
    q.set_act_scales(got_scales)
    assert all(m.act_scale is not None for m in q.int8_layers().values())
    got = q(torch.from_numpy(s["video"])).numpy()
    want = _jax_forward(s, want_scales)
    assert _matches_jax(q, s["video"], want, monkeypatch) <= TOL
    fp32 = s["fp"](torch.from_numpy(s["video"])).numpy()
    assert _rel(got, fp32) < 0.12        # JAX's static int8 contract


@pytest.fixture()
def quant_logs(caplog):
    """caplog's handler on both packages' quant loggers, each record
    once: a runner built earlier in this process stops the packages'
    loggers from propagating to the root (``setup_logging``)."""
    loggers = [logging.getLogger(m.__name__) for m in (pquant, jquant)]
    saved = [lg.propagate for lg in loggers]
    for lg in loggers:
        lg.addHandler(caplog.handler)
        lg.propagate = False
    yield caplog
    for lg, propagate in zip(loggers, saved):
        lg.removeHandler(caplog.handler)
        lg.propagate = propagate


def test_scale_tuple_missing_a_layer_warns_and_stays_dynamic(setups,
                                                             quant_logs):
    caplog = quant_logs
    s = setups["vit"]
    q = s["pcls"](**s["kw"], device="cpu", quantized=True)
    q.load_state_dict(s["qsd"], strict=True)
    scales = (("block0/attn/qkv", 0.02),)
    with caplog.at_level(logging.WARNING):
        q.set_act_scales(scales)
        assert jquant.scale_for(scales, "block0/fc1") == 0.0
    layers = q.int8_layers()
    assert layers["block0/attn/qkv"].act_scale == pytest.approx(0.02)
    assert all(m.act_scale is None for p, m in layers.items()
               if p != "block0/attn/qkv")
    port = [r for r in caplog.records if r.name == pquant.__name__]
    jax_ = [r for r in caplog.records if r.name == jquant.__name__]
    assert len(port) == len(layers) - 1 and len(jax_) == 1
    assert any("block0/fc1" in r.getMessage() for r in port)
    # an empty tuple is dynamic everywhere, silently
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        q.set_act_scales(())
    assert not caplog.records
    assert all(m.act_scale is None for m in q.int8_layers().values())


@pytest.mark.parametrize("kw", [{}, {"name_suffix": "_b"}])
def test_scale_helpers_equal_jax(kw):
    sfx = kw.get("name_suffix", "")
    scales = ((f"layer0_block0/attn/qkv{sfx}", 0.5),
              (f"layer0_block0/fc1{sfx}", 0.25), (f"block1/fc2{sfx}", 2.0))
    for prefix in ("layer0_block0", "block1", "layer0_block0/attn", "x"):
        assert pquant.filter_scales(scales, prefix) == \
            jquant.filter_scales(scales, prefix)
    for name, _ in scales:
        assert pquant.scale_for(scales, name) == jquant.scale_for(scales, name)
    assert pquant.scale_for((), "a", 3.0) == jquant.scale_for((), "a", 3.0)
