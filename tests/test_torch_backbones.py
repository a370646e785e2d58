"""The port's visual backbones against the JAX package on the CPU, fp32:
the window-attention and flash attention cores (their plain versions)
against the JAX kernel in interpret mode and the JAX einsum core to 1e-5,
small Swin3D and VideoMAE ViT models to 1e-4, the state-dict converters
against ``params_from_torch`` key for key, and the port's copies of the
numpy helpers against the originals."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tim_tpu.models.backbones import swin3d as jswin
from tim_tpu.models.backbones import vit as jvit
from chip_smoke import attention_close, online_attention
from tim_tpu.ops.pallas_swin import (
    window_attention_flash, window_type_major, window_type_major_inverse)
from tim_tpu_torch.convert import (
    load_backbone_state, swin_state_dict_from_jax, vit_state_dict_from_jax)
from tim_tpu_torch.models.backbones import swin3d as pswin
from tim_tpu_torch.models.backbones import vit as pvit
from tim_tpu_torch.ops.flash_mha import flash_mha, flash_mha_plain
from tim_tpu_torch.ops.window_attention import (
    attention_bias, window_attention, window_attention_plain, window_scores)

SWIN_GEOMETRY = dict(patch_size=(2, 4, 4), embed_dim=16, depths=(2, 2),
                     num_heads=(2, 4), window_size=(8, 3, 3))


def _perturbed(variables, seed):
    """The init's params plus seeded numpy noise, so that no LayerNorm or
    bias sits at its trivial init."""
    rng = np.random.default_rng(seed)
    return {"params": jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + rng.normal(scale=0.05, size=x.shape))
        .astype(np.float32), variables["params"])}


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


@pytest.mark.parametrize("n_types,batch,h,n,dh", [
    (1, 3, 2, 27, 32),    # unshifted: one bias for every window
    (3, 2, 2, 72, 32),    # shifted: region ids per window type
    (4, 2, 3, 18, 64),
])
def test_window_attention_plain_matches_jax_kernel(n_types, batch, h, n, dh):
    rng = np.random.default_rng(n)
    bw = batch * n_types
    q, k, v = (rng.normal(size=(bw, h, n, dh)).astype(np.float32)
               for _ in range(3))
    bias = (rng.normal(size=(h, n, n)) * 2).astype(np.float32)
    region = (rng.integers(0, 3, size=(n_types, n)).astype(np.int32)
              if n_types > 1 else None)
    scale = dh ** -0.5
    ab = attention_bias(_t(bias), None if region is None
                        else torch.from_numpy(region)).numpy()
    if region is not None:
        assert (ab[:, 0] - bias[0] == -100.0).any()   # masked entries
    want = window_attention_flash(
        *(window_type_major(jnp.asarray(t), n_types) for t in (q, k, v)),
        jnp.asarray(ab), sm_scale=scale, interpret=True)
    want = np.asarray(window_type_major_inverse(want, n_types))
    args = (_t(q), _t(k), _t(v), _t(bias),
            None if region is None else torch.from_numpy(region))
    got = window_attention_plain(*args, sm_scale=scale)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    # on CPU tensors the wrapper is the plain version and counts nothing
    before = window_attention.launches
    np.testing.assert_array_equal(
        window_attention(*args, sm_scale=scale).numpy(), got.numpy())
    assert window_attention.launches == before


def _jax_attention_core(q, k, v, scale):
    """The einsum branch of ``vit.py:108-113`` on [B, S, H, dh]."""
    attn = jnp.einsum("bqhd,bkhd->bhqk", q * scale, k,
                      preferred_element_type=jnp.float32)
    attn = jax.nn.softmax(attn, axis=-1).astype(q.dtype)
    return jnp.einsum("bhqk,bkhd->bqhd", attn, v,
                      preferred_element_type=jnp.float32)


@pytest.mark.parametrize("s,dh", [(18, 64), (130, 32)])
def test_flash_mha_plain_matches_jax_core(s, dh):
    rng = np.random.default_rng(s)
    q, k, v = (rng.normal(size=(2, s, 3, dh)).astype(np.float32)
               for _ in range(3))
    scale = dh ** -0.5
    want = np.asarray(_jax_attention_core(*map(jnp.asarray, (q, k, v)),
                                          scale))
    args = [_t(x).transpose(1, 2) for x in (q, k, v)]
    got = flash_mha_plain(*args, sm_scale=scale).transpose(1, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    before = flash_mha.launches
    np.testing.assert_array_equal(
        flash_mha(*args, sm_scale=scale).transpose(1, 2).numpy(),
        got.numpy())
    assert flash_mha.launches == before


def _swin_pair():
    jmodel = jswin.SwinTransformer3D(**SWIN_GEOMETRY)
    clip = np.random.default_rng(3).normal(size=(2, 8, 24, 24, 3)).astype(
        np.float32)
    variables = _perturbed(jmodel.init(jax.random.PRNGKey(0),
                                       jnp.asarray(clip)), 0)
    model = pswin.SwinTransformer3D(**SWIN_GEOMETRY, device="cpu")
    sd = swin_state_dict_from_jax(variables, SWIN_GEOMETRY["depths"])
    model.load_state_dict(sd, strict=True)
    return jmodel, variables, model, clip


@pytest.mark.parametrize("core", ["flash_mha", "window_attention"])
def test_bf16_attention_gate_passes_only_the_kernels_arithmetic(core):
    """chip_smoke's bf16 gate for kernels 4 and 5: the kernels' arithmetic
    (online softmax over 64-key tiles, unnormalised probabilities rounded
    to bf16) passes against the plain version at ViT-L's S and a shifted
    Swin-B window; the plain output scaled by 0.98 and an online softmax
    whose running sum is not rescaled fail."""
    rng = np.random.default_rng(0)

    def bf16(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).bfloat16()

    if core == "flash_mha":
        q, k, v = (bf16(1, 4, 1568, 64) for _ in range(3))
        want = flash_mha_plain(q, k, v, sm_scale=0.125)
        s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * 0.125
    else:
        dims = (16, 14, 14)
        window, shift = pswin.effective_window(dims, (16, 7, 7), (8, 3, 3))
        region = torch.from_numpy(pswin.shift_region_ids(dims, window, shift))
        q, k, v = (bf16(4, 2, 784, 32) for _ in range(3))
        bias = bf16(2, 784, 784).float()
        want = window_attention_plain(q, k, v, bias, region,
                                      sm_scale=32 ** -0.5)
        s = window_scores(q, k, bias, region, sm_scale=32 ** -0.5)
    assert attention_close(online_attention(s, v), want)[0]
    assert not attention_close((want.float() * 0.98).bfloat16(), want)[0]
    assert not attention_close(online_attention(s, v, rescale_sum=False),
                               want)[0]


@pytest.mark.parametrize("pool", [True, False])
def test_swin_matches_jax(pool):
    """Window clamping (D = 4 < 8), shifted blocks with region masks, the
    bias-index row slice and patch merging (12 -> 6 -> 3)."""
    jmodel, variables, model, clip = _swin_pair()
    want = np.asarray(jmodel.apply(variables, jnp.asarray(clip), pool))
    got = model(torch.from_numpy(clip), pool)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def test_swin_embed_only_and_embedded_match_jax():
    jmodel, variables, model, clip = _swin_pair()
    want_emb = np.asarray(jmodel.apply(variables, jnp.asarray(clip),
                                       embed_only=True))
    emb = model(torch.from_numpy(clip), embed_only=True)
    np.testing.assert_allclose(emb.numpy(), want_emb, atol=1e-5, rtol=1e-5)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(want_emb),
                                   embedded=True))
    np.testing.assert_allclose(model(emb, embedded=True).numpy(), want,
                               atol=1e-4, rtol=1e-4)


def _vit_pair(init_values):
    kw = dict(img_size=24, patch_size=8, embed_dim=32, depth=2, num_heads=4,
              num_frames=4, tubelet_size=2, init_values=init_values)
    jmodel = jvit.VideoMAEViT(**kw)
    clip = np.random.default_rng(4).normal(size=(2, 4, 24, 24, 3)).astype(
        np.float32)   # S = 2 x 3 x 3 = 18 tokens
    variables = _perturbed(jmodel.init(jax.random.PRNGKey(1),
                                       jnp.asarray(clip)), 1)
    model = pvit.VideoMAEViT(**kw, device="cpu")
    model.load_state_dict(vit_state_dict_from_jax(variables, 2), strict=True)
    return jmodel, variables, model, clip


@pytest.mark.parametrize("init_values", [0.0, 0.1])
def test_vit_matches_jax(init_values):
    jmodel, variables, model, clip = _vit_pair(init_values)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(clip)))
    got = model(torch.from_numpy(clip))
    assert got.shape == want.shape == (2, 32)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def test_vit_embed_only_and_embedded_match_jax():
    jmodel, variables, model, clip = _vit_pair(0.0)
    want_emb = np.asarray(jmodel.apply(variables, jnp.asarray(clip),
                                       embed_only=True))
    emb = model(torch.from_numpy(clip), embed_only=True)
    np.testing.assert_allclose(emb.numpy(), want_emb, atol=1e-5, rtol=1e-5)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(want_emb),
                                   embedded=True))
    np.testing.assert_allclose(model(emb, embedded=True).numpy(), want,
                               atol=1e-4, rtol=1e-4)


def _assert_same_tree(got, want):
    g = jax.tree_util.tree_leaves_with_path(got)
    w = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=str(path))


def test_swin_state_dict_inverts_params_from_torch():
    _, variables, model, _ = _swin_pair()
    sd = swin_state_dict_from_jax(variables, SWIN_GEOMETRY["depths"])
    assert set(sd) == set(model.state_dict())
    _assert_same_tree(jswin.params_from_torch(sd, SWIN_GEOMETRY["depths"]),
                      variables)


@pytest.mark.parametrize("init_values", [0.0, 0.1])
def test_vit_state_dict_inverts_params_from_torch(init_values):
    _, variables, model, _ = _vit_pair(init_values)
    sd = vit_state_dict_from_jax(variables, 2)
    assert set(sd) == set(model.state_dict())
    _assert_same_tree(jvit.params_from_torch(sd, 2), variables)


def test_load_backbone_state_skips_extras_and_needs_every_param():
    _, variables, model, _ = _vit_pair(0.0)
    sd = vit_state_dict_from_jax(variables, 2)
    extra = dict(sd, **{"head.weight": torch.zeros(3, 32)})
    assert load_backbone_state(model, extra) == ["head.weight"]
    sd.pop("fc_norm.bias")
    with pytest.raises(KeyError, match="fc_norm.bias"):
        load_backbone_state(model, sd)


@pytest.mark.parametrize("window", [(8, 3, 3), (16, 7, 7), (4, 3, 3)])
def test_relative_position_index_equals_jax(window):
    np.testing.assert_array_equal(pswin.relative_position_index(window),
                                  jswin.relative_position_index(window))


@pytest.mark.parametrize("dims,window,shift", [
    ((16, 56, 56), (16, 7, 7), (0, 3, 3)),   # Swin-B stage 1: clamped D
    ((4, 6, 6), (4, 3, 3), (0, 1, 1)),
    ((8, 6, 9), (4, 3, 3), (2, 1, 1)),
])
def test_shift_mask_and_region_ids_equal_jax(dims, window, shift):
    want = jswin.shift_attention_mask(dims, window, shift)
    np.testing.assert_array_equal(
        pswin.shift_attention_mask(dims, window, shift), want)
    ids = pswin.shift_region_ids(dims, window, shift)
    assert ids.dtype == np.int32 and ids.shape == want.shape[:2]
    # the kernel's mask from the ids is the JAX mask
    from tim_tpu_torch.ops.window_attention import region_mask
    np.testing.assert_array_equal(region_mask(torch.from_numpy(ids)).numpy(),
                                  want)


def test_effective_window_and_partition_equal_jax():
    for size in ((4, 6, 6), (16, 56, 56), (16, 7, 7), (32, 8, 8)):
        assert (pswin.effective_window(size, (16, 7, 7), (8, 3, 3))
                == jswin.effective_window(size, (16, 7, 7), (8, 3, 3)))
    x = np.random.default_rng(5).normal(size=(2, 4, 6, 6, 3)).astype(
        np.float32)
    win = (2, 3, 3)
    got = pswin.window_partition(torch.from_numpy(x), win)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jswin.window_partition(jnp.asarray(x), win)))
    np.testing.assert_array_equal(
        pswin.window_reverse(got, win, 2, 4, 6, 6).numpy(), x)


@pytest.mark.parametrize("n,d", [(50, 24), (1568, 1024)])
def test_sinusoid_table_equals_jax(n, d):
    np.testing.assert_array_equal(pvit.sinusoid_position_table(n, d),
                                  jvit.sinusoid_position_table(n, d))
