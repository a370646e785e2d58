"""Kernel 5 / 5b's plain versions at the VideoMAE head dims past 64 that
the card reads in place (ViT-H/16's 80, ViT-g/14's 88), against the JAX
package on the CPU:

- ``flash_mha_plain`` (and ``flash_mha_qkv`` on the packed projection,
  which runs it on the CPU) against the einsum branch of
  ``tim_tpu/models/backbones/vit.py:107-112``, which ``flash_mha``
  replaces on the TPU;
- ``flash_mha_bwd_plain`` (and the packed gradient of ``flash_mha_qkv``)
  against ``jax.grad`` of that branch.

Inputs are seeded numpy arrays in the models' packed [B, S, 3, H, dh]
layout, fp32, with a ragged S (37: no tile multiple); every output within
1e-5 of its largest value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tim_tpu_torch.ops import flash_mha as fm

TOL = 1e-5     # fp32, of each output's largest value
SHAPE = (2, 37, 2)   # B, S, H


def _jax_core(q, k, v, scale):
    """The einsum branch of ``vit.py:107-112`` on [B, S, H, dh] (fp32)."""
    attn = jnp.einsum("bqhd,bkhd->bhqk", q * scale, k,
                      preferred_element_type=jnp.float32)
    attn = jax.nn.softmax(attn, axis=-1).astype(q.dtype)
    return jnp.einsum("bhqk,bkhd->bqhd", attn, v,
                      preferred_element_type=jnp.float32)


def _close(got, want, name):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= TOL * scale, f"{name}: max abs err {err} > {TOL} x {scale}"


def _packed(dh, seed):
    """A packed qkv [B, S, 3, H, dh] and an output gradient [B, S, H, dh]."""
    rng = np.random.default_rng(seed)
    b, s, h = SHAPE
    qkv = rng.normal(size=(b, s, 3, h, dh)).astype(np.float32)
    do = rng.normal(size=(b, s, h, dh)).astype(np.float32)
    return qkv, do


@pytest.mark.parametrize("dh", [80, 88])
def test_flash_plain_matches_jax_attention(dh):
    qkv, _ = _packed(dh, dh)
    scale = dh ** -0.5
    want = _jax_core(*(jnp.asarray(qkv[:, :, i]) for i in range(3)), scale)
    packed = torch.from_numpy(qkv)
    q, k, v = fm.unpack_qkv(packed)
    plain = fm.flash_mha_plain(q, k, v, sm_scale=scale)
    _close(plain.transpose(1, 2).numpy(), want, "flash_mha_plain")
    got = fm.flash_mha_qkv(packed, sm_scale=scale)
    _close(got.transpose(1, 2).numpy(), want, "flash_mha_qkv")


@pytest.mark.parametrize("dh", [80, 88])
def test_flash_bwd_plain_matches_jax_grad(dh):
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
