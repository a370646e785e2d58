"""The plain PyTorch versions of the two ported kernels against the JAX
Pallas kernels run in interpret mode (as tests/test_attention.py and
tests/test_pallas_fused.py run them), and the kernel build's failure mode
on a host without nvcc. The CUDA kernels themselves are checked against
their plain versions on the card by tests/test_torch_gpu.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tim_tpu.ops.pallas_attention import (
    query_block_attention as jax_query_block_attention)
from tim_tpu.ops.pallas_fused import fused_post_attention as jax_fused
from tim_tpu_torch import _build
from tim_tpu_torch.ops.fused_post_attention import (
    fused_post_attention, fused_post_attention_plain)
from tim_tpu_torch.ops.query_block_attention import (
    query_block_attention, query_block_attention_plain)

# fp32: the same function, sums in another order; bf16: the bound
# tests/test_pallas_fused.py uses
TOL = {"float32": 1e-5, "bfloat16": 5e-2}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _to_torch(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(_TORCH[dtype])


def _query_block_inputs(b=2, h=3, nq=37, f=11, dh=32, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((b, h, nq, dh), (b, h, f, dh), (b, h, nq, dh),
                          (b, h, f, dh), (b, h, nq, dh))]


def _fused_inputs(b=2, s=37, c=64, ff=128, seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        x=rng.normal(size=(b, s, c)), attn=rng.normal(size=(b, s, c)),
        ln1_s=rng.uniform(0.5, 1.5, c), ln1_b=rng.normal(size=c) * 0.1,
        w1=rng.normal(size=(c, ff)) * 0.1, b1=rng.normal(size=ff) * 0.1,
        w2=rng.normal(size=(ff, c)) * 0.1, b2=rng.normal(size=c) * 0.1,
        ln2_s=rng.uniform(0.5, 1.5, c), ln2_b=rng.normal(size=c) * 0.1)


def _torch_fused_args(p, dtype):
    """Port argument order; weights in nn.Linear's [out, in] layout."""
    act = [_to_torch(p[k], dtype) for k in ("x", "attn")]
    f32 = {k: _to_torch(p[k], "float32")
           for k in ("ln1_s", "ln1_b", "b1", "b2", "ln2_s", "ln2_b")}
    w1 = _to_torch(p["w1"].T, "float32")
    w2 = _to_torch(p["w2"].T, "float32")
    return (*act, f32["ln1_s"], f32["ln1_b"], w1, f32["b1"], w2, f32["b2"],
            f32["ln2_s"], f32["ln2_b"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_query_block_plain_matches_pallas(dtype):
    arrs = _query_block_inputs()
    want = jax_query_block_attention(
        *[jnp.asarray(a, jnp.dtype(dtype)) for a in arrs], tile_q=16,
        interpret=True)
    got = query_block_attention(*[_to_torch(a, dtype) for a in arrs])
    assert got.dtype == _TORCH[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype])


def test_query_block_reads_strided_and_broadcast_views():
    """The wrapper takes strided views (as the packed projection gives
    them) and a batch-broadcast query block without copying."""
    arrs = _query_block_inputs(b=1)
    t = [torch.from_numpy(a) for a in arrs]
    dense = query_block_attention_plain(
        *[x.expand(3, -1, -1, -1).contiguous() for x in t])
    views = query_block_attention(*[x.expand(3, -1, -1, -1) for x in t])
    torch.testing.assert_close(views, dense, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_plain_matches_pallas(dtype):
    p = _fused_inputs()
    jdt = jnp.dtype(dtype)
    want = jax_fused(
        jnp.asarray(p["x"], jdt), jnp.asarray(p["attn"], jdt),
        *[jnp.asarray(p[k], jnp.float32)
          for k in ("ln1_s", "ln1_b", "w1", "b1", "w2", "b2", "ln2_s",
                    "ln2_b")], block_rows=32, interpret=True)
    got = fused_post_attention(*_torch_fused_args(p, dtype))
    assert got.dtype == _TORCH[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype])


def test_build_names_missing_nvcc():
    if _build.find_nvcc() is not None:
        pytest.skip("this host has nvcc")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.library()
