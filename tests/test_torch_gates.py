"""Kernel 1 (query-block attention) as its bf16 tensor-core kernel computes
it, checked on the CPU: the plain version against the Pallas kernel in
interpret mode at the context widths the kernel walks in 64-key chunks
(F 130 and 300); the bf16 gate (``chip_smoke.query_block_close``, which
``chip_smoke.py`` and ``tests/test_torch_gpu.py`` hold the kernel to)
passes the kernel's arithmetic, emulated here, and rejects the two faulty
controls; the wrapper refuses rows the kernel's 16-byte copies cannot
read. The kernel itself runs on the card only (tests/test_torch_gpu.py).
Also: each cut ``tim_tpu_torch.ablate`` times kernel 5b, the forward
core of kernels 4 and 5, kernel 4b, kernel 2 or kernel 3 with still finds
its span in the kernel's source."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import query_block_close, query_block_without_self
from tim_tpu.ops.pallas_attention import (
    query_block_attention as jax_query_block_attention)
from tim_tpu_torch import _build, ablate
from tim_tpu_torch.ops import query_block_attention as qba

_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(b, h, nq, f, dh, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((b, h, nq, dh), (b, h, f, dh), (b, h, nq, dh),
                          (b, h, f, dh), (b, h, nq, dh))]


def _kernel_arithmetic(qq, kc, kq, vc, vq, chunk=64):
    """What the bf16 tensor-core kernel computes: fp32 scores, the self
    score starting the row max, an online softmax over 64-key chunks of
    the context, unnormalised probabilities rounded to bf16 for P V (fp32
    sums), the fp32 self term added after dividing by the row sum."""
    scale = qq.shape[-1] ** -0.5
    q = qq.float()
    self_s = (q * kq.float()).sum(-1) * scale
    m = self_s.clone()
    l = torch.zeros_like(m)
    o = torch.zeros(q.shape)
    for c0 in range(0, kc.shape[2], chunk):
        s = q @ kc[:, :, c0:c0 + chunk].float().transpose(-1, -2) * scale
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(-1)
        o = (o * corr[..., None]
             + p.to(torch.bfloat16).float() @ vc[:, :, c0:c0 + chunk].float())
        m = m_new
    e_self = torch.exp(self_s - m)
    inv = 1.0 / (l + e_self)
    return (o * inv[..., None]
            + (e_self * inv)[..., None] * vq.float()).to(qq.dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("f", [130, 300])
def test_query_block_plain_matches_pallas_wide_context(dtype, f):
    arrs = _inputs(2, 2, 37, f, 32, seed=f)
    want = jax_query_block_attention(
        *[jnp.asarray(a, jnp.dtype(dtype)) for a in arrs], tile_q=16,
        interpret=True)
    got = qba.query_block_attention(
        *[torch.from_numpy(a).to(_TORCH[dtype]) for a in arrs])
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=1e-5 if dtype == "float32" else 5e-2)


@pytest.mark.parametrize("f", [11, 100, 130, 300])
def test_query_block_bf16_gate(f):
    """At the detection head dim (128), the gate passes the kernel's
    rounding of P to bf16 and rejects a dropped self term and outputs
    scaled by 0.98."""
    args = [torch.from_numpy(a).to(torch.bfloat16)
            for a in _inputs(2, 2, 64, f, 128, seed=f)]
    want = qba.query_block_attention_plain(*args)
    ok, err, rel = query_block_close(_kernel_arithmetic(*args), want)
    assert ok and rel < 5e-3, (err, rel)
    for bad in (query_block_without_self(*args),
                (want.float() * 0.98).to(torch.bfloat16)):
        assert not query_block_close(bad, want)[0]


def test_query_block_fp32_gate_stays_flat():
    args = [torch.from_numpy(a) for a in _inputs(1, 2, 40, 100, 64, seed=3)]
    want = qba.query_block_attention_plain(*args)
    assert query_block_close(want + 5e-5, want)[0]
    assert not query_block_close(want + 2e-4, want)[0]


@pytest.mark.parametrize("dh,refused", [(128, True), (64, True),
                                        (256, False)])
def test_query_block_check_refuses_unaligned_bf16_rows(dh, refused):
    """The bf16 tensor-core kernel (head dims 32-160) copies rows with
    16-byte cp.async, so it refuses a row stride or base address off 16
    bytes (``refused``): the wrapper copies such rows, zero-padded, onto
    the tensor-core instance (``copy_width``), as the column-slice design
    past 160 (TMA boxes of 16-byte rows) does with its own at head dim
    256. The wrapper's check takes them all."""
    b, h, nq, f = 1, 2, 24, 10
    ok = [torch.zeros(b, h, n, dh, dtype=torch.bfloat16)
          for n in (nq, f, nq, f, nq)]
    qba._check(*ok)
    plan = qba.TENSOR_CORES if refused else qba.COLS
    assert qba.launch_plan(dh, torch.bfloat16) == plan
    assert qba.copy_width(dh, torch.bfloat16, *ok) is None
    padded = torch.zeros(b, h, nq, dh + 4, dtype=torch.bfloat16)[..., :dh]
    shifted = torch.zeros(b * h * nq * dh + 1,
                          dtype=torch.bfloat16)[1:].view(b, h, nq, dh)
    for bad in (padded, shifted):
        args = [bad, ok[1], ok[2], ok[3], ok[4]]
        qba._check(*args)
        assert qba.launch_plan(dh, torch.bfloat16) == plan
        assert qba.copy_width(dh, torch.bfloat16, *args) == dh
    qba._check(*[t.float() for t in ok])   # fp32: the CUDA-core instance
    assert qba.launch_plan(dh, torch.float32) == qba.CUDA_CORES


def test_ablation_cuts_find_their_spans():
    """Each part ``python -m tim_tpu_torch.ablate`` removes from kernel
    5b's source is found there, and removing it shortens the source."""
    with open(os.path.join(_build._CSRC, ablate.HEADER)) as f:
        text = f.read()
    for start, end, new in ablate.CUTS.values():
        assert text.count(start) == 1
        out = ablate.cut(text, start, end, new)
        assert len(out) < len(text) and end in out


@pytest.mark.parametrize("name", sorted(ablate.FORWARD_CUTS))
def test_forward_ablation_cuts_find_their_spans(name):
    """Each part the ablation removes from the forward core of kernels 4
    and 5 is found there once, and removing it shortens the source."""
    with open(os.path.join(_build._CSRC, ablate.FORWARD_HEADER)) as f:
        text = f.read()
    start, end, new = ablate.FORWARD_CUTS[name]
    assert text.count(start) == 1
    out = ablate.cut(text, start, end, new)
    assert len(out) < len(text) and end in out


@pytest.mark.parametrize("header,cuts,name", [
    *((ablate.WINDOW_BWD_HEADER, "WINDOW_BWD_CUTS", name)
      for name in sorted(ablate.WINDOW_BWD_CUTS)),
    *((ablate.TAIL_HEADER, "TAIL_CUTS", name)
      for name in sorted(ablate.TAIL_CUTS)),
    *((ablate.INT8_SOURCE, "INT8_CUTS", name)
      for name in sorted(ablate.INT8_CUTS)),
])
def test_backward_and_tail_ablation_cuts_find_their_spans(header, cuts,
                                                          name):
    """Each part the ablation removes from kernel 4b's bf16 backward,
    kernel 2's bf16 tail or kernel 3 (the quantize, the epilogue's stores,
    the GELU, the bias) is found there once, and removing it shortens the
    source."""
    with open(os.path.join(_build._CSRC, header)) as f:
        text = f.read()
    start, end, new = getattr(ablate, cuts)[name]
    assert text.count(start) == 1
    out = ablate.cut(text, start, end, new)
    assert len(out) < len(text) and end in out


@pytest.mark.parametrize("header,cuts,name", [
    *((ablate.SPLIT_HEADER, "SPLIT_CUTS", name)
      for name in sorted(ablate.SPLIT_CUTS)),
    *((ablate.COLS_HEADER, "QBA_COLS_CUTS", name)
      for name in sorted(ablate.QBA_COLS_CUTS)),
])
def test_split_and_query_block_cols_ablation_cuts_find_their_spans(
        header, cuts, name):
    """Each part the ablation removes from kernel 5b's split passes (129 to
    256) or from kernel 1's column-slice kernel (past 160) is found there,
    in kernel 1's case first in the one-block-a-slice kernel (before the
    cluster kernel that shares some of its text), and removing it
    shortens the source."""
    with open(os.path.join(_build._CSRC, header)) as f:
        text = f.read()
    spec = getattr(ablate, cuts)[name]
    out = text
    for start, end, new in (spec if isinstance(spec, list) else [spec]):
        assert start in out
        if header == ablate.COLS_HEADER:
            assert out.index(start) < out.index("cluster_kernel(")
        else:
            assert out.count(start) == 1
        cut = ablate.cut(out, start, end, new)
        assert len(cut) < len(out) and end in cut
        out = cut
