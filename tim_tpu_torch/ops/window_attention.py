"""Swin3D window attention: counterpart of
``tim_tpu/ops/pallas_swin.py::window_attention_flash`` (forward).

Per (window, head): ``softmax(q k^T * sm_scale + ab[type]) v`` with fp32
scores, probabilities cast to v's dtype before the PV product, output in
q's dtype. The JAX model builds ``ab`` as the relative-position bias
[H, N, N] plus, in shifted blocks, the shift mask [nW, N, N]
(``swin3d.py:169-171``), and the mask is -100 wherever two tokens' region
ids differ (``shift_attention_mask``). Here the two terms are passed
apart: ``bias`` [H, N, N] fp32 and ``region_ids`` [nW, N] int32 (or None
for an unshifted block). The window type of batch entry ``i`` is
``i % nW`` on the batch-major order ``window_partition`` produces, so no
window-type-major transpose is needed.

``window_attention`` launches the CUDA kernel (``csrc/window_attention.cu``)
for CUDA tensors and runs ``window_attention_plain`` for CPU tensors.
There is no fallback between the two. It is differentiable in q, k, v and
the bias: on the CPU through the plain version's PyTorch ops, on the card
through ``window_attention_bwd`` (``csrc/window_attention_bwd.cu``), whose
bias gradient [H, N, N] is dS summed over every window. (The JAX kernel's
``dab`` [n_types, H, N, N] sums over the windows of each type; summed over
the types it is the same quantity, and the gradient of the bias either
way, since the shift mask is a constant.) ``window_attention_qkv`` takes
the packed [BW, N, 3, H, dh] projection and returns its gradient packed.
"""

from __future__ import annotations

import ctypes

import torch

from tim_tpu_torch import _build
from tim_tpu_torch.ops.flash_mha import (
    bwd_args, check_qkv, launch_args, needs_grad, pack_qkv, packed_grads,
    row_stats, softmax_attention_bwd_plain, unpack_qkv)

MASK_VALUE = -100.0
# The head dim the kernel is built for: every Swin stage
HEAD_DIM = 32
# tim_window_attention(q, k, v, out, strides, lse, bias, region_ids, n_win,
# bw, h, n, dh, bf16, scale, stream)
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_longlong)]
             + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
             + [ctypes.c_float, ctypes.c_void_p])
# tim_window_attention_bwd(q, k, v, o, do, dq, dk, dv, strides, lse, delta,
# dq_accum, bias, region_ids, n_win, dbias, dbias_groups, groups, bw, h, n,
# dh, bf16, scale, stream)
_BWD_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.POINTER(ctypes.c_longlong)]
                 + [ctypes.c_void_p] * 5 + [ctypes.c_int]
                 + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6
                 + [ctypes.c_float, ctypes.c_void_p])
# tim_window_attention_bwd_groups(bw, h, n)
_GROUPS_ARGTYPES = [ctypes.c_int] * 3


def region_mask(region_ids):
    """[nW, N] region ids -> the [nW, N, N] additive shift mask: -100 where
    query and key region ids differ, else 0 (fp32)."""
    diff = region_ids[:, None, :] != region_ids[:, :, None]
    return torch.where(diff, MASK_VALUE, 0.0).float()


def attention_bias(bias, region_ids=None):
    """``ab`` as ``swin3d.py:169-171`` materialises it: [1, H, N, N] bias,
    plus the [nW, 1, N, N] shift mask when there is one (fp32)."""
    ab = bias.float()[None]
    if region_ids is not None:
        ab = ab + region_mask(region_ids)[:, None]
    return ab


def window_scores(q, k, bias, region_ids=None, *, sm_scale: float):
    """fp32 scores ``q k^T * sm_scale + ab[type]`` [BW, H, N, N], ``ab``
    materialised as the JAX model does; window type ``i % n_types``."""
    ab = attention_bias(bias, region_ids)
    n_types = ab.shape[0]
    bw, h, n, _ = q.shape
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    return (s.view(bw // n_types, n_types, h, n, n) + ab[None]).view(
        bw, h, n, n)


def window_attention_plain(q, k, v, bias, region_ids=None, *,
                           sm_scale: float):
    """The body of ``pallas_swin._kernel`` in plain PyTorch; q/k/v
    [BW, H, N, dh]."""
    s = window_scores(q, k, bias, region_ids, sm_scale=sm_scale)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


def window_attention_bwd_plain(q, k, v, bias, region_ids, do, *,
                               sm_scale: float):
    """The body of ``pallas_swin._bwd_kernel`` in plain PyTorch, ``ab``
    materialised as ``attention_bias`` does: (dq, dk, dv) in the operand
    dtypes and dbias [H, N, N] fp32, dS summed over every window."""
    s = window_scores(q, k, bias, region_ids, sm_scale=sm_scale)
    dq, dk, dv, ds = softmax_attention_bwd_plain(s, q, k, v, do,
                                                 sm_scale=sm_scale)
    return dq, dk, dv, ds.sum(0)


def _check(q, bias, region_ids):
    bw, h, n, _ = q.shape
    if bias.dtype != torch.float32 or tuple(bias.shape) != (h, n, n) or \
            not bias.is_contiguous() or bias.device != q.device or \
            bias.data_ptr() % 16:
        raise ValueError(f"window_attention: bias must be contiguous, "
                         f"16-byte aligned fp32 {(h, n, n)} on {q.device}, "
                         f"got {bias.dtype} "
                         f"{tuple(bias.shape)} on {bias.device}")
    if region_ids is not None:
        nw = region_ids.shape[0]
        if (region_ids.dtype != torch.int32 or region_ids.dim() != 2
                or region_ids.shape[1] != n or not region_ids.is_contiguous()
                or region_ids.device != q.device or bw % nw):
            raise ValueError(f"window_attention: region_ids must be "
                             f"contiguous int32 [nW, {n}] on {q.device} "
                             f"with nW dividing {bw}, got "
                             f"{region_ids.dtype} {tuple(region_ids.shape)}")


def _region_args(region_ids):
    return (None if region_ids is None else region_ids.data_ptr(),
            1 if region_ids is None else region_ids.shape[0])


def _launch_fwd(q, k, v, bias, region_ids, sm_scale, lse=None):
    check_qkv("window_attention", q, k, v, HEAD_DIM)
    _check(q, bias, region_ids)
    bw, h, n, dh = q.shape
    view, strides = launch_args(q, k, v)
    fn = _build.launcher("tim_window_attention", _ARGTYPES)
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), view.data_ptr(),
                strides, None if lse is None else lse.data_ptr(),
                bias.data_ptr(), *_region_args(region_ids),
                bw, h, n, dh, int(q.dtype == torch.bfloat16), float(sm_scale),
                torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(status, "window_attention")
    window_attention.launches += 1
    return view


def window_attention_with_lse(q, k, v, bias, region_ids=None, *,
                              sm_scale: float):
    """(output, row log-sum-exp [BW, H, N] fp32) of one forward launch on
    the card: what the autograd Function keeps for
    ``window_attention_bwd``."""
    lse = row_stats(q)
    return _launch_fwd(q, k, v, bias, region_ids, sm_scale, lse), lse


def bwd_groups(bw: int, h: int, n: int) -> int:
    """The number of window groups the bf16 backward kernel sums dbias over
    for [bw, h, n] on the current card: each group's blocks keep their own
    partial sum, and more than one group adds a [groups, h, n, n] fp32
    scratch summed by a short pass."""
    groups = _build.launcher("tim_window_attention_bwd_groups",
                             _GROUPS_ARGTYPES)(bw, h, n)
    if groups < 1:
        raise RuntimeError("window_attention_bwd: no device to size the "
                           "window groups for")
    return groups


def window_attention_bwd(q, k, v, bias, region_ids, out, lse, do, *,
                         sm_scale: float, grads=None):
    """(dq, dk, dv, dbias) of ``window_attention`` for the output gradient
    ``do``, given the forward's output ``out`` and row log-sum-exp ``lse``
    [BW, H, N] fp32; dbias [H, N, N] fp32 sums over every window. CUDA
    tensors launch the backward kernel (dq/dk/dv written into ``grads``
    when given, else into views of one packed [BW, N, 3, H, dh] buffer) or
    raise; CPU tensors take ``window_attention_bwd_plain``. In bf16 dq is
    summed over key blocks with fp32 atomics, so its last bits may change
    from run to run (dk, dv, dbias do not); under
    ``torch.use_deterministic_algorithms(True)`` dq comes instead from an
    atomic-free pass over the key tiles. fp32 is atomic-free either way."""
    if q.device.type == "cpu":
        return window_attention_bwd_plain(q, k, v, bias, region_ids, do,
                                          sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"window_attention_bwd: no kernel for device "
                         f"{q.device}")
    check_qkv("window_attention_bwd", q, k, v, HEAD_DIM)
    _check(q, bias, region_ids)
    grads = packed_grads(q) if grads is None else grads
    check_qkv("window_attention_bwd", *grads, HEAD_DIM)
    do, strides = bwd_args(q, k, v, out, do, grads)
    bw, h, n, dh = q.shape
    bf16 = q.dtype == torch.bfloat16
    dbias = torch.empty_like(bias)
    delta = torch.empty_like(lse)
    # bf16: dq's fp32 sum over key blocks (zeroed by the kernel's
    # preprocess), none on the deterministic route; dbias's partial sums of
    # each window group when there is more than one group
    atomic_dq = bf16 and not torch.are_deterministic_algorithms_enabled()
    dq_accum = (torch.empty((bw, h, n, dh), dtype=torch.float32,
                            device=q.device) if atomic_dq else None)
    groups = bwd_groups(bw, h, n) if bf16 else 1
    dbias_groups = (torch.empty((groups, h, n, n), dtype=torch.float32,
                                device=q.device) if groups > 1 else None)
    fn = _build.launcher("tim_window_attention_bwd", _BWD_ARGTYPES)
    status = fn(*(t.data_ptr() for t in (q, k, v, out, do, *grads)),
                strides, lse.data_ptr(), delta.data_ptr(),
                None if dq_accum is None else dq_accum.data_ptr(),
                bias.data_ptr(), *_region_args(region_ids), dbias.data_ptr(),
                None if dbias_groups is None else dbias_groups.data_ptr(),
                groups, bw, h, n, dh, int(bf16), float(sm_scale),
                torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(status, "window_attention_bwd")
    window_attention_bwd.launches += 1
    return (*grads, dbias)


class _WindowAttention(torch.autograd.Function):
    """window_attention over a packed [BW, N, 3, H, dh] qkv on the card,
    kernel both ways; the backward kernel writes the packed gradient
    directly."""

    @staticmethod
    def forward(ctx, qkv, bias, region_ids, sm_scale):
        out, lse = window_attention_with_lse(*unpack_qkv(qkv), bias,
                                             region_ids, sm_scale=sm_scale)
        ctx.save_for_backward(qkv, bias, region_ids, out, lse)
        ctx.sm_scale = sm_scale
        return out

    @staticmethod
    def backward(ctx, do):
        qkv, bias, region_ids, out, lse = ctx.saved_tensors
        grad = torch.empty_like(qkv)
        *_, dbias = window_attention_bwd(
            *unpack_qkv(qkv), bias, region_ids, out, lse, do,
            sm_scale=ctx.sm_scale, grads=unpack_qkv(grad))
        return grad, dbias, None, None


def window_attention(q, k, v, bias, region_ids=None, *, sm_scale: float):
    """Window attention for q/k/v [BW, H, N, dh] (dh 32 on the card, any
    on the CPU; fp32 or bf16), bias [H, N, N] fp32, region_ids [nW, N]
    int32 or None; returns [BW, H, N, dh] in q's dtype, a view of a
    contiguous [BW, N, H, dh] tensor. Inputs may be strided views of the packed qkv projection; the
    kernel reads them in place. CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise, and when a gradient is needed the
    forward also keeps its row statistic for ``window_attention_bwd`` (q,
    k and v are then packed into one copy, whose gradient the backward
    kernel writes)."""
    if q.device.type == "cpu":
        return window_attention_plain(q, k, v, bias, region_ids,
                                      sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"window_attention: no kernel for device {q.device}")
    if needs_grad(q, k, v, bias):
        return _WindowAttention.apply(pack_qkv(q, k, v), bias, region_ids,
                                      sm_scale)
    return _launch_fwd(q, k, v, bias, region_ids, sm_scale)


def window_attention_qkv(qkv, bias, region_ids=None, *, sm_scale: float):
    """``window_attention`` of the packed projection qkv [BW, N, 3, H, dh];
    its gradient comes back packed in the same layout."""
    if qkv.device.type == "cuda" and needs_grad(qkv, bias):
        return _WindowAttention.apply(qkv, bias, region_ids, sm_scale)
    return window_attention(*unpack_qkv(qkv), bias, region_ids,
                            sm_scale=sm_scale)


# Numbers of kernel launches (forward, backward); the plain CPU versions
# do not count.
window_attention.launches = 0
window_attention_bwd.launches = 0
