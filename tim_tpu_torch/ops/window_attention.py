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
There is no fallback between the two.
"""

from __future__ import annotations

import ctypes

import torch

from tim_tpu_torch import _build
from tim_tpu_torch.ops.flash_mha import check_qkv, launch_args

MASK_VALUE = -100.0
# tim_window_attention(q, k, v, out, strides, bias, region_ids, n_win, bw,
# h, n, dh, bf16, scale, stream)
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_longlong)]
             + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6
             + [ctypes.c_float, ctypes.c_void_p])


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


def window_attention(q, k, v, bias, region_ids=None, *, sm_scale: float):
    """Window attention for q/k/v [BW, H, N, dh] (dh 32 or 64, fp32 or
    bf16), bias [H, N, N] fp32, region_ids [nW, N] int32 or None; returns
    [BW, H, N, dh] in q's dtype, a view of a contiguous [BW, N, H, dh]
    tensor. Inputs may be strided views of the packed qkv projection; the
    kernel reads them in place. CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise."""
    if q.device.type == "cpu":
        return window_attention_plain(q, k, v, bias, region_ids,
                                      sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"window_attention: no kernel for device {q.device}")
    check_qkv("window_attention", q, k, v)
    _check(q, bias, region_ids)
    bw, h, n, dh = q.shape
    view, strides = launch_args(q, k, v)
    fn = _build.launcher("tim_window_attention", _ARGTYPES)
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), view.data_ptr(),
                strides, bias.data_ptr(),
                None if region_ids is None else region_ids.data_ptr(),
                1 if region_ids is None else region_ids.shape[0],
                bw, h, n, dh, int(q.dtype == torch.bfloat16), float(sm_scale),
                torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(status, "window_attention")
    window_attention.launches += 1
    return view


# Number of kernel launches; the plain CPU version does not count.
window_attention.launches = 0
