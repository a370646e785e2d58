"""Multi-head flash attention: counterpart of ``tim_tpu/ops/flash.py::flash_mha``.

Exact unmasked ``softmax(q k^T * sm_scale) v`` over [B, H, S, dh] with
fp32 scores, output in q's dtype. The JAX function pads S to a multiple of
128 with segment ids for the TPU's tiling; that padding is not part of the
function and has no counterpart here.

``flash_mha`` launches the CUDA kernel (``csrc/flash_mha.cu``) for CUDA
tensors and runs ``flash_mha_plain`` for CPU tensors. There is no fallback
between the two.
"""

from __future__ import annotations

import ctypes

import torch

from tim_tpu_torch import _build

_DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (32, 64)
# tim_flash_mha(q, k, v, out, strides, b, h, s, dh, bf16, scale, stream)
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_longlong)]
             + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p])


def flash_mha_plain(q, k, v, *, sm_scale: float):
    """The einsum branch of ``tim_tpu/models/backbones/vit.py:108-113``
    with the scale applied to the fp32 scores, as the kernel does:
    probabilities cast to v's dtype before the PV product, which sums in
    fp32 and rounds once to q's dtype."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


def check_qkv(name: str, q, k, v) -> None:
    """What the kernels of ``csrc/flash_attention.cuh`` take: q/k/v of one
    shape [B, H, S, dh] and dtype on one device, dh in ``HEAD_DIMS``, the
    last dim contiguous and the other strides and base addresses aligned
    to 16 bytes (so that a row loads as 16-byte vectors)."""
    if q.dim() != 4:
        raise ValueError(f"{name}: q must be [B, H, S, dh], got "
                         f"{tuple(q.shape)}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"{name}: dtype {q.dtype} not in {_DTYPES}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {q.shape[-1]} not in "
                         f"{HEAD_DIMS}")
    per16 = 16 // q.element_size()
    for tname, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name}: {tname} is {t.dtype} on {t.device}, "
                             f"q is {q.dtype} on {q.device}")
        if t.shape != q.shape:
            raise ValueError(f"{name}: {tname} has shape {tuple(t.shape)}, "
                             f"q {tuple(q.shape)}")
        if (t.stride(3) != 1 or any(s % per16 for s in t.stride()[:3])
                or t.data_ptr() % 16):
            raise ValueError(f"{name}: {tname} needs a contiguous last dim "
                             f"and 16-byte aligned rows (strides "
                             f"{t.stride()})")


def launch_args(q, k, v):
    """The output as a [B, H, S, dh] view of a new contiguous [B, S, H, dh]
    tensor (so the output projection reads it without a copy), and the 12
    (batch, head, row) element strides of q, k, v and out for the C
    launchers."""
    b, h, s, dh = q.shape
    view = torch.empty((b, s, h, dh), dtype=q.dtype,
                       device=q.device).permute(0, 2, 1, 3)
    strides = (ctypes.c_longlong * 12)(
        *[st for t in (q, k, v, view) for st in t.stride()[:3]])
    return view, strides


def flash_mha(q, k, v, *, sm_scale: float):
    """softmax(q k^T * sm_scale) v for q/k/v [B, H, S, dh] (dh 32 or 64,
    fp32 or bf16, any S >= 1); returns [B, H, S, dh] in q's dtype, a view
    of a contiguous [B, S, H, dh] tensor. Inputs may be strided views (e.g.
    of the packed qkv projection); the kernel reads them in place. CPU
    tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if q.device.type == "cpu":
        return flash_mha_plain(q, k, v, sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_mha: no kernel for device {q.device}")
    check_qkv("flash_mha", q, k, v)
    b, h, s, dh = q.shape
    view, strides = launch_args(q, k, v)
    fn = _build.launcher("tim_flash_mha", _ARGTYPES)
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), view.data_ptr(),
                strides, b, h, s, dh, int(q.dtype == torch.bfloat16),
                float(sm_scale),
                torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(status, "flash_mha")
    flash_mha.launches += 1
    return view


# Number of kernel launches; the plain CPU version does not count.
flash_mha.launches = 0
