"""Multi-head flash attention: counterpart of ``tim_tpu/ops/flash.py::flash_mha``.

Exact unmasked ``softmax(q k^T * sm_scale) v`` over [B, H, S, dh] with
fp32 scores, output in q's dtype. The JAX function pads S to a multiple of
128 with segment ids for the TPU's tiling; that padding is not part of the
function and has no counterpart here.

``flash_mha`` launches the CUDA kernel (``csrc/flash_mha.cu``) for CUDA
tensors and runs ``flash_mha_plain`` for CPU tensors. There is no fallback
between the two. It is differentiable: on the CPU through the plain
version's PyTorch ops, on the card through ``flash_mha_bwd`` (the backward
kernel, ``csrc/flash_mha_bwd.cu``), which needs the forward's row
log-sum-exp. ``flash_mha_qkv`` takes the packed [B, S, 3, H, dh]
projection the models produce and returns its gradient packed the same
way, so autograd adds no copies for the three slices.
"""

from __future__ import annotations

import ctypes

import torch

from tim_tpu_torch import _build

_DTYPES = (torch.float32, torch.bfloat16)
# The head dim the kernel is built for: ViT-B/L and the MAE decoder
HEAD_DIM = 64
# tim_flash_mha(q, k, v, out, strides, lse, b, h, s, dh, bf16, scale,
# stream)
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_longlong),
                                      ctypes.c_void_p]
             + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p])
# tim_flash_mha_bwd(q, k, v, o, do, dq, dk, dv, strides, lse, delta,
# dq_accum, b, h, s, dh, bf16, scale, stream)
_BWD_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.POINTER(ctypes.c_longlong)]
                 + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                 + [ctypes.c_float, ctypes.c_void_p])


def flash_mha_plain(q, k, v, *, sm_scale: float):
    """The einsum branch of ``tim_tpu/models/backbones/vit.py:108-113``
    with the scale applied to the fp32 scores, as the kernel does:
    probabilities cast to v's dtype before the PV product, which sums in
    fp32 and rounds once to q's dtype."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


def softmax_attention_bwd_plain(s, q, k, v, do, *, sm_scale: float):
    """The body of ``pallas_swin._bwd_kernel`` from fp32 scores ``s``
    [..., N, N] (scale, bias and mask already applied): (dq, dk, dv) in the
    operand dtypes and the fp32 score gradient ds. Probabilities are cast
    to v's dtype for dv and ``ds * sm_scale`` to q's dtype for dq and dk;
    every product sums in fp32."""
    p = torch.softmax(s, dim=-1)
    do32 = do.float()
    dv = torch.matmul(p.to(v.dtype).float().transpose(-1, -2), do32)
    dp = torch.matmul(do32, v.float().transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dsc = (ds * sm_scale).to(q.dtype).float()
    dq = torch.matmul(dsc, k.float())
    dk = torch.matmul(dsc.transpose(-1, -2), q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), ds


def flash_mha_bwd_plain(q, k, v, do, *, sm_scale: float):
    """(dq, dk, dv) of ``flash_mha_plain`` for the output gradient ``do``,
    the backward kernel's arithmetic in plain PyTorch (no bias)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    return softmax_attention_bwd_plain(s, q, k, v, do,
                                       sm_scale=sm_scale)[:3]


def check_qkv(name: str, q, k, v, head_dim: int = HEAD_DIM) -> None:
    """What the kernels of ``csrc/flash_attention.cuh`` take: q/k/v of one
    shape [B, H, S, dh] and dtype on one device, dh the ``head_dim`` the
    kernel is built for, the
    last dim contiguous and the other strides and base addresses aligned
    to 16 bytes (so that a row loads as 16-byte vectors)."""
    if q.dim() != 4:
        raise ValueError(f"{name}: q must be [B, H, S, dh], got "
                         f"{tuple(q.shape)}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"{name}: dtype {q.dtype} not in {_DTYPES}")
    if q.shape[-1] != head_dim:
        raise ValueError(f"{name}: head dim {q.shape[-1]}, the kernel is "
                         f"built for {head_dim}")
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


def needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def unpack_qkv(qkv):
    """q, k, v as [B, H, S, dh] views of a packed [B, S, 3, H, dh]."""
    return tuple(qkv[:, :, i].transpose(1, 2) for i in range(3))


def pack_qkv(q, k, v):
    """One packed [B, S, 3, H, dh] copy of q, k, v [B, H, S, dh]: the
    autograd Functions take the models' packed layout."""
    return torch.stack([t.transpose(1, 2) for t in (q, k, v)], 2)


def row_stats(q):
    """An fp32 [B, H, S] buffer for the forward's row log-sum-exp."""
    return torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)


def aligned(t) -> bool:
    """Whether the kernels read ``t`` in place: last dim contiguous, other
    strides and the base address 16-byte aligned."""
    per16 = 16 // t.element_size()
    return (t.stride(-1) == 1 and not any(s % per16 for s in t.stride()[:-1])
            and t.data_ptr() % 16 == 0)


def bwd_args(q, k, v, out, do, grads):
    """(do usable in place, 24 (batch, head, row) element strides of q, k,
    v, out, do, dq, dk, dv) for the C backward launchers."""
    if do.shape != q.shape or do.dtype != q.dtype or not aligned(do):
        do = do.to(q.dtype).contiguous()
    strides = (ctypes.c_longlong * 24)(
        *[st for t in (q, k, v, out, do, *grads) for st in t.stride()[:3]])
    return do, strides


def packed_grads(q):
    """dq, dk, dv as views of one new packed [B, S, 3, H, dh] buffer."""
    b, h, s, dh = q.shape
    return unpack_qkv(torch.empty((b, s, 3, h, dh), dtype=q.dtype,
                                  device=q.device))


def _launch_fwd(q, k, v, sm_scale, lse=None):
    check_qkv("flash_mha", q, k, v)
    b, h, s, dh = q.shape
    view, strides = launch_args(q, k, v)
    fn = _build.launcher("tim_flash_mha", _ARGTYPES)
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), view.data_ptr(),
                strides, None if lse is None else lse.data_ptr(), b, h, s,
                dh, int(q.dtype == torch.bfloat16), float(sm_scale),
                torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(status, "flash_mha")
    flash_mha.launches += 1
    return view


def flash_mha_with_lse(q, k, v, *, sm_scale: float):
    """(output, row log-sum-exp [B, H, S] fp32) of one forward launch on
    the card: what the autograd Function keeps for ``flash_mha_bwd``."""
    lse = row_stats(q)
    return _launch_fwd(q, k, v, sm_scale, lse), lse


def flash_mha_bwd(q, k, v, out, lse, do, *, sm_scale: float, grads=None):
    """(dq, dk, dv) of ``flash_mha`` for the output gradient ``do``, given
    the forward's output ``out`` and row log-sum-exp ``lse`` [B, H, S] fp32.
    CUDA tensors launch the backward kernel (written into ``grads``, three
    [B, H, S, dh] views, when given; else into views of one packed
    [B, S, 3, H, dh] buffer) or raise; CPU tensors take
    ``flash_mha_bwd_plain`` (``out`` and ``lse`` unused). dk and dv are
    the same bits every run. In bf16 the one-pass kernel sums dq over key
    blocks with fp32 atomic adds, so dq may differ in its last bits from
    run to run; under ``torch.use_deterministic_algorithms(True)`` dq
    comes instead from an atomic-free pass over the key tiles (the same
    bits every run, one more pass). fp32 is atomic-free either way."""
    if q.device.type == "cpu":
        return flash_mha_bwd_plain(q, k, v, do, sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_mha_bwd: no kernel for device {q.device}")
    check_qkv("flash_mha_bwd", q, k, v)
    grads = packed_grads(q) if grads is None else grads
    check_qkv("flash_mha_bwd", *grads)
    do, strides = bwd_args(q, k, v, out, do, grads)
    b, h, s, dh = q.shape
    delta = torch.empty_like(lse)
    bf16 = q.dtype == torch.bfloat16
    # bf16: dq summed over key blocks in fp32 (zeroed by the kernel's
    # preprocess), then rounded into dq; none on the deterministic route
    atomic_dq = bf16 and not torch.are_deterministic_algorithms_enabled()
    dq_accum = (torch.empty((b, h, s, dh), dtype=torch.float32,
                            device=q.device) if atomic_dq else None)
    fn = _build.launcher("tim_flash_mha_bwd", _BWD_ARGTYPES)
    status = fn(*(t.data_ptr() for t in (q, k, v, out, do, *grads)),
                strides, lse.data_ptr(), delta.data_ptr(),
                dq_accum.data_ptr() if atomic_dq else None, b, h, s, dh,
                int(bf16), float(sm_scale),
                torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(status, "flash_mha_bwd")
    flash_mha_bwd.launches += 1
    return grads


class _FlashMHA(torch.autograd.Function):
    """flash_mha over a packed [B, S, 3, H, dh] qkv on the card, kernel
    both ways; the backward kernel writes the packed gradient directly."""

    @staticmethod
    def forward(ctx, qkv, sm_scale):
        out, lse = flash_mha_with_lse(*unpack_qkv(qkv), sm_scale=sm_scale)
        ctx.save_for_backward(qkv, out, lse)
        ctx.sm_scale = sm_scale
        return out

    @staticmethod
    def backward(ctx, do):
        qkv, out, lse = ctx.saved_tensors
        grad = torch.empty_like(qkv)
        flash_mha_bwd(*unpack_qkv(qkv), out, lse, do, sm_scale=ctx.sm_scale,
                      grads=unpack_qkv(grad))
        return grad, None


def flash_mha(q, k, v, *, sm_scale: float):
    """softmax(q k^T * sm_scale) v for q/k/v [B, H, S, dh] (dh 64 on the
    card, any on the CPU; fp32 or bf16, any S >= 1); returns [B, H, S, dh] in q's dtype, a view
    of a contiguous [B, S, H, dh] tensor. Inputs may be strided views (e.g.
    of the packed qkv projection); the kernel reads them in place. CPU
    tensors take the plain version; CUDA tensors launch the kernel or
    raise, and when a gradient is needed the forward also keeps its row
    statistic for ``flash_mha_bwd`` (q, k and v are then packed into one
    copy, whose gradient the backward kernel writes)."""
    if q.device.type == "cpu":
        return flash_mha_plain(q, k, v, sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_mha: no kernel for device {q.device}")
    if needs_grad(q, k, v):
        return _FlashMHA.apply(pack_qkv(q, k, v), sm_scale)
    return _launch_fwd(q, k, v, sm_scale)


def flash_mha_qkv(qkv, *, sm_scale: float):
    """``flash_mha`` of the packed projection qkv [B, S, 3, H, dh]; its
    gradient comes back packed in the same layout."""
    if qkv.device.type == "cuda" and needs_grad(qkv):
        return _FlashMHA.apply(qkv, sm_scale)
    return flash_mha(*unpack_qkv(qkv), sm_scale=sm_scale)


# Numbers of kernel launches (forward, backward); the plain CPU versions
# do not count.
flash_mha.launches = 0
flash_mha_bwd.launches = 0
