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

The kernels are built at instances (head dims) 64, 128 and 256, and in
bf16 also 80, 96 and 112 (``HEAD_DIMS``; ``launch_plan`` picks one route a
head dim, dtype and direction). bf16 past 64 up to 128 runs on the head dim
rounded up to 16, the instances whose tiles add a 32- and / or 16-column
block to the 64-column ones (``WIDE``): the kernels' TMA maps span the true
head dim and fill the columns past it with zeros, so a head dim that is a
multiple of 8 (ViT-H/16's 80, ViT-g/14's 88, ViT-G/14's 104) is read in
place. The bf16 backward from 129 to 256 has instances 192 and 256 of its
own (``SPLIT``, ``csrc/flash_mha_bwd_256.cu``), which read every multiple
of 8 above 128 in place the same way (ViT-L at ``--num_heads 4``: 256;
``--embed_dim 1152 | 1200 --num_heads 6``: 192, 200); the forward there
runs on instance 256. Any other head dim up to 256 (91, say; fp32 at 80)
runs on the next instance through
one copy of q, k and v into a zero-padded packed buffer (``padded_qkv``;
zero columns add nothing to the scores, and give zero output and gradient
columns), with ``sm_scale`` as given (1/sqrt of the true head dim) and
views of the outputs' first dh columns returned. Rows that the kernels
cannot read in place (not 16-byte aligned) take the same copy. Past 256
(a ViT at ``--num_heads 2``: head dim 512) every head dim runs on the
column-slice route (``csrc/flash_mha_cols.cu``, ``flash_mha_bwd_cols.cu``:
bf16 on wgmma, the backward in two atomic-free passes, fp32 on the CUDA
cores;
a grid axis over 256-column output slices), in place where the head dim
fills 16-byte rows, else through the same copy to the next multiple of 64
(``SLICED``). Up to 512 each slice's block recomputes the scores over the
full head dim, Q resident; in bf16 from 513 to 2048 (``CLUSTER_DIMS``) the
slices of a query tile run as one thread-block cluster that forms them
once (each block its share over its columns, summed across the cluster in
rank order, so every slice sees the same bits); past 2048 Q streams
through each block's ring with K. A route's
launch raises if it fails: nothing falls back to another. Each launch
counts one on its wrapper (``launches``) and on its route
(``routes[route(...)]``).
"""

from __future__ import annotations

import collections
import ctypes

import torch

from tim_tpu_torch import _build

_DTYPES = (torch.float32, torch.bfloat16)
# The instances the kernels are built for (64: ViT-B/L and the MAE
# decoder); fp32 has 64, 128 and 256; others run zero-padded
HEAD_DIMS = (64, 80, 96, 112, 128, 256)
F32_HEAD_DIMS = (64, 128, 256)
# bf16 past 64: the instances that read a head dim 8 below theirs in place
WIDE = (80, 96, 112, 128)
# the bf16 backward's instances from 129 to 256 (the split passes), each
# reading a multiple of 8 up to 56 below it in place
SPLIT = (192, 256)
# past this head dim, the column-slice route (any head dim, run at its own
# or at the next multiple of 64)
SLICED = HEAD_DIMS[-1]
# the bf16 forward's head dims on the cluster route: the 3 to 8 slices of
# a query tile (a portable cluster holds 8 blocks) as one thread-block
# cluster; past it Q streams, the route "wgmma streamed slices". The
# kernels' launch (csrc/attention_cols_sm90.cuh, ``on_cluster``) picks
# the route from the head dim alone; this names it
CLUSTER_DIMS = (2 * SLICED + 1, 8 * SLICED)
# tim_flash_mha(q, k, v, out, strides, lse, b, h, s, dh, instance, bf16,
# scale, stream)
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_longlong),
                                      ctypes.c_void_p]
             + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p])
# tim_flash_mha_cols(q, k, v, out, strides, lse, b, h, s, dh, bf16, scale,
# stream)
_COLS_ARGTYPES = ([ctypes.c_void_p] * 4
                  + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
                  + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p])
# tim_flash_mha_bwd_cols(q, k, v, o, do, dq, dk, dv, strides, lse, delta,
# b, h, s, dh, bf16, scale, stream)
_BWD_COLS_ARGTYPES = ([ctypes.c_void_p] * 8
                      + [ctypes.POINTER(ctypes.c_longlong)]
                      + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
                      + [ctypes.c_float, ctypes.c_void_p])
# tim_flash_mha_bwd(q, k, v, o, do, dq, dk, dv, strides, lse, delta,
# dq_accum, b, h, s, dh, instance, bf16, scale, stream)
_BWD_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.POINTER(ctypes.c_longlong)]
                 + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
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


def check_qkv(name: str, q, k, v, inst: int, backward: bool = False) -> None:
    """What the kernels of instance ``inst`` take: q/k/v of one shape
    [B, H, S, dh] and dtype on one device, dh the instance's (or one that
    the instance reads in place, ``reads_in_place``), the last dim
    contiguous and the other strides and base addresses aligned to 16
    bytes (so that a row loads as 16-byte vectors)."""
    if q.dim() != 4:
        raise ValueError(f"{name}: q must be [B, H, S, dh], got "
                         f"{tuple(q.shape)}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"{name}: dtype {q.dtype} not in {_DTYPES}")
    if not reads_in_place(q.shape[-1], q.dtype, inst, backward):
        raise ValueError(f"{name}: head dim {q.shape[-1]}, the kernel is "
                         f"built for {inst}")
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


def instance_dim(dh: int, dtype, backward: bool = False) -> int:
    """The head dim of the kernel instance that head dim ``dh`` runs on in
    ``dtype``: past 256 (``SLICED``) the column-slice route at dh itself
    where a row of dh fills 16-byte words, else at the next multiple of
    64; bf16 past 64 up to 128 dh rounded up to 16 (``WIDE``); the bf16
    ``backward`` from 129 to 256 the least of ``SPLIT`` that holds it;
    else the least of ``F32_HEAD_DIMS`` that holds it."""
    if dh > SLICED:
        return dh if dh * _size(dtype) % 16 == 0 else -(-dh // 64) * 64
    if dtype == torch.bfloat16 and WIDE[0] - 16 < dh <= WIDE[-1]:
        return -(-dh // 16) * 16
    if backward and dtype == torch.bfloat16 and dh > WIDE[-1]:
        return min(w for w in SPLIT if w >= dh)
    return min(w for w in F32_HEAD_DIMS if w >= dh)


def _size(dtype) -> int:
    return 2 if dtype == torch.bfloat16 else 4


def reads_in_place(dh: int, dtype, inst: int, backward: bool = False) -> bool:
    """Whether instance ``inst`` reads head dim ``dh`` where it lies: its
    own, or in bf16 a multiple of 8 below it on the ``WIDE`` instances
    (within 16) and the backward's ``SPLIT`` ones (within 64): the TMA
    maps span dh; TMA fills the columns up to the instance with zeros."""
    if dh == inst:
        return True
    if dtype != torch.bfloat16 or dh % 8:
        return False
    if inst in WIDE:
        return inst - 16 < dh < inst
    return backward and inst in SPLIT and inst - 64 < dh < inst


def cluster(inst: int, dtype) -> bool:
    """Whether the forward at instance ``inst`` runs the column slices of
    a query tile as one thread-block cluster (bf16, ``CLUSTER_DIMS``)."""
    return (dtype == torch.bfloat16
            and CLUSTER_DIMS[0] <= inst <= CLUSTER_DIMS[1])


def slices_route(dtype, inst: int, backward: bool = False) -> str:
    """The column-slice route's name at instance ``inst`` past ``SLICED``
    (kernels 1, 4 and 5 share it): "wgmma slices 512" (one block a slice),
    "wgmma cluster slices 1024" (``cluster``), "wgmma streamed slices
    2304" (bf16 forward past ``CLUSTER_DIMS``), "wgmma two passes slices
    512" (bf16 backward), "fp32 cuda cores slices 512"."""
    if dtype == torch.float32:
        return f"fp32 cuda cores slices {inst}"
    if backward:
        return f"wgmma two passes slices {inst}"
    if cluster(inst, dtype):
        return f"wgmma cluster slices {inst}"
    if inst > CLUSTER_DIMS[1]:
        return f"wgmma streamed slices {inst}"
    return f"wgmma slices {inst}"


def launch_plan(dh: int, dtype, *tensors, backward: bool = False):
    """(instance head dim, whether q/k/v go through a zero-padded copy) of
    the forward or the ``backward``: the copy is taken when the instance
    does not read dh in place (``reads_in_place``) or a row cannot be read
    in place (``aligned``)."""
    w = instance_dim(dh, dtype, backward)
    return w, not (reads_in_place(dh, dtype, w, backward)
                   and all(aligned(t) for t in tensors))


def route(dtype, inst: int, copied: bool, backward: bool = False,
          deterministic: bool = False) -> str:
    """The name of the route that a launch at instance ``inst`` takes (the
    key of its count in ``flash_mha.routes`` / ``flash_mha_bwd.routes``):
    fp32 on the CUDA cores; bf16 forward on the wgmma core; bf16 backward on
    the one-pass wgmma core at 64 (with the atomic-free dq pass instead of
    atomic adds when ``deterministic``), the two wgmma passes on ``WIDE``,
    the two split wgmma passes on ``SPLIT``; past 256 (``SLICED``) the
    column-slice routes (``slices_route``; the backward's is atomic-free
    whether ``deterministic`` or not, one name); " via copy" when the
    zero-padded copy was taken."""
    if inst > SLICED:
        name = slices_route(dtype, inst, backward)
    elif dtype == torch.float32:
        name = f"fp32 cuda cores {inst}"
    elif not backward:
        name = f"wgmma {inst}"
    elif inst == 64:
        name = "wgmma one pass 64" + (" + dq pass" if deterministic else "")
    elif inst in WIDE:
        name = f"wgmma two passes {inst}"
    else:
        name = f"wgmma split passes {inst}"
    return name + (" via copy" if copied else "")


def check_args(name: str, q, k, v) -> None:
    """What ``flash_mha`` takes on the card: q/k/v [B, H, S, dh] of one
    shape and dtype (fp32 or bf16) on one device, any dh >= 1; any strides
    (``launch_plan`` copies rows it cannot read in place)."""
    if q.dim() != 4:
        raise ValueError(f"{name}: q must be [B, H, S, dh], got "
                         f"{tuple(q.shape)}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"{name}: dtype {q.dtype} not in {_DTYPES}")
    if q.shape[-1] < 1:
        raise ValueError(f"{name}: head dim {q.shape[-1]} < 1")
    for tname, t in (("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name}: {tname} is {t.dtype} on {t.device}, "
                             f"q is {q.dtype} on {q.device}")
        if t.shape != q.shape:
            raise ValueError(f"{name}: {tname} has shape {tuple(t.shape)}, "
                             f"q {tuple(q.shape)}")


def padded_qkv(q, k, v, width: int):
    """One zero-padded packed [B, S, 3, H, width] copy of q, k, v
    [B, H, S, dh] (dh <= width): the layout glue of ``launch_plan``."""
    b, h, s, dh = q.shape
    buf = q.new_zeros((b, s, 3, h, width))
    for i, t in enumerate((q, k, v)):
        buf[:, :, i, :, :dh] = t.transpose(1, 2)
    return buf


def pad_last(t, width: int):
    """t zero-padded in its last dim to ``width`` (a new tensor)."""
    return torch.nn.functional.pad(t, (0, width - t.shape[-1]))


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


def _launch_fwd(q, k, v, sm_scale, lse, inst, copied):
    """One launch of instance ``inst`` on q/k/v that it reads in place
    (``copied``: they are the zero-padded copy, for the route's count)."""
    if inst <= SLICED and inst not in (HEAD_DIMS if q.dtype == torch.bfloat16
                                       else F32_HEAD_DIMS):
        raise ValueError(f"flash_mha: no {q.dtype} instance at head dim "
                         f"{inst}")
    check_qkv("flash_mha", q, k, v, inst)
    b, h, s, dh = q.shape
    view, strides = launch_args(q, k, v)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), view.data_ptr())
    lse_ptr = None if lse is None else lse.data_ptr()
    bf16 = int(q.dtype == torch.bfloat16)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if inst > SLICED:
        fn = _build.launcher("tim_flash_mha_cols", _COLS_ARGTYPES)
        status = fn(*ptrs, strides, lse_ptr, b, h, s, dh, bf16,
                    float(sm_scale), stream)
    else:
        fn = _build.launcher("tim_flash_mha", _ARGTYPES)
        status = fn(*ptrs, strides, lse_ptr, b, h, s, dh, inst, bf16,
                    float(sm_scale), stream)
    _build.check(status, "flash_mha")
    flash_mha.launches += 1
    flash_mha.routes[route(q.dtype, inst, copied)] += 1
    return view


def _forward(q, k, v, sm_scale, lse=None):
    """One forward launch for any head dim: through a padded copy where
    ``launch_plan`` says so, the output sliced back."""
    check_args("flash_mha", q, k, v)
    dh = q.shape[-1]
    w, pad = launch_plan(dh, q.dtype, q, k, v)
    if not pad:
        return _launch_fwd(q, k, v, sm_scale, lse, w, False)
    out = _launch_fwd(*unpack_qkv(padded_qkv(q, k, v, w)), sm_scale, lse, w,
                      True)
    return out[..., :dh]


def flash_mha_with_lse(q, k, v, *, sm_scale: float):
    """(output, row log-sum-exp [B, H, S] fp32) of one forward launch on
    the card: what the autograd Function keeps for ``flash_mha_bwd``."""
    lse = row_stats(q)
    return _forward(q, k, v, sm_scale, lse), lse


def flash_mha_bwd(q, k, v, out, lse, do, *, sm_scale: float, grads=None):
    """(dq, dk, dv) of ``flash_mha`` for the output gradient ``do``, given
    the forward's output ``out`` and row log-sum-exp ``lse`` [B, H, S] fp32.
    CUDA tensors launch the backward kernel (written into ``grads``, three
    [B, H, S, dh] views, when given; else into views of one packed
    [B, S, 3, H, dh] buffer) or raise; CPU tensors take
    ``flash_mha_bwd_plain`` (``out`` and ``lse`` unused). dk and dv are
    the same bits every run. In bf16 at head dim 64 the one-pass kernel
    sums dq over key blocks with fp32 atomic adds, so dq may differ in its
    last bits from run to run; under
    ``torch.use_deterministic_algorithms(True)`` dq comes instead from an
    atomic-free pass over the key tiles (the same bits every run, one more
    pass). Every other route (fp32; bf16 past 64: two passes, dk/dv then
    dq; past 256 the column-slice passes) is atomic-free either way."""
    if q.device.type == "cpu":
        return flash_mha_bwd_plain(q, k, v, do, sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_mha_bwd: no kernel for device {q.device}")
    check_args("flash_mha_bwd", q, k, v)
    dh = q.shape[-1]
    w, pad = launch_plan(dh, q.dtype, q, k, v, out, backward=True)
    if pad:
        qkv = padded_qkv(q, k, v, w)
        got = _launch_bwd(*unpack_qkv(qkv), pad_last(out, w), lse,
                          pad_last(do.to(q.dtype), w), sm_scale, None, w,
                          True)
        got = tuple(g[..., :dh] for g in got)
        if grads is None:
            return got
        for g, x in zip(grads, got):
            g.copy_(x)
        return grads
    return _launch_bwd(q, k, v, out, lse, do, sm_scale, grads, w, False)


def bwd_scratch(lse, inst: int, bf16: bool):
    """The backward's fp32 scratch for D (the C launcher's ``delta``): like
    ``lse``, [B, H, S]; the two passes of the bf16 ``WIDE`` and ``SPLIT``
    instances keep lse and D in rows padded to 4 (16 bytes, their TMA
    boxes' alignment), 2 x B x H x S rounded up to 4."""
    if bf16 and (inst in WIDE or inst in SPLIT):
        b, h, s = lse.shape
        return lse.new_empty(2 * b * h * (-(-s // 4) * 4))
    return torch.empty_like(lse)


def _launch_bwd(q, k, v, out, lse, do, sm_scale, grads, inst, copied):
    """One launch of the backward at instance ``inst`` on operands that it
    reads in place (``copied``: the zero-padded copy, for the route's
    count)."""
    grads = packed_grads(q) if grads is None else grads
    check_qkv("flash_mha_bwd", *grads, inst, backward=True)
    do, strides = bwd_args(q, k, v, out, do, grads)
    b, h, s, dh = q.shape
    bf16 = q.dtype == torch.bfloat16
    delta = bwd_scratch(lse, inst, bf16)
    # bf16 at 64: dq summed over key blocks in fp32 (zeroed by the
    # kernel's preprocess), then rounded into dq; none on the deterministic
    # route or past 64
    deterministic = torch.are_deterministic_algorithms_enabled()
    atomic_dq = bf16 and inst == 64 and not deterministic
    dq_accum = (torch.empty((b, h, s, dh), dtype=torch.float32,
                            device=q.device) if atomic_dq else None)
    ptrs = [t.data_ptr() for t in (q, k, v, out, do, *grads)]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if inst > SLICED:
        fn = _build.launcher("tim_flash_mha_bwd_cols", _BWD_COLS_ARGTYPES)
        status = fn(*ptrs, strides, lse.data_ptr(), delta.data_ptr(), b, h,
                    s, dh, int(bf16), float(sm_scale), stream)
    else:
        fn = _build.launcher("tim_flash_mha_bwd", _BWD_ARGTYPES)
        status = fn(*ptrs, strides, lse.data_ptr(), delta.data_ptr(),
                    dq_accum.data_ptr() if atomic_dq else None, b, h, s, dh,
                    inst, int(bf16), float(sm_scale), stream)
    _build.check(status, "flash_mha_bwd")
    flash_mha_bwd.launches += 1
    flash_mha_bwd.routes[route(q.dtype, inst, copied, backward=True,
                               deterministic=deterministic and bf16)] += 1
    return grads


class _FlashMHA(torch.autograd.Function):
    """flash_mha over a packed [B, S, 3, H, dh] qkv on the card, kernel
    both ways; the backward kernel writes the packed gradient directly."""

    @staticmethod
    def forward(ctx, qkv, sm_scale):
        dh = qkv.shape[-1]
        check_args("flash_mha", *unpack_qkv(qkv))
        w, pad = launch_plan(dh, qkv.dtype, *unpack_qkv(qkv))
        # a head dim the instance cannot read in place: one zero-padded
        # copy, kept for the backward, whose padded gradient columns are
        # sliced away
        qkv_k = pad_last(qkv, w) if pad else qkv
        lse = row_stats(unpack_qkv(qkv)[0])
        out = _launch_fwd(*unpack_qkv(qkv_k), sm_scale, lse, w, pad)
        # the backward's own plan (bf16 from 129 to 256: the split passes'
        # instances) keeps qkv as given and plans it again
        ctx.same = launch_plan(dh, qkv.dtype, *unpack_qkv(qkv),
                               backward=True) == (w, pad)
        ctx.save_for_backward(qkv_k if ctx.same else qkv, out, lse)
        ctx.sm_scale, ctx.dh, ctx.inst, ctx.pad = sm_scale, dh, w, pad
        return out[..., :dh] if pad else out

    @staticmethod
    def backward(ctx, do):
        qkv, out, lse = ctx.saved_tensors
        grad = torch.empty_like(qkv)
        if not ctx.same:
            flash_mha_bwd(*unpack_qkv(qkv), out[..., :ctx.dh], lse, do,
                          sm_scale=ctx.sm_scale, grads=unpack_qkv(grad))
            return grad, None
        # the saved qkv: the input (read in place), or its copy padded to
        # the instance
        width = qkv.shape[-1]
        if width != ctx.dh:
            do = pad_last(do.to(qkv.dtype), width)
        _launch_bwd(*unpack_qkv(qkv), out, lse, do, ctx.sm_scale,
                    unpack_qkv(grad), ctx.inst, ctx.pad)
        return (grad[..., :ctx.dh] if width != ctx.dh else grad), None


def flash_mha(q, k, v, *, sm_scale: float):
    """softmax(q k^T * sm_scale) v for q/k/v [B, H, S, dh] (any dh >= 1;
    fp32 or bf16, any S >= 1); returns
    [B, H, S, dh] in q's dtype, a view of a contiguous [B, S, H, dh']
    tensor (dh' the instance's head dim, ``launch_plan``). Inputs may be
    strided views (e.g. of the packed qkv projection); the kernel reads
    them in place (or copies them once, ``launch_plan``). CPU
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
    return _forward(q, k, v, sm_scale)


def flash_mha_qkv(qkv, *, sm_scale: float):
    """``flash_mha`` of the packed projection qkv [B, S, 3, H, dh]; its
    gradient comes back packed in the same layout."""
    if qkv.device.type == "cuda" and needs_grad(qkv):
        return _FlashMHA.apply(qkv, sm_scale)
    return flash_mha(*unpack_qkv(qkv), sm_scale=sm_scale)


# Numbers of kernel launches (forward, backward), and of each by route
# (``route``); the plain CPU versions do not count.
flash_mha.launches = 0
flash_mha_bwd.launches = 0
flash_mha.routes = collections.Counter()
flash_mha_bwd.routes = collections.Counter()
