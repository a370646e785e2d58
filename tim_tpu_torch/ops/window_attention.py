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
There is no fallback between the two. The card takes every head dim: the
kernels are built at instances 32 (every Swin preset's head dim), in the
bf16 forward 48 and 64 (``PAIR_DIMS``: kernel 4's window-pair design,
``csrc/window_attention_64.cu``, the bias brought by TMA) and kernel 5's
(``flash_mha.HEAD_DIMS``: 64, 128, 256, in bf16 also 80, 96 and 112), with
the column-slice route past 256 (in bf16 from 513 to 2048 the slices of a
query tile as one thread-block cluster), and ``launch_plan`` picks one as
``flash_mha`` does: bf16 forward head dims 40, 48, 56 and 64, bf16
multiples of 8 from 72 to 128 and past 256 are read in place, any other
head dim goes through one zero-padded copy of q, k and v (and of out and
do in the backward, whose bf16 instances past 32 are kernel 5's: 40 and
48 take the copy to 64 there) to its instance, the outputs and gradients
sliced back (zero columns add nothing to the scores; ``sm_scale`` stays
the caller's; the bias and region ids are unchanged; the pair design's
bias map needs rows of a multiple of 4 floats, so a sequence off a
multiple of 4 hands it a copy of the bias with padded rows). A launch
that fails raises; nothing falls back to another route. Each launch counts one on its wrapper (``launches``) and on its
route (``routes[route(...)]``). It is differentiable in q, k, v and
the bias: on the CPU through the plain version's PyTorch ops, on the card
through ``window_attention_bwd`` (``csrc/window_attention_bwd.cu``), whose
bias gradient [H, N, N] is dS summed over every window. (The JAX kernel's
``dab`` [n_types, H, N, N] sums over the windows of each type; summed over
the types it is the same quantity, and the gradient of the bias either
way, since the shift mask is a constant.) ``window_attention_qkv`` takes
the packed [BW, N, 3, H, dh] projection and returns its gradient packed.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from tim_tpu_torch import _build
from tim_tpu_torch.ops import flash_mha as fm
from tim_tpu_torch.ops.flash_mha import (
    aligned, bwd_args, check_args, check_qkv, launch_args, needs_grad,
    pack_qkv, packed_grads, pad_last, padded_qkv, row_stats,
    softmax_attention_bwd_plain, unpack_qkv)

MASK_VALUE = -100.0
# The instance every Swin preset runs on (head dim 32 at every stage);
# past it, in the bf16 forward, kernel 4's window-pair instances up to 64
# (PAIR_DIMS), then kernel 5's instances (fm.HEAD_DIMS, fm.F32_HEAD_DIMS),
# and past fm.SLICED the column-slice route
SWIN_DIM = 32
PAIR_DIMS = (48, 64)
# tim_window_attention(q, k, v, out, strides, lse, bias, bias_pitch,
# region_ids, n_win, bw, h, n, dh, inst, bf16, scale, stream)
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_longlong)]
             + [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p]
             + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p])
# tim_window_attention_bwd(q, k, v, o, do, dq, dk, dv, strides, lse, delta,
# dq_accum, bias, region_ids, n_win, dbias, dbias_groups, groups, bw, h, n,
# dh, inst, bf16, scale, stream)
_BWD_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.POINTER(ctypes.c_longlong)]
                 + [ctypes.c_void_p] * 5 + [ctypes.c_int]
                 + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7
                 + [ctypes.c_float, ctypes.c_void_p])
# The bf16 dbias pass past 32 (csrc/window_dbias_sm90.cuh): a block owns
# (head, 128 query rows, 64 keys) and a group of consecutive windows
_DBIAS_ROWS, _DBIAS_KEYS = 128, 64
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


def _pairs(dh: int, dtype, backward: bool) -> bool:
    """Whether head dim ``dh`` runs on the window-pair instances (the bf16
    forward from 33 to 64)."""
    return (not backward and dtype == torch.bfloat16
            and SWIN_DIM < dh <= PAIR_DIMS[-1])


def instance_dim(dh: int, dtype, backward: bool = False) -> int:
    """The head dim of the kernel instance that head dim ``dh`` runs on in
    ``dtype``: 32 up to 32; the bf16 forward the least of ``PAIR_DIMS``
    that holds it up to 64; else kernel 5's (``flash_mha.instance_dim``)."""
    if dh <= SWIN_DIM:
        return SWIN_DIM
    if _pairs(dh, dtype, backward):
        return min(w for w in PAIR_DIMS if w >= dh)
    return fm.instance_dim(dh, dtype)


def reads_in_place(dh: int, dtype, inst: int, backward: bool = False):
    """Whether instance ``inst`` reads head dim ``dh`` where it lies: the
    window-pair instances a multiple of 8 above the one below them (48:
    40, 48; 64: 56, 64), the others as ``flash_mha.reads_in_place``."""
    if _pairs(dh, dtype, backward) and inst in PAIR_DIMS:
        return dh % 8 == 0 and inst - 16 < dh <= inst
    return fm.reads_in_place(dh, dtype, inst)


def launch_plan(dh: int, dtype, *tensors, backward: bool = False):
    """(instance head dim, whether q/k/v go through a zero-padded copy),
    as ``flash_mha.launch_plan`` with 32 and, in the bf16 forward,
    ``PAIR_DIMS`` among the instances (``backward``: the plan of
    ``window_attention_bwd``)."""
    w = instance_dim(dh, dtype, backward)
    return w, not (reads_in_place(dh, dtype, w, backward)
                   and all(aligned(t) for t in tensors))


def route(dtype, inst: int, copied: bool, backward: bool = False,
          deterministic: bool = False) -> str:
    """The name of the route a launch at instance ``inst`` takes (the key
    of its count in ``window_attention.routes`` /
    ``window_attention_bwd.routes``). Forward: ``flash_mha.route``'s names
    ("wgmma 48", "wgmma 64", "fp32 cuda cores 32", "wgmma slices 512",
    "wgmma cluster slices 1024", ...). Backward:
    fp32 the CUDA-core passes ("fp32 cuda cores 64"; from 128 the
    column-chunk passes, "fp32 cuda cores slices 128"); bf16 at 32 the
    one-pass wgmma core ("wgmma one pass 32", with " + dq pass" when
    ``deterministic``), past 32 two atomic-free wgmma passes ("wgmma two
    passes 64"; from 256 the column-slice ones, "wgmma two passes slices
    256") and the dbias pass (" + dbias pass"); " via copy" when the
    zero-padded copy was taken."""
    if not backward:
        return fm.route(dtype, inst, copied)
    if dtype == torch.float32:
        slices = " slices" if inst > 64 else ""
        name = f"fp32 cuda cores{slices} {inst}"
    elif inst == SWIN_DIM:
        name = "wgmma one pass 32" + (" + dq pass" if deterministic else "")
    else:
        slices = " slices" if inst >= fm.SLICED else ""
        name = f"wgmma two passes{slices} {inst} + dbias pass"
    return name + (" via copy" if copied else "")


def pair_bias(bias):
    """The bias as the window-pair instances' TMA map reads it: rows of a
    multiple of 4 floats (16 bytes), so a sequence off a multiple of 4
    takes a copy with padded rows; (bias, row pitch in floats)."""
    n = bias.shape[-1]
    pitch = -(-n // 4) * 4
    if pitch == n:
        return bias, n
    return torch.nn.functional.pad(bias, (0, pitch - n)), pitch


def _launch_fwd(q, k, v, bias, region_ids, sm_scale, lse, inst, copied):
    """One launch of instance ``inst`` on q/k/v that it reads in place
    (``copied``: they are the zero-padded copy, for the route's count)."""
    dh = q.shape[-1]
    pairs = _pairs(dh, q.dtype, False) and inst in PAIR_DIMS
    if pairs and not reads_in_place(dh, q.dtype, inst):
        raise ValueError(f"window_attention: head dim {dh}, the kernel is "
                         f"built for {inst}")
    check_qkv("window_attention", q, k, v, dh if pairs else inst)
    _check(q, bias, region_ids)
    bw, h, n, _ = q.shape
    bias_k, pitch = pair_bias(bias) if pairs else (bias, n)
    view, strides = launch_args(q, k, v)
    fn = _build.launcher("tim_window_attention", _ARGTYPES)
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), view.data_ptr(),
                strides, None if lse is None else lse.data_ptr(),
                bias_k.data_ptr(), pitch, *_region_args(region_ids),
                bw, h, n, dh, inst, int(q.dtype == torch.bfloat16),
                float(sm_scale),
                torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(status, "window_attention")
    window_attention.launches += 1
    window_attention.routes[route(q.dtype, inst, copied)] += 1
    return view


def _forward(q, k, v, bias, region_ids, sm_scale, lse=None):
    """One forward launch for any head dim: through a padded copy where
    ``launch_plan`` says so, the output sliced back."""
    check_args("window_attention", q, k, v)
    dh = q.shape[-1]
    w, pad = launch_plan(dh, q.dtype, q, k, v)
    if not pad:
        return _launch_fwd(q, k, v, bias, region_ids, sm_scale, lse, w,
                           False)
    out = _launch_fwd(*unpack_qkv(padded_qkv(q, k, v, w)), bias, region_ids,
                      sm_scale, lse, w, True)
    return out[..., :dh]


def window_attention_with_lse(q, k, v, bias, region_ids=None, *,
                              sm_scale: float):
    """(output, row log-sum-exp [BW, H, N] fp32) of one forward launch on
    the card: what the autograd Function keeps for
    ``window_attention_bwd``."""
    lse = row_stats(q)
    return _forward(q, k, v, bias, region_ids, sm_scale, lse), lse


def bwd_groups(bw: int, h: int, n: int) -> int:
    """The number of window groups the bf16 backward kernel at head dim 32
    sums dbias over for [bw, h, n] on the current card: each group's blocks
    keep their own partial sum, and more than one group adds a [groups, h,
    n, n] fp32 scratch summed by a short pass."""
    groups = _build.launcher("tim_window_attention_bwd_groups",
                             _GROUPS_ARGTYPES)(bw, h, n)
    if groups < 1:
        raise RuntimeError("window_attention_bwd: no device to size the "
                           "window groups for")
    return groups


def dbias_groups(bw: int, h: int, n: int, sms: int) -> int:
    """The window groups of the bf16 dbias pass past head dim 32 for
    [bw, h, n] on a card of ``sms`` SMs: one block an SM each owns (head,
    128 query rows, 64 keys) of a group and walks its windows; with too
    few such blocks for two waves, the windows are cut into groups (at
    most one a window) summed in a [groups, h, n, n] fp32 scratch by a
    short pass, in order."""
    blocks = h * -(-n // _DBIAS_ROWS) * -(-n // _DBIAS_KEYS)
    return max(1, min(bw, -(-2 * sms // blocks)))


def _bwd_scratch(lse, inst: int, bf16: bool):
    """D's fp32 scratch (the C launcher's ``delta``): [BW, H, N], or for
    the bf16 two wgmma passes at 64-128 their padded lse and D rows
    (``flash_mha.bwd_scratch``)."""
    if bf16 and 64 <= inst <= fm.WIDE[-1]:
        b, h, n = lse.shape
        return lse.new_empty(2 * b * h * (-(-n // 4) * 4))
    return torch.empty_like(lse)


def window_attention_bwd(q, k, v, bias, region_ids, out, lse, do, *,
                         sm_scale: float, grads=None):
    """(dq, dk, dv, dbias) of ``window_attention`` for the output gradient
    ``do``, given the forward's output ``out`` and row log-sum-exp ``lse``
    [BW, H, N] fp32; dbias [H, N, N] fp32 sums over every window. CUDA
    tensors launch the backward kernels of the instance ``launch_plan``
    picks (through the zero-padded copy where it says so; dq/dk/dv written
    into ``grads`` when given, else into views of one packed [BW, N, 3, H,
    dh] buffer) or raise; CPU tensors take ``window_attention_bwd_plain``.
    In bf16 at head dim 32 dq is summed over key blocks with fp32 atomics,
    so its last bits may change from run to run (dk, dv, dbias do not);
    under ``torch.use_deterministic_algorithms(True)`` dq comes instead from
    an atomic-free pass over the key tiles. Every other route (fp32; bf16
    past 32) is atomic-free either way."""
    if q.device.type == "cpu":
        return window_attention_bwd_plain(q, k, v, bias, region_ids, do,
                                          sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"window_attention_bwd: no kernel for device "
                         f"{q.device}")
    check_args("window_attention_bwd", q, k, v)
    dh = q.shape[-1]
    w, pad = launch_plan(dh, q.dtype, q, k, v, out, backward=True)
    if not pad:
        return _launch_bwd(q, k, v, bias, region_ids, out, lse, do,
                           sm_scale, grads, w, False)
    *got, dbias = _launch_bwd(*unpack_qkv(padded_qkv(q, k, v, w)), bias,
                              region_ids, pad_last(out, w), lse,
                              pad_last(do.to(q.dtype), w), sm_scale, None, w,
                              True)
    got = [g[..., :dh] for g in got]
    if grads is not None:
        for g, x in zip(grads, got):
            g.copy_(x)
        got = list(grads)
    return (*got, dbias)


def _launch_bwd(q, k, v, bias, region_ids, out, lse, do, sm_scale, grads,
                inst, copied):
    """One launch of the backward at instance ``inst`` on operands that it
    reads in place (``copied``: the zero-padded copy, for the route's
    count)."""
    check_qkv("window_attention_bwd", q, k, v, inst)
    _check(q, bias, region_ids)
    grads = packed_grads(q) if grads is None else grads
    check_qkv("window_attention_bwd", *grads, inst)
    do, strides = bwd_args(q, k, v, out, do, grads)
    bw, h, n, dh = q.shape
    bf16 = q.dtype == torch.bfloat16
    dbias = torch.empty_like(bias)
    delta = _bwd_scratch(lse, inst, bf16)
    # bf16 at 32: dq's fp32 sum over key blocks (zeroed by the kernel's
    # preprocess), none on the deterministic route; dbias's partial sums of
    # each window group when there is more than one group
    deterministic = torch.are_deterministic_algorithms_enabled()
    atomic_dq = bf16 and inst == SWIN_DIM and not deterministic
    dq_accum = (torch.empty((bw, h, n, dh), dtype=torch.float32,
                            device=q.device) if atomic_dq else None)
    if not bf16:
        groups = 1
    elif inst == SWIN_DIM:
        groups = bwd_groups(bw, h, n)
    else:
        groups = dbias_groups(bw, h, n, torch.cuda.get_device_properties(
            q.device).multi_processor_count)
    dbias_parts = (torch.empty((groups, h, n, n), dtype=torch.float32,
                               device=q.device) if groups > 1 else None)
    fn = _build.launcher("tim_window_attention_bwd", _BWD_ARGTYPES)
    status = fn(*(t.data_ptr() for t in (q, k, v, out, do, *grads)),
                strides, lse.data_ptr(), delta.data_ptr(),
                None if dq_accum is None else dq_accum.data_ptr(),
                bias.data_ptr(), *_region_args(region_ids), dbias.data_ptr(),
                None if dbias_parts is None else dbias_parts.data_ptr(),
                groups, bw, h, n, dh, inst, int(bf16), float(sm_scale),
                torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(status, "window_attention_bwd")
    window_attention_bwd.launches += 1
    window_attention_bwd.routes[route(q.dtype, inst, copied, backward=True,
                                      deterministic=deterministic)] += 1
    return (*grads, dbias)


# tim_window_attention_dbias(q, k, v, do, strides, lse, delta, bias,
# region_ids, n_win, dbias, scratch, groups, bw, h, n, dh, scale, stream)
_DBIAS_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_longlong)]
                   + [ctypes.c_void_p] * 4 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_void_p])


def window_attention_dbias(q, k, v, bias, region_ids, lse, delta, do, *,
                           sm_scale: float):
    """dbias [H, N, N] fp32 alone: the pass ``window_attention_bwd`` runs
    after its dq, dk and dv passes in bf16 past head dim 32, given the
    forward's ``lse`` and D = rowsum(do * out) ``delta`` ([BW, H, N] fp32),
    to hold and time it on its own. bf16 CUDA tensors whose head dim the
    pass reads in place (a multiple of 8 past 32, rows 16-byte aligned);
    CPU tensors take the plain backward's dbias."""
    if q.device.type == "cpu":
        return window_attention_bwd_plain(q, k, v, bias, region_ids, do,
                                          sm_scale=sm_scale)[3]
    check_args("window_attention_dbias", q, k, v)
    bw, h, n, dh = q.shape
    if (q.dtype != torch.bfloat16 or dh <= SWIN_DIM or dh % 8
            or not all(aligned(t) for t in (q, k, v, do))):
        raise ValueError(f"window_attention_dbias: bf16 head dims past "
                         f"{SWIN_DIM} that are multiples of 8, rows 16-byte "
                         f"aligned; got {q.dtype} head dim {dh}")
    _check(q, bias, region_ids)
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.dtype != torch.float32 or t.shape != q.shape[:3]
                or not t.is_contiguous()):
            raise ValueError(f"window_attention_dbias: {name} must be "
                             f"contiguous fp32 {tuple(q.shape[:3])}")
    groups = dbias_groups(bw, h, n, torch.cuda.get_device_properties(
        q.device).multi_processor_count)
    dbias = torch.empty_like(bias)
    parts = (torch.empty((groups, h, n, n), dtype=torch.float32,
                         device=q.device) if groups > 1 else None)
    strides = (ctypes.c_longlong * 12)(
        *[st for t in (q, k, v, do) for st in t.stride()[:3]])
    fn = _build.launcher("tim_window_attention_dbias", _DBIAS_ARGTYPES)
    status = fn(*(t.data_ptr() for t in (q, k, v, do)), strides,
                lse.data_ptr(), delta.data_ptr(), bias.data_ptr(),
                *_region_args(region_ids), dbias.data_ptr(),
                None if parts is None else parts.data_ptr(), groups, bw, h,
                n, dh, float(sm_scale),
                torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(status, "window_attention_dbias")
    window_attention_dbias.launches += 1
    return dbias


class _WindowAttention(torch.autograd.Function):
    """window_attention over a packed [BW, N, 3, H, dh] qkv on the card,
    kernel both ways; the backward kernel writes the packed gradient
    directly (of the zero-padded copy, sliced back, where ``launch_plan``
    takes one). Where the backward's plan differs from the forward's (bf16
    from 33 to 64: the forward's window-pair instances, the backward's
    kernel 5 ones), each takes its own, through ``window_attention_bwd``
    in the backward."""

    @staticmethod
    def forward(ctx, qkv, bias, region_ids, sm_scale):
        dh = qkv.shape[-1]
        check_args("window_attention", *unpack_qkv(qkv))
        w, pad = launch_plan(dh, qkv.dtype, *unpack_qkv(qkv))
        same = (w, pad) == launch_plan(dh, qkv.dtype, *unpack_qkv(qkv),
                                       backward=True)
        # a head dim the instance cannot read in place: one zero-padded
        # copy, kept for the backward when it runs the same instance, whose
        # padded gradient columns are sliced away
        qkv_k = pad_last(qkv, w) if pad else qkv
        lse = row_stats(unpack_qkv(qkv)[0])
        out = _launch_fwd(*unpack_qkv(qkv_k), bias, region_ids, sm_scale,
                          lse, w, pad)
        ctx.save_for_backward(qkv_k if same else qkv, bias, region_ids, out,
                              lse)
        ctx.sm_scale, ctx.dh, ctx.inst, ctx.pad = sm_scale, dh, w, pad
        ctx.same = same
        return out[..., :dh] if pad else out

    @staticmethod
    def backward(ctx, do):
        qkv, bias, region_ids, out, lse = ctx.saved_tensors
        grad = torch.empty_like(qkv)
        if not ctx.same:
            *_, dbias = window_attention_bwd(
                *unpack_qkv(qkv), bias, region_ids, out[..., :ctx.dh], lse,
                do, sm_scale=ctx.sm_scale, grads=unpack_qkv(grad))
            return grad, dbias, None, None
        width = qkv.shape[-1]
        if width != ctx.dh:
            do = pad_last(do.to(qkv.dtype), width)
        *_, dbias = _launch_bwd(*unpack_qkv(qkv), bias, region_ids, out, lse,
                                do, ctx.sm_scale, unpack_qkv(grad), ctx.inst,
                                ctx.pad)
        return (grad[..., :ctx.dh] if width != ctx.dh else grad), dbias, \
            None, None


def window_attention(q, k, v, bias, region_ids=None, *, sm_scale: float):
    """Window attention for q/k/v [BW, H, N, dh] (any dh >= 1; fp32 or
    bf16), bias [H, N, N] fp32, region_ids [nW, N] int32 or None; returns
    [BW, H, N, dh] in q's dtype, a view of a contiguous [BW, N, H, dh']
    tensor (dh' the instance's head dim, ``launch_plan``). Inputs may be
    strided views of the packed qkv projection; the kernel reads them in
    place (or copies them once, ``launch_plan``). CPU tensors take the
    plain version; CUDA tensors launch the kernel or raise, and when a
    gradient is needed the forward also keeps its row statistic for
    ``window_attention_bwd`` (q, k and v are then packed into one copy,
    whose gradient the backward kernel writes)."""
    if q.device.type == "cpu":
        return window_attention_plain(q, k, v, bias, region_ids,
                                      sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"window_attention: no kernel for device {q.device}")
    if needs_grad(q, k, v, bias):
        return _WindowAttention.apply(pack_qkv(q, k, v), bias, region_ids,
                                      sm_scale)
    return _forward(q, k, v, bias, region_ids, sm_scale)


def window_attention_qkv(qkv, bias, region_ids=None, *, sm_scale: float):
    """``window_attention`` of the packed projection qkv [BW, N, 3, H, dh];
    its gradient comes back packed in the same layout."""
    if qkv.device.type == "cuda" and needs_grad(qkv, bias):
        return _WindowAttention.apply(qkv, bias, region_ids, sm_scale)
    return window_attention(*unpack_qkv(qkv), bias, region_ids,
                            sm_scale=sm_scale)


# Numbers of kernel launches (forward, backward), and of each by route
# (``route``); the plain CPU versions do not count.
window_attention.launches = 0
window_attention_bwd.launches = 0
window_attention_dbias.launches = 0
window_attention.routes = collections.Counter()
window_attention_bwd.routes = collections.Counter()
