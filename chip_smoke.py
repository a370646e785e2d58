#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``tim_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):
  1. device: a CUDA card is required; prints nvidia-smi's name and power
     limit (and the SM clock, for the exponential floors); TF32 stays at
     PyTorch's defaults, as the entry points run; the
     CPU references use no more threads than the host lets it use;
  2. build: compiles the CUDA kernels from ``tim_tpu_torch/csrc`` (one
     nvcc per source, all started together); prints each source's compile
     seconds and each attention kernel's registers and spills (ptxas);
  3. kernels: each kernel against its plain PyTorch version on the card
     (kernels 1 and 2 in fp32 and bf16 at batch 16, kernel 1's bf16 gate
     scaled to its output and shown to reject two faulty controls: the
     self term dropped, the output x 0.98; kernel 2's bf16 gate, the flat
     bound and a relative RMS, shown to reject two: b2 omitted, LN2's
     statistics over half the row; kernel 3 with fp32 and
     bf16 output, with and without bias and GELU, N in {3806, 44, 256},
     ragged M, strided inputs), then timed (CUDA events) at the serving
     shapes (bf16, batch 128) beside its plain version and one library
     route for the same function; the least time the card could take is
     computed from the same shapes (kernel 2 also beside its two bare
     bf16 products through ``torch.matmul``); then the bf16 linear against
     its own
     fp32-accumulator reference rounded per kind (TORCH_LINEAR, DENSE),
     bit-equal on exact sums, timed beside the route before the repair,
     and the linears' bias epilogue kernel (``csrc/bias_act.cu``: the
     bias add rounded per kind, with the MLPs' GELU) against its plain
     version at the backbones' shapes, timed;
  4. fp32 slice: ``make_inference_step`` of a full-width EPIC detection
     TimDetection (random weights from a seeded generator) on 2 windows,
     on the card with the kernels and on the CPU with the plain versions;
  5. bf16 serving: ``DetectionServer.detect_video`` (batch 128, top-8)
     over a synthetic 300 s video; kernels 1 and 2 launched once per
     encoder layer per batch; bf16 vs fp32 scores on the 2 windows;
  6. int8 fp32 slice: ``DetectionServer.quantized`` at full width in fp32
     with the fused int8 heads, calibrated on the 2 windows, against the
     same int8 model on the CPU; the card's calibrated scales against the
     CPU's;
  7. int8 serving: ``detect_video`` in int8 static serving (bf16 compute,
     fused heads) on the same video: kernel 1 launched 6 times per batch,
     kernel 2 never, kernel 3 twice; int8 vs bf16 scores on the 2 windows
     within the repo's contract (max 0.1, mean 0.01);
  8. headline mode: the same with bf16 attention scores (``fast_scores``):
     kernel 1 never launched, kernel 3 twice per batch;
  9. backbone kernels: kernel 4 (window attention) against its plain
     version in fp32 and bf16 at each Swin-B stage shape of one 32 x 224^2
     clip (shifted and unshifted blocks; stage 4 has one window type) and
     kernel 5 (flash attention) at S 1568, 160 and a ragged 37 and the MAE
     decoder's 8 heads, each as its inference and its training launch
     (the row lse against the plain log-sum-exp; the bf16 gate also shown
     to reject two faulty controls), then both timed at batch 8 at every
     shape the paths launch (kernel 4: every stage; kernel 5: ViT-L, the
     MAE encoder and decoder) beside the plain version, the library call
     without and with inputs that require grad (the call that keeps its
     lse), the bound and the exponential floor;
 10. backbone fp32 slices: full-width Swin-B (32 x 224^2) and ViT-L
     (16 x 224^2) on one clip, on the card with the kernels against the
     CPU with the plain versions; 24 launches per forward;
 11. extraction: ``make_visual_apply`` (bf16, batch 8) and
     ``extract_features_for_video`` over a synthetic video of 64 clips
     per backbone: device and wall clips/s, kernel 4 (Swin-B) and kernel 5
     (ViT-L) launched 24 times per forward; bf16 vs fp32 features on 2
     clips;
 12. training kernels: the backward of kernel 4 at every Swin-B stage
     shape (2 clips, shifted and unshifted) and of kernel 5 at
     [2, 16, 1568, 64], S 160 (MAE encoder), ragged S 37 and the MAE
     decoder's [2, 8, 1568, 64], against the plain backwards in fp32 and
     bf16 (the bf16 gate shown to reject faulty controls: D omitted,
     dbias from one window, dbias without one of the window groups the
     kernel sums over), then timed at batch 8 beside the plain
     backward and the backward of ``scaled_dot_product_attention``
     (and their share of the bound); kernels 4b's and 5b's deterministic
     routes (``torch.use_deterministic_algorithms``): two calls bit-equal,
     within the gate, timed;
 13. fp32 gradient slices: full-width ViT-L (2 blocks) and Swin-B (depths
     2, 2, 2, 2) ``TwoHeadViT`` on one clip, every parameter gradient on
     the card against the CPU;
 14. finetune steps at full width and depth in bf16, batch 8:
     ``BackboneFinetuneRunner`` over ViT-L (LLRD AdamW, mixup 0.8) and
     ``make_two_head_step`` + AdamW over Swin-B, 2 warm-up and 5 timed
     steps each: ms per step, clips/s, peak memory; 24 launches of
     kernel 4 or 5 and 24 of its backward per step, nothing else;
 15. MAE pretraining: ``BackbonePretrainRunner`` over ``PretrainVideoMAE``
     (ViT-L encoder, 512 x 12 decoder) in bf16, batch 8, mask 0.9: 36
     launches of kernel 5 and 36 of its backward per step;
 16. TIM detection training at the full width of ``epic_detection``
     (S = 898, 3806 + 44 classes), on synthetic splits of 484 windows
     built from numpy (real feature widths, two augmentation sets):
     a. one fp32 train step of the model cut to 2 encoder layers (every
        dropout rate 0, drloc 0.3) on 2 windows, card vs CPU with the same
        draws: losses and metrics within 1e-4 relative, every parameter
        gradient within 1e-3 of its largest value, the normaliser;
     b. ``DetectionRunner.train_epoch`` on the banked path, bf16, batch
        64, every dropout on: 2 warm-up and 5 timed steps (ms a step,
        device and wall windows/s, peak memory); finite losses and
        gradient norms, every parameter moved, the normaliser moved off
        250, kernels 1 and 2 never launched, the bias epilogue steady;
     c. ``validate`` of those weights in bf16 on the banked and the host
        path and in fp32: kernel 1 six times a batch, kernel 2 never;
        the paths within 1e-3, bf16 vs fp32 within 2e-2 relative;
     d. the state saved, ``resume``d into a fresh runner (step,
        normaliser, optimizer state and parameters equal), one more step
        from both: parameters within 1e-5 of each tensor's largest;
 18. the detection mAP chain, on phase 16's runner (its regression heads'
     two sigmoids biased apart) and validation split:
     ``extract_dense_predictions`` top-8 on the banked path (kernel 1 six
     times a batch) and the host path (the same rows, within 1e-3), the
     top-8 columns against a dense dump of 64 windows, ``evaluate_detections``
     of the banked dump against the split's GT (seconds of the dump and of
     the evaluation); an fp32 dump of 4 windows card vs CPU (within 1e-3)
     and their avg mAP against GT made of the CPU dump's best detections
     (within 1e-6); the GT fed back as predictions gives avg mAP 1.0;
 17. TIM recognition at the full width of ``epic_recognition`` (4
     layers, heads 97/300/3806/44), the class heads' weights x4 so that
     random logits spread, on synthetic splits of 484 windows from numpy:
     a. the fp32 forward of 2 windows card vs CPU (1e-3 of the largest
        logit; kernel 1 once a layer);
     b. kernel 1 against its plain version at the recognition shapes,
        serving [64, 8, 4, 128] and validation [64, 8, 3 nv + na, 128],
        fp32 and bf16 (the gate rejecting the self term dropped), timed
        beside its plain version and masked SDPA;
     c. ``RecognitionServer.classify_intervals`` (ensemble 5, batch 64) of
        200 intervals of a synthetic 300 s video in fp32, bf16, int8
        static and bf16 with the fused tail (kernel 1 four times a batch
        on each, kernel 2 only on the last, kernel 3 never): device and
        wall intervals/s; bf16 vs fp32 probabilities within 0.1; int8 vs
        fp32 top-1 agreement >= 0.75 and probabilities within 0.25;
     d. an fp32 train step at depth 2 card vs CPU (losses 1e-4 relative,
        gradients 1e-3 of each largest but the k bias); 2 + 5 bf16
        ``RecognitionRunner`` steps on the banked path at batch 64, every
        dropout on, mixup 0.2, drloc 0.3 (ms a step, windows/s, peak
        memory; kernels 1 and 2 never), one host-path step; the state
        resumed into a fresh runner, one more step from both bit-equal;
     e. ``validate`` banked and host (statistics within 1e-5, kernel 1 four
        times a batch), two banked vote sums bit-equal, and
        ``extract_predictions`` on both paths;
 19. the command lines and the checkpoint gate, on phase 16's and 17's
     splits: ``cli.run`` (banked, bf16, batch 64) ``--variant detection
     --train`` for one epoch (the CLI's EPIC model: 97 verb and 44 audio
     classes), then ``--validate`` and ``--extract_feats --extract_top_k
     8`` resumed from its checkpoint, each against a ``DetectionRunner``
     resumed from the same file (within 1e-3; kernel 1 six times a batch,
     kernel 2 never); ``--variant recognition --validate`` and
     ``--extract_feats`` with ``--torch_checkpoint`` on phase 17's trained
     weights saved in the reference's format, against a
     ``RecognitionRunner`` (kernel 1 four times a batch); then
     ``validate_checkpoint`` on both full-width checkpoints (load, infer,
     convert and contract PASS, parity SKIPs without the reference tree;
     kernel 1 once a layer, kernel 3 twice in the detection contract),
     with each stage's seconds and the contract's numbers;
 20. audio: full-size Auditory SlowFast (R50, width 64, 2304-d feature)
     in fp32 on one clip's spectrogram [1, 1, 200, 128], card vs CPU
     within 1e-3; ``make_audio_apply`` and ``extract_features_for_video``
     with the CLI's clip function over a synthetic 60 s waveform (1.1 s
     records every 0.2 s, a clean and a SpecAugment set, batch 8): device
     and wall clips/s, peak memory, the clean set against per-clip
     forwards (within 1e-4).
The counts are set to 0 just before each serving, extraction or training
run and read just after it (the bias epilogue's count must be the same in
every forward or step of a run, and not 0). Each phase's wall seconds are printed after it,
and all of them on one ``[time]`` line at the end. The line before the last is the kernels' JSON; the
last line is ``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import subprocess
import sys
import time

T_START = time.perf_counter()

import numpy as np
import torch
import torch.nn.functional as F

SEED = 0
# Random heads give scores whose spread no fixed threshold fits: the serving
# phases threshold at the score that about this many candidates clear,
# read off the 2-window run (keeps Soft-NMS to seconds).
TARGET_CANDIDATES = 5000
# Kernel 1 in bf16 is held to attention_close (scaled to its output), the
# others to kernel_close with these bounds.
TOL = {("query_block_attention", "float32"): 1e-4,
       ("fused_post_attention", "float32"): 2e-4,
       ("fused_post_attention", "bfloat16"): 5e-2}
# Kernel 2 in bf16 is also held to ||got - want|| / ||want||: the flat
# bound alone passes a tail without b2 (b2 ~ 0.02 moves z by < 2 spacings
# and 1.2e-2 relative RMS); the same function summed in another order
# differs only where a bf16 rounding flips
FUSED_BF16_REL_RMS = 5e-3
SLICE_TOL = 1e-3         # fp32 card vs fp32 CPU, whole slice
# kernels 4 and 5 vs their plain versions: fp32 sums in another order
# (1e-4 elementwise); bf16 scaled to the output (see attention_close)
ATTN_F32_TOL = 1e-4
ATTN_BF16_FLOOR = 2.0 ** -7      # of max |want|, beside two bf16 spacings
ATTN_BF16_REL_RMS = 1e-2         # ||got - want|| / ||want||
# the kernels' row log-sum-exp (natural log, about 8 at these shapes)
# against torch.logsumexp of the plain fp32 scores: fp32 sums of up to 1568
# exponentials in another order, ex2.approx (relative error 2^-22)
LSE_TOL = 1e-4
# kernel 5 checked at ViT-L's S, the MAE encoder's 160 visible tokens, a
# ragged S and the MAE decoder's 8 heads; timed at batch 8 at the main
# paths' shapes (ViT-L and the MAE encoder: 16 heads; the decoder: 8)
FLASH_CHECK_SHAPES = ((2, 16, 1568), (2, 16, 160), (3, 16, 37), (2, 8, 1568))
FLASH_SHAPES = ((16, 1568), (16, 160), (8, 1568))
# bf16 vs fp32 backbone features, relative to the largest fp32 feature
# (measured 5.9e-3 Swin-B, 4.4e-3 ViT-L; features scaled by 0.98 fail)
BF16_FEATURE_TOL = 1.5e-2
# Swin-B stages on one 32 x 224^2 clip: (windows per clip, heads, token
# grid); N = 16 x 7 x 7 = 784 tokens per window, head dim 32
SWIN_STAGES = ((64, 4, (16, 56, 56)), (16, 8, (16, 28, 28)),
               (4, 16, (16, 14, 14)), (1, 32, (16, 7, 7)))
EXTRACT_CLIPS = 64
BF16_SCORE_TOL = 0.1     # bf16 vs fp32 sigmoid scores
# int8 vs bf16 sigmoid scores: tests/test_quant_accuracy.py's contract
INT8_SCORE_MAX, INT8_SCORE_MEAN = 0.1, 0.01
# The int8 slice amplifies float32 rounding: where the card's and the CPU's
# sums differ by an ulp, an activation may round to the neighbouring int8
# step, and with random weights such flips cascade through the 6 layers
# (a one-ulp change of the input features moves the CPU's own scores by
# ~2e-3, proposals by ~2e-2 s, calibrated scales by ~4e-3; the fp32 model
# moves 1e-7). So the int8 phases hold the card to the CPU's own spread
# under a one-ulp input change, measured in the same run: card vs CPU at
# most ULP_ENVELOPE times that spread (max and mean), or SLICE_TOL where
# the spread is below it.
ULP_ENVELOPE = 4.0
# Card rates (NVIDIA's H100 SXM data sheet, dense): device memory bytes/s
# and tensor-core operations/s by input type
HBM_BYTES_PER_S = 3.35e12
SM_CLOCK_HZ = 1.98e9     # replaced by nvidia-smi's clocks.max.sm in main
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12}


def log(msg: str) -> None:
    print(msg, flush=True)


PHASE_S = {}   # wall seconds of each phase, for the closing [time] line


def timed(name, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` as the phase ``name``: its wall seconds are
    logged and kept in ``PHASE_S``."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    PHASE_S[name] = round(time.perf_counter() - t0, 2)
    log(f"[time] {name}: {PHASE_S[name]:.2f} s")
    return out


def require(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device milliseconds of ``fn`` over ``iters`` launches."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 10, warmup: int = 2):
    """(mean device ms, mean host ms to issue one call) of ``fn``: the
    calls are queued behind a spin kernel that outlasts their issue, so
    the events time the device back to back whatever the host's speed."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    spin_ms = 20.0
    while True:
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        marks[0].record()
        torch.cuda._sleep(int(spin_ms * 1e-3 * SM_CLOCK_HZ))
        marks[1].record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        marks[2].record()
        torch.cuda.synchronize()
        if host_ms < marks[0].elapsed_time(marks[1]):
            return marks[1].elapsed_time(marks[2]) / iters, host_ms / iters
        spin_ms *= 4


def bound(nbytes: float, ops: float, kind: str):
    """(least ms, what bounds it): bytes over the memory rate against
    operations over the peak rate of ``kind``."""
    ms_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    ms_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return (ms_bytes, "bytes") if ms_bytes >= ms_ops else (ms_ops,
                                                          "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def bf16_spacing(want):
    mag = want.float().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def kernel_close(got, want, tol: float) -> bool:
    """Every |got - want| <= tol; for bf16 outputs, <= max(tol, two bf16
    spacings at |want|). Two correct implementations that sum in different
    orders flip bf16 roundings, and a flip carried through LN2 reaches two
    spacings, 0.0625 at |z| in [4, 8), about once in 10^7 outputs (seen on
    the card at batch 16 and 64), so a flat 5e-2 cannot hold at serving
    sizes; below |z| = 4 the flat bound is the binding one."""
    err = (got.float() - want.float()).abs()
    bound_ = torch.full_like(err, tol)
    if got.dtype == torch.bfloat16:
        bound_ = torch.maximum(bound_, 2 * bf16_spacing(want))
    return bool((err <= bound_).all())


def fused_close(got, want):
    """Kernel 2 against its plain version: (ok, max abs error, relative RMS
    error); kernel_close with TOL, and in bf16 also the relative RMS
    within FUSED_BF16_REL_RMS."""
    err = (got.float() - want.float()).abs()
    rel = (err.norm() / want.float().norm()).item()
    dtype = str(got.dtype).split(".")[1]
    ok = kernel_close(got, want, TOL[("fused_post_attention", dtype)])
    if got.dtype == torch.bfloat16:
        ok = ok and rel <= FUSED_BF16_REL_RMS
    return ok, err.max().item(), rel


def tail_with_ln2_over_half(x, attn, ln1_w, ln1_b, w1, b1, w2, b2, ln2_w,
                            ln2_b):
    """A fault, kernel 2's gate's control: the plain tail with LN2's
    statistics taken over the first half of each row only."""
    from tim_tpu_torch.ops import fused_post_attention as fpa
    dt = x.dtype
    y = fpa.layer_norm_fp32(x + attn, ln1_w, ln1_b).to(dt)
    h = F.gelu(fpa._matmul_bias(y, w1, b1).float(),
               approximate="none").to(dt)
    s = (y + fpa._matmul_bias(h, w2, b2)).float()
    half = s[..., :s.shape[-1] // 2]
    mu = half.mean(-1, keepdim=True)
    var = torch.clamp((half * half).mean(-1, keepdim=True) - mu * mu, min=0)
    return ((s - mu) * torch.rsqrt(var + fpa.EPS) * ln2_w + ln2_b).to(dt)


def attention_close(got, want):
    """Kernels 4 and 5 against their plain versions: (ok, max abs error,
    relative RMS error). fp32: every |got - want| <= ATTN_F32_TOL. bf16:
    attention outputs are small (about sqrt(e / S) for unit-variance
    scores: 0.04 at S = 1568), so kernels 1 and 2's flat 5e-2 would pass a
    kernel that shrinks every output by 20%. Here every |got - want| <= two
    bf16 spacings at |want| plus ATTN_BF16_FLOOR * max |want|, and
    ||got - want|| / ||want|| <= ATTN_BF16_REL_RMS. The probabilities are
    rounded to bf16 before normalising in the kernel and after it in the
    plain version, which two correct kernels differ by."""
    err = (got.float() - want.float()).abs()
    rel = (err.norm() / want.float().norm()).item()
    if got.dtype != torch.bfloat16:
        ok = bool((err <= ATTN_F32_TOL).all())
    else:
        floor = ATTN_BF16_FLOOR * want.float().abs().max()
        ok = (bool((err <= 2 * bf16_spacing(want) + floor).all())
              and rel <= ATTN_BF16_REL_RMS)
    return ok, err.max().item(), rel


def query_block_close(got, want):
    """Kernel 1 against its plain version: (ok, max abs error, relative RMS
    error). fp32 within TOL; bf16 by attention_close: its outputs are about
    0.1 in size, so a flat 5e-2 would pass a kernel that drops the self
    term (weight about 1 / (F + 1)), and the tensor-core kernel rounds the
    probabilities to bf16 before P V, where the plain version keeps fp32."""
    if got.dtype == torch.bfloat16:
        return attention_close(got, want)
    err = (got.float() - want.float()).abs()
    tol = TOL[("query_block_attention", "float32")]
    return (bool((err <= tol).all()), err.max().item(),
            (err.norm() / want.float().norm()).item())


def query_block_without_self(qq, kc, kq, vc, vq):
    """A fault, kernel 1's gate's control: the plain version with the self
    term's value dropped (its weight still in the denominator)."""
    scale = 1.0 / qq.shape[-1] ** 0.5
    q = qq.float() * scale
    scores = torch.matmul(q, kc.float().transpose(-1, -2))
    self_scores = (q * kq.float()).sum(-1, keepdim=True)
    m = torch.maximum(scores.amax(-1, keepdim=True), self_scores)
    e_ctx = torch.exp(scores - m)
    denom = e_ctx.sum(-1, keepdim=True) + torch.exp(self_scores - m)
    return torch.matmul(e_ctx / denom, vc.float()).to(qq.dtype)


def online_attention(s, v, tile: int = 64, rescale_sum: bool = True):
    """softmax(s) v as kernels 4 and 5 compute it, from fp32 scores s
    [..., N, N]: an online softmax over key tiles of ``tile``, the fp32
    running sum of the unnormalised probabilities, those probabilities
    rounded to v's dtype for the PV product, one rounding of the output.
    ``rescale_sum=False`` is a fault, the bf16 gate's control: the running
    sum is not rescaled when the running max grows, so outputs shrink."""
    m = torch.full(s.shape[:-1], float("-inf"), device=s.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(*s.shape[:-1], v.shape[-1], device=s.device)
    for j in range(0, s.shape[-1], tile):
        st = s[..., j:j + tile]
        m_new = torch.maximum(m, st.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(st - m_new[..., None])
        l = (l * corr if rescale_sum else l) + p.sum(-1)
        acc = (acc * corr[..., None]
               + p.to(v.dtype).float() @ v[..., j:j + tile, :].float())
        m = m_new
    return (acc / l[..., None]).to(v.dtype)


def int8_close(got, want) -> bool:
    """Kernel 3 against its plain version: the int8 operands and int32 sums
    are identical, so fp32 outputs differ only by the epilogue's erf (one
    ulp; 1 + erf cancels for y < -2, hence the 1e-5 absolute floor beside
    1e-5 relative), and bf16 outputs by at most one output spacing."""
    err = (got.float() - want.float()).abs()
    if got.dtype == torch.bfloat16:
        return bool((err <= bf16_spacing(want)).all())
    return bool((err <= 1e-5 + 1e-5 * want.float().abs()).all())


def phase_linear_rounding(gen):
    """The bf16 linear on the card against its own fp32-accumulator
    reference rounded per kind (TORCH_LINEAR: fp32 sum + fp32 bias, one
    rounding; DENSE: the product rounded, then + the bf16 bias in bf16):
    bit-equal where every fp32 sum is exact (signed powers of two), and
    within a rounding flip in at most 1% of the outputs (sums in another
    order) on normal inputs at ViT-L's qkv and fc1 shapes; timed beside
    ``F.linear`` with a bf16 bias (the route before the repair)."""
    from tim_tpu_torch.models.common import DENSE, TORCH_LINEAR, linear

    def want(x, w, b, kind):
        acc = x.float() @ w.to(torch.bfloat16).float().t()
        if kind == TORCH_LINEAR:
            return (acc + b).to(torch.bfloat16)
        return acc.to(torch.bfloat16) + b.to(torch.bfloat16)

    def pow2(*shape, lo):
        e = torch.randint(lo, 1, shape, generator=gen, device="cuda")
        sign = torch.randint(-1, 2, shape, generator=gen, device="cuda")
        return torch.exp2(e.float()) * sign

    report = {}
    for kind in (TORCH_LINEAR, DENSE):
        x, w = pow2(4, 37, 64, lo=-3), pow2(96, 64, lo=-4)
        b = torch.rand(96, generator=gen, device="cuda") * 4 - 2
        got = linear(x, w, b, torch.bfloat16, rounding=kind)
        require(torch.equal(got, want(x.to(torch.bfloat16), w, b, kind)),
                f"bf16 linear ({kind}) differs from its fp32 reference on "
                f"exact sums")
        for n_out in (3072, 4096):
            x = torch.randn(8 * 1568, 1024, generator=gen,
                            device="cuda").to(torch.bfloat16)
            w = torch.randn(n_out, 1024, generator=gen, device="cuda") * 0.03
            b = torch.randn(n_out, generator=gen, device="cuda")
            got = linear(x, w, b, torch.bfloat16, rounding=kind)
            share = (got != want(x, w, b, kind)).float().mean().item()
            wb, bb = w.to(torch.bfloat16), b.to(torch.bfloat16)
            row = {"mismatch_share": share,
                   "ms": cuda_ms(lambda: linear(x, w, b, torch.bfloat16,
                                                rounding=kind)),
                   "previous_ms": cuda_ms(lambda: F.linear(x, wb, bb))}
            log(f"[linear] {kind} [12544, 1024] -> {n_out}: rounding flips "
                f"in {share:.2e} of the outputs; {row['ms']:.4f} ms "
                f"(previous route {row['previous_ms']:.4f} ms)")
            require(share <= 1e-2, f"bf16 linear ({kind}) differs from "
                    f"its fp32 reference in {share} of the outputs")
            report[f"{kind}_{n_out}"] = row
    return report


def check_bias_act(gen):
    """The bias epilogue kernel against its plain version at the main
    paths' shapes (ViT-L's qkv and fc1, Swin-B's stage-1 fc1 and qkv, a
    detection regression head's 2 columns), then timed at ViT-L's fc1 and
    qkv."""
    from tim_tpu_torch.ops.bias_act import bias_act, bias_act_plain
    worst = 0.0
    cases = ((8 * 1568, 3072, torch.float32, False),
             (8 * 1568, 4096, torch.bfloat16, True),
             (8 * 16 * 56 * 56, 512, torch.bfloat16, True),
             (8 * 16 * 56 * 56, 384, torch.bfloat16, False),
             (8 * 1568, 4096, torch.float32, True),
             (4 * 399, 2, torch.float32, False),
             (37, 12, torch.bfloat16, True))
    for rows, cols, dtype, gelu in cases:
        y = (torch.randn(rows, cols, generator=gen, device="cuda") * 3).to(
            dtype)
        b = torch.randn(cols, generator=gen, device="cuda")
        got, pre = bias_act(y, b, gelu=gelu, keep_pre=True)
        torch.cuda.synchronize()
        want, h = bias_act_plain(y, b, gelu=gelu)
        err = max_err(got, want)
        flips = (got != want).float().mean().item()
        tag = (f"[{rows}, {cols}] {str(dtype)[6:]} in"
               f"{' + GELU' if gelu else ''}")
        log(f"[linear] bias_act {tag}: max_abs_err={err:.3e}, "
            f"{flips:.2e} of the outputs differ")
        # bit-equal, the GELU included: JAX's bf16 steps on both sides,
        # erfc from the same CUDA library
        require(torch.equal(got, want) and (pre is None or torch.equal(pre, h)),
                f"bias_act {tag} disagrees with its plain version")
        worst = max(worst, err)
    rows, cols = 8 * 1568, 4096
    y = torch.randn(rows, cols, generator=gen, device="cuda").to(
        torch.bfloat16)
    b = torch.randn(cols, generator=gen, device="cuda")
    ms_bound, by = bound(nbytes(y, b) + rows * cols * 2, 0, "bf16")
    report = {"max_abs_err": worst,
              "ms": cuda_ms(lambda: bias_act(y, b, gelu=True)),
              "plain_ms": cuda_ms(lambda: bias_act_plain(y, b, gelu=True)),
              "library_ms": None, "bound_ms": ms_bound, "bound_by": by}
    y32 = torch.randn(rows, 3072, generator=gen, device="cuda")
    b32 = torch.randn(3072, generator=gen, device="cuda")
    report["fp32_in_ms"] = cuda_ms(lambda: bias_act(y32, b32, gelu=False))
    fp32_in_bound = bound(nbytes(y32, b32) + rows * 3072 * 2, 0, "bf16")[0]
    log(f"[linear] bias_act [{rows}, {cols}] bf16 + GELU (ViT-L fc1): "
        f"kernel {report['ms']:.4f} ms, plain {report['plain_ms']:.4f} ms, "
        f"bound {ms_bound:.4f} ms ({by}); fp32 in [{rows}, 3072] (ViT-L "
        f"qkv) {report['fp32_in_ms']:.4f} ms, bound "
        f"{fp32_in_bound:.4f} ms")
    return report


def qkv_views(batch, dtype, gen):
    """q/k/v of one layer as the model hands them to attention: strided
    [B, H, S, dh] views of one packed projection."""
    from tim_tpu_torch import config as C
    from tim_tpu_torch.models.queries import generate_query_pyramid
    cfg = C.epic_detection()
    nq = generate_query_pyramid(cfg.inference_query_size).shape[0]
    s = cfg.num_context + 2 * nq
    width, heads = cfg.encoder_width, cfg.nhead
    qkv = torch.randn(batch, s, 3 * width, generator=gen, device="cuda")
    q, k, v = qkv.to(dtype).view(batch, s, 3, heads, width // heads).permute(
        2, 0, 3, 1, 4)
    f = cfg.num_context
    return (q[:, :, f:], k[:, :, :f], k[:, :, f:], v[:, :, :f], v[:, :, f:])


def tail_args(batch, dtype, gen, seq=898, c=1024, ff=2048):
    """Inputs of one encoder layer's post-attention tail (the detection
    layer's shapes by default)."""

    def u(*shape, bound):
        return (torch.rand(*shape, generator=gen, device="cuda") * 2 - 1) * bound

    x = torch.randn(batch, seq, c, generator=gen, device="cuda").to(dtype)
    attn = torch.randn(batch, seq, c, generator=gen, device="cuda").to(dtype)
    return (x, attn, 1 + u(c, bound=0.5), u(c, bound=0.1),
            u(ff, c, bound=c ** -0.5), u(ff, bound=c ** -0.5),
            u(c, ff, bound=ff ** -0.5), u(c, bound=ff ** -0.5),
            1 + u(c, bound=0.5), u(c, bound=0.1))


def unfused_tail(x, attn, ln1_w, ln1_b, w1, b1, w2, b2, ln2_w, ln2_b):
    """What EncoderLayer runs with use_fused_ffn=False: library bf16 GEMMs
    and separate LN/GELU/residual passes. Timed beside the kernel, since the
    plain version's products run in fp32."""
    from tim_tpu_torch.models.common import TORCH_LINEAR, linear
    from tim_tpu_torch.ops.fused_post_attention import layer_norm_fp32
    dt = x.dtype
    y = layer_norm_fp32(x + attn, ln1_w, ln1_b).to(dt)
    h = linear(linear(y, w1, b1, dt, rounding=TORCH_LINEAR, gelu=True), w2,
               b2, dt, rounding=TORCH_LINEAR)
    return layer_norm_fp32(y + h, ln2_w, ln2_b).to(dt)


def masked_sdpa_args(qq, kc, kq, vc, vq):
    """The query block as one library attention call: keys [kc || kq],
    values [vc || vq], a boolean mask allowing every context key and the
    query's own key."""
    nq, f = qq.shape[2], kc.shape[2]
    mask = torch.zeros(nq, f + nq, dtype=torch.bool, device=qq.device)
    mask[:, :f] = True
    mask[:, f:] = torch.eye(nq, dtype=torch.bool, device=qq.device)
    return qq, torch.cat([kc, kq], 2), torch.cat([vc, vq], 2), mask


def int8_head_args(batch, n, dtype, gen, *, bias=True, seq=898,
                   rows=(100, 499), k=1024):
    """Inputs of one int8 class head as the model hands them over: x the
    strided [B, rows, K] query slice of a [B, seq, K] encoder output, w_q
    [N, K] int8, per-channel scales that keep y near unit size, a static
    activation scale from x's abs-max."""
    x = torch.randn(batch, seq, k, generator=gen, device="cuda").to(dtype)
    xv = x[:, rows[0]:rows[1]]
    w_q = torch.randint(-127, 128, (n, k), generator=gen, device="cuda",
                        dtype=torch.int8)
    w_scale = (0.5 + torch.rand(n, generator=gen, device="cuda")) * 3e-4
    b = (torch.randn(n, generator=gen, device="cuda") * 0.1 if bias
         else None)
    act_scale = xv.float().abs().amax().item() / 127.0
    return xv, w_q, w_scale, act_scale, b


def int8_library_route(x, w_q_padded, w_scale, act_scale, bias, n):
    """Kernel 3's function from library calls: quantize, ``torch._int_mm``
    over N padded to a multiple of 8, dequantize + bias epilogue."""
    from tim_tpu_torch.ops.int8_matmul_fused import _scales
    inv_sx, sx = _scales(act_scale)
    x2 = x.reshape(-1, x.shape[-1]).float()
    xq = torch.clamp(torch.round(x2 * inv_sx), -127, 127).to(torch.int8)
    acc = torch._int_mm(xq, w_q_padded.t())[:, :n]
    return (acc.float() * (sx * w_scale) + bias).to(x.dtype)


def phase_kernels():
    from tim_tpu_torch.ops import fused_post_attention as fpa
    from tim_tpu_torch.ops import query_block_attention as qba

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    kernels = {
        "query_block_attention": (qba.query_block_attention,
                                  qba.query_block_attention_plain, qkv_views),
        "fused_post_attention": (fpa.fused_post_attention,
                                 fpa.fused_post_attention_plain, tail_args),
    }

    def close(name, got, want):
        """(ok, max abs error, description of the bound)"""
        if name == "query_block_attention":
            ok, err, rel = query_block_close(got, want)
            return ok, err, (f"relative RMS {rel:.3e}; attention_close"
                             if got.dtype == torch.bfloat16
                             else f"tol {TOL[(name, 'float32')]}")
        tol = TOL[(name, str(got.dtype).split(".")[1])]
        ok, err, rel = fused_close(got, want)
        return ok, err, (f"tol {tol}, relative RMS {rel:.3e}"
                         + (f" (<= {FUSED_BF16_REL_RMS})"
                            if got.dtype == torch.bfloat16 else ""))

    report = {}
    for name, (kernel, plain, make) in kernels.items():
        for dtype in (torch.float32, torch.bfloat16):
            args = make(16, dtype, gen)
            got = kernel(*args)
            torch.cuda.synchronize()
            want = plain(*args)
            ok, err, how = close(name, got, want)
            log(f"[kernels] {name} {dtype} B=16: max_abs_err={err:.3e} "
                f"({how})")
            require(ok, f"{name} {dtype} disagrees with its plain version: "
                    f"max abs {err} ({how})")
        args = make(128, torch.bfloat16, gen)
        got, want = kernel(*args), plain(*args)
        ok, err, how = close(name, got, want)
        require(ok, f"{name} bf16 B=128 disagrees: max abs {err} ({how})")
        if name == "query_block_attention":
            # the gate must reject a kernel that drops the self term or
            # shrinks every output by 2%
            for cname, bad in (("self term dropped",
                                query_block_without_self(*args)),
                               ("output x 0.98",
                                (want.float() * 0.98).to(want.dtype))):
                c_ok, c_err, c_rel = query_block_close(bad, want)
                log(f"[kernels] {name} bf16 B=128 control '{cname}': max "
                    f"abs {c_err:.3e}, relative RMS {c_rel:.3e}, "
                    f"{'passes' if c_ok else 'rejected'}")
                require(not c_ok, f"{name}: the bf16 gate passes the faulty "
                        f"control '{cname}'")
                del bad
        else:
            # the gate must reject a tail without b2 and one whose LN2
            # takes its statistics over half of each row
            no_b2 = list(args)
            no_b2[7] = torch.zeros_like(args[7])
            for cname, bad in (("b2 omitted", plain(*no_b2)),
                               ("LN2 statistics over half the row",
                                tail_with_ln2_over_half(*args))):
                c_ok, c_err, c_rel = fused_close(bad, want)
                log(f"[kernels] {name} bf16 B=128 control '{cname}': max "
                    f"abs {c_err:.3e}, relative RMS {c_rel:.3e}, "
                    f"{'passes' if c_ok else 'rejected'}")
                require(not c_ok, f"{name}: the bf16 gate passes the faulty "
                        f"control '{cname}'")
                del bad
            del no_b2
        out_bytes = nbytes(got)
        del got, want
        ms = cuda_ms(lambda: kernel(*args))
        plain_ms = cuda_ms(lambda: plain(*args))
        log(f"[kernels] {name} bf16 B=128: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, max_abs_err={err:.3e}")
        report[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        if name == "query_block_attention":
            qq, kc = args[0], args[1]
            b, h, nq, dh = qq.shape
            f = kc.shape[2]
            # scores and weighted values over F context keys plus self
            ops = 4 * b * h * nq * (f + 1) * dh
            sdpa = masked_sdpa_args(*args)
            lib_err = max_err(F.scaled_dot_product_attention(
                sdpa[0], sdpa[1], sdpa[2], attn_mask=sdpa[3]),
                kernel(*args))
            report[name]["library_ms"] = cuda_ms(
                lambda: F.scaled_dot_product_attention(
                    sdpa[0], sdpa[1], sdpa[2], attn_mask=sdpa[3]))
            log(f"[kernels] {name} bf16 B=128: masked "
                f"scaled_dot_product_attention {report[name]['library_ms']:.4f}"
                f" ms (max abs diff to the kernel {lib_err:.3e})")
            del sdpa
        else:
            x, w1 = args[0], args[4]
            ops = 2 * 2 * (x.numel() // x.shape[-1]) * x.shape[-1] * w1.shape[0]
            report[name]["library_ms"] = cuda_ms(lambda: unfused_tail(*args))
            # a yardstick of the product part alone: the two bare bf16
            # products through the library
            y = x.reshape(-1, x.shape[-1])
            w1b, w2b = w1.to(y.dtype), args[6].to(y.dtype)
            h = torch.matmul(y, w1b.t())
            report[name]["products_matmul_ms"] = cuda_ms(
                lambda: torch.matmul(torch.matmul(y, w1b.t()), w2b.t()))
            report[name]["product_ms"] = cuda_ms(
                lambda: torch.matmul(y, w1b.t())), cuda_ms(
                lambda: torch.matmul(h, w2b.t()))
            del y, h, w1b, w2b
            log(f"[kernels] {name} bf16 B=128: unfused library-GEMM tail "
                f"{report[name]['library_ms']:.4f} ms; the two bare bf16 "
                f"products (torch.matmul) "
                f"{report[name]['products_matmul_ms']:.4f} ms "
                f"({report[name]['product_ms'][0]:.4f} + "
                f"{report[name]['product_ms'][1]:.4f})")
        report[name]["bound_ms"], report[name]["bound_by"] = bound(
            nbytes(*args) + out_bytes, ops, "bf16")
        report[name]["share_of_bound"] = (report[name]["bound_ms"]
                                          / report[name]["ms"])
        log(f"[kernels] {name} bf16 B=128: bound "
            f"{report[name]['bound_ms']:.4f} ms ({report[name]['bound_by']}"
            f"; {100 * report[name]['share_of_bound']:.1f}% of it reached)")
        del args
        torch.cuda.empty_cache()
    report["int8_matmul_fused"] = phase_kernel_int8(gen)
    return report


def phase_kernel_int8(gen):
    """Kernel 3 against its plain version, then timed at both serving
    heads (fc_action N 3806, fc_audio N 44; 128 windows x 399 queries)
    beside the library route, its bare product (``torch._int_mm`` of
    pre-quantized rows, N padded to a multiple of 8) and a bf16
    ``F.linear``."""
    from tim_tpu_torch.ops import int8_matmul_fused as i8

    worst, cases_run = 0.0, 0
    for n in (3806, 44, 256):
        for dtype in (torch.float32, torch.bfloat16):
            for bias, act in ((False, None), (True, None), (True, "gelu")):
                x, w_q, w_scale, sx, b = int8_head_args(3, n, dtype, gen,
                                                        bias=bias)
                cases = [("strided", x)]
                if n == 256:   # ragged 2-D rows, contiguous
                    cases.append(("2-D", x[0, :333].contiguous()))
                for layout, xin in cases:
                    got = i8.int8_matmul_fused(xin, w_q, w_scale, sx, b, act,
                                               out_dtype=dtype)
                    torch.cuda.synchronize()
                    want = i8.int8_matmul_fused_plain(
                        xin, w_q, w_scale, sx, b, act, out_dtype=dtype)
                    err = max_err(got, want)
                    worst = max(worst, err)
                    cases_run += 1
                    require(got.shape == want.shape and int8_close(got, want),
                            f"int8_matmul_fused N={n} {dtype} bias={bias} "
                            f"act={act} {layout} disagrees with its plain "
                            f"version: max abs {err}")
    log(f"[kernels] int8_matmul_fused: {cases_run} cases (N 3806/44/256, "
        f"fp32/bf16, "
        f"bias, GELU, ragged M, strided and 2-D x) agree with the plain "
        f"version, max abs err {worst:.3e}")

    seq = torch.randn(128, 898, 1024, generator=gen, device="cuda").to(
        torch.bfloat16)
    shapes = []
    for head, n, rows in (("fc_action", 3806, (100, 499)),
                          ("fc_audio", 44, (499, 898))):
        x = seq[:, rows[0]:rows[1]]
        w_q = torch.randint(-127, 128, (n, 1024), generator=gen,
                            device="cuda", dtype=torch.int8)
        w_scale = (0.5 + torch.rand(n, generator=gen, device="cuda")) * 3e-4
        b = torch.randn(n, generator=gen, device="cuda") * 0.1
        sx = x.float().abs().amax().item() / 127.0
        args = (x, w_q, w_scale, sx, b)
        got = i8.int8_matmul_fused(*args)
        want = i8.int8_matmul_fused_plain(*args)
        err = max_err(got, want)
        require(int8_close(got, want), f"int8_matmul_fused {head} serving "
                f"shape disagrees: max abs {err}")
        m = x.numel() // x.shape[-1]
        ms_bound, by = bound(nbytes(x, w_q, w_scale, b, got),
                             2 * m * 1024 * n, "int8")
        del got, want
        w_pad = F.pad(w_q, (0, 0, 0, -n % 8))
        w_bf16 = (w_q.float() * w_scale[:, None]).to(torch.bfloat16)
        b_bf16 = b.to(torch.bfloat16)
        inv_sx = i8._scales(sx)[0]
        xq = torch.clamp(torch.round(x.reshape(m, 1024).float() * inv_sx),
                         -127, 127).to(torch.int8)
        row = {
            "head": head, "m": m, "k": 1024, "n": n, "max_abs_err": err,
            "ms": cuda_ms(lambda: i8.int8_matmul_fused(*args)),
            "plain_ms": cuda_ms(lambda: i8.int8_matmul_fused_plain(*args)),
            "library_ms": cuda_ms(lambda: int8_library_route(
                x, w_pad, w_scale, sx, b, n)),
            "int_mm_ms": cuda_ms(lambda: torch._int_mm(xq, w_pad.t())),
            "bf16_linear_ms": cuda_ms(lambda: F.linear(x, w_bf16, b_bf16)),
            "bound_ms": ms_bound, "bound_by": by}
        log(f"[kernels] int8_matmul_fused {head} [{m} x 1024] -> {n} bf16: "
            f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
            f"library route (quantize + _int_mm + epilogue) "
            f"{row['library_ms']:.4f} ms, its bare product (_int_mm, N "
            f"{n + -n % 8}) {row['int_mm_ms']:.4f} ms, bf16 F.linear "
            f"{row['bf16_linear_ms']:.4f} ms, bound {ms_bound:.4f} ms ({by}, "
            f"{100 * ms_bound / row['ms']:.1f}% of it reached), "
            f"max_abs_err={err:.3e}")
        del xq
        shapes.append(row)
        del args
    del seq
    torch.cuda.empty_cache()
    action = shapes[0]
    return {"max_abs_err": max(worst, *(r["max_abs_err"] for r in shapes)),
            **{k: action[k] for k in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms")},
            "per_head": shapes}


def window_batch(cfg, n, rng):
    f = cfg.num_feats
    return {
        "v_feats": rng.normal(size=(n, f, cfg.visual_input_dim)),
        "a_feats": rng.normal(size=(n, f, cfg.audio_input_dim)),
        "times": np.sort(rng.uniform(0, 1, size=(n, cfg.num_context, 2)), -1),
        "window_start": np.arange(n, dtype=np.float64),
        "window_size": np.full(n, 30.0),
    }


def to_torch(batch, device):
    return {k: torch.from_numpy(np.asarray(v, np.float32)).to(device)
            for k, v in batch.items()}


def compare_outputs(tag, gpu_out, cpu_out, tol):
    require(sorted(gpu_out) == sorted(cpu_out), f"{tag}: output keys differ")
    for key in sorted(cpu_out):
        g, c = gpu_out[key].cpu(), cpu_out[key]
        require(tuple(g.shape) == tuple(c.shape)
                and bool(torch.isfinite(g).all()),
                f"{tag} {key}: shape {tuple(g.shape)} vs {tuple(c.shape)} "
                f"or non-finite")
        err = max_err(g, c)
        log(f"[{tag}] {key} {tuple(g.shape)}: max_abs_err={err:.3e}")
        require(err <= tol, f"{tag} {key}: card vs CPU {err} > {tol}")


def phase_slice_fp32(rng):
    from tim_tpu_torch import config as C
    from tim_tpu_torch.models import TimDetection
    from tim_tpu_torch.train.detection import make_inference_step

    cfg = C.epic_detection(compute_dtype="float32", use_fused_ffn=True)
    t0 = time.perf_counter()
    cpu_model = TimDetection(cfg, device="cpu",
                             generator=torch.Generator().manual_seed(SEED))
    # With random weights the regression heads' two sigmoids sit near one
    # constant pair, often with end < start, which the eval chain drops as
    # empty. Bias them apart so that the proposals are intervals.
    with torch.no_grad():
        for mlp in (cpu_model.reg_head.fc_visual_action,
                    cpu_model.reg_head.fc_audio_action):
            mlp[4].bias.copy_(torch.tensor([-1.0, 1.0]))
    state_dict = cpu_model.state_dict()
    gpu_model = TimDetection(cfg, device="cuda")
    gpu_model.load_state_dict(state_dict, strict=True)
    log(f"[slice-fp32] built full-width TimDetection "
        f"({sum(p.numel() for p in cpu_model.parameters())} params) in "
        f"{time.perf_counter() - t0:.2f} s")

    batch = window_batch(cfg, 2, rng)
    gpu_out = make_inference_step(gpu_model, cfg)(to_torch(batch, "cuda"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cpu_out = make_inference_step(cpu_model, cfg)(to_torch(batch, "cpu"))
    log(f"[slice-fp32] CPU plain forward of 2 windows: "
        f"{time.perf_counter() - t0:.2f} s")
    compare_outputs("slice-fp32", gpu_out, cpu_out, SLICE_TOL)
    return state_dict, batch, gpu_out


def synthetic_video(cfg, rng):
    """~300 s video, a feature every 0.2 s, feat_stride 3 (30 s windows)."""
    duration, gap = 300.0, 0.2
    steps = int(duration / gap)
    starts = (np.arange(steps) * gap).astype(np.float32)
    feat_times = np.stack([starts, starts + 1.0], -1)
    v = rng.normal(size=(steps, cfg.visual_input_dim)).astype(np.float32)
    a = rng.normal(size=(steps, cfg.audio_input_dim)).astype(np.float32)
    return v, a, feat_times, duration


def launch_counters():
    from tim_tpu_torch.ops import bias_act as ba
    from tim_tpu_torch.ops import flash_mha as fm
    from tim_tpu_torch.ops import fused_post_attention as fpa
    from tim_tpu_torch.ops import int8_matmul_fused as i8
    from tim_tpu_torch.ops import query_block_attention as qba
    from tim_tpu_torch.ops import window_attention as wa
    return {"query_block_attention": qba.query_block_attention,
            "fused_post_attention": fpa.fused_post_attention,
            "int8_matmul_fused": i8.int8_matmul_fused,
            "window_attention": wa.window_attention,
            "flash_mha": fm.flash_mha,
            "window_attention_bwd": wa.window_attention_bwd,
            "flash_mha_bwd": fm.flash_mha_bwd,
            "bias_act": ba.bias_act}


def attention_launches(launches):
    """The launches of the TPU kernels' counterparts, without the bias
    epilogue of the bf16 linears."""
    return sum(n for name, n in launches.items() if name != "bias_act")


def require_steady(tag, launches, calls):
    """The bias epilogue of the bf16 linears launched the same number of
    times, at least once, in each of ``calls`` forwards or steps."""
    n = launches["bias_act"]
    require(n > 0 and n % calls == 0, f"{tag}: bias_act launched {n} "
            f"times in {calls} calls")


def serve_run(tag, server, video, threshold):
    """One warm-up and one measured ``detect_video`` with every kernel's
    count set to 0 just before the measured call and read just after it.
    Returns (launches, batches, metrics)."""
    import tim_tpu_torch.serve as serve_mod

    v, a, feat_times, duration = video
    n_windows = len(server._window_starts(duration))
    n_batches = -(-n_windows // server.batch_size)
    counters = launch_counters()
    events, candidates = [], []
    infer = server._infer
    threshold_topk = serve_mod.threshold_predictions_topk

    def timed_infer(batch):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = infer(batch)
        end.record()
        events.append((start, end))
        return out

    def counting_threshold(*args, **kwargs):
        cands = threshold_topk(*args, **kwargs)
        candidates.append(sum(len(c["scores"]) for c in cands.values()))
        return cands

    server._infer = timed_infer
    serve_mod.threshold_predictions_topk = counting_threshold
    try:
        server.detect_video(v, a, feat_times, duration,
                            score_threshold=threshold)   # warm-up
        events.clear()
        candidates.clear()
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dets = server.detect_video(v, a, feat_times, duration,
                                   score_threshold=threshold)
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
    finally:
        serve_mod.threshold_predictions_topk = threshold_topk
        server._infer = infer

    device_ms = sum(s.elapsed_time(e) for s, e in events)
    log(f"[{tag}] {n_windows} windows in {n_batches} batches of "
        f"{server.batch_size}: device part {device_ms:.3f} ms")
    log(f"[{tag}] device windows/s {n_windows / (device_ms / 1e3):.2f} "
        f"({n_batches * server.batch_size / (device_ms / 1e3):.2f} incl. "
        f"padding)")
    log(f"[{tag}] wall windows/s {n_windows / wall:.2f} (detect_video "
        f"{wall:.3f} s)")
    log(f"[{tag}] candidates {candidates[0]}, detections "
        f"{len(dets['scores'])}, launches {launches}")
    require(len(dets["scores"]) > 0, f"{tag}: no detections")
    segs = dets["segments"]
    require(bool(np.isfinite(segs).all() and np.isfinite(dets["scores"]).all()),
            f"{tag}: non-finite detections")
    require(bool((segs[:, 1] > segs[:, 0]).all()), f"{tag}: empty segments")
    require(bool((np.diff(dets["scores"]) <= 1e-6).all()),
            f"{tag}: detections not score-sorted")
    return launches, n_batches, {
        "windows": n_windows, "batches": n_batches, "device_ms": device_ms,
        "windows_per_s": n_windows / (device_ms / 1e3), "wall_s": wall,
        "wall_windows_per_s": n_windows / wall, "candidates": candidates[0],
        "detections": len(dets["scores"])}


def require_launches(tag, launches, per_batch, n_batches):
    for name, count in per_batch.items():
        require(launches[name] == count * n_batches,
                f"{tag}: {name} launched {launches[name]} times, expected "
                f"{count} x {n_batches} batches")


def phase_serve_bf16(state_dict, batch2, fp32_out, video):
    from tim_tpu_torch import config as C
    from tim_tpu_torch.serve import DetectionServer
    from tim_tpu_torch.train.detection import make_inference_step

    cfg = C.epic_detection(compute_dtype="bfloat16", use_fused_ffn=True)
    server = DetectionServer(cfg, state_dict, device="cuda",
                             batch_size=128, top_k=8)

    # bf16 vs fp32 scores on the 2 windows of the fp32 phase
    out16 = make_inference_step(server.model, cfg)(to_torch(batch2, "cuda"))
    diff = max(max_err(out16[k], fp32_out[k]) for k in ("v_scores", "a_scores"))
    log(f"[serve-bf16] bf16 vs fp32 sigmoid scores, 2 windows: max abs "
        f"diff {diff:.4e} (tol {BF16_SCORE_TOL})")
    require(diff <= BF16_SCORE_TOL, f"bf16 scores drift {diff}")
    top = torch.sort(out16["v_scores"].flatten(), descending=True).values
    n_windows_est = len(server._window_starts(video[3]))
    per_window = TARGET_CANDIDATES / n_windows_est
    threshold = top[int(per_window * len(batch2["times"]))].item()
    log(f"[serve-bf16] score threshold {threshold:.6f}: the score "
        f"{TARGET_CANDIDATES} candidates over {n_windows_est} windows would "
        f"clear if every window scored like these 2")

    launches, n_batches, metrics = serve_run("serve-bf16", server, video,
                                             threshold)
    require_launches("serve-bf16", launches,
                     {"query_block_attention": cfg.num_layers,
                      "fused_post_attention": cfg.num_layers,
                      "int8_matmul_fused": 0}, n_batches)
    metrics["bf16_vs_fp32"] = diff
    return launches, metrics, out16, threshold


def one_ulp_up(batch):
    """The batch with its feature inputs one float32 ulp larger."""
    out = dict(batch)
    for key in ("v_feats", "a_feats"):
        out[key] = batch[key] * (1 + 2.0 ** -23)
    return out


def phase_int8_slice_fp32(state_dict, batch2):
    from tim_tpu_torch import config as C
    from tim_tpu_torch.models import TimDetection
    from tim_tpu_torch.serve import DetectionServer
    from tim_tpu_torch.train.detection import make_inference_step

    cfg = C.epic_detection(compute_dtype="float32", quantized_inference=True,
                           quant_pallas_heads=True)
    cpu_batch = to_torch(batch2, "cpu")
    t0 = time.perf_counter()
    server = DetectionServer.quantized(cfg, state_dict,
                                       [to_torch(batch2, "cuda")],
                                       device="cuda")
    log(f"[int8-slice-fp32] DetectionServer.quantized (quantize + calibrate "
        f"on 2 windows) on the card: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    cpu_scales = [dict(DetectionServer.quantized(
        cfg, state_dict, [b], device="cpu").cfg.quant_act_scales)
        for b in (cpu_batch, one_ulp_up(cpu_batch))]
    log(f"[int8-slice-fp32] the same twice on the CPU (inputs and inputs "
        f"one ulp up): {time.perf_counter() - t0:.2f} s")
    card = dict(server.cfg.quant_act_scales)
    cpu, cpu_up = cpu_scales
    require(sorted(card) == sorted(cpu) and len(card) == 4 * cfg.num_layers + 2,
            f"calibrated layers differ: {sorted(card)} vs {sorted(cpu)}")
    rel = max(abs(card[k] - cpu[k]) / cpu[k] for k in cpu)
    spread = max(abs(cpu_up[k] - cpu[k]) / cpu[k] for k in cpu)
    log(f"[int8-slice-fp32] {len(card)} calibrated scales, card vs CPU max "
        f"relative diff {rel:.3e}; CPU vs CPU one ulp up {spread:.3e} "
        f"(limit {ULP_ENVELOPE} x that)")
    require(rel <= max(1e-6, ULP_ENVELOPE * spread),
            f"calibrated scales differ by {rel}, spread {spread}")

    # the card's model (its scales and int8 weights) on the CPU
    cpu_model = TimDetection(server.cfg, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in
                               server.model.state_dict().items()},
                              strict=True)
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    gpu_out = make_inference_step(server.model, server.cfg)(
        to_torch(batch2, "cuda"))
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    log(f"[int8-slice-fp32] launches {launches}")
    require(launches["int8_matmul_fused"] == 2
            and launches["fused_post_attention"] == 0,
            f"int8 fp32 slice launches {launches}")
    cpu_step = make_inference_step(cpu_model, server.cfg)
    t0 = time.perf_counter()
    cpu_out = cpu_step(cpu_batch)
    log(f"[int8-slice-fp32] CPU plain forward of 2 windows: "
        f"{time.perf_counter() - t0:.2f} s")
    cpu_up_out = cpu_step(one_ulp_up(cpu_batch))
    require(sorted(gpu_out) == sorted(cpu_out), "int8 output keys differ")
    worst = {}
    for key in sorted(cpu_out):
        g, c = gpu_out[key].cpu(), cpu_out[key]
        require(g.shape == c.shape and bool(torch.isfinite(g).all()),
                f"int8 {key}: shape {tuple(g.shape)} vs {tuple(c.shape)} "
                f"or non-finite")
        err, up = (g - c).abs(), (cpu_up_out[key] - c).abs()
        lim_max = max(SLICE_TOL, ULP_ENVELOPE * up.max().item())
        lim_mean = max(SLICE_TOL, ULP_ENVELOPE * up.mean().item())
        log(f"[int8-slice-fp32] {key} {tuple(g.shape)}: card vs CPU max "
            f"{err.max().item():.3e} mean {err.mean().item():.3e}; CPU one "
            f"ulp up max {up.max().item():.3e} mean {up.mean().item():.3e}"
            f" (limits {lim_max:.3e}, {lim_mean:.3e})")
        require(err.max().item() <= lim_max
                and err.mean().item() <= lim_mean,
                f"int8 {key}: card vs CPU beyond the one-ulp envelope")
        worst[key] = {"max": err.max().item(), "mean": err.mean().item(),
                      "ulp_max": up.max().item(), "ulp_mean": up.mean().item()}
    return worst, rel


def phase_serve_int8(tag, state_dict, batch2, out16, video, threshold,
                     fast_scores):
    from tim_tpu_torch import config as C
    from tim_tpu_torch.serve import DetectionServer
    from tim_tpu_torch.train.detection import make_inference_step

    cfg = C.epic_detection(compute_dtype="bfloat16", use_fused_ffn=True,
                           quant_pallas_heads=True, fast_scores=fast_scores)
    t0 = time.perf_counter()
    server = DetectionServer.quantized(cfg, state_dict,
                                       [to_torch(batch2, "cuda")],
                                       device="cuda", batch_size=128,
                                       top_k=8)
    log(f"[{tag}] DetectionServer.quantized: "
        f"{time.perf_counter() - t0:.2f} s")
    out8 = make_inference_step(server.model, server.cfg)(
        to_torch(batch2, "cuda"))
    deltas = torch.cat([(out8[k] - out16[k]).abs().flatten()
                        for k in ("v_scores", "a_scores")])
    d_max, d_mean = deltas.max().item(), deltas.mean().item()
    log(f"[{tag}] int8 vs bf16 sigmoid scores, 2 windows: max abs diff "
        f"{d_max:.4e} (tol {INT8_SCORE_MAX}), mean {d_mean:.4e} "
        f"(tol {INT8_SCORE_MEAN})")
    require(d_max <= INT8_SCORE_MAX and d_mean <= INT8_SCORE_MEAN,
            f"{tag}: int8 scores drift max {d_max} mean {d_mean}")

    launches, n_batches, metrics = serve_run(tag, server, video, threshold)
    require_launches(tag, launches,
                     {"query_block_attention": 0 if fast_scores
                      else cfg.num_layers,
                      "fused_post_attention": 0, "int8_matmul_fused": 2},
                     n_batches)
    metrics.update(int8_vs_bf16_max=d_max, int8_vs_bf16_mean=d_mean)
    return launches, metrics


def swin_qkv(batch, n_win, heads, dtype, gen, n=784, dh=32):
    """q/k/v of one Swin block as the model hands them to kernel 4:
    strided [B*nW, H, N, dh] views of one packed [B*nW, N, 3, H, dh]
    projection."""
    qkv = torch.randn(batch * n_win, n, 3, heads, dh, generator=gen,
                      device="cuda").to(dtype)
    return tuple(qkv[:, :, i].transpose(1, 2) for i in range(3))


def swin_bias(heads, dims, shifted, gen):
    """A block's relative-position bias [H, N, N] (a random table gathered
    by the real index) and region ids [nW, N] (None when unshifted)."""
    from tim_tpu_torch.models.backbones import swin3d as sw
    window, shift = sw.effective_window(dims, (16, 7, 7),
                                        (8, 3, 3) if shifted else (0, 0, 0))
    n = window[0] * window[1] * window[2]
    table = torch.randn(31 * 13 * 13, heads, generator=gen, device="cuda")
    idx = torch.from_numpy(sw.relative_position_index((16, 7, 7))[:n, :n]
                           .reshape(-1)).cuda()
    bias = table[idx].view(n, n, heads).permute(2, 0, 1).contiguous()
    region = None
    if any(shift):
        region = torch.from_numpy(sw.shift_region_ids(
            dims, window, shift)).cuda()
    return bias, region


def vit_qkv(batch, seq, dtype, gen, heads=16, dh=64):
    """q/k/v of one ViT block: strided [B, H, S, dh] views of the packed
    [B, S, 3, H, dh] projection."""
    qkv = torch.randn(batch, seq, 3, heads, dh, generator=gen,
                      device="cuda").to(dtype)
    return tuple(qkv[:, :, i].transpose(1, 2) for i in range(3))


def check_attention(name, kernel, plain, scores, args, kw, tag,
                    controls=False):
    """The kernel's inference and training (lse) launches against the plain
    version; the row log-sum-exp against torch.logsumexp of the plain fp32
    scores (``scores``, a function of the inputs). Returns (inference
    output, max abs error). In bf16, with ``controls``, also requires that
    the gate rejects two faulty controls: the plain output scaled by 0.98,
    and the online softmax that does not rescale its running sum."""
    got = kernel(*args, **kw)
    got_lse, lse = kernel_with_lse(name)(*args, **kw)
    torch.cuda.synchronize()
    want = plain(*args, **kw)
    s = scores(*args, **kw)
    lse_err = max_err(lse, torch.logsumexp(s, -1))
    worst = 0.0
    for launch, out in (("inference", got), ("lse", got_lse)):
        ok, err, rel = attention_close(out, want)
        log(f"[backbone-kernels] {name} {tag} {launch}: max_abs_err="
            f"{err:.3e}, relative RMS {rel:.3e}")
        require(out.shape == want.shape and ok,
                f"{name} {tag} ({launch} launch) disagrees with its plain "
                f"version: max abs {err}, relative RMS {rel}")
        worst = max(worst, err)
    log(f"[backbone-kernels] {name} {tag}: lse max_abs_err={lse_err:.3e} "
        f"(tol {LSE_TOL})")
    require(lse_err <= LSE_TOL, f"{name} {tag}: lse differs from the plain "
            f"log-sum-exp by {lse_err}")
    if controls and got.dtype == torch.bfloat16:
        bad = {"plain x 0.98": (want.float() * 0.98).to(want.dtype),
               "running sum not rescaled": online_attention(
                   s, args[2], rescale_sum=False)}
        for cname, out in bad.items():
            bad_ok, bad_err, bad_rel = attention_close(out, want)
            log(f"[backbone-kernels] {name} {tag} control '{cname}': max "
                f"abs {bad_err:.3e}, relative RMS {bad_rel:.3e}, "
                f"{'passes' if bad_ok else 'rejected'}")
            require(not bad_ok, f"{name} {tag}: the bf16 gate passes the "
                    f"faulty control '{cname}'")
    return got, worst


def kernel_with_lse(name):
    """The training launch of kernel ``name``: (output, row lse)."""
    from tim_tpu_torch.ops import flash_mha as fm
    from tim_tpu_torch.ops import window_attention as wa
    return {"flash_mha": fm.flash_mha_with_lse,
            "window_attention": wa.window_attention_with_lse}[name]


def swin_scores(q, k, v, bias, region, *, sm_scale):
    from tim_tpu_torch.ops.window_attention import window_scores
    return window_scores(q, k, bias, region, sm_scale=sm_scale)


def vit_scores(q, k, v, *, sm_scale):
    return torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale


def window_library_args(q, k, v, bias, region, n_win):
    """Kernel 4's function as one ``scaled_dot_product_attention`` call:
    [B, nW*H, N, dh] inputs and a float mask ab[type] broadcast over the
    clips (ab as the JAX model materialises it, in q's dtype)."""
    from tim_tpu_torch.ops.window_attention import attention_bias
    bw, h, n, dh = q.shape
    shape = (bw // n_win, n_win * h, n, dh)
    ab = attention_bias(bias, region).expand(n_win, h, n, n)
    return ([t.reshape(shape) for t in (q, k, v)],
            ab.reshape(1, n_win * h, n, n).to(q.dtype))


def sdpa_with_grad(*args, **kwargs):
    """The forward of one ``scaled_dot_product_attention`` call on inputs
    that require grad: the library call that also keeps its log-sum-exp
    for the backward, beside a kernel's training launch."""
    leaves = [t.detach().requires_grad_() for t in args]

    def run():
        with torch.enable_grad():
            F.scaled_dot_product_attention(*leaves, **kwargs)
    return run


# numbers the kernels' reports carry for the log lines that are computed
# from shapes (or from another number), not measured; the kernels' JSON line
# leaves them out (its bound_ms is the one computed number it keeps)
COMPUTED = ("exp_floor_ms", "share_of_bound", "groups")


def measured(report):
    """``report`` without the COMPUTED keys, at every depth."""
    if isinstance(report, dict):
        return {k: measured(v) for k, v in report.items()
                if k not in COMPUTED}
    if isinstance(report, list):
        return [measured(v) for v in report]
    return report


def exp_floor_ms(n_scores):
    """One exponential a score on the SMs' 16-a-clock units (132 SMs) at
    the card's highest SM clock: the least time the softmax can take."""
    return n_scores / (16 * 132 * SM_CLOCK_HZ) * 1e3


def time_forward(kernel, with_lse, plain, library, library_grad, args, kw,
                 nbytes_, n_scores, dh):
    """The inference and training (lse) launches of a forward kernel at
    batch 8 beside its plain version, its library call without and with
    inputs that require grad, its bound and its exponential floor."""
    ms_bound, by = bound(nbytes_, 4 * n_scores * dh, "bf16")
    row = {}
    row["ms"], row["host_ms"] = device_ms(lambda: kernel(*args, **kw))
    row["lse_ms"], row["lse_host_ms"] = device_ms(
        lambda: with_lse(*args, **kw))
    row["plain_ms"] = cuda_ms(lambda: plain(*args, **kw), iters=3)
    row["library_ms"], row["library_host_ms"] = device_ms(library)
    row["library_grad_ms"], _ = device_ms(library_grad)
    row.update(bound_ms=ms_bound, bound_by=by,
               exp_floor_ms=exp_floor_ms(n_scores))
    row["share_of_bound"] = ms_bound / row["ms"]
    return row


def log_forward(name, tag, row, lib_name, lib_err):
    log(f"[backbone-kernels] {name} {tag} bf16 (device ms, host ms a "
        f"call): kernel {row['ms']:.4f} ms (host {row['host_ms']:.4f}), "
        f"training launch (writes lse) {row['lse_ms']:.4f} ms (host "
        f"{row['lse_host_ms']:.4f}), plain {row['plain_ms']:.4f} ms, "
        f"{lib_name} {row['library_ms']:.4f} ms (host "
        f"{row['library_host_ms']:.4f}; max abs diff to the kernel "
        f"{lib_err:.3e}), with inputs that require grad "
        f"{row['library_grad_ms']:.4f} ms; bound "
        f"{row['bound_ms']:.4f} ms ({row['bound_by']}, "
        f"{100 * row['share_of_bound']:.1f}%), exponential floor "
        f"{row['exp_floor_ms']:.4f} ms")


def phase_backbone_kernels(gen):
    """Kernels 4 and 5 (inference and training launches) against their
    plain versions, then timed at batch 8 (the extraction and training
    batch) at every shape the main paths launch."""
    from tim_tpu_torch import _build
    from tim_tpu_torch.ops import flash_mha as fm
    from tim_tpu_torch.ops import window_attention as wa

    worst = {"window_attention": 0.0, "flash_mha": 0.0}
    cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for n_win, heads, dims in SWIN_STAGES:
            for shifted in ((False, True) if n_win > 1 else (False,)):
                q, k, v = swin_qkv(1, n_win, heads, dtype, gen)
                bias, region = swin_bias(heads, dims, shifted, gen)
                _, err = check_attention(
                    "window_attention", wa.window_attention,
                    wa.window_attention_plain, swin_scores,
                    (q, k, v, bias, region), {"sm_scale": 32 ** -0.5},
                    f"{dtype} nW={n_win} H={heads} shifted={shifted} "
                    f"n_types={1 if region is None else n_win}",
                    controls=n_win == 64 and shifted)
                worst["window_attention"] = max(worst["window_attention"],
                                                err)
                cases += 1
        for b, h, s in FLASH_CHECK_SHAPES:
            _, err = check_attention(
                "flash_mha", fm.flash_mha, fm.flash_mha_plain, vit_scores,
                vit_qkv(b, s, dtype, gen, heads=h), {"sm_scale": 0.125},
                f"{dtype} [{b}, {h}, {s}, 64]",
                controls=s == 1568 and h == 16)
            worst["flash_mha"] = max(worst["flash_mha"], err)
            cases += 1
    log(f"[backbone-kernels] {cases} cases (each launch) agree with the "
        f"plain versions")

    report = {}
    per_stage = []
    for n_win, heads, dims in SWIN_STAGES:
        shifted = n_win > 1
        q, k, v = swin_qkv(8, n_win, heads, torch.bfloat16, gen)
        bias, region = swin_bias(heads, dims, shifted, gen)
        args, kw = (q, k, v, bias, region), {"sm_scale": 32 ** -0.5}
        bw, h, n, dh = q.shape
        out = wa.window_attention(*args, **kw)
        torch.cuda.synchronize()
        ok, err, rel = attention_close(out, wa.window_attention_plain(*args,
                                                                     **kw))
        require(ok, f"window_attention bf16 batch 8 nW={n_win}: max abs "
                f"{err}, relative RMS {rel}")
        lib_qkv, mask = window_library_args(q, k, v, bias, region, n_win)
        lib_kw = {"attn_mask": mask, "scale": 32 ** -0.5}
        lib_err = max_err(F.scaled_dot_product_attention(
            *lib_qkv, **lib_kw).reshape(out.shape), out)
        row = {"stage": len(per_stage) + 1, "windows": bw, "heads": h,
               "shifted": shifted, "max_abs_err": err,
               **time_forward(
                   wa.window_attention, wa.window_attention_with_lse,
                   wa.window_attention_plain,
                   lambda: F.scaled_dot_product_attention(*lib_qkv, **lib_kw),
                   sdpa_with_grad(*lib_qkv, **lib_kw), args, kw,
                   nbytes(q, k, v, bias, region, out), bw * h * n * n, dh)}
        log_forward("window_attention", f"stage {row['stage']} [{bw}, {h}, "
                    f"{n}, {dh}] shifted={shifted}", row, "masked "
                    "scaled_dot_product_attention", lib_err)
        per_stage.append(row)
        del args, lib_qkv, mask, q, k, v, out
        torch.cuda.empty_cache()
    first = per_stage[0]
    report["window_attention"] = {
        "max_abs_err": max(worst["window_attention"],
                           *(r["max_abs_err"] for r in per_stage)),
        **{key: first[key] for key in first if key.endswith(("ms", "_by"))},
        "per_stage": per_stage}

    per_shape = []
    for h, s in FLASH_SHAPES:
        q, k, v = vit_qkv(8, s, torch.bfloat16, gen, heads=h)
        kw = {"sm_scale": 0.125}
        out = fm.flash_mha(q, k, v, **kw)
        torch.cuda.synchronize()
        ok, err, rel = attention_close(out, fm.flash_mha_plain(q, k, v, **kw))
        require(ok, f"flash_mha bf16 [8, {h}, {s}, 64]: max abs {err}, "
                f"relative RMS {rel}")
        lib_err = max_err(F.scaled_dot_product_attention(q, k, v, scale=0.125),
                          out)
        row = {"shape": [8, h, s, 64], "max_abs_err": err,
               **time_forward(
                   fm.flash_mha, fm.flash_mha_with_lse, fm.flash_mha_plain,
                   lambda: F.scaled_dot_product_attention(q, k, v,
                                                          scale=0.125),
                   sdpa_with_grad(q, k, v, scale=0.125), (q, k, v), kw,
                   nbytes(q, k, v, out), 8 * h * s * s, 64)}
        # the C launcher alone (tensor maps and launch), arguments made
        # once: what of the wrapper's host time a call is not Python
        c_fn = _build.launcher("tim_flash_mha", fm._ARGTYPES)
        view, strides = fm.launch_args(q, k, v)
        c_args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), view.data_ptr(),
                  strides, None, 8, h, s, 64, 1, 0.125,
                  torch.cuda.current_stream().cuda_stream)
        _, row["launcher_host_ms"] = device_ms(lambda: c_fn(*c_args))
        log_forward("flash_mha", f"[8, {h}, {s}, 64]", row,
                    "scaled_dot_product_attention", lib_err)
        log(f"[backbone-kernels] flash_mha [8, {h}, {s}, 64]: the C "
            f"launcher alone {row['launcher_host_ms']:.4f} ms of host a "
            f"call (the wrapper {row['host_ms']:.4f})")
        per_shape.append(row)
        del q, k, v, out
        torch.cuda.empty_cache()
    first = per_shape[0]
    report["flash_mha"] = {
        "max_abs_err": max(worst["flash_mha"],
                           *(r["max_abs_err"] for r in per_shape)),
        **{key: first[key] for key in first if key.endswith(("ms", "_by"))},
        "per_shape": per_shape}
    return report


BACKBONES = {
    # backbone: (factory, clip shape, kernel that its attention launches)
    "omnivore": ("omnivore_swinB_epic", (32, 224, 224, 3),
                 "window_attention"),
    "videomae": ("videomae_vit_large", (16, 224, 224, 3), "flash_mha"),
}


def backbone(name, dtype, device):
    """The backbone as ``make_visual_apply`` builds it (generator seeded
    0), in ``dtype`` on ``device``."""
    from tim_tpu_torch.models.backbones import swin3d, vit
    factory = getattr(swin3d if name == "omnivore" else vit, BACKBONES[name][0])
    return factory(dtype=dtype, device=device,
                   generator=torch.Generator().manual_seed(SEED)).eval()


def phase_backbone_slice_fp32(name, clips):
    """Full-width backbone on one clip in fp32: the card with its kernels
    against the CPU with the plain versions; the card's fp32 features of
    ``clips`` are returned for the bf16 comparison."""
    kernel = BACKBONES[name][2]
    t0 = time.perf_counter()
    cpu_model = backbone(name, "float32", "cpu")
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    log(f"[slice-{name}-fp32] built two full-width {name} backbones "
        f"({sum(p.numel() for p in cpu_model.parameters())} params) in "
        f"{time.perf_counter() - t0:.2f} s")
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    x = torch.from_numpy(clips)
    gpu = gpu_model(x.cuda())
    torch.cuda.synchronize()
    launches = {n: fn.launches for n, fn in counters.items()}
    require(launches[kernel] == 24 and sum(launches.values()) == 24,
            f"{name} fp32 forward launches {launches}, expected 24 of "
            f"{kernel}")
    t0 = time.perf_counter()
    cpu = cpu_model(x[:1])
    log(f"[slice-{name}-fp32] CPU plain forward of 1 clip: "
        f"{time.perf_counter() - t0:.2f} s")
    g = gpu[:1].cpu()
    require(g.shape == cpu.shape and bool(torch.isfinite(g).all()),
            f"{name} fp32 features: shape {tuple(g.shape)} vs "
            f"{tuple(cpu.shape)} or non-finite")
    err = max_err(g, cpu)
    log(f"[slice-{name}-fp32] features {tuple(g.shape)}: card vs CPU "
        f"max_abs_err={err:.3e} (tol {SLICE_TOL}), launches {launches}")
    require(err <= SLICE_TOL, f"{name} fp32 card vs CPU {err} > {SLICE_TOL}")
    del cpu_model, gpu_model
    torch.cuda.empty_cache()
    return gpu.float(), err


def phase_extract(name, fp32_feats, clips):
    """``make_visual_apply`` + ``extract_features_for_video`` in bf16 over
    a synthetic video of EXTRACT_CLIPS clips at batch 8."""
    from tim_tpu_torch.extract.cli import build_parser, make_visual_apply
    from tim_tpu_torch.extract.pipeline import extract_features_for_video

    frames = BACKBONES[name][1][0]
    args = build_parser().parse_args(
        ["--backbone", name, "--feature_times", "unused", "--out_dir",
         "unused", "--batch_size", "8", "--compute_dtype", "bfloat16",
         "--num_frames", str(frames)])
    t0 = time.perf_counter()
    apply_fn = make_visual_apply(args)
    log(f"[extract-{name}] make_visual_apply (random weights, seed {SEED}): "
        f"{time.perf_counter() - t0:.2f} s")
    # bf16 vs fp32 features on the 2 clips of the fp32 phase
    feats16 = apply_fn(torch.from_numpy(clips))
    rel = max_err(feats16, fp32_feats) / fp32_feats.abs().max().item()
    log(f"[extract-{name}] bf16 vs fp32 features, 2 clips: relative max "
        f"diff {rel:.4e} (tol {BF16_FEATURE_TOL})")
    require(rel <= BF16_FEATURE_TOL, f"{name} bf16 features drift {rel}")

    rng = np.random.default_rng(SEED + 1)
    shape = BACKBONES[name][1]
    base = [rng.normal(size=shape).astype(np.float32) for _ in range(4)]
    events = []

    class Timed:
        device = apply_fn.device

        def __call__(self, x):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = apply_fn(x)
            end.record()
            events.append((start, end))
            return out

    def clip_fn(t, a):
        return base[t % len(base)]

    timed = Timed()
    extract_features_for_video(clip_fn, 8, 1, timed, batch_size=8)  # warm-up
    events.clear()
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bank = extract_features_for_video(clip_fn, EXTRACT_CLIPS, 1, timed,
                                      batch_size=8)
    wall = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in counters.items()}
    device_ms = sum(s.elapsed_time(e) for s, e in events)
    forwards = len(events)
    kernel = BACKBONES[name][2]
    log(f"[extract-{name}] {EXTRACT_CLIPS} clips in {forwards} batches of 8:"
        f" device {device_ms:.3f} ms, {EXTRACT_CLIPS / (device_ms / 1e3):.2f}"
        f" device clips/s; wall {wall:.3f} s, "
        f"{EXTRACT_CLIPS / wall:.2f} wall clips/s; launches {launches}")
    require(bank.shape == (EXTRACT_CLIPS, 1, 1024)
            and bool(np.isfinite(bank).all()),
            f"{name} bank {bank.shape} or non-finite")
    require(launches[kernel] == 24 * forwards
            and attention_launches(launches) == launches[kernel],
            f"{name} extraction launches {launches}, expected 24 x "
            f"{forwards} of {kernel}")
    require_steady(f"extract-{name}", launches, forwards)
    return launches, {
        "clips": EXTRACT_CLIPS, "batches": forwards, "device_ms": device_ms,
        "device_clips_per_s": EXTRACT_CLIPS / (device_ms / 1e3),
        "wall_s": wall, "wall_clips_per_s": EXTRACT_CLIPS / wall,
        "launches_per_forward": launches[kernel] / forwards,
        "bf16_vs_fp32_rel": rel}


def phase_backbones(gen):
    """Phases 9-11; returns (kernel report, launches by path)."""
    report = timed("backbone-kernels", phase_backbone_kernels, gen)
    by_path = {}
    for name in BACKBONES:
        rng = np.random.default_rng(SEED)
        clips = rng.normal(size=(2, *BACKBONES[name][1])).astype(np.float32)
        fp32_feats, err = timed(f"slice-{name}-fp32",
                                phase_backbone_slice_fp32, name, clips)
        launches, m = timed(f"extract-{name}", phase_extract, name,
                            fp32_feats, clips)
        m["fp32_card_vs_cpu"] = err
        log(f"[extract-{name}] summary {json.dumps(m)}")
        by_path[f"extract-{name}"] = launches
        torch.cuda.empty_cache()
    return report, by_path

# Backward kernels 4b and 5b against their plain versions: fp32 within
# GRAD_F32_TOL of each gradient's largest value (sums in another order);
# bf16 as attention_close, scaled to each gradient: elementwise two bf16
# spacings + GRAD_BF16_FLOOR * max |want|, relative RMS <= GRAD_BF16_REL_RMS
# (the kernel takes D = do . o from the rounded output o, the plain version
# rowsum(dp * p); both round p and ds * scale to bf16 at the same points).
GRAD_F32_TOL = 1e-4
GRAD_BF16_FLOOR = 2.0 ** -7
GRAD_BF16_REL_RMS = 1e-2
# fp32 gradient slices, card vs CPU: of each parameter's largest gradient
GRAD_SLICE_TOL = 1e-3
TRAIN_WARMUP, TRAIN_STEPS, TRAIN_BATCH = 2, 5, 8
# Kernel-5 shapes of the training paths: ViT-L [B, 16, 1568, 64], the MAE
# encoder's 160 visible tokens, a ragged S, the MAE decoder's 8 heads
FLASH_BWD_SHAPES = ((2, 16, 1568), (2, 16, 160), (3, 16, 37), (2, 8, 1568))


def grad_close(got, want, bf16: bool):
    """A backward kernel's output against its plain version: (ok, max abs
    error, relative RMS error); ``bf16`` names the inputs' type (dbias is
    fp32 either way)."""
    err = (got.float() - want.float()).abs()
    peak = want.float().abs().max()
    rel = (err.norm() / want.float().norm()).item()
    if not bf16:
        ok = bool((err <= GRAD_F32_TOL * peak).all())
    else:
        ok = (bool((err <= 2 * bf16_spacing(want) + GRAD_BF16_FLOOR * peak)
                   .all()) and rel <= GRAD_BF16_REL_RMS)
    return ok, err.max().item(), rel


def emulated_attention_bwd(s, q, k, v, do, *, sm_scale, drop_delta=False):
    """(dq, dk, dv, ds) as the backward kernels compute them, from fp32
    scores s [..., N, N]: the forward's output o from
    ``online_attention`` (rounded to v's dtype), D = do . o, p = exp(s -
    lse), p and ds * scale rounded to the operand type before their
    products. ``drop_delta=True`` is a fault, the gate's control: ds = p
    * dp without D."""
    o = online_attention(s, v).float()
    p = torch.exp(s - torch.logsumexp(s, -1, keepdim=True))
    do32 = do.float()
    dv = (p.to(v.dtype).float().transpose(-1, -2) @ do32).to(v.dtype)
    dp = do32 @ v.float().transpose(-1, -2)
    delta = 0.0 if drop_delta else (do32 * o).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    dsc = (ds * sm_scale).to(q.dtype).float()
    return ((dsc @ k.float()).to(q.dtype),
            (dsc.transpose(-1, -2) @ q.float()).to(k.dtype), dv, ds)


def check_grads(name, got, want, bf16, tag):
    """Each gradient of ``got`` against ``want``; returns the worst max
    abs error."""
    worst = 0.0
    for gname, g, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        ok, err, rel = grad_close(g, w, bf16)
        log(f"[train-kernels] {name} {tag} {gname}: max_abs_err={err:.3e}, "
            f"relative RMS {rel:.3e} (largest |want| "
            f"{w.float().abs().max().item():.3e})")
        require(g.shape == w.shape and ok, f"{name} {tag} {gname} disagrees "
                f"with its plain version: max abs {err}, relative RMS {rel}")
        worst = max(worst, err)
    return worst


def check_controls(name, tag, want, controls):
    """The bf16 gate must reject each faulty control: (name, index of the
    gradient it replaces, its value)."""
    for cname, i, bad in controls:
        ok, err, rel = grad_close(bad, want[i], True)
        log(f"[train-kernels] {name} {tag} control '{cname}': max abs "
            f"{err:.3e}, relative RMS {rel:.3e}, "
            f"{'passes' if ok else 'rejected'}")
        require(not ok, f"{name} {tag}: the bf16 gate passes the faulty "
                f"control '{cname}'")


def flash_bwd_case(b, h, s, dtype, gen):
    from tim_tpu_torch.ops import flash_mha as fm
    q, k, v = vit_qkv(b, s, dtype, gen, heads=h)
    out, lse = fm.flash_mha_with_lse(q, k, v, sm_scale=0.125)
    do = torch.randn(out.shape, generator=gen, device="cuda").to(dtype)
    return (q, k, v), out, lse, do


def window_bwd_case(batch, n_win, heads, dims, shifted, dtype, gen):
    from tim_tpu_torch.ops import window_attention as wa
    q, k, v = swin_qkv(batch, n_win, heads, dtype, gen)
    bias, region = swin_bias(heads, dims, shifted, gen)
    out, lse = wa.window_attention_with_lse(q, k, v, bias, region,
                                            sm_scale=32 ** -0.5)
    do = torch.randn(out.shape, generator=gen, device="cuda").to(dtype)
    return (q, k, v, bias, region), out, lse, do


def sdpa_bwd_ms(q, k, v, do, mask=None):
    """Device ms of the backward of one ``scaled_dot_product_attention``
    call, through autograd (graph kept, backward repeated)."""
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    if mask is not None:
        leaves.append(mask.detach().requires_grad_())
    out = F.scaled_dot_product_attention(
        *leaves[:3], attn_mask=leaves[3] if mask is not None else None,
        scale=q.shape[-1] ** -0.5)
    return cuda_ms(lambda: torch.autograd.grad(out, leaves, do,
                                               retain_graph=True), iters=5)


def attention_bwd_bound(q, nbytes_):
    """5 products of 2 N^2 dh per (batch, head) at the bf16 peak, or the
    bytes at the memory rate, whichever is larger."""
    b, h, n, dh = q.shape
    return bound(nbytes_, 5 * 2 * b * h * n * n * dh, "bf16")


def deterministic_flash_bwd(args, out, lse, do):
    """Kernel 5b's route under ``torch.use_deterministic_algorithms(True)``
    (dq from the atomic-free pass): two calls bit-equal in dq, dk and dv,
    each gradient within the bf16 gate of the plain backward, dk and dv
    bit-equal to the default route's; timed beside it."""
    from tim_tpu_torch.ops import flash_mha as fm
    kw = {"sm_scale": 0.125}
    default = [g.clone() for g in fm.flash_mha_bwd(*args, out, lse, do, **kw)]
    torch.use_deterministic_algorithms(True)
    try:
        first = [g.clone() for g in fm.flash_mha_bwd(*args, out, lse, do,
                                                     **kw)]
        second = fm.flash_mha_bwd(*args, out, lse, do, **kw)
        torch.cuda.synchronize()
        equal = [torch.equal(a, b) for a, b in zip(first, second)]
        del second
        ms = cuda_ms(lambda: fm.flash_mha_bwd(*args, out, lse, do, **kw))
    finally:
        torch.use_deterministic_algorithms(False)
    require(all(equal), f"flash_mha_bwd deterministic route: two calls "
            f"differ (dq, dk, dv bit-equal: {equal})")
    require(torch.equal(first[1], default[1])
            and torch.equal(first[2], default[2]),
            "flash_mha_bwd deterministic route: dk or dv differ from the "
            "default route's")
    err = check_grads("flash_mha_bwd", first,
                      fm.flash_mha_bwd_plain(*args, do, **kw), True,
                      "bf16 [8, 16, 1568, 64] deterministic route")
    log(f"[train-kernels] flash_mha_bwd deterministic route: dq, dk, dv "
        f"bit-equal between two calls; {ms:.4f} ms a call")
    return {"deterministic_ms": ms, "deterministic_max_abs_err": err}


def deterministic_window_bwd(args, out, lse, do, default):
    """Kernel 4b's route under ``torch.use_deterministic_algorithms(True)``
    (dq from the atomic-free pass): two calls bit-equal in dq, dk, dv and
    dbias, dk, dv and dbias bit-equal to the default route's ``default``,
    every gradient within the bf16 gate; timed."""
    from tim_tpu_torch.ops import window_attention as wa
    kw = {"sm_scale": 32 ** -0.5}
    torch.use_deterministic_algorithms(True)
    try:
        first = [g.clone() for g in wa.window_attention_bwd(
            *args, out, lse, do, **kw)]
        second = wa.window_attention_bwd(*args, out, lse, do, **kw)
        torch.cuda.synchronize()
        equal = [torch.equal(a, b) for a, b in zip(first, second)]
        del second
        ms = cuda_ms(lambda: wa.window_attention_bwd(*args, out, lse, do,
                                                     **kw))
    finally:
        torch.use_deterministic_algorithms(False)
    require(all(equal), f"window_attention_bwd deterministic route: two "
            f"calls differ (dq, dk, dv, dbias bit-equal: {equal})")
    require(all(torch.equal(first[i], default[i]) for i in (1, 2, 3)),
            "window_attention_bwd deterministic route: dk, dv or dbias "
            "differ from the default route's")
    err = check_grads("window_attention_bwd", first,
                      wa.window_attention_bwd_plain(*args, do, **kw), True,
                      "bf16 stage 1 batch 8 deterministic route")
    log(f"[train-kernels] window_attention_bwd deterministic route: dq, dk, "
        f"dv, dbias bit-equal between two calls; {ms:.4f} ms a call")
    return {"deterministic_ms": ms, "deterministic_max_abs_err": err}


def phase_training_kernels(gen):
    """Kernels 4b and 5b against their plain backwards in fp32 and bf16,
    the bf16 gate shown to reject two faulty controls, then both timed at
    batch 8 beside the plain backward and the backward of one library
    call."""
    from tim_tpu_torch.ops import flash_mha as fm
    from tim_tpu_torch.ops import window_attention as wa

    worst = {"window_attention_bwd": 0.0, "flash_mha_bwd": 0.0}
    cases = 0
    t0 = time.perf_counter()
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        for n_win, heads, dims in SWIN_STAGES:
            for shifted in ((False, True) if n_win > 1 else (False,)):
                args, out, lse, do = window_bwd_case(2, n_win, heads, dims,
                                                     shifted, dtype, gen)
                tag = f"{dtype} nW={n_win} H={heads} shifted={shifted} 2 clips"
                got = wa.window_attention_bwd(*args, out, lse, do,
                                              sm_scale=32 ** -0.5)
                torch.cuda.synchronize()
                want = wa.window_attention_bwd_plain(*args, do,
                                                     sm_scale=32 ** -0.5)
                worst["window_attention_bwd"] = max(
                    worst["window_attention_bwd"],
                    check_grads("window_attention_bwd", got, want, bf16, tag))
                if bf16 and n_win == 64 and shifted:
                    s = wa.window_scores(args[0], args[1], args[3], args[4],
                                         sm_scale=32 ** -0.5)
                    bad = emulated_attention_bwd(
                        s, *args[:3], do, sm_scale=32 ** -0.5,
                        drop_delta=True)
                    ds = emulated_attention_bwd(
                        s, *args[:3], do, sm_scale=32 ** -0.5)[3]
                    # the kernel sums dbias over groups of windows
                    groups = wa.bwd_groups(*args[0].shape[:3])
                    per_group = -(-args[0].shape[0] // groups)
                    log(f"[train-kernels] window_attention_bwd {tag}: "
                        f"dbias summed over {groups} window groups")
                    check_controls("window_attention_bwd", tag, want, [
                        ("D omitted", 0, bad[0]),
                        ("dbias from one window only", 3, ds[0]),
                        ("dbias without one window group", 3,
                         ds[per_group:].sum(0))])
                    del s, bad, ds
                cases += 1
                del args, out, lse, do, got, want
        for b, h, s_len in FLASH_BWD_SHAPES:
            args, out, lse, do = flash_bwd_case(b, h, s_len, dtype, gen)
            tag = f"{dtype} [{b}, {h}, {s_len}, 64]"
            got = fm.flash_mha_bwd(*args, out, lse, do, sm_scale=0.125)
            torch.cuda.synchronize()
            want = fm.flash_mha_bwd_plain(*args, do, sm_scale=0.125)
            worst["flash_mha_bwd"] = max(
                worst["flash_mha_bwd"],
                check_grads("flash_mha_bwd", got, want, bf16, tag))
            if bf16 and s_len == 1568 and h == 16:
                s = vit_scores(*args, sm_scale=0.125)
                bad = emulated_attention_bwd(s, *args, do, sm_scale=0.125,
                                             drop_delta=True)
                check_controls("flash_mha_bwd", tag, want,
                               [("D omitted, dq", 0, bad[0]),
                                ("D omitted, dk", 1, bad[1])])
                del s, bad
            cases += 1
            del args, out, lse, do, got, want
    torch.cuda.empty_cache()
    log(f"[train-kernels] {cases} cases agree with the plain backwards "
        f"({time.perf_counter() - t0:.2f} s)")

    report = {}
    per_stage = []
    for n_win, heads, dims in SWIN_STAGES:
        shifted = n_win > 1
        args, out, lse, do = window_bwd_case(8, n_win, heads, dims, shifted,
                                             torch.bfloat16, gen)
        q, k, v, bias, region = args
        kw = {"sm_scale": 32 ** -0.5}
        got = wa.window_attention_bwd(*args, out, lse, do, **kw)
        torch.cuda.synchronize()
        want = wa.window_attention_bwd_plain(*args, do, **kw)
        err = check_grads("window_attention_bwd", got, want, True,
                          f"bf16 batch 8 nW={n_win}")
        ms_bound, by = attention_bwd_bound(
            q, nbytes(q, k, v, out, do, *got[:3], lse, bias, region, got[3]))
        det = (deterministic_window_bwd(args, out, lse, do, got)
               if not per_stage else {})
        del got, want
        torch.cuda.empty_cache()
        row = {"stage": len(per_stage) + 1, "windows": q.shape[0],
               "heads": heads, "shifted": shifted, "max_abs_err": err,
               "ms": cuda_ms(lambda: wa.window_attention_bwd(
                   *args, out, lse, do, **kw)),
               "plain_ms": cuda_ms(lambda: wa.window_attention_bwd_plain(
                   *args, do, **kw), iters=3, warmup=1),
               "bound_ms": ms_bound, "bound_by": by,
               "groups": wa.bwd_groups(*q.shape[:3]), **det}
        row["share_of_bound"] = ms_bound / row["ms"]
        torch.cuda.empty_cache()
        lib_qkv, mask = window_library_args(q, k, v, bias, region, n_win)
        lib_do = do.reshape(lib_qkv[0].shape)
        try:
            row["library_ms"] = sdpa_bwd_ms(*lib_qkv, lib_do, mask)
            lib = ("scaled_dot_product_attention backward with a float mask "
                   "ab[type] that requires grad")
        except RuntimeError as e:   # no backend gives the mask's gradient
            log(f"[train-kernels] SDPA cannot give dbias here: {e}")
            row["library_ms"] = sdpa_bwd_ms(*lib_qkv, lib_do, mask.detach())
            lib = ("scaled_dot_product_attention backward, mask without "
                   "grad (SDPA cannot give dbias)")
        row["library"] = lib
        log(f"[train-kernels] window_attention_bwd stage {row['stage']} "
            f"[{q.shape[0]}, {heads}, 784, 32] bf16 shifted={shifted}: "
            f"kernel {row['ms']:.4f} ms ({row['groups']} window groups), "
            f"plain {row['plain_ms']:.4f} ms, {lib} "
            f"{row['library_ms']:.4f} ms ({row['ms'] / row['library_ms']:.2f}"
            f"x), bound {ms_bound:.4f} ms ({by}; "
            f"{100 * row['share_of_bound']:.1f}% of it reached)")
        per_stage.append(row)
        del args, q, k, v, bias, region, out, lse, do, lib_qkv, mask, lib_do
        torch.cuda.empty_cache()
    first = per_stage[0]
    report["window_attention_bwd"] = {
        "max_abs_err": max(worst["window_attention_bwd"],
                           *(r["max_abs_err"] for r in per_stage)),
        **{key: first[key] for key in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms",
                                       "deterministic_ms")},
        "per_stage": per_stage}

    args, out, lse, do = flash_bwd_case(8, 16, 1568, torch.bfloat16, gen)
    q, k, v = args
    got = fm.flash_mha_bwd(*args, out, lse, do, sm_scale=0.125)
    torch.cuda.synchronize()
    err = check_grads("flash_mha_bwd", got,
                      fm.flash_mha_bwd_plain(*args, do, sm_scale=0.125), True,
                      "bf16 [8, 16, 1568, 64]")
    ms_bound, by = attention_bwd_bound(q, nbytes(q, k, v, out, do, *got,
                                                 lse))
    del got
    torch.cuda.empty_cache()
    report["flash_mha_bwd"] = {
        "max_abs_err": max(worst["flash_mha_bwd"], err),
        "ms": cuda_ms(lambda: fm.flash_mha_bwd(*args, out, lse, do,
                                               sm_scale=0.125)),
        "plain_ms": cuda_ms(lambda: fm.flash_mha_bwd_plain(
            *args, do, sm_scale=0.125), iters=3, warmup=1),
        "library_ms": sdpa_bwd_ms(q, k, v, do),
        "bound_ms": ms_bound, "bound_by": by}
    r = report["flash_mha_bwd"]
    r["share_of_bound"] = r["bound_ms"] / r["ms"]
    log(f"[train-kernels] flash_mha_bwd [8, 16, 1568, 64] bf16: kernel "
        f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
        f"scaled_dot_product_attention backward {r['library_ms']:.4f} ms, "
        f"bound {ms_bound:.4f} ms ({by})")
    r.update(deterministic_flash_bwd(args, out, lse, do))
    del args, q, k, v, out, lse, do
    torch.cuda.empty_cache()
    return report


def train_model(kind, dtype, device, **trunk_kw):
    """A ``TwoHeadViT`` over the ViT-L or Swin-B trunk (random weights,
    generator seeded ``SEED``) in ``dtype`` on ``device``."""
    from tim_tpu_torch.models.backbones import swin3d, vit
    from tim_tpu_torch.runner.backbone import TwoHeadViT
    gen = torch.Generator().manual_seed(SEED)
    if kind == "vit":
        trunk = vit.videomae_vit_large(dtype, device=device, generator=gen,
                                       **trunk_kw)
    else:
        trunk = swin3d.omnivore_swinB_epic(dtype, device=device,
                                           generator=gen, **trunk_kw)
    return TwoHeadViT(trunk, generator=gen)


def two_head_loss(model, video, verbs, nouns):
    from tim_tpu_torch.train.backbone_finetune import (
        mixup_targets, soft_target_cross_entropy)
    perm = torch.arange(video.shape[0], device=video.device)
    lv, ln_ = model(video)
    return (soft_target_cross_entropy(lv, mixup_targets(verbs, perm, 1.0, 97))
            + soft_target_cross_entropy(ln_, mixup_targets(nouns, perm, 1.0,
                                                           300)))


def phase_grad_slice_fp32(kind):
    """One clip through a full-width, reduced-depth ``TwoHeadViT`` in fp32
    (ViT-L 2 blocks, Swin-B depths (2, 2, 2, 2)): every parameter gradient
    on the card (kernels 4/5 both ways) against the CPU (plain versions)."""
    kw = {"depth": 2} if kind == "vit" else {"depths": (2, 2, 2, 2)}
    frames = 16 if kind == "vit" else 32
    cpu_model = train_model(kind, "float32", "cpu", **kw)
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    rng = np.random.default_rng(SEED)
    clip = torch.from_numpy(rng.normal(size=(1, frames, 224, 224, 3))
                            .astype(np.float32))
    verbs, nouns = torch.tensor([3]), torch.tensor([17])
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    loss = two_head_loss(gpu_model, clip.cuda(), verbs.cuda(), nouns.cuda())
    loss.backward()
    torch.cuda.synchronize()
    launches = {n: fn.launches for n, fn in counters.items()}
    blocks = 2 if kind == "vit" else 8
    kernel = "flash_mha" if kind == "vit" else "window_attention"
    require(launches[kernel] == blocks and launches[f"{kernel}_bwd"] == blocks
            and sum(launches.values()) == 2 * blocks,
            f"{kind} fp32 slice launches {launches}")
    t0 = time.perf_counter()
    cpu_loss = two_head_loss(cpu_model, clip, verbs, nouns)
    cpu_loss.backward()
    log(f"[grad-slice-{kind}] CPU plain forward + backward of 1 clip: "
        f"{time.perf_counter() - t0:.2f} s; loss card {loss.item():.6f}, "
        f"CPU {cpu_loss.item():.6f}; launches {launches}")
    worst, worst_name = 0.0, ""
    cpu_params = dict(cpu_model.named_parameters())
    for name, p in gpu_model.named_parameters():
        g, c = p.grad.cpu(), cpu_params[name].grad
        require(bool(torch.isfinite(g).all()), f"{kind} {name}: non-finite")
        rel = max_err(g, c) / max(c.abs().max().item(), 1e-30)
        if rel > worst:
            worst, worst_name = rel, name
        require(rel <= GRAD_SLICE_TOL, f"{kind} fp32 gradient {name}: card "
                f"vs CPU {rel} of its largest value > {GRAD_SLICE_TOL}")
    log(f"[grad-slice-{kind}] {len(cpu_params)} parameter gradients, card "
        f"vs CPU within {worst:.3e} of each tensor's largest value (worst "
        f"{worst_name}; tol {GRAD_SLICE_TOL})")
    del cpu_model, gpu_model
    torch.cuda.empty_cache()
    return worst


class SyntheticClips:
    """``n`` EK100-style examples ({video, verb, noun}) cycling through 4
    random clips of ``shape`` (seeded), labels drawn once."""

    def __init__(self, n, shape, seed=SEED + 2):
        rng = np.random.default_rng(seed)
        self.base = [rng.normal(size=shape).astype(np.float32)
                     for _ in range(4)]
        self.verbs = rng.integers(0, 97, n)
        self.nouns = rng.integers(0, 300, n)

    def __len__(self):
        return len(self.verbs)

    def __getitem__(self, i):
        return {"video": self.base[i % 4], "verb": self.verbs[i],
                "noun": self.nouns[i]}


def timed_steps(owner, attr, events, losses):
    """Wrap ``owner.attr`` (a step function) so that each call records
    CUDA events around it and keeps its loss."""
    step = getattr(owner, attr)

    def timed(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        metrics = step(*args, **kwargs)
        end.record()
        events.append((start, end))
        losses.append(metrics["loss"])
        return metrics

    setattr(owner, attr, timed)


def check_grads_finite(optimizer, flags):
    """Before each optimizer step, record whether every gradient is finite
    (a device flag; read once at the end)."""
    def hook(opt, args, kwargs):
        grads = [p.grad for g in opt.param_groups for p in g["params"]
                 if p.grad is not None]
        norms = torch._foreach_norm(grads)
        flags.append(torch.isfinite(torch.stack(norms)).all())
    return optimizer.register_step_pre_hook(hook)


def train_run(tag, model, run, kernel, per_step, batch):
    """``run(n_steps)`` TRAIN_WARMUP times one step (gradients checked
    finite), then TRAIN_STEPS steps with every count set to 0 just before
    and read just after; the events and losses come from the step wrapper
    that ``run`` installs. Returns (launches, metrics)."""
    events, losses, flags = [], [], []
    before = [p.detach().clone() for p in model.parameters()]
    torch.cuda.reset_peak_memory_stats()
    hook = check_grads_finite(run.optimizer(), flags)
    run(TRAIN_WARMUP, events, losses)
    torch.cuda.synchronize()
    hook.remove()
    # (the hook may run twice a step: ClippedAdamW.step calls AdamW.step)
    require(len(flags) >= TRAIN_WARMUP and bool(torch.stack(flags).all()),
            f"{tag}: non-finite gradients in the warm-up steps")
    events.clear()
    losses.clear()
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(TRAIN_STEPS, events, losses)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    step_ms = [s.elapsed_time(e) for s, e in events]
    loss_values = [float(x) for x in losses]
    moved = sum(int(not torch.equal(b, p.detach()))
                for b, p in zip(before, model.parameters()))
    ms = sum(step_ms) / len(step_ms)
    log(f"[{tag}] {len(step_ms)} steps of batch {batch}: device "
        f"{ms:.3f} ms per step ({', '.join(f'{x:.3f}' for x in step_ms)}), "
        f"{batch / (ms / 1e3):.2f} device clips/s; wall {wall:.3f} s, "
        f"{len(step_ms) * batch / wall:.2f} wall clips/s; peak "
        f"max_memory_allocated {peak / 2 ** 30:.2f} GiB; losses "
        f"{', '.join(f'{x:.5f}' for x in loss_values)}; launches {launches}")
    require(len(step_ms) == TRAIN_STEPS, f"{tag}: {len(step_ms)} steps ran")
    require(all(np.isfinite(loss_values)), f"{tag}: non-finite loss")
    n_params = len(before)
    require(moved == n_params, f"{tag}: {n_params - moved} of {n_params} "
            f"parameter tensors did not move")
    require(launches[kernel] == per_step * TRAIN_STEPS
            and launches[f"{kernel}_bwd"] == per_step * TRAIN_STEPS
            and attention_launches(launches) == 2 * per_step * TRAIN_STEPS,
            f"{tag}: launches {launches}, expected {per_step} x "
            f"{TRAIN_STEPS} of {kernel} and of {kernel}_bwd and no other "
            f"attention kernel")
    require_steady(tag, launches, TRAIN_STEPS)
    return launches, {
        "batch": batch, "steps": TRAIN_STEPS, "ms_per_step": ms,
        "step_ms": step_ms, "device_clips_per_s": batch / (ms / 1e3),
        "wall_s": wall, "wall_clips_per_s": TRAIN_STEPS * batch / wall,
        "peak_bytes": peak, "losses": loss_values,
        "launches_per_step": launches[kernel] / TRAIN_STEPS}


class RunnerSteps:
    """``fit`` of a runner over a dataset of ``n`` steps' worth of clips,
    its step function wrapped by ``timed_steps``."""

    def __init__(self, runner, shape, attr="train_ds"):
        self.runner, self.shape, self.attr = runner, shape, attr

    def optimizer(self):
        return self.runner.state.optimizer

    def __call__(self, n, events, losses):
        setattr(self.runner, self.attr,
                SyntheticClips(n * self.runner.batch_size, self.shape))
        self.runner.epochs = 1
        step = self.runner._step_fn
        timed_steps(self.runner, "_step_fn", events, losses)
        try:
            self.runner.fit()
        finally:
            self.runner._step_fn = step


def phase_finetune_vit():
    """``BackboneFinetuneRunner`` over full-depth ViT-L in bf16 (LLRD
    AdamW, mixup 0.8) at batch 8."""
    from tim_tpu_torch.runner.backbone import BackboneFinetuneRunner
    t0 = time.perf_counter()
    model = train_model("vit", "bfloat16", "cuda")
    built = time.perf_counter() - t0
    shape = BACKBONES["videomae"][1]
    runner = BackboneFinetuneRunner(
        model, SyntheticClips(TRAIN_BATCH * (TRAIN_WARMUP + TRAIN_STEPS),
                              shape), None,
        batch_size=TRAIN_BATCH, epochs=1, lr=1e-3, mixup_alpha=0.8,
        seed=SEED)
    runner.init_state()
    log(f"[finetune-vit] TwoHeadViT(ViT-L) bf16 "
        f"({sum(p.numel() for p in model.parameters())} params) in "
        f"{built:.2f} s, with its LLRD AdamW in "
        f"{time.perf_counter() - t0:.2f} s")
    out = train_run("finetune-vit", model, RunnerSteps(runner, shape),
                    "flash_mha", 24, TRAIN_BATCH)
    del runner, model
    torch.cuda.empty_cache()
    return out


class SwinSteps:
    """``make_two_head_step`` + AdamW(1e-4, wd 0.05), as
    ``scripts/bench_finetune_swin.py`` drives Swin-B, on batches of
    ``SyntheticClips`` moved to the card."""

    def __init__(self, model, batch):
        from tim_tpu_torch.runner.backbone import make_two_head_step
        from tim_tpu_torch.train.state import TrainState
        self.state = TrainState(model, torch.optim.AdamW(
            model.parameters(), lr=1e-4, weight_decay=0.05))
        self.step = make_two_head_step(model, mixup_alpha=0.8, seed=SEED)
        self.data = SyntheticClips(batch, BACKBONES["omnivore"][1])
        self.batch = batch

    def optimizer(self):
        return self.state.optimizer

    def __call__(self, n, events, losses):
        step = self.step
        timed_steps(self, "step", events, losses)
        try:
            for _ in range(n):
                items = [self.data[i] for i in range(self.batch)]
                batch = {k: torch.from_numpy(np.stack([e[k] for e in items]))
                         .cuda() for k in items[0]}
                self.step(self.state, batch)
        finally:
            self.step = step


def phase_finetune_swin():
    """Full-depth Swin-B in bf16 at batch 8 (it fits: about 24 GiB)."""
    t0 = time.perf_counter()
    model = train_model("swin", "bfloat16", "cuda")
    log(f"[finetune-swin] TwoHeadViT(Swin-B) bf16 "
        f"({sum(p.numel() for p in model.parameters())} params) in "
        f"{time.perf_counter() - t0:.2f} s")
    out = train_run("finetune-swin", model, SwinSteps(model, TRAIN_BATCH),
                    "window_attention", 24, TRAIN_BATCH)
    del model
    torch.cuda.empty_cache()
    return out


def phase_pretrain_mae():
    """``BackbonePretrainRunner`` over ``PretrainVideoMAE`` (ViT-L encoder,
    decoder 512 x 12 x 8 heads) in bf16 at batch 8, mask ratio 0.9."""
    from tim_tpu_torch.models.backbones.mae import PretrainVideoMAE
    from tim_tpu_torch.runner.backbone import BackbonePretrainRunner
    t0 = time.perf_counter()
    model = PretrainVideoMAE(dtype="bfloat16", device="cuda",
                             generator=torch.Generator().manual_seed(SEED))
    runner = BackbonePretrainRunner(
        model, SyntheticClips(TRAIN_BATCH, BACKBONES["videomae"][1]),
        mask_ratio=0.9, batch_size=TRAIN_BATCH, seed=SEED)
    runner.init_state()
    log(f"[pretrain-mae] PretrainVideoMAE bf16 "
        f"({sum(p.numel() for p in model.parameters())} params; "
        f"{runner.masking.total_masks} of "
        f"{int(np.prod(model.grid))} tubes masked) in "
        f"{time.perf_counter() - t0:.2f} s")
    out = train_run("pretrain-mae", model,
                    RunnerSteps(runner, BACKBONES["videomae"][1], "dataset"),
                    "flash_mha", 36, TRAIN_BATCH)
    del runner, model
    torch.cuda.empty_cache()
    return out


def phase_training(gen):
    """Phases 12-15; returns (kernel report, launches by path)."""
    report = timed("train-kernels", phase_training_kernels, gen)
    slices = {f"finetune-{kind}": timed(f"grad-slice-{kind}",
                                        phase_grad_slice_fp32, kind)
              for kind in ("vit", "swin")}
    by_path = {}
    for path, phase in (("finetune-vit", phase_finetune_vit),
                        ("finetune-swin", phase_finetune_swin),
                        ("pretrain-mae", phase_pretrain_mae)):
        launches, metrics = timed(path, phase)
        metrics["fp32_grad_slice_rel"] = slices.get(path)
        log(f"[{path}] summary {json.dumps(metrics)}")
        by_path[path] = launches
    return report, by_path


# Phase 16: TIM detection training and validation, EPIC-KITCHENS-100
# detection at full width (d_model 512, encoder 1024, 8 heads, FFN 2048,
# 3806 + 44 classes, 2 x 399 queries, S = 898), bf16, batch 64.
DET_BATCH, DET_WARMUP, DET_STEPS = 64, 2, 5
DET_METRIC_RTOL = 1e-4     # fp32 slice, card vs CPU: losses and metrics
DET_VAL_PATHS_RTOL = 1e-3  # bf16 validation, host vs banked path
DET_VAL_BF16_RTOL = 2e-2   # bf16 vs fp32 validation losses, same weights
DET_RESUME_TOL = 1e-5      # resumed vs uninterrupted step, of each largest


def det_split(cfg, videos, rng, *, seconds=150.0, num_aug=2):
    """A synthetic detection split built from numpy alone (no pandas):
    ``videos`` videos of ``seconds`` s, a 1 s feature every 0.2 s (``num_aug``
    augmentation sets, real widths), 30 s windows at a 1 s stride (feature
    stride 3), 40 actions a video of 1-8 s; a window's GT are the actions
    fully inside it. Returns a ``DetectionDataset`` (121 windows a video)."""
    from tim_tpu_torch.data.dataset import DetectionDataset, FeatureStore
    from tim_tpu_torch.data.windows import (
        Window, WindowSet, window_feat_indices)
    size, gap, stride = 30.0, 0.2, 3
    feats = {"v": {}, "a": {}}
    times, windows = {}, []
    max_v = max_a = 0
    for i in range(videos):
        vid = f"P{i:02d}_{i:02d}"
        starts = np.arange(0.0, seconds - 1.0, gap, dtype=np.float32)
        times[vid] = np.stack([starts, starts + 1.0], -1)
        for m, dim in (("v", cfg.visual_input_dim),
                       ("a", cfg.audio_input_dim)):
            feats[m][vid] = rng.standard_normal(
                (len(starts), num_aug, dim), dtype=np.float32)
        acts = []
        for audio in (False, True):
            start = rng.uniform(0.0, seconds - 8.0, 40)
            stop = start + rng.uniform(1.0, 8.0, 40)
            labels = np.stack([
                rng.integers(0, 97, 40), rng.integers(0, 300, 40),
                rng.integers(0, cfg.visual_classes[-1], 40),
                rng.integers(0, cfg.audio_classes, 40)], -1)
            labels[:, 3 if not audio else slice(0, 3)] = -1
            acts.append((np.stack([start, stop], -1).astype(np.float32),
                         labels))
        for w in range(int(seconds - size) + 1):
            lo, hi = float(w), float(w) + size
            win = Window(video_id=vid, start_sec=lo, stop_sec=hi,
                         feat_indices=window_feat_indices(
                             times[vid], lo, hi, stride, cfg.num_feats))
            (vq, vl), (aq, al) = [
                (q[(q[:, 0] >= lo) & (q[:, 1] <= hi)],
                 lab[(q[:, 0] >= lo) & (q[:, 1] <= hi)]) for q, lab in acts]
            win.v_queries, win.v_labels = vq, vl
            win.a_queries, win.a_labels = aq, al
            max_v, max_a = max(max_v, len(vq)), max(max_a, len(aq))
            windows.append(win)
    ws = WindowSet(windows=windows, max_visual_actions=max_v,
                   max_audio_actions=max_a, num_actions=80 * videos,
                   window_size=size)
    return DetectionDataset(
        ws, FeatureStore(feats["v"], times), FeatureStore(feats["a"], times),
        dataset_name="synthetic")


def det_batch(ds, n, device):
    """The first ``n`` windows of ``ds`` as a batch of tensors on
    ``device``."""
    from tim_tpu_torch.data.dataset import batch_iterator
    batch = next(batch_iterator(ds, n, shuffle=False))
    return {k: torch.from_numpy(np.asarray(v)).to(device)
            for k, v in batch.items() if not k.startswith("_")}


def det_state(model, tcfg):
    from tim_tpu_torch.train.optim import make_optimizer
    from tim_tpu_torch.train.state import create_train_state
    return create_train_state(model, make_optimizer(
        model.parameters(), tcfg.lr, tcfg.weight_decay, 100, 10,
        min_lr=tcfg.min_lr, clip_norm=tcfg.clip_norm),
        normaliser=tcfg.normaliser_init)


def captured_grads(state):
    """{name: gradient} as the optimizer's step is about to use them."""
    grads = {}
    names = {id(p): n for n, p in state.model.named_parameters()}

    def hook(opt, args, kwargs):
        for group in opt.param_groups:
            for p in group["params"]:
                grads[names[id(p)]] = p.grad.detach().clone()
    state.optimizer.register_step_pre_hook(hook)
    return grads


def phase_det_grad_slice_fp32(train_ds):
    """16a: one fp32 train step of full-width ``epic_detection`` with 2
    encoder layers (every dropout rate 0, drloc 0.3) on 2 windows, on the
    card and on the CPU with the same draws: losses and metrics, every
    parameter gradient and the normaliser."""
    from tim_tpu_torch import config as C
    from tim_tpu_torch.models import TimDetection
    from tim_tpu_torch.train.detection import make_train_step
    cfg = C.epic_detection(compute_dtype="float32", num_layers=2,
                           enc_dropout=0.0, feat_dropout=0.0,
                           seq_dropout=0.0)
    tcfg = C.TrainConfig(lambda_drloc=0.3)
    cpu_model = TimDetection(cfg, device="cpu",
                             generator=torch.Generator().manual_seed(SEED))
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    batch = det_batch(train_ds, 2, "cpu")   # its augmentation sets drawn once
    out = {}
    for dev, model in (("cuda", gpu_model), ("cpu", cpu_model)):
        state = det_state(model, tcfg)
        grads = captured_grads(state)
        counters = launch_counters()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        metrics = make_train_step(model, cfg, tcfg)(
            state, {k: v.to(dev) for k, v in batch.items()})
        metrics = {k: v.double().cpu() for k, v in metrics.items()}
        out[dev] = (metrics, grads, float(state.normaliser),
                    {n: fn.launches for n, fn in counters.items()},
                    time.perf_counter() - t0)
    (gm, gg, gn, launches, g_s), (cm, cg, cn, _, c_s) = out["cuda"], out["cpu"]
    log(f"[det-grad-slice] fp32 step of 2 windows, 2 layers: card "
        f"{g_s:.2f} s, CPU {c_s:.2f} s; launches on the card {launches}")
    require(launches["query_block_attention"] == 0
            and launches["fused_post_attention"] == 0
            and attention_launches(launches) == 0,
            f"det fp32 train step launched {launches}")
    require(sorted(gm) == sorted(cm), "det fp32 slice: metric keys differ")
    rels = {k: abs(float(gm[k]) - float(cm[k])) / max(abs(float(cm[k])),
                                                      1e-30) for k in cm}
    for k in sorted(cm):
        log(f"[det-grad-slice] {k}: card {float(gm[k]):.8g}, CPU "
            f"{float(cm[k]):.8g} (rel {rels[k]:.2e})")
    worst_m = max(rels.values())
    require(worst_m <= DET_METRIC_RTOL, f"det fp32 slice metrics: card vs "
            f"CPU {worst_m} > {DET_METRIC_RTOL}")
    require(abs(gn - cn) <= DET_METRIC_RTOL * abs(cn) and gn != 250.0,
            f"det fp32 slice normaliser: card {gn}, CPU {cn}")
    require(sorted(gg) == sorted(cg) and len(cg) == len(list(
        cpu_model.parameters())), "det fp32 slice: gradients missing")
    worst, worst_name = 0.0, ""
    for name in cg:
        g, c = gg[name].cpu(), cg[name]
        require(bool(torch.isfinite(g).all()), f"det {name}: non-finite")
        rel = max_err(g, c) / max(c.abs().max().item(), 1e-30)
        if rel > worst:
            worst, worst_name = rel, name
        require(rel <= GRAD_SLICE_TOL, f"det fp32 gradient {name}: card vs "
                f"CPU {rel} of its largest value > {GRAD_SLICE_TOL}")
    log(f"[det-grad-slice] {len(cg)} parameter gradients within {worst:.3e} "
        f"of each tensor's largest value (worst {worst_name}; tol "
        f"{GRAD_SLICE_TOL}); metrics within {worst_m:.2e} (tol "
        f"{DET_METRIC_RTOL}); normaliser card {gn:.6f}, CPU {cn:.6f}")
    del cpu_model, gpu_model
    torch.cuda.empty_cache()
    return {"grad_rel": worst, "metric_rel": worst_m}


def det_runner(cfg, train_ds, val_ds, banked):
    from tim_tpu_torch import config as C
    from tim_tpu_torch.runner.detection import DetectionRunner
    tcfg = C.TrainConfig(batch_size=DET_BATCH, epochs=1, seed=SEED)
    runner = DetectionRunner(cfg, tcfg, train_ds, val_ds, print_freq=1000,
                             use_device_bank=banked, device="cuda")
    runner.init_state()
    return runner


def phase_det_train(train_ds, val_ds):
    """16b: ``DetectionRunner.train_epoch`` (banked: the split on the card,
    a batch a tensor of window ids) over 7 batches of 64 windows, bf16,
    every dropout on: 2 warm-up steps, then 5 timed steps with every count
    set to 0 just before them and read just after."""
    from tim_tpu_torch import config as C
    runner = det_runner(C.epic_detection(), train_ds, val_ds, True)
    require(runner._tables.num_windows // DET_BATCH == DET_WARMUP + DET_STEPS,
            f"det split of {runner._tables.num_windows} windows")
    before = [p.detach().clone() for p in runner.model.parameters()]
    counters = launch_counters()
    events, metrics, marks = [], [], {}
    step = runner._bank_step

    def timed_step(state, batch):
        if len(metrics) == DET_WARMUP:
            torch.cuda.synchronize()
            for fn in counters.values():
                fn.launches = 0
            marks["t0"] = time.perf_counter()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = step(state, batch)
        end.record()
        events.append((start, end))
        metrics.append(out)
        return out

    torch.cuda.reset_peak_memory_stats()
    runner._bank_step = timed_step
    try:
        runner.train_epoch(0)
    finally:
        runner._bank_step = step
    torch.cuda.synchronize()
    wall = time.perf_counter() - marks["t0"]
    launches = {n: fn.launches for n, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    step_ms = [s.elapsed_time(e) for s, e in events[DET_WARMUP:]]
    losses = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    normaliser = float(runner.state.normaliser)
    moved = sum(int(not torch.equal(b, p.detach()))
                for b, p in zip(before, runner.model.parameters()))
    ms = sum(step_ms) / len(step_ms)
    log(f"[det-train] {len(step_ms)} steps of batch {DET_BATCH}: device "
        f"{ms:.3f} ms per step ({', '.join(f'{x:.3f}' for x in step_ms)}), "
        f"{DET_BATCH / (ms / 1e3):.2f} device windows/s; wall {wall:.3f} s, "
        f"{DET_STEPS * DET_BATCH / wall:.2f} wall windows/s; peak "
        f"max_memory_allocated {peak / 2 ** 30:.2f} GiB; losses "
        f"{', '.join(f'{x:.5f}' for x in losses)}; grad norms "
        f"{', '.join(f'{x:.4f}' for x in norms)}; normaliser "
        f"{normaliser:.4f}; launches {launches}")
    require(len(step_ms) == DET_STEPS, f"det-train: {len(step_ms)} steps")
    require(all(np.isfinite(losses)) and all(np.isfinite(norms)),
            "det-train: non-finite loss or gradient norm")
    n_params = len(before)
    require(moved == n_params, f"det-train: {n_params - moved} of "
            f"{n_params} parameter tensors did not move")
    require(normaliser != 250.0, "det-train: the normaliser stayed 250")
    require(attention_launches(launches) == 0,
            f"det-train: launches {launches}, expected no kernel 1, 2 or "
            f"other attention kernel in a train step")
    require_steady("det-train", launches, DET_STEPS)
    return runner, launches, {
        "batch": DET_BATCH, "steps": DET_STEPS, "ms_per_step": ms,
        "step_ms": step_ms, "device_windows_per_s": DET_BATCH / (ms / 1e3),
        "wall_s": wall, "wall_windows_per_s": DET_STEPS * DET_BATCH / wall,
        "peak_bytes": peak, "losses": losses, "grad_norms": norms,
        "normaliser": normaliser,
        "bias_act_per_step": launches["bias_act"] / DET_STEPS}


def det_validate(tag, runner):
    """``runner.validate()`` with every count set to 0 just before and read
    just after, its val steps timed by CUDA events. Returns (losses,
    launches, batches, metrics)."""
    counters = launch_counters()
    events = []
    step = runner._val_step

    def timed(state, batch):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = step(state, batch)
        end.record()
        events.append((start, end))
        return out

    runner._val_step = timed
    try:
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        losses = runner.validate()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {n: fn.launches for n, fn in counters.items()}
    finally:
        runner._val_step = step
    n_batches = len(events)
    windows = n_batches * DET_BATCH
    device = sum(s.elapsed_time(e) for s, e in events)
    log(f"[{tag}] {n_batches} batches of {DET_BATCH}: device {device:.3f} "
        f"ms, {windows / (device / 1e3):.2f} device windows/s; wall "
        f"{wall:.3f} s, {windows / wall:.2f} wall windows/s; losses "
        f"{json.dumps(losses)}; launches {launches}")
    require(all(np.isfinite(v) for v in losses.values()),
            f"{tag}: non-finite losses")
    return losses, launches, n_batches, {
        "batches": n_batches, "device_ms": device,
        "device_windows_per_s": windows / (device / 1e3),
        "wall_s": wall, "wall_windows_per_s": windows / wall}


def phase_det_val(runner, val_ds):
    """16c: ``validate`` of the trained weights in bf16 on the banked path
    (the runner of 16b) and on the host path, and in fp32 (host path):
    kernel 1 six times a batch, kernel 2 never; host vs banked losses;
    bf16 vs fp32 losses."""
    from tim_tpu_torch import config as C
    sd = runner.model.state_dict()
    out = {}
    for tag, cfg, banked in (
            ("det-val-banked", C.epic_detection(), True),
            ("det-val-host", C.epic_detection(), False),
            ("det-val-fp32", C.epic_detection(compute_dtype="float32"),
             False)):
        r = runner if banked else det_runner(cfg, None, val_ds, False)
        if r is not runner:
            r.load_torch_checkpoint(sd)
            r.state.normaliser = runner.state.normaliser.clone()
        losses, launches, n_batches, m = det_validate(tag, r)
        if cfg.compute_dtype == "bfloat16":
            require(launches["query_block_attention"]
                    == cfg.num_layers * n_batches
                    and launches["fused_post_attention"] == 0,
                    f"{tag}: launches {launches}, expected kernel 1 "
                    f"{cfg.num_layers} x {n_batches} batches, kernel 2 never")
            require_steady(tag, launches, n_batches)
        out[tag] = (losses, launches, m)
        if r is not runner:
            del r
            torch.cuda.empty_cache()
    banked, host, fp32 = (out[t][0] for t in (
        "det-val-banked", "det-val-host", "det-val-fp32"))
    require(sorted(banked) == sorted(host) == sorted(fp32),
            "det-val: loss keys differ")
    rel_paths = max(abs(banked[k] - host[k]) / max(abs(host[k]), 1e-30)
                    for k in host)
    rel_bf16 = max(abs(host[k] - fp32[k]) / max(abs(fp32[k]), 1e-30)
                   for k in fp32)
    log(f"[det-val] banked vs host losses within {rel_paths:.3e} (tol "
        f"{DET_VAL_PATHS_RTOL}); bf16 vs fp32 within {rel_bf16:.3e} (tol "
        f"{DET_VAL_BF16_RTOL})")
    require(rel_paths <= DET_VAL_PATHS_RTOL,
            f"det-val: banked vs host {rel_paths} > {DET_VAL_PATHS_RTOL}")
    require(rel_bf16 <= DET_VAL_BF16_RTOL,
            f"det-val: bf16 vs fp32 {rel_bf16} > {DET_VAL_BF16_RTOL}")
    metrics = {t: out[t][2] for t in out}
    metrics.update(paths_rel=rel_paths, bf16_vs_fp32_rel=rel_bf16)
    return out["det-val-banked"][1], metrics


def phase_det_resume(runner, train_ds):
    """16d: save the state after the timed steps, ``resume`` it into a
    fresh runner: step, normaliser, optimizer state and parameters equal;
    then one more step from both: parameters within DET_RESUME_TOL."""
    import tempfile
    from tim_tpu_torch import config as C
    from tim_tpu_torch.train.checkpoint import save_checkpoint
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        save_checkpoint(tmp, runner.state, epoch=1)
        fresh = det_runner(C.epic_detection(), train_ds, None, True)
        epoch = fresh.resume(tmp)
        io_s = time.perf_counter() - t0
    a, b = runner.state, fresh.state
    require(epoch == 1 and a.step == b.step
            and torch.equal(a.normaliser, b.normaliser),
            f"det-resume: epoch {epoch}, step {a.step} vs {b.step}, "
            f"normaliser {float(a.normaliser)} vs {float(b.normaliser)}")
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    same = all(torch.equal(sa["state"][i][k], sb["state"][i][k])
               for i in sa["state"] for k in sa["state"][i])
    same &= all(torch.equal(sa["if_finite"][k], sb["if_finite"][k])
                for k in sa["if_finite"])
    same &= all(torch.equal(p, q) for p, q in zip(
        a.model.state_dict().values(), b.model.state_dict().values()))
    require(same and len(sa["state"]) == len(sb["state"]),
            "det-resume: optimizer state or parameters differ after resume")
    ids = torch.arange(DET_BATCH, device="cuda")
    for r in (runner, fresh):
        r._bank_step(r.state, r._tables.batch(ids))
    pairs = list(zip(a.model.parameters(), b.model.parameters()))
    worst = max(max_err(p, q) / max(p.abs().max().item(), 1e-30)
                for p, q in pairs)
    equal = sum(int(torch.equal(p, q)) for p, q in pairs)
    log(f"[det-resume] checkpoint save + resume {io_s:.2f} s; state equal "
        f"after resume; one more step from both: parameters within "
        f"{worst:.3e} of each tensor's largest value (tol {DET_RESUME_TOL}), "
        f"{equal} of {len(pairs)} tensors bit-equal")
    require(worst <= DET_RESUME_TOL, f"det-resume: {worst} > "
            f"{DET_RESUME_TOL}")
    del fresh
    torch.cuda.empty_cache()
    return {"resume_rel": worst, "save_resume_s": io_s}


def phase_detection_training():
    """Phases 16 and 18; returns the launches of the train, validation and
    mAP paths, and the splits."""
    from tim_tpu_torch import config as C
    cfg = C.epic_detection()
    rng = np.random.default_rng(SEED + 3)
    t0 = time.perf_counter()
    train_ds, val_ds = det_split(cfg, 4, rng), det_split(cfg, 4, rng)
    log(f"[det] synthetic splits of {len(train_ds)} and {len(val_ds)} "
        f"windows ({cfg.visual_input_dim} + {cfg.audio_input_dim} wide "
        f"features) in {time.perf_counter() - t0:.2f} s")
    summary = {"grad_slice": timed("det-grad-slice",
                                   phase_det_grad_slice_fp32, train_ds)}
    runner, train_launches, summary["train"] = timed(
        "det-train", phase_det_train, train_ds, val_ds)
    val_launches, summary["val"] = timed("det-val", phase_det_val, runner,
                                         val_ds)
    summary["resume"] = timed("det-resume", phase_det_resume, runner,
                              train_ds)
    map_launches, summary["map"] = timed("det-map", phase_det_map, runner,
                                         val_ds)
    log(f"[det] summary {json.dumps(summary)}")
    del runner
    torch.cuda.empty_cache()
    return {"det-train": train_launches, "det-val": val_launches,
            "det-map": map_launches}, (train_ds, val_ds)


# Phase 17: TIM recognition at the full width of ``epic_recognition``
# (d_model 512, encoder 1024, 8 heads of 128, 4 layers, FFN 2048, 100
# context tokens, heads 97/300/3806/44), random weights from the seed.
REC_BATCH, REC_WARMUP, REC_STEPS = 64, 2, 5
REC_INTERVALS, REC_ENSEMBLE = 200, 5
REC_SLICE_TOL = 1e-3        # fp32 logits card vs CPU, of the largest
REC_BF16_DP = 0.1           # bf16 vs fp32 serving probabilities
# int8 static vs fp32 serving: tests/test_serve.py's contract
REC_INT8_AGREE, REC_INT8_DP = 0.75, 0.25
REC_VAL_RTOL = 1e-5         # banked vs host validation statistics
REC_METRIC_RTOL = 1e-4      # fp32 train step, card vs CPU: losses
# Random class heads give near-uniform scores over 3806 classes, whose
# top-1 any rounding flips; their weights are scaled up so that the
# logits spread (std ~2) and the top-1 and agreement gates mean something.
REC_HEAD_GAIN = 4.0


def rec_split(cfg, videos, rng, *, seconds=150.0, num_aug=2, per_video=40):
    """A synthetic recognition split built from numpy alone (no pandas):
    ``videos`` videos of ``seconds`` s, a 1 s feature every 0.2 s
    (``num_aug`` augmentation sets, real widths), 30 s windows at a 1 s
    stride (feature stride 3), ``per_video`` visual and as many audio
    actions a video of 1-8 s, each with its own action id; a window's
    queries are the actions fully inside it (every action is inside one).
    Returns a ``RecognitionDataset`` (121 windows a video)."""
    from tim_tpu_torch.data.dataset import FeatureStore, RecognitionDataset
    from tim_tpu_torch.data.windows import (
        Window, WindowSet, window_feat_indices)
    size, gap, stride = 30.0, 0.2, 3
    vc = cfg.visual_classes
    feats = {"v": {}, "a": {}}
    times, windows = {}, []
    max_v = max_a = next_id = 0
    for i in range(videos):
        vid = f"P{i:02d}_{i:02d}"
        starts = np.arange(0.0, seconds - 1.0, gap, dtype=np.float32)
        times[vid] = np.stack([starts, starts + 1.0], -1)
        for m, dim in (("v", cfg.visual_input_dim),
                       ("a", cfg.audio_input_dim)):
            feats[m][vid] = rng.standard_normal(
                (len(starts), num_aug, dim), dtype=np.float32)
        acts = []
        for prefix in ("v", "a"):
            start = rng.uniform(0.0, seconds - 8.0, per_video)
            stop = start + rng.uniform(1.0, 8.0, per_video)
            labels = -np.ones((per_video, 4), np.int64)
            if prefix == "v":
                for col, n in enumerate((vc[0], vc[1], vc[-1])):
                    labels[:, col] = rng.integers(0, n, per_video)
            else:
                labels[:, 3] = rng.integers(0, cfg.audio_classes, per_video)
            ids = np.arange(next_id, next_id + per_video)
            next_id += per_video
            acts.append((prefix, np.stack([start, stop], -1).astype(
                np.float32), labels, ids))
        for w in range(int(seconds - size) + 1):
            lo, hi = float(w), float(w) + size
            win = Window(video_id=vid, start_sec=lo, stop_sec=hi,
                         feat_indices=window_feat_indices(
                             times[vid], lo, hi, stride, cfg.num_feats))
            for prefix, q, lab, ids in acts:
                inside = np.flatnonzero((q[:, 0] >= lo) & (q[:, 1] <= hi))
                setattr(win, f"{prefix}_queries", q[inside])
                setattr(win, f"{prefix}_labels", lab[inside])
                setattr(win, f"{prefix}_action_ids", ids[inside])
                setattr(win, f"{prefix}_narration_ids",
                        [f"{prefix}_{j}" for j in ids[inside]])
            max_v = max(max_v, len(win.v_queries))
            max_a = max(max_a, len(win.a_queries))
            windows.append(win)
    ws = WindowSet(windows=windows, max_visual_actions=max_v,
                   max_audio_actions=max_a, num_actions=next_id,
                   window_size=size)
    return RecognitionDataset(ws, FeatureStore(feats["v"], times),
                              FeatureStore(feats["a"], times),
                              rng=np.random.default_rng(SEED))


class EventTimed:
    """``fn`` with each call's device time recorded by CUDA events."""

    def __init__(self, fn):
        self.fn = fn
        self.events = []

    def __call__(self, *args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.fn(*args, **kwargs)
        end.record()
        self.events.append((start, end))
        return out

    def device_ms(self) -> float:
        return sum(s.elapsed_time(e) for s, e in self.events)


def zero_counts():
    counters = launch_counters()
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    return counters


def read_counts(counters):
    torch.cuda.synchronize()
    return {name: fn.launches for name, fn in counters.items()}


def rec_cpu_model(cfg):
    """A full-width ``TimRecognition`` on the CPU from the seed, its class
    heads scaled by REC_HEAD_GAIN, and its state dict."""
    from tim_tpu_torch.models import TimRecognition
    model = TimRecognition(cfg, device="cpu",
                           generator=torch.Generator().manual_seed(SEED))
    with torch.no_grad():
        for name, p in model.cls_head.named_parameters():
            if name.endswith("weight"):
                p.mul_(REC_HEAD_GAIN)
    return model, model.state_dict()


def rec_inputs(cfg, b, nv, na, rng, device):
    """A random forward batch (v, a, times) on ``device``."""
    f = cfg.num_feats
    v = rng.normal(size=(b, f, cfg.visual_input_dim)).astype(np.float32)
    a = rng.normal(size=(b, f, cfg.audio_input_dim)).astype(np.float32)
    t = np.sort(rng.uniform(0, 1, (b, cfg.num_context + nv + na, 2)),
                -1).astype(np.float32)
    return tuple(torch.from_numpy(x).to(device) for x in (v, a, t))


def phase_rec_slice_fp32(rng):
    """17a: the fp32 forward of full-width ``TimRecognition`` on 2 windows
    (3 visual queries a head, 2 audio), card vs CPU, kernel 1 once a
    layer on the card; returns the state dict."""
    from tim_tpu_torch import config as C
    from tim_tpu_torch.models import TimRecognition
    cfg = C.epic_recognition(compute_dtype="float32")
    cpu_model, sd = rec_cpu_model(cfg)
    gpu_model = TimRecognition(cfg, device="cuda")
    gpu_model.load_state_dict(sd, strict=True)
    nv, na = 3, 2
    inputs = rec_inputs(cfg, 2, nv, na, rng, "cpu")
    counters = zero_counts()
    with torch.inference_mode():
        got, gctx = gpu_model(*(x.cuda() for x in inputs), nv, na)
    launches = read_counts(counters)
    with torch.inference_mode():
        want, wctx = cpu_model(*inputs, nv, na)
    require(launches["query_block_attention"] == cfg.num_layers,
            f"rec-slice-fp32: launches {launches}")
    worst = 0.0
    for name, g, w in zip(("verb", "noun", "action", "audio"), got, want):
        rel = max_err(g.cpu(), w) / w.abs().max().item()
        worst = max(worst, rel)
        log(f"[rec-slice-fp32] {name} logits {tuple(w.shape)}: card vs CPU "
            f"max abs {max_err(g.cpu(), w):.3e}, {rel:.3e} of the largest "
            f"{w.abs().max().item():.3f} (tol {REC_SLICE_TOL})")
        require(bool(torch.isfinite(g).all()) and rel <= REC_SLICE_TOL,
                f"rec-slice-fp32 {name}: {rel} > {REC_SLICE_TOL}")
    ctx_rel = max_err(gctx.cpu(), wctx) / wctx.abs().max().item()
    require(ctx_rel <= REC_SLICE_TOL, f"rec-slice-fp32 context {ctx_rel}")
    log(f"[rec-slice-fp32] context tokens within {ctx_rel:.3e}; launches "
        f"{launches}")
    return sd, {"logits_rel": worst, "context_rel": ctx_rel}


def rec_qkv_views(batch, nq, dtype, gen, f=100, heads=8, dh=128):
    """Kernel 1's inputs as a recognition layer hands them over: strided
    [B, H, S, dh] views of one packed projection of S = F + Nq tokens."""
    s, width = f + nq, heads * dh
    qkv = torch.randn(batch, s, 3 * width, generator=gen, device="cuda")
    q, k, v = qkv.to(dtype).view(batch, s, 3, heads, dh).permute(
        2, 0, 3, 1, 4)
    return (q[:, :, f:], k[:, :, :f], k[:, :, f:], v[:, :, :f], v[:, :, f:])


def phase_rec_kernels(gen, nq_val):
    """17b: kernel 1 against its plain version at the recognition shapes:
    serving [64, 8, 4, 128] (one query a head: verb, noun, action, audio)
    and validation [64, 8, 3 nv + na, 128], fp32 and bf16 (the bf16 gate
    shown to reject the self term dropped); timed in bf16 beside the plain
    version and masked SDPA, with the bound."""
    from tim_tpu_torch.ops import query_block_attention as qba
    report = {}
    for tag, nq in (("serve", 4), ("val", nq_val)):
        for dtype in (torch.float32, torch.bfloat16):
            args = rec_qkv_views(REC_BATCH, nq, dtype, gen)
            got = qba.query_block_attention(*args)
            want = qba.query_block_attention_plain(*args)
            ok, err, rel = query_block_close(got, want)
            log(f"[rec-kernels] query_block_attention {tag} {dtype} "
                f"{tuple(got.shape)}: max_abs_err={err:.3e}, relative RMS "
                f"{rel:.3e}")
            require(ok, f"rec-kernels {tag} {dtype}: kernel 1 disagrees "
                    f"({err}, {rel})")
        c_ok, c_err, _ = query_block_close(
            query_block_without_self(*args), want)
        log(f"[rec-kernels] {tag} bf16 control 'self term dropped': max abs "
            f"{c_err:.3e}, {'passes' if c_ok else 'rejected'}")
        require(not c_ok, f"rec-kernels {tag}: the bf16 gate passes the "
                f"self term dropped")
        b, h, _, dh = args[0].shape
        f = args[1].shape[2]
        ms, host_ms = device_ms(lambda: qba.query_block_attention(*args))
        plain_ms = cuda_ms(lambda: qba.query_block_attention_plain(*args))
        sdpa = masked_sdpa_args(*args)
        library_ms, _ = device_ms(lambda: F.scaled_dot_product_attention(
            sdpa[0], sdpa[1], sdpa[2], attn_mask=sdpa[3]))
        bound_ms, by = bound(nbytes(*args) + nbytes(got),
                             4 * b * h * nq * (f + 1) * dh, "bf16")
        report[tag] = {"shape": [b, h, nq, dh], "max_abs_err": err,
                       "ms": ms, "host_ms": host_ms, "plain_ms": plain_ms,
                       "library_ms": library_ms, "bound_ms": bound_ms,
                       "bound_by": by}
        log(f"[rec-kernels] query_block_attention {tag} bf16 "
            f"{[b, h, nq, dh]}: kernel {ms:.4f} ms (host {host_ms:.4f} ms a "
            f"call), plain {plain_ms:.4f} ms, masked SDPA "
            f"{library_ms:.4f} ms, bound {bound_ms:.5f} ms ({by}, "
            f"{100 * bound_ms / ms:.1f}%)")
        del args, got, want, sdpa
    return report


def rec_video(cfg, rng, n_intervals=REC_INTERVALS):
    """A ~300 s video (a feature every 0.2 s) and ``n_intervals`` random
    intervals of 1-8 s in it."""
    v, a, feat_times, duration = synthetic_video(cfg, rng)
    start = rng.uniform(0.0, duration - 9.0, n_intervals)
    intervals = np.stack([start, start + rng.uniform(1.0, 8.0, n_intervals)],
                         -1).astype(np.float32)
    return v, a, feat_times, intervals


def rec_calibration_batch(cfg, video, n, window_size=30.0):
    """(v, a, times) of the first ``n`` intervals, each in its first
    covering window, assembled as ``classify_intervals`` assembles them."""
    from tim_tpu_torch.data.windows import window_feat_indices
    v, a, feat_times, intervals = video
    vs, as_, ts = [], [], []
    for s, e in intervals[:n]:
        ws = max(0.0, float(np.ceil(max(0.0, e - window_size))))
        idx = window_feat_indices(feat_times, ws,
                                  min(ws + window_size, feat_times[-1, 1]),
                                  3, cfg.num_feats)
        t = np.concatenate([feat_times[idx, :2]] * 2
                           + [np.asarray([[s, e]], np.float32)] * 2)
        vs.append(v[idx])
        as_.append(a[idx])
        ts.append(np.clip((t - ws) / window_size, 0.0, None))
    return tuple(np.stack(x).astype(np.float32) for x in (vs, as_, ts))


def rec_serve_run(tag, server, video, per_batch):
    """A warm-up on 8 intervals, then ``classify_intervals`` over the
    video's intervals with every count set to 0 just before and read just
    after; its forwards timed by CUDA events. Returns (scores, launches,
    metrics)."""
    v, a, feat_times, intervals = video
    server.classify_intervals(v, a, feat_times, intervals[:8])
    jobs = sum(len(server._covering_windows(float(s), float(e)))
               for s, e in intervals)
    n_batches = -(-jobs // server.batch_size)
    model = server.model
    server.model = timed_model = EventTimed(model)
    try:
        counters = zero_counts()
        t0 = time.perf_counter()
        out = server.classify_intervals(v, a, feat_times, intervals)
        wall = time.perf_counter() - t0
        launches = read_counts(counters)
    finally:
        server.model = model
    device = timed_model.device_ms()
    n = len(intervals)
    log(f"[{tag}] {n} intervals, {jobs} windows in {n_batches} batches of "
        f"{server.batch_size}: device {device:.3f} ms, "
        f"{n / (device / 1e3):.2f} device intervals/s; wall {wall:.3f} s, "
        f"{n / wall:.2f} wall intervals/s; launches {launches}")
    require(sorted(out) == ["action", "audio", "noun", "verb"],
            f"{tag}: heads {sorted(out)}")
    for name, p in out.items():
        require(bool(np.isfinite(p).all()) and p.shape[0] == n
                and np.allclose(p.sum(-1), 1.0, atol=1e-6),
                f"{tag} {name}: not a distribution per interval")
    require_launches(tag, launches, per_batch, n_batches)
    if server.cfg.compute_dtype == "bfloat16":
        require_steady(tag, launches, n_batches)
    return out, launches, {
        "intervals": n, "windows": jobs, "batches": n_batches,
        "device_ms": device, "device_intervals_per_s": n / (device / 1e3),
        "wall_s": wall, "wall_intervals_per_s": n / wall}


def score_agreement(got, want):
    """(top-1 agreement over every head's intervals, max |delta p|)."""
    agree = total = 0
    dp = 0.0
    for head in want:
        agree += int((got[head].argmax(-1) == want[head].argmax(-1)).sum())
        total += len(want[head])
        dp = max(dp, float(np.abs(got[head] - want[head]).max()))
    return agree / total, dp


def phase_rec_serve(sd, rng):
    """17c: ``RecognitionServer.classify_intervals`` (ensemble 5, batch 64)
    over 200 intervals of a synthetic 300 s video in fp32, bf16, int8
    static (calibrated on 16 of the intervals' windows) and bf16 with the
    fused tail (kernel 2): kernel 1 once a layer a batch on every path,
    kernel 2 only with the fused tail, kernel 3 never (int8 recognition
    heads are the static int8 linear, as in JAX); bf16 and int8 scores
    against fp32."""
    from tim_tpu_torch import config as C
    from tim_tpu_torch.serve import RecognitionServer
    video = rec_video(C.epic_recognition(), rng)
    kw = dict(device="cuda", ensemble=REC_ENSEMBLE, batch_size=REC_BATCH)
    layers = C.epic_recognition().num_layers
    plain = {"query_block_attention": layers, "fused_post_attention": 0,
             "int8_matmul_fused": 0}
    runs, launches, metrics = {}, {}, {}
    for tag, cfg, quantized in (
            ("serve-rec-fp32", C.epic_recognition(compute_dtype="float32"),
             False),
            ("serve-rec-bf16", C.epic_recognition(), False),
            ("serve-rec-int8", C.epic_recognition(), True),
            ("serve-rec-fused", C.epic_recognition(use_fused_ffn=True),
             False)):
        t0 = time.perf_counter()
        if quantized:
            server = RecognitionServer.quantized(
                cfg, sd, [rec_calibration_batch(cfg, video, 16)], **kw)
        else:
            server = RecognitionServer(cfg, sd, **kw)
        log(f"[{tag}] server built in {time.perf_counter() - t0:.2f} s")
        per_batch = dict(plain)
        if cfg.use_fused_ffn:
            per_batch["fused_post_attention"] = layers
        runs[tag], launches[tag], metrics[tag] = rec_serve_run(
            tag, server, video, per_batch)
        del server
        torch.cuda.empty_cache()
    want = runs["serve-rec-fp32"]
    for tag, limit, agree_min in (
            ("serve-rec-bf16", REC_BF16_DP, None),
            ("serve-rec-fused", REC_BF16_DP, None),
            ("serve-rec-int8", REC_INT8_DP, REC_INT8_AGREE)):
        agree, dp = score_agreement(runs[tag], want)
        metrics[tag].update(top1_agreement_vs_fp32=agree, max_dp_vs_fp32=dp)
        log(f"[{tag}] vs fp32: top-1 agreement {agree:.4f}, max |dp| "
            f"{dp:.4e} (tol {limit}"
            + (f", agreement >= {agree_min})" if agree_min else ")"))
        require(dp <= limit, f"{tag}: max |dp| vs fp32 {dp} > {limit}")
        if agree_min is not None:
            require(agree >= agree_min, f"{tag}: top-1 agreement {agree} < "
                    f"{agree_min}")
    top = want["action"].max(-1)
    log(f"[serve-rec] fp32 action top-1 probability: median "
        f"{np.median(top):.4f}, min {top.min():.4f}")
    return launches, metrics


def rec_runner(cfg, train_ds, val_ds, banked, **tkw):
    from tim_tpu_torch import config as C
    from tim_tpu_torch.runner.recognition import RecognitionRunner
    tcfg = C.TrainConfig(batch_size=REC_BATCH, epochs=1, seed=SEED, **tkw)
    runner = RecognitionRunner(cfg, tcfg, train_ds, val_ds, print_freq=1000,
                               use_device_bank=banked, device="cuda")
    runner.init_state()
    return runner


def phase_rec_grad_slice_fp32(train_ds):
    """17d (i): one fp32 train step of full-width ``epic_recognition``
    cut to 2 encoder layers (every dropout rate 0, mixup 0.2, drloc 0.3)
    on 2 windows, on the card and on the CPU with the same draws: losses
    and every parameter gradient (the middle third of ``in_proj_bias``,
    the k bias, whose gradient is 0 in exact arithmetic, excepted)."""
    from tim_tpu_torch import config as C
    from tim_tpu_torch.data.dataset import batch_iterator
    from tim_tpu_torch.models import TimRecognition
    from tim_tpu_torch.train.recognition import make_train_step
    cfg = C.epic_recognition(compute_dtype="float32", num_layers=2,
                             enc_dropout=0.0, feat_dropout=0.0,
                             seq_dropout=0.0)
    tcfg = C.TrainConfig(mixup_alpha=0.2, lambda_drloc=0.3)
    cpu_model = TimRecognition(cfg, device="cpu",
                               generator=torch.Generator().manual_seed(SEED))
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    train_ds.sample_augmentations = False
    batch = next(batch_iterator(train_ds, 2, shuffle=False))
    train_ds.sample_augmentations = True
    ws = train_ds.windows
    nv, na = ws.max_visual_actions, ws.max_audio_actions
    out = {}
    for dev, model in (("cuda", gpu_model), ("cpu", cpu_model)):
        state = det_state(model, tcfg)
        grads = captured_grads(state)
        counters = zero_counts()
        metrics = make_train_step(model, cfg, tcfg, nv, na)(
            state, {k: torch.from_numpy(np.asarray(v)).to(dev)
                    for k, v in batch.items() if not k.startswith("_")
                    and not k.endswith("action_ids")})
        out[dev] = ({k: float(v) for k, v in metrics.items()}, grads,
                    read_counts(counters))
    (gm, gg, launches), (cm, cg, _) = out["cuda"], out["cpu"]
    require(attention_launches(launches) == 0,
            f"rec fp32 train step launched {launches}")
    rels = {k: abs(gm[k] - cm[k]) / max(abs(cm[k]), 1e-30) for k in cm}
    worst_m = max(rels.values())
    log(f"[rec-grad-slice] metrics card vs CPU: "
        f"{json.dumps({k: [gm[k], cm[k]] for k in sorted(cm)})}; worst "
        f"relative {worst_m:.3e} (tol {REC_METRIC_RTOL})")
    require(sorted(gm) == sorted(cm) and worst_m <= REC_METRIC_RTOL,
            f"rec fp32 slice metrics: {worst_m} > {REC_METRIC_RTOL}")
    require(len(cg) == len(list(cpu_model.parameters())) == len(gg),
            "rec fp32 slice: gradients missing")
    worst, worst_name = 0.0, ""
    for name in cg:
        g, c = gg[name].cpu(), cg[name]
        if name.endswith("in_proj_bias"):
            third = len(c) // 3
            g = torch.cat([g[:third], g[2 * third:]])
            c = torch.cat([c[:third], c[2 * third:]])
        require(bool(torch.isfinite(g).all()), f"rec {name}: non-finite")
        rel = max_err(g, c) / max(c.abs().max().item(), 1e-30)
        if rel > worst:
            worst, worst_name = rel, name
        require(rel <= GRAD_SLICE_TOL, f"rec fp32 gradient {name}: card vs "
                f"CPU {rel} of its largest value > {GRAD_SLICE_TOL}")
    log(f"[rec-grad-slice] {len(cg)} parameter gradients within {worst:.3e} "
        f"of each tensor's largest value (worst {worst_name}; tol "
        f"{GRAD_SLICE_TOL})")
    del cpu_model, gpu_model
    torch.cuda.empty_cache()
    return {"grad_rel": worst, "metric_rel": worst_m}


def phase_rec_train(train_ds, val_ds):
    """17d (ii): ``RecognitionRunner.train_epoch`` on the banked path over
    7 batches of 64 windows, bf16, every dropout of the preset on, mixup
    0.2, drloc 0.3: 2 warm-up steps, then 5 timed steps with every count
    set to 0 just before them and read just after; then one step on the
    host path."""
    from tim_tpu_torch import config as C
    from tim_tpu_torch.data.dataset import batch_iterator
    runner = rec_runner(C.epic_recognition(), train_ds, val_ds, True,
                        mixup_alpha=0.2, lambda_drloc=0.3)
    require(runner._tables.num_windows // REC_BATCH
            == REC_WARMUP + REC_STEPS,
            f"rec split of {runner._tables.num_windows} windows")
    before = [p.detach().clone() for p in runner.model.parameters()]
    step = runner._bank_step
    metrics, marks = [], {}
    timed_step = EventTimed(step)

    def counted(state, batch):
        if len(metrics) == REC_WARMUP:
            marks["counters"] = zero_counts()
            timed_step.events.clear()
            marks["t0"] = time.perf_counter()
        out = timed_step(state, batch)
        metrics.append(out)
        return out

    torch.cuda.reset_peak_memory_stats()
    runner._bank_step = counted
    try:
        runner.train_epoch(0)
    finally:
        runner._bank_step = step
    launches = read_counts(marks["counters"])
    wall = time.perf_counter() - marks["t0"]
    peak = torch.cuda.max_memory_allocated()
    step_ms = [s.elapsed_time(e) for s, e in timed_step.events]
    losses = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    moved = sum(int(not torch.equal(b, p.detach()))
                for b, p in zip(before, runner.model.parameters()))
    ms = sum(step_ms) / len(step_ms)
    # one step on the host path: a numpy batch moved to the card
    host_batch = runner._to_device(next(batch_iterator(
        train_ds, REC_BATCH, shuffle=False)))
    host_timed = EventTimed(runner._train_step)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host_metrics = host_timed(runner.state, host_batch)
    host_loss = float(host_metrics["loss"])
    host_wall = (time.perf_counter() - t0) * 1e3
    host_ms = host_timed.device_ms()
    log(f"[rec-train] {len(step_ms)} banked steps of batch {REC_BATCH} "
        f"(S = {runner.model.cfg.num_context + 3 * runner.nv + runner.na}): "
        f"device {ms:.3f} ms per step ({', '.join(f'{x:.3f}' for x in step_ms)}),"
        f" {REC_BATCH / (ms / 1e3):.2f} device windows/s; wall {wall:.3f} s,"
        f" {REC_STEPS * REC_BATCH / wall:.2f} wall windows/s; peak "
        f"max_memory_allocated {peak / 2 ** 30:.2f} GiB; losses "
        f"{', '.join(f'{x:.5f}' for x in losses)}; grad norms "
        f"{', '.join(f'{x:.4f}' for x in norms)}; launches {launches}")
    log(f"[rec-train] host-path step: device {host_ms:.3f} ms, wall "
        f"{host_wall:.3f} ms, loss {host_loss:.5f}")
    require(len(step_ms) == REC_STEPS, f"rec-train: {len(step_ms)} steps")
    require(all(np.isfinite(losses + norms + [host_loss])),
            "rec-train: non-finite loss or gradient norm")
    require(moved == len(before), f"rec-train: {len(before) - moved} of "
            f"{len(before)} parameter tensors did not move")
    require(attention_launches(launches) == 0,
            f"rec-train: launches {launches}, expected no kernel 1, 2 or "
            f"other attention kernel in a train step")
    require_steady("rec-train", launches, REC_STEPS)
    return runner, launches, {
        "batch": REC_BATCH, "steps": REC_STEPS, "ms_per_step": ms,
        "step_ms": step_ms, "device_windows_per_s": REC_BATCH / (ms / 1e3),
        "wall_s": wall, "wall_windows_per_s": REC_STEPS * REC_BATCH / wall,
        "peak_bytes": peak, "losses": losses, "grad_norms": norms,
        "host_step_device_ms": host_ms, "host_step_wall_ms": host_wall}


def rec_validate(tag, runner):
    """``runner.validate()`` with every count set to 0 just before and
    read just after, its eval steps timed by CUDA events. Returns (stats,
    launches, metrics)."""
    step = runner._eval_step
    runner._eval_step = timed_eval = EventTimed(step)
    try:
        counters = zero_counts()
        t0 = time.perf_counter()
        stats = runner.validate()
        wall = time.perf_counter() - t0
        launches = read_counts(counters)
    finally:
        runner._eval_step = step
    n_batches = len(timed_eval.events)
    windows = runner.val_ds.windows
    n = len(windows.windows)
    device = timed_eval.device_ms()
    log(f"[{tag}] {n} windows in {n_batches} batches of {REC_BATCH}: device "
        f"{device:.3f} ms, {n / (device / 1e3):.2f} device windows/s; wall "
        f"{wall:.3f} s, {n / wall:.2f} wall windows/s; stats "
        f"{json.dumps(stats)}; launches {launches}")
    require(all(np.isfinite(v) for v in stats.values()),
            f"{tag}: non-finite statistics")
    require(launches["query_block_attention"]
            == runner.cfg.num_layers * n_batches
            and launches["fused_post_attention"] == 0,
            f"{tag}: launches {launches}, expected kernel 1 "
            f"{runner.cfg.num_layers} x {n_batches} batches, kernel 2 never")
    require_steady(tag, launches, n_batches)
    return stats, launches, {
        "windows": n, "batches": n_batches, "device_ms": device,
        "device_windows_per_s": n / (device / 1e3), "wall_s": wall,
        "wall_windows_per_s": n / wall}


def phase_rec_val(runner, val_ds):
    """17e: ``validate`` of the trained weights in bf16 on the banked path
    (twice: the vote sums bit-equal) and on the host path (every statistic
    within REC_VAL_RTOL); ``extract_predictions`` on both paths."""
    from tim_tpu_torch import config as C
    from tim_tpu_torch.evals.meters import WindowVoteAccumulator
    from tim_tpu_torch.runner.recognition import _head_spec
    banked, launches, m_banked = rec_validate("rec-val-banked", runner)
    host_runner = rec_runner(C.epic_recognition(), None, val_ds, False)
    host_runner.load_torch_checkpoint(runner.model.state_dict())
    host, _, m_host = rec_validate("rec-val-host", host_runner)
    require(sorted(banked) == sorted(host), "rec-val: statistic keys differ")
    rel = max(abs(banked[k] - host[k]) / max(abs(host[k]), 1e-30)
              for k in host)
    accs = []
    for _ in range(2):
        acc = WindowVoteAccumulator(val_ds.windows.num_actions,
                                    _head_spec(runner.cfg))
        runner._run_bank_accum(acc)
        accs.append(acc)
    same = all(np.array_equal(accs[0].sums[h], accs[1].sums[h])
               for h in accs[0].sums)
    log(f"[rec-val] banked vs host statistics within {rel:.3e} (tol "
        f"{REC_VAL_RTOL}); two banked vote sums bit-equal: {same}")
    require(rel <= REC_VAL_RTOL, f"rec-val: banked vs host {rel}")
    require(same, "rec-val: two banked validations differ")
    t0 = time.perf_counter()
    dump = runner.extract_predictions()
    dump_s = time.perf_counter() - t0
    dump_host = host_runner.extract_predictions()
    worst = max(float(np.abs(dump[k] - dump_host[k]).max())
                for k in ("verb", "noun", "action", "audio"))
    n_v = len(dump["v_narration_ids"])
    log(f"[rec-val] extract_predictions (banked) {dump_s:.3f} s: action "
        f"{dump['action'].shape}, audio {dump['audio'].shape}; banked vs "
        f"host scores within {worst:.3e}")
    require(dump["action"].shape[0] == n_v
            and dump_host["v_narration_ids"] == dump["v_narration_ids"]
            and np.allclose(dump["action"].sum(1), 1.0, atol=1e-6)
            and worst <= REC_VAL_RTOL,
            f"rec-val: extract_predictions differ ({worst})")
    del host_runner
    torch.cuda.empty_cache()
    return launches, {"banked": m_banked, "host": m_host, "paths_rel": rel,
                      "extract_s": dump_s, "extract_rel": worst}


def phase_rec_resume(runner, train_ds):
    """17d (iii): save the state after the timed steps, ``resume`` it into
    a fresh runner; one more banked step from both: bit-equal
    parameters."""
    import tempfile
    from tim_tpu_torch import config as C
    from tim_tpu_torch.train.checkpoint import save_checkpoint
    with tempfile.TemporaryDirectory() as tmp:
        save_checkpoint(tmp, runner.state, epoch=1)
        fresh = rec_runner(C.epic_recognition(), train_ds, None, True,
                           mixup_alpha=0.2, lambda_drloc=0.3)
        epoch = fresh.resume(tmp)
    require(epoch == 1 and fresh.state.step == runner.state.step,
            f"rec-resume: epoch {epoch}, step {fresh.state.step}")
    ids = torch.arange(REC_BATCH, device="cuda")
    for r in (runner, fresh):
        r._bank_step(r.state, r._tables.batch(ids))
    pairs = list(zip(runner.model.parameters(), fresh.model.parameters()))
    equal = sum(int(torch.equal(p, q)) for p, q in pairs)
    log(f"[rec-resume] one more step from the resumed and the uninterrupted "
        f"state: {equal} of {len(pairs)} parameter tensors bit-equal")
    require(equal == len(pairs), f"rec-resume: {len(pairs) - equal} tensors "
            f"differ")
    del fresh
    torch.cuda.empty_cache()
    return {"bit_equal": equal, "tensors": len(pairs)}


def phase_recognition(gen):
    """Phase 17; returns (kernel 1's recognition report, launches by
    path, (the validation split, the trained state dict on the CPU))."""
    from tim_tpu_torch import config as C
    cfg = C.epic_recognition()
    rng = np.random.default_rng(SEED + 4)
    t0 = time.perf_counter()
    train_ds, val_ds = rec_split(cfg, 4, rng), rec_split(cfg, 4, rng)
    # one query count a head for both splits (the banked eval step's
    # shapes are the train split's)
    for key in ("max_visual_actions", "max_audio_actions"):
        most = max(getattr(ds.windows, key) for ds in (train_ds, val_ds))
        for ds in (train_ds, val_ds):
            setattr(ds.windows, key, most)
    ws = val_ds.windows
    nq_val = 3 * ws.max_visual_actions + ws.max_audio_actions
    log(f"[rec] synthetic splits of {len(train_ds)} and {len(val_ds)} "
        f"windows ({ws.num_actions} actions, up to "
        f"{ws.max_visual_actions} visual and {ws.max_audio_actions} audio "
        f"queries a window) in {time.perf_counter() - t0:.2f} s")
    summary = {}
    sd, summary["slice"] = timed("rec-slice-fp32", phase_rec_slice_fp32, rng)
    report = timed("rec-kernels", phase_rec_kernels, gen, nq_val)
    serve_launches, summary["serve"] = timed("rec-serve", phase_rec_serve,
                                             sd, rng)
    del sd
    summary["grad_slice"] = timed("rec-grad-slice",
                                  phase_rec_grad_slice_fp32, train_ds)
    runner, train_launches, summary["train"] = timed(
        "rec-train", phase_rec_train, train_ds, val_ds)
    val_launches, summary["val"] = timed("rec-val", phase_rec_val, runner,
                                         val_ds)
    summary["resume"] = timed("rec-resume", phase_rec_resume, runner,
                              train_ds)
    log(f"[rec] summary {json.dumps(summary)}")
    trained = {k: v.detach().cpu() for k, v in
               runner.model.state_dict().items()}
    del runner
    torch.cuda.empty_cache()
    return report, {"serve-rec-bf16": serve_launches["serve-rec-bf16"],
                    "serve-rec-int8": serve_launches["serve-rec-int8"],
                    "serve-rec-fused": serve_launches["serve-rec-fused"],
                    "rec-train": train_launches,
                    "rec-val": val_launches}, (val_ds, trained)


# Phase 18: the detection mAP chain on phase 16's runner and validation
# split.
MAP_TOPK = 8
MAP_CANDIDATES = 20000     # the score threshold: what about this many clear
MAP_SCORE_TOL = 1e-3       # fp32 dumps, card vs CPU
MAP_AVG_TOL = 1e-6         # avg mAP of the card's and the CPU's fp32 dumps
MAP_FP32_WINDOWS = 4
MAP_PSEUDO_GT = 100


def det_gt(ds):
    """Evaluator GT columns of a detection split: its windows' visual
    actions, each once."""
    from tim_tpu_torch.evals.format_predictions import gt_to_columns
    rows = {}
    for w in ds.windows.windows:
        for (s, e), lab in zip(w.v_queries, w.v_labels):
            rows[(w.video_id, float(s), float(e), int(lab[2]))] = None
    vids, starts, stops, labels = zip(*rows)
    return gt_to_columns(np.asarray(vids, object), np.asarray(starts),
                         np.asarray(stops), np.asarray(labels))


def det_subset(ds, n):
    """The first ``n`` windows of ``ds`` as a split of their own."""
    sub = copy.copy(ds)
    sub.windows = dataclasses.replace(ds.windows,
                                      windows=ds.windows.windows[:n])
    return sub


def threshold_for(values, n):
    """The score that ``n`` of ``values`` clear."""
    flat = np.sort(np.asarray(values).ravel())
    return float(flat[max(len(flat) - n, 0)])


def phase_det_map(runner, val_ds):
    """Phase 18: on phase 16's trained runner (its regression heads' two
    sigmoids biased apart, so that proposals are intervals):
    ``extract_dense_predictions`` top-8 on the banked path (kernel 1 six
    times a batch) and the host path (the same rows), the top-8 columns
    against a dense dump, ``evaluate_detections`` of the banked dump
    against the split's GT; an fp32 card vs CPU dump of 4 windows and the
    mAP of each against GT made of the CPU dump's 100 best detections,
    shifted; GT fed back as the predictions gives avg mAP 1.0."""
    from tim_tpu_torch import config as C
    from tim_tpu_torch.evals.format_predictions import (
        evaluate_detections, gt_to_columns, nms_per_video,
        threshold_predictions)
    from tim_tpu_torch.runner.detection import DetectionRunner
    with torch.no_grad():
        for mlp in (runner.model.reg_head.fc_visual_action,
                    runner.model.reg_head.fc_audio_action):
            mlp[4].bias.copy_(torch.tensor([-1.0, 1.0]))
    sd = runner.model.state_dict()
    gt = det_gt(val_ds)
    n_win = len(val_ds)
    n_batches = -(-n_win // DET_BATCH)
    counters = zero_counts()
    t0 = time.perf_counter()
    dump = runner.extract_dense_predictions(top_k=MAP_TOPK)
    dump_s = time.perf_counter() - t0
    launches = read_counts(counters)
    require(launches["query_block_attention"] == 6 * n_batches
            and launches["fused_post_attention"] == 0,
            f"det-map: launches {launches}, expected kernel 1 6 x "
            f"{n_batches} batches")
    require_steady("det-map", launches, n_batches)
    rows = n_win * runner.num_queries
    require(len(dump["video_ids"]) == rows
            and dump["action_topk_values"].shape == (rows, MAP_TOPK),
            f"det-map: dump of {len(dump['video_ids'])} rows")
    thr = threshold_for(dump["action_topk_values"], MAP_CANDIDATES)
    t0 = time.perf_counter()
    m_ap, avg, sub = evaluate_detections(
        dump["video_ids"], dump["v_proposals"],
        (dump["action_topk_values"], dump["action_topk_classes"]), gt,
        score_threshold=thr, topk_num_classes=runner.cfg.visual_classes[-1])
    eval_s = time.perf_counter() - t0
    n_det = sum(len(v) for v in sub["results"].values())
    log(f"[det-map] banked top-{MAP_TOPK} dump of {n_win} windows ({rows} "
        f"rows) {dump_s:.3f} s; evaluate_detections (threshold {thr:.5f}, "
        f"{n_det} detections after Soft-NMS, {len(gt['label'])} GT) "
        f"{eval_s:.3f} s: mAP {np.round(m_ap, 6).tolist()}, avg {avg:.6f}; "
        f"launches {launches}")
    require(n_det > 0 and np.isfinite(avg), "det-map: no detections")

    host = det_runner(C.epic_detection(), None, val_ds, False)
    host.load_torch_checkpoint(sd)
    t0 = time.perf_counter()
    hdump = host.extract_dense_predictions(top_k=MAP_TOPK)
    host_s = time.perf_counter() - t0
    same_rows = (np.array_equal(hdump["video_ids"], dump["video_ids"])
                 and np.array_equal(hdump["queries"], dump["queries"]))
    h_err = max(float(np.abs(hdump[k] - dump[k]).max())
                for k in ("action_topk_values", "v_proposals"))
    log(f"[det-map] host-path dump {host_s:.3f} s: the same rows {same_rows}"
        f", top-{MAP_TOPK} scores and proposals within {h_err:.3e} of the "
        f"banked dump")
    require(same_rows and h_err <= MAP_SCORE_TOL,
            f"det-map: host vs banked dumps ({same_rows}, {h_err})")
    # the top-k columns against the dense scores of the same windows
    sub64 = det_subset(val_ds, DET_BATCH)
    dense = host.extract_dense_predictions(dataset=sub64)["action"]
    topk = host.extract_dense_predictions(dataset=sub64, top_k=MAP_TOPK)
    vals, cls = topk["action_topk_values"], topk["action_topk_classes"]
    picked = np.take_along_axis(dense, cls.astype(np.int64), -1)
    rest = dense.copy()
    np.put_along_axis(rest, cls.astype(np.int64), -np.inf, -1)
    k_err = float(np.abs(picked - vals).max())
    order_ok = bool((rest.max(-1) <= vals.min(-1) + 1e-6).all())
    log(f"[det-map] top-{MAP_TOPK} columns vs the dense dump of "
        f"{DET_BATCH} windows: values within {k_err:.3e}, no class left out "
        f"scores above the k-th: {order_ok}")
    require(k_err <= 1e-6 and order_ok, "det-map: top-k columns disagree "
            "with the dense scores")
    del host, dense, rest, picked
    torch.cuda.empty_cache()

    # fp32, card vs CPU, on 4 windows in one batch of 4
    sub4 = det_subset(val_ds, MAP_FP32_WINDOWS)
    cfg32 = C.epic_detection(compute_dtype="float32")
    tcfg4 = C.TrainConfig(batch_size=MAP_FP32_WINDOWS, epochs=1, seed=SEED)
    dumps, secs = {}, {}
    for dev in ("cuda", "cpu"):
        r = DetectionRunner(cfg32, tcfg4, None, sub4, print_freq=1000,
                            device=dev)
        r.load_torch_checkpoint(sd)
        t0 = time.perf_counter()
        dumps[dev] = r.extract_dense_predictions()
        secs[dev] = time.perf_counter() - t0
        del r
    g, c = dumps["cuda"], dumps["cpu"]
    f_err = max(float(np.abs(g[k] - c[k]).max())
                for k in ("action", "audio", "v_proposals", "a_proposals"))
    # GT that random weights can hit: the CPU dump's MAP_PSEUDO_GT best
    # detections after Soft-NMS, each shifted by up to 60% of its length
    # (tIoU 0.25-1 with the detection), so that the mAP compared lies
    # between 0 and 1 and moves with the scores' order and the proposals
    thr4 = threshold_for(c["action"], 2000)
    dets = nms_per_video(threshold_predictions(
        c["video_ids"], c["v_proposals"], c["action"], thr4))
    flat = [(s, v, seg, lab) for v, d in dets.items()
            for s, seg, lab in zip(d["scores"], d["segments"], d["labels"])]
    flat.sort(key=lambda r: -r[0])
    _, g_vid, g_seg, g_lab = zip(*flat[:MAP_PSEUDO_GT])
    g_seg = np.asarray(g_seg, np.float64)
    shift = (np.random.default_rng(SEED).uniform(-0.6, 0.6, len(g_seg))
             * (g_seg[:, 1] - g_seg[:, 0]))
    gt4 = gt_to_columns(np.asarray(g_vid, object), g_seg[:, 0] + shift,
                        g_seg[:, 1] + shift, np.asarray(g_lab))
    maps = {}
    for dev, d in dumps.items():
        maps[dev] = evaluate_detections(d["video_ids"], d["v_proposals"],
                                        d["action"], gt4,
                                        score_threshold=thr4)[:2]
    d_avg = abs(maps["cuda"][1] - maps["cpu"][1])
    log(f"[det-map] fp32 dump of {MAP_FP32_WINDOWS} windows: card "
        f"{secs['cuda']:.3f} s, CPU {secs['cpu']:.3f} s, scores and "
        f"proposals within {f_err:.3e} (tol {MAP_SCORE_TOL}); avg mAP card "
        f"{maps['cuda'][1]:.8f}, CPU {maps['cpu'][1]:.8f} (|diff| "
        f"{d_avg:.2e}, tol {MAP_AVG_TOL})")
    require(np.array_equal(g["video_ids"], c["video_ids"])
            and f_err <= MAP_SCORE_TOL, f"det-map fp32: {f_err}")
    require(d_avg <= MAP_AVG_TOL and 0.05 < maps["cpu"][1] < 0.95,
            f"det-map fp32 avg mAP differ by {d_avg} (CPU "
            f"{maps['cpu'][1]})")

    # control: the GT fed back as proposals scores avg mAP 1.0
    labels = np.asarray(gt["label"], np.int64)
    onehot = np.full((len(labels), runner.cfg.visual_classes[-1]), 1e-4,
                     np.float32)
    onehot[np.arange(len(labels)), labels] = 0.9
    _, perfect, _ = evaluate_detections(
        gt["video-id"], np.stack([gt["t-start"], gt["t-end"]], -1), onehot,
        gt)
    log(f"[det-map] control: GT fed back as the predictions, avg mAP "
        f"{perfect:.6f}")
    require(abs(perfect - 1.0) <= 1e-9, f"det-map control: {perfect}")
    return launches, {
        "windows": n_win, "dump_s": dump_s, "host_dump_s": host_s,
        "eval_s": eval_s, "avg_mAP": avg, "detections": n_det,
        "fp32_dump_card_s": secs["cuda"], "fp32_dump_cpu_s": secs["cpu"],
        "fp32_rel": f_err, "fp32_avg_diff": d_avg, "control_avg": perfect}


# Phase 19: the command lines and the checkpoint gate, on phase 16's and
# 17's full-width splits: the TIM CLI (``cli.run``, banked, bf16, batch 64)
# builds the EPIC models of its defaults (detection: the 97-verb head and
# 44 audio classes; recognition: 97/300/3806/44).
CLI_TOL = 1e-3             # CLI runs vs the runner's own, same weights
CLI_TOPK = 8
GATE_NUM_FEATS = "50"      # the CLI's models take 50 features a window


def cli_args(variant, out, *extra):
    """Parsed TIM CLI flags at the parser's defaults, banked, output to
    ``out``."""
    from tim_tpu_torch import cli
    return cli.build_parser().parse_args(
        ["--variant", variant, "--output_dir", str(out), "--device_bank",
         "true", "--print-freq", "1000", *extra])


def epic_detection_split(ds, train):
    """``ds``'s windows and banks as ``cli.load_datasets`` builds an EPIC
    detection split: verb labels (``--verb_only``, the CLI's 97-class
    head), augmentation sets sampled on the train split only."""
    from tim_tpu_torch.data.dataset import DetectionDataset
    return DetectionDataset(ds.windows, ds.visual, ds.audio,
                            sample_augmentations=train, verb_only=True,
                            include_verb_noun=False, dataset_name="epic")


def cli_run(tag, args, train_ds, val_ds):
    """``cli.run`` on the card with every count set to 0 just before and
    read just after. Returns (result, launches, seconds)."""
    from tim_tpu_torch import cli
    counters = zero_counts()
    t0 = time.perf_counter()
    out = cli.run(args, train_ds, val_ds, device="cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_counts(counters)
    log(f"[{tag}] cli.run {secs:.3f} s; launches {launches}")
    return out, launches, secs


def stats_diff(tag, got, want):
    """The largest |got - want| of two statistics dicts, relative to
    max(1, |want|); fails unless every value is finite and within
    CLI_TOL."""
    require(sorted(got) == sorted(want), f"{tag}: statistics keys differ")
    diff = max(abs(float(got[k]) - float(want[k]))
               / max(1.0, abs(float(want[k]))) for k in want)
    require(all(np.isfinite(float(v)) for v in got.values()),
            f"{tag}: non-finite statistics {got}")
    require(diff <= CLI_TOL, f"{tag}: {diff} > {CLI_TOL}")
    return diff


def dump_diff(tag, got, want, keys):
    """The largest difference of two dumps' numeric columns, each relative
    to max(1, its largest |want|)."""
    require(all(k in got for k in keys), f"{tag}: dump keys {sorted(got)}")
    diff = max(float(np.abs(np.asarray(got[k], np.float64)
                            - np.asarray(want[k], np.float64)).max())
               / max(1.0, float(np.abs(want[k]).max())) for k in keys)
    require(diff <= CLI_TOL, f"{tag}: dumps differ by {diff}")
    return diff


def require_kernel1(tag, launches, per_batch, batches):
    require(launches["query_block_attention"] == per_batch * batches
            and launches["fused_post_attention"] == 0,
            f"{tag}: launches {launches}, expected kernel 1 {per_batch} x "
            f"{batches} batches, kernel 2 never")


def phase_cli_detection(train_ds, val_ds, out):
    """19a: ``--train`` for one epoch, then ``--validate`` and
    ``--extract_feats --extract_top_k 8`` resumed from its checkpoint,
    each against a ``DetectionRunner`` resumed from the same checkpoint.
    Returns (launches by path, metrics, the reference-format checkpoint)."""
    from tim_tpu_torch import cli
    from tim_tpu_torch.runner.detection import DetectionRunner
    train_ds = epic_detection_split(train_ds, True)
    val_ds = epic_detection_split(val_ds, False)
    n_val = len(val_ds)
    val_batches, dump_batches = n_val // DET_BATCH, -(-n_val // DET_BATCH)
    args = cli_args("detection", out, "--train", "--finetune_epochs", "1")
    mcfg, tcfg = cli.configs_from_args(args)
    layers = mcfg.num_layers
    fit_stats, l_train, s_train = cli_run("cli-det-train", args, train_ds,
                                          val_ds)
    require_kernel1("cli-det-train", l_train, layers, val_batches)
    payload = torch.load(out / "checkpoint.pt", map_location="cpu",
                         weights_only=True)
    require(payload["epoch"] == 1 and payload["step"] == len(train_ds)
            // DET_BATCH, f"cli-det-train: checkpoint epoch "
            f"{payload['epoch']}, step {payload['step']}")

    args = cli_args("detection", out, "--validate", "--resume", str(out))
    val_stats, l_val, s_val = cli_run("cli-det-val", args, None, val_ds)
    require_kernel1("cli-det-val", l_val, layers, val_batches)
    runner = DetectionRunner(mcfg, tcfg, None, val_ds, print_freq=1000,
                             use_device_bank=True, device="cuda")
    runner.resume(str(out))
    own = runner.validate()
    d_val = stats_diff("cli-det-val", val_stats, own)
    d_fit = stats_diff("cli-det-train", fit_stats, own)

    args = cli_args("detection", out, "--extract_feats", "--extract_top_k",
                    str(CLI_TOPK), "--resume", str(out))
    dump, l_dump, s_dump = cli_run("cli-det-dump", args, None, val_ds)
    require_kernel1("cli-det-dump", l_dump, layers, dump_batches)
    with np.load(out / "dense_predictions.npz", allow_pickle=True) as f:
        saved = {k: f[k] for k in f.files}
    require(sorted(saved) == sorted(dump)
            and list(saved["video_ids"]) == list(dump["video_ids"]),
            "cli-det-dump: the file differs from the returned dump")
    own_dump = runner.extract_dense_predictions(top_k=CLI_TOPK)
    cols = ("queries", "v_proposals", "a_proposals", "action_topk_values",
            "audio_topk_values")
    d_dump = dump_diff("cli-det-dump", saved, own_dump, cols)
    rows = len(dump["video_ids"])
    require(rows == n_val * runner.num_queries
            and dump["action_topk_values"].shape == (rows, CLI_TOPK),
            f"cli-det-dump: {rows} rows")
    sizes = {f.name: f.stat().st_size for f in sorted(out.glob("*.pt"))}
    log(f"[cli-det] train 1 epoch ({len(train_ds)} windows) {s_train:.3f} "
        f"s (checkpoint files {json.dumps(sizes)} bytes), stats "
        f"{json.dumps(fit_stats)}; validate {s_val:.3f} s; dump "
        f"{s_dump:.3f} s ({rows} rows, top-{CLI_TOPK}); against the "
        f"runner's own: validate {d_val:.3e}, train's last validation "
        f"{d_fit:.3e}, dump {d_dump:.3e} (tol {CLI_TOL})")
    path = out / "tim_detection.pyth"
    torch.save({"state_dict": payload["params"], "epoch": payload["epoch"]},
               path)
    del runner
    torch.cuda.empty_cache()
    return ({"cli-det-train": l_train, "cli-det-val": l_val,
             "cli-det-dump": l_dump},
            {"train_s": s_train, "val_s": s_val, "dump_s": s_dump,
             "val_diff": d_val, "fit_diff": d_fit, "dump_diff": d_dump},
            path)


def phase_cli_recognition(val_ds, state_dict, out):
    """19b: phase 17's trained weights saved in the reference's format,
    ``--validate`` and ``--extract_feats`` with ``--torch_checkpoint`` on
    them, each against a ``RecognitionRunner`` with the same weights.
    Returns (launches by path, metrics, the checkpoint)."""
    from tim_tpu_torch import cli
    from tim_tpu_torch.runner.recognition import RecognitionRunner
    path = out / "tim_recognition.pyth"
    torch.save({"state_dict": state_dict, "epoch": 1}, path)
    args = cli_args("recognition", out, "--validate", "--torch_checkpoint",
                    str(path))
    mcfg, tcfg = cli.configs_from_args(args)
    runner = RecognitionRunner(mcfg, tcfg, None, val_ds, print_freq=1000,
                               use_device_bank=True, device="cuda")
    runner.load_torch_checkpoint(state_dict)
    counters = zero_counts()
    own = runner.validate()
    l_own = read_counts(counters)
    stats, l_val, s_val = cli_run("cli-rec-val", args, None, val_ds)
    batches = -(-len(val_ds) // REC_BATCH)
    require_kernel1("cli-rec-val", l_val, mcfg.num_layers, batches)
    require(l_val == l_own, f"cli-rec-val: launches {l_val}, the runner's "
            f"own {l_own}")
    d_val = stats_diff("cli-rec-val", stats, own)

    args = cli_args("recognition", out, "--extract_feats",
                    "--torch_checkpoint", str(path))
    preds, l_dump, s_dump = cli_run("cli-rec-dump", args, None, val_ds)
    require_kernel1("cli-rec-dump", l_dump, mcfg.num_layers, batches)
    require((out / "val_features.pkl").exists(),
            "cli-rec-dump: no val_features.pkl")
    own_preds = runner.extract_predictions()
    require(preds["v_narration_ids"] == own_preds["v_narration_ids"]
            and preds["a_narration_ids"] == own_preds["a_narration_ids"],
            "cli-rec-dump: narration ids differ")
    d_dump = dump_diff("cli-rec-dump", preds, own_preds,
                       ("verb", "noun", "action", "audio"))
    log(f"[cli-rec] validate {s_val:.3f} s, stats {json.dumps(stats)}; "
        f"extract {s_dump:.3f} s (action {preds['action'].shape}); against "
        f"the runner's own: validate {d_val:.3e}, predictions {d_dump:.3e} "
        f"(tol {CLI_TOL})")
    del runner
    torch.cuda.empty_cache()
    return ({"cli-rec-val": l_val, "cli-rec-dump": l_dump},
            {"val_s": s_val, "dump_s": s_dump, "val_diff": d_val,
             "dump_diff": d_dump}, path)


def phase_gate(task, path):
    """19c: ``validate_checkpoint`` on a full-width checkpoint on the card:
    load, infer, convert and contract PASS, parity SKIPs (no reference
    tree); the contract's fp32 model launches kernel 1 once a layer, the
    detection contract's fused int8 class heads kernel 3 twice."""
    from tim_tpu_torch import validate_checkpoint as VC
    counters = zero_counts()
    t0 = time.perf_counter()
    gate = VC.validate([str(path), "--task", task, "--num_feats",
                        GATE_NUM_FEATS], device="cuda")
    secs = time.perf_counter() - t0
    launches = read_counts(counters)
    tag = f"gate-{task}"
    contract = gate.numbers.get("contract", {})
    log(f"[{tag}] stages {json.dumps(gate.tags)}; seconds "
        f"{json.dumps({k: round(v, 3) for k, v in gate.seconds.items()})}, "
        f"{secs:.3f} s in all; contract {json.dumps(contract)}; launches "
        f"{launches}")
    want = {"load": "PASS", "infer": "PASS", "convert": "PASS",
            "parity": "SKIP", "contract": "PASS"}
    require(gate.tags == want, f"{tag}: stages {gate.tags}")
    layers = gate.numbers["infer"]["num_layers"]
    heads = 2 if task == "detection" else 0
    require(launches["query_block_attention"] == layers
            and launches["int8_matmul_fused"] == heads,
            f"{tag}: launches {launches}, expected kernel 1 {layers} "
            f"times, kernel 3 {heads}")
    return launches, {"contract": contract, "seconds": gate.seconds,
                      "total_s": secs}


def phase_cli_and_gate(det_splits, rec_val_ds, rec_state_dict):
    """Phase 19; returns the launches by path."""
    import pathlib
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        det_out = pathlib.Path(tmp) / "detection"
        rec_out = pathlib.Path(tmp) / "recognition"
        det_out.mkdir()
        rec_out.mkdir()
        det_l, det_m, det_path = timed("cli-detection", phase_cli_detection,
                                       *det_splits, det_out)
        rec_l, rec_m, rec_path = timed("cli-recognition",
                                       phase_cli_recognition, rec_val_ds,
                                       rec_state_dict, rec_out)
        paths, gates = {**det_l, **rec_l}, {}
        for task, path in (("detection", det_path),
                           ("recognition", rec_path)):
            paths[f"gate-{task}"], gates[task] = timed(
                f"gate-{task}", phase_gate, task, path)
    log(f"[cli] summary {json.dumps({'detection': det_m, 'recognition': rec_m, 'gate': gates})}")
    return paths


# Phase 20: Auditory SlowFast at the EPIC-Sounds defaults (R50, width 64,
# alpha 4, beta_inv 8, 2304-d feature) in fp32, random weights from the
# seed; audio extraction over a synthetic 60 s waveform.
AUDIO_SR = 24000
AUDIO_SECONDS, AUDIO_HOP, AUDIO_RECORD = 60.0, 0.2, 1.1
AUDIO_NUM_AUG, AUDIO_BATCH = 2, 8
AUDIO_TOL = 1e-3           # fp32 card vs CPU, of the largest feature / logit
AUDIO_CLIP_TOL = 1e-4      # bank rows vs per-clip forwards on the card
AUDIO_CHECK_CLIPS = 12


def phase_audio_slice_fp32(wave):
    """20a: full-size ``AuditorySlowFast()`` on one clip (a 0.999 s crop's
    spectrogram, [1, 1, 200, 128]), card against CPU."""
    from tim_tpu_torch.extract.audio import (
        extract_clip_spectrogram, record_clip_bounds)
    from tim_tpu_torch.models.backbones.slowfast import (
        AuditorySlowFast, pack_pathways)
    lo, hi = record_clip_bounds(0, int(round(AUDIO_RECORD * AUDIO_SR)),
                                int(round(0.999 * AUDIO_SR)), 0, 1)
    spec = extract_clip_spectrogram(wave, lo, hi, sampling_rate=AUDIO_SR)
    x = torch.from_numpy(spec)[None, None]
    models = {d: AuditorySlowFast(device=d, generator=torch.Generator()
                                  .manual_seed(SEED))
              for d in ("cpu", "cuda")}
    out, secs = {}, {}
    for dev, model in models.items():
        t0 = time.perf_counter()
        out[dev] = [t.float().cpu() for t in
                    model(*pack_pathways(x.to(dev), model.alpha))]
        secs[dev] = time.perf_counter() - t0
    (g_logits, g_feat), (c_logits, c_feat) = out["cuda"], out["cpu"]
    err_f = ((g_feat - c_feat).abs().max() / c_feat.abs().max()).item()
    err_l = ((g_logits - c_logits).abs().max() / c_logits.abs().max()).item()
    n_params = sum(p.numel() for p in models["cpu"].parameters())
    log(f"[audio-slice-fp32] AuditorySlowFast ({n_params} parameters) on "
        f"[1, 1, {spec.shape[0]}, {spec.shape[1]}]: feature "
        f"{tuple(c_feat.shape)}, card vs CPU feature {err_f:.3e}, "
        f"probabilities {err_l:.3e} of the largest (tol {AUDIO_TOL}); "
        f"card {secs['cuda']:.3f} s, CPU {secs['cpu']:.3f} s; cuDNN TF32 "
        f"flag {torch.backends.cudnn.allow_tf32} (restored)")
    require(tuple(c_feat.shape) == (1, 2304) and spec.shape == (200, 128),
            f"audio-slice: feature {tuple(c_feat.shape)}, spectrogram "
            f"{spec.shape}")
    require(err_f <= AUDIO_TOL and err_l <= AUDIO_TOL,
            f"audio-slice: card vs CPU {err_f}, {err_l}")
    return {"feature_rel": err_f, "prob_rel": err_l, "card_s": secs["cuda"],
            "cpu_s": secs["cpu"]}


def phase_audio_extract(wave):
    """20b: ``make_audio_apply`` and ``extract_features_for_video`` over
    the waveform with the CLI's clip function (records of 1.1 s every
    0.2 s, two augmentation sets: the clean crop and a SpecAugment one,
    batch 8); counts set to 0 just before and read just after; device
    (CUDA events) and wall clips/s, peak memory; the clean set against
    per-clip forwards."""
    import random
    from tim_tpu_torch.extract import cli as ecli
    from tim_tpu_torch.extract.pipeline import extract_features_for_video
    args = ecli.build_parser().parse_args(
        ["--backbone", "slowfast", "--feature_times", "-", "--out_dir", "-",
         "--num_aug", str(AUDIO_NUM_AUG), "--batch_size", str(AUDIO_BATCH)])
    apply_fn = ecli.make_audio_apply(args, device="cuda")
    starts = np.arange(0.0, AUDIO_SECONDS - AUDIO_RECORD + 1e-6, AUDIO_HOP)
    n = len(starts)
    clip_fn = ecli.audio_clip_fn(wave, starts, starts + AUDIO_RECORD,
                                 AUDIO_SR, AUDIO_NUM_AUG)
    timed_apply = EventTimed(apply_fn)
    timed_apply.device = apply_fn.device
    random.seed(SEED)                        # SpecAugment's draws
    torch.cuda.reset_peak_memory_stats()
    counters = zero_counts()
    t0 = time.perf_counter()
    bank = extract_features_for_video(clip_fn, n, AUDIO_NUM_AUG, timed_apply,
                                      batch_size=AUDIO_BATCH)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(counters)
    peak = torch.cuda.max_memory_allocated()
    clips = n * AUDIO_NUM_AUG
    device = timed_apply.device_ms()
    t0 = time.perf_counter()
    for t in range(min(n, 16)):
        clip_fn(t, 1)
    aug_ms = (time.perf_counter() - t0) * 1e3 / min(n, 16)
    worst = 0.0
    for t in np.linspace(0, n - 1, AUDIO_CHECK_CLIPS).astype(int):
        one = apply_fn(torch.from_numpy(clip_fn(int(t), 0))[None].cuda())
        want = one[0].cpu().numpy()
        worst = max(worst, float(np.abs(bank[t, 0] - want).max()
                                 / np.abs(want).max()))
    log(f"[audio-extract] {n} records x {AUDIO_NUM_AUG} sets = {clips} clips "
        f"of a {AUDIO_SECONDS:.0f} s waveform, batch {AUDIO_BATCH}: device "
        f"{device:.3f} ms ({len(timed_apply.events)} batches), "
        f"{clips / (device / 1e3):.2f} device clips/s; wall {wall:.3f} s, "
        f"{clips / wall:.2f} wall clips/s (a SpecAugment clip's host "
        f"spectrogram {aug_ms:.2f} ms); peak max_memory_allocated "
        f"{peak / 2 ** 30:.3f} GiB; bank {bank.shape}; clean set vs "
        f"{AUDIO_CHECK_CLIPS} per-clip forwards {worst:.3e} (tol "
        f"{AUDIO_CLIP_TOL}); launches {launches}")
    require(bank.shape == (n, AUDIO_NUM_AUG, 2304)
            and np.isfinite(bank).all(), f"audio-extract: bank {bank.shape}")
    require(not np.allclose(bank[:, 0], bank[:, 1]),
            "audio-extract: the SpecAugment set equals the clean set")
    require(worst <= AUDIO_CLIP_TOL, f"audio-extract: clean set vs per-clip "
            f"forwards {worst}")
    return launches, {
        "records": n, "clips": clips, "device_ms": device,
        "device_clips_per_s": clips / (device / 1e3), "wall_s": wall,
        "wall_clips_per_s": clips / wall, "spec_augment_clip_ms": aug_ms,
        "peak_bytes": peak, "clean_vs_per_clip": worst}


def phase_audio():
    """Phase 20; returns the extraction's launches by path."""
    wave = np.random.default_rng(SEED).normal(
        scale=0.1, size=int(AUDIO_SECONDS * AUDIO_SR)).astype(np.float32)
    summary = {"slice": timed("audio-slice-fp32", phase_audio_slice_fp32,
                              wave)}
    launches, summary["extract"] = timed("audio-extract",
                                         phase_audio_extract, wave)
    log(f"[audio] summary {json.dumps(summary)}")
    torch.cuda.empty_cache()
    return {"audio-extract": launches}


def usable_cpus() -> int:
    """CPUs this process may use: its affinity, capped by the cgroup v2
    quota when one is set (a container may see more CPUs than it may
    use)."""
    n = len(os.sched_getaffinity(0))
    try:
        with open("/sys/fs/cgroup/cpu.max") as f:
            quota, period = f.read().split()
        if quota != "max":
            n = min(n, max(1, int(quota) // int(period)))
    except (OSError, ValueError):
        pass
    return n


def phase_build():
    """Phase 2: the library built from ``tim_tpu_torch/csrc``; logs each
    source's compile seconds and, per attention, tail and int8 kernel, the
    registers and spill bytes ``ptxas`` reported."""
    from tim_tpu_torch import _build
    lib = _build.build()
    _build.library()
    sources, kernels = _build.resource_usage(lib)
    log(f"[build] compile seconds per source: {', '.join(sources)}")
    names = [k[0] for k in kernels]
    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cu++filt")
    pretty = names
    if os.path.exists(tool):
        filt = subprocess.run([tool], input="\n".join(names),
                              capture_output=True, text=True, timeout=60)
        if len(filt.stdout.splitlines()) == len(names):
            pretty = filt.stdout.splitlines()
    for (name, regs, st, ld), nice in zip(kernels, pretty):
        if any(ns in name for ns in ("tim_attn", "tim_qba", "tim_fpa",
                                     "tim_i8")):
            log(f"[build] ptxas: {nice}: {regs} registers, spill stores "
                f"{st} B, spill loads {ld} B")
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    log(smi.stdout.strip().splitlines()[0])
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm,clocks.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0].split(",")
    global SM_CLOCK_HZ
    SM_CLOCK_HZ = float(clock[0]) * 1e6
    log(f"[device] SM clock: max {clock[0].strip()} MHz, now "
        f"{clock[1].strip()} MHz (the exponential floors use the max)")
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {kind} x{torch.cuda.device_count()}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    # the plain CPU references: no more threads than the CPUs allowed
    threads = min(torch.get_num_threads(), usable_cpus())
    log(f"[device] host: {os.cpu_count()} CPUs visible, {usable_cpus()} "
        f"usable; torch CPU threads {torch.get_num_threads()} -> {threads}")
    torch.set_num_threads(threads)

    lib = timed("build", phase_build)
    log(f"[build] {lib}")

    kernel_report = timed("kernels", phase_kernels)
    linear_report = timed("linear", phase_linear_rounding,
                          torch.Generator(device="cuda").manual_seed(SEED))
    log(f"[linear] summary {json.dumps(linear_report)}")
    kernel_report["bias_act"] = check_bias_act(
        torch.Generator(device="cuda").manual_seed(SEED))
    rng = np.random.default_rng(SEED)
    state_dict, batch2, fp32_out = timed("slice-fp32", phase_slice_fp32, rng)
    from tim_tpu_torch import config as C
    video = synthetic_video(C.epic_detection(), rng)
    launches_bf16, serving, out16, threshold = timed(
        "serve-bf16", phase_serve_bf16, state_dict, batch2, fp32_out, video)
    log(f"[serve-bf16] summary {json.dumps(serving)}")
    err8, cal_rel = timed("int8-slice-fp32", phase_int8_slice_fp32,
                          state_dict, batch2)
    launches_int8, serving8 = timed(
        "serve-int8", phase_serve_int8, "serve-int8", state_dict, batch2,
        out16, video, threshold, False)
    serving8.update(int8_fp32_card_vs_cpu=err8, calibration_rel=cal_rel)
    log(f"[serve-int8] summary {json.dumps(serving8)}")
    launches_fast, serving_fast = timed(
        "serve-int8-fast-scores", phase_serve_int8, "serve-int8-fast-scores",
        state_dict, batch2, out16, video, threshold, True)
    log(f"[serve-int8-fast-scores] summary {json.dumps(serving_fast)}")
    del state_dict, batch2, fp32_out, out16
    torch.cuda.empty_cache()

    backbone_report, backbone_paths = phase_backbones(
        torch.Generator(device="cuda").manual_seed(SEED))
    kernel_report.update(backbone_report)
    training_report, training_paths = phase_training(
        torch.Generator(device="cuda").manual_seed(SEED + 1))
    kernel_report.update(training_report)
    detection_paths, det_splits = phase_detection_training()
    rec_report, recognition_paths, (rec_val_ds, rec_trained) = \
        phase_recognition(torch.Generator(device="cuda").manual_seed(SEED + 2))
    kernel_report["query_block_attention"]["recognition"] = rec_report
    cli_paths = phase_cli_and_gate(det_splits, rec_val_ds, rec_trained)
    del det_splits, rec_val_ds, rec_trained
    audio_paths = phase_audio()
    by_path = {"serve-bf16": launches_bf16, "serve-int8": launches_int8,
               "serve-int8-fast-scores": launches_fast, **backbone_paths,
               **training_paths, **detection_paths, **recognition_paths,
               **cli_paths, **audio_paths}
    for path in ("serve-rec-bf16", "rec-val", "det-map", "cli-det-train",
                 "cli-det-val", "cli-det-dump", "cli-rec-val",
                 "cli-rec-dump", "gate-detection", "gate-recognition"):
        require(by_path[path]["query_block_attention"] > 0,
                f"{path}: kernel 1 never launched")
    require(by_path["gate-detection"]["int8_matmul_fused"] > 0,
            "gate-detection: kernel 3 never launched")
    require(by_path["rec-train"]["query_block_attention"] == 0,
            "rec-train: kernel 1 launched")
    sources = {
        # name: (source, TPU kernel, the serving path whose count is reported)
        "query_block_attention": ("tim_tpu_torch/csrc/query_block_attention.cu",
                                  "tim_tpu/ops/pallas_attention.py:54",
                                  "serve-bf16"),
        "fused_post_attention": ("tim_tpu_torch/csrc/fused_post_attention.cu",
                                 "tim_tpu/ops/pallas_fused.py:109",
                                 "serve-bf16"),
        "int8_matmul_fused": ("tim_tpu_torch/csrc/int8_matmul_fused.cu",
                              "tim_tpu/ops/pallas_int8.py:50", "serve-int8"),
        "window_attention": ("tim_tpu_torch/csrc/window_attention.cu",
                             "tim_tpu/ops/pallas_swin.py:71",
                             "extract-omnivore"),
        "flash_mha": ("tim_tpu_torch/csrc/flash_mha.cu",
                      "tim_tpu/ops/flash.py:82", "extract-videomae"),
        "window_attention_bwd": ("tim_tpu_torch/csrc/window_attention_bwd.cu",
                                 "tim_tpu/ops/pallas_swin.py:109",
                                 "finetune-swin"),
        "flash_mha_bwd": ("tim_tpu_torch/csrc/flash_mha_bwd.cu",
                          "tim_tpu/ops/flash.py:71", "finetune-vit"),
        # replaces no TPU kernel (JAX leaves the bias add to XLA)
        "bias_act": ("tim_tpu_torch/csrc/bias_act.cu", None,
                     "extract-videomae"),
    }
    log(f"[time] {json.dumps(PHASE_S)}; total "
        f"{time.perf_counter() - T_START:.2f} s from the start of the script")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": by_path[path][name], "path": path,
         "launches_by_path": {p: counts[name] for p, counts in
                              by_path.items()},
         **measured(kernel_report[name])}
        for name, (src, rep, path) in sources.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
