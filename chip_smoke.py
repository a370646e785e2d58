#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``tim_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):
  1. device: a CUDA card is required; prints nvidia-smi's name and power
     limit; TF32 stays at PyTorch's defaults, as the entry points run;
  2. build: compiles the CUDA kernels from ``tim_tpu_torch/csrc`` (one
     nvcc per source, all started together);
  3. kernels: each kernel against its plain PyTorch version on the card
     (kernels 1 and 2 in fp32 and bf16 at batch 16; kernel 3 with fp32 and
     bf16 output, with and without bias and GELU, N in {3806, 44, 256},
     ragged M, strided inputs), then timed (CUDA events) at the serving
     shapes (bf16, batch 128) beside its plain version and one library
     route for the same function; the least time the card could take is
     computed from the same shapes;
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
     kernel 5 (flash attention) at [2, 16, 1568, 64] and a ragged S (the
     bf16 gate also shown to reject two faulty controls), then both timed
     at batch 8 beside the plain version and one library call;
 10. backbone fp32 slices: full-width Swin-B (32 x 224^2) and ViT-L
     (16 x 224^2) on one clip, on the card with the kernels against the
     CPU with the plain versions; 24 launches per forward;
 11. extraction: ``make_visual_apply`` (bf16, batch 8) and
     ``extract_features_for_video`` over a synthetic video of 64 clips
     per backbone: device and wall clips/s, kernel 4 (Swin-B) and kernel 5
     (ViT-L) launched 24 times per forward; bf16 vs fp32 features on 2
     clips.
The counts are set to 0 just before each serving or extraction run and
read just after it. The line before the last is the kernels' JSON; the
last line is ``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

SEED = 0
# Random heads give scores whose spread no fixed threshold fits: the serving
# phases threshold at the score that about this many candidates clear,
# read off the 2-window run (keeps Soft-NMS to seconds).
TARGET_CANDIDATES = 5000
TOL = {("query_block_attention", "float32"): 1e-4,
       ("query_block_attention", "bfloat16"): 5e-2,
       ("fused_post_attention", "float32"): 2e-4,
       ("fused_post_attention", "bfloat16"): 5e-2}
SLICE_TOL = 1e-3         # fp32 card vs fp32 CPU, whole slice
# kernels 4 and 5 vs their plain versions: fp32 sums in another order
# (1e-4 elementwise); bf16 scaled to the output (see attention_close)
ATTN_F32_TOL = 1e-4
ATTN_BF16_FLOOR = 2.0 ** -7      # of max |want|, beside two bf16 spacings
ATTN_BF16_REL_RMS = 1e-2         # ||got - want|| / ||want||
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
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12}


def log(msg: str) -> None:
    print(msg, flush=True)


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
    from tim_tpu_torch.models.common import exact_gelu, linear
    from tim_tpu_torch.ops.fused_post_attention import layer_norm_fp32
    dt = x.dtype
    y = layer_norm_fp32(x + attn, ln1_w, ln1_b).to(dt)
    h = linear(exact_gelu(linear(y, w1, b1, dt)), w2, b2, dt)
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
    report = {}
    for name, (kernel, plain, make) in kernels.items():
        for dtype in (torch.float32, torch.bfloat16):
            args = make(16, dtype, gen)
            got = kernel(*args)
            torch.cuda.synchronize()
            want = plain(*args)
            err = max_err(got, want)
            tol = TOL[(name, str(dtype).split(".")[1])]
            log(f"[kernels] {name} {dtype} B=16: max_abs_err={err:.3e} "
                f"(tol {tol})")
            require(kernel_close(got, want, tol),
                    f"{name} {dtype} disagrees with its plain version: "
                    f"max abs {err} (tol {tol})")
        args = make(128, torch.bfloat16, gen)
        got, want = kernel(*args), plain(*args)
        err = max_err(got, want)
        require(kernel_close(got, want, TOL[(name, "bfloat16")]),
                f"{name} bf16 B=128 disagrees: max abs {err}")
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
            log(f"[kernels] {name} bf16 B=128: unfused library-GEMM tail "
                f"{report[name]['library_ms']:.4f} ms")
        report[name]["bound_ms"], report[name]["bound_by"] = bound(
            nbytes(*args) + out_bytes, ops, "bf16")
        log(f"[kernels] {name} bf16 B=128: bound "
            f"{report[name]['bound_ms']:.4f} ms ({report[name]['bound_by']})")
        del args
        torch.cuda.empty_cache()
    report["int8_matmul_fused"] = phase_kernel_int8(gen)
    return report


def phase_kernel_int8(gen):
    """Kernel 3 against its plain version, then timed at both serving
    heads (fc_action N 3806, fc_audio N 44; 128 windows x 399 queries)."""
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
        row = {
            "head": head, "m": m, "k": 1024, "n": n, "max_abs_err": err,
            "ms": cuda_ms(lambda: i8.int8_matmul_fused(*args)),
            "plain_ms": cuda_ms(lambda: i8.int8_matmul_fused_plain(*args)),
            "library_ms": cuda_ms(lambda: int8_library_route(
                x, w_pad, w_scale, sx, b, n)),
            "bf16_linear_ms": cuda_ms(lambda: F.linear(x, w_bf16, b_bf16)),
            "bound_ms": ms_bound, "bound_by": by}
        log(f"[kernels] int8_matmul_fused {head} [{m} x 1024] -> {n} bf16: "
            f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
            f"library route (quantize + _int_mm + epilogue) "
            f"{row['library_ms']:.4f} ms, bf16 F.linear "
            f"{row['bf16_linear_ms']:.4f} ms, bound {ms_bound:.4f} ms ({by})"
            f", max_abs_err={err:.3e}")
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
    from tim_tpu_torch.ops import flash_mha as fm
    from tim_tpu_torch.ops import fused_post_attention as fpa
    from tim_tpu_torch.ops import int8_matmul_fused as i8
    from tim_tpu_torch.ops import query_block_attention as qba
    from tim_tpu_torch.ops import window_attention as wa
    return {"query_block_attention": qba.query_block_attention,
            "fused_post_attention": fpa.fused_post_attention,
            "int8_matmul_fused": i8.int8_matmul_fused,
            "window_attention": wa.window_attention,
            "flash_mha": fm.flash_mha}


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


def check_attention(name, kernel, plain, args, kw, tag, scores=None):
    """The kernel against its plain version; returns (kernel output, max
    abs error). In bf16, with ``scores`` (a function of the inputs giving
    the fp32 scores), also requires that the gate rejects two faulty
    controls: the plain output scaled by 0.98, and the online softmax that
    does not rescale its running sum."""
    got = kernel(*args, **kw)
    torch.cuda.synchronize()
    want = plain(*args, **kw)
    ok, err, rel = attention_close(got, want)
    log(f"[backbone-kernels] {name} {tag}: max_abs_err={err:.3e}, "
        f"relative RMS {rel:.3e}")
    require(got.shape == want.shape and ok,
            f"{name} {tag} disagrees with its plain version: max abs {err}, "
            f"relative RMS {rel}")
    if scores is not None and got.dtype == torch.bfloat16:
        controls = {"plain x 0.98": (want.float() * 0.98).to(want.dtype),
                    "running sum not rescaled": online_attention(
                        scores(*args, **kw), args[2], rescale_sum=False)}
        for cname, bad in controls.items():
            bad_ok, bad_err, bad_rel = attention_close(bad, want)
            log(f"[backbone-kernels] {name} {tag} control '{cname}': max "
                f"abs {bad_err:.3e}, relative RMS {bad_rel:.3e}, "
                f"{'passes' if bad_ok else 'rejected'}")
            require(not bad_ok, f"{name} {tag}: the bf16 gate passes the "
                    f"faulty control '{cname}'")
    return got, err


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


def phase_backbone_kernels(gen):
    """Kernels 4 and 5 against their plain versions, then timed at batch
    8 (the extraction batch)."""
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
                    wa.window_attention_plain, (q, k, v, bias, region),
                    {"sm_scale": 32 ** -0.5},
                    f"{dtype} nW={n_win} H={heads} shifted={shifted} "
                    f"n_types={1 if region is None else n_win}",
                    scores=(swin_scores if n_win == 64 and shifted
                            else None))
                worst["window_attention"] = max(worst["window_attention"],
                                                err)
                cases += 1
        for b, s in ((2, 1568), (2, 200), (3, 37)):
            _, err = check_attention(
                "flash_mha", fm.flash_mha, fm.flash_mha_plain,
                vit_qkv(b, s, dtype, gen), {"sm_scale": 0.125},
                f"{dtype} [{b}, 16, {s}, 64]",
                scores=vit_scores if s == 1568 else None)
            worst["flash_mha"] = max(worst["flash_mha"], err)
            cases += 1
    log(f"[backbone-kernels] {cases} cases agree with the plain versions")

    report = {}
    per_stage = []
    for n_win, heads, dims in SWIN_STAGES:
        shifted = n_win > 1
        q, k, v = swin_qkv(8, n_win, heads, torch.bfloat16, gen)
        bias, region = swin_bias(heads, dims, shifted, gen)
        args, kw = (q, k, v, bias, region), {"sm_scale": 32 ** -0.5}
        out, err = check_attention("window_attention", wa.window_attention,
                                   wa.window_attention_plain, args, kw,
                                   f"bf16 batch 8 nW={n_win}")
        bw, h, n, dh = q.shape
        ms_bound, by = bound(nbytes(q, k, v, bias, region, out),
                             4 * bw * h * n * n * dh, "bf16")
        lib_qkv, mask = window_library_args(q, k, v, bias, region, n_win)
        lib_err = max_err(F.scaled_dot_product_attention(
            *lib_qkv, attn_mask=mask, scale=32 ** -0.5).reshape(out.shape),
            out)
        del out
        row = {"stage": len(per_stage) + 1, "windows": bw, "heads": h,
               "shifted": shifted, "max_abs_err": err,
               "ms": cuda_ms(lambda: wa.window_attention(*args, **kw)),
               "plain_ms": cuda_ms(
                   lambda: wa.window_attention_plain(*args, **kw), iters=3),
               "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                   *lib_qkv, attn_mask=mask, scale=32 ** -0.5)),
               "bound_ms": ms_bound, "bound_by": by}
        log(f"[backbone-kernels] window_attention stage {row['stage']} "
            f"[{bw}, {h}, {n}, {dh}] bf16 shifted={shifted}: kernel "
            f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, masked "
            f"scaled_dot_product_attention {row['library_ms']:.4f} ms (max "
            f"abs diff to the kernel {lib_err:.3e}), bound {ms_bound:.4f} ms "
            f"({by})")
        per_stage.append(row)
        del args, lib_qkv, mask, q, k, v
        torch.cuda.empty_cache()
    first = per_stage[0]
    report["window_attention"] = {
        "max_abs_err": max(worst["window_attention"],
                           *(r["max_abs_err"] for r in per_stage)),
        **{key: first[key] for key in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms")},
        "per_stage": per_stage}

    q, k, v = vit_qkv(8, 1568, torch.bfloat16, gen)
    kw = {"sm_scale": 0.125}
    out, err = check_attention("flash_mha", fm.flash_mha, fm.flash_mha_plain,
                               (q, k, v), kw, "bf16 [8, 16, 1568, 64]")
    b, h, s, dh = q.shape
    ms_bound, by = bound(nbytes(q, k, v, out), 4 * b * h * s * s * dh,
                         "bf16")
    lib_err = max_err(F.scaled_dot_product_attention(q, k, v, **{
        "scale": 0.125}), out)
    del out
    report["flash_mha"] = {
        "max_abs_err": max(worst["flash_mha"], err),
        "ms": cuda_ms(lambda: fm.flash_mha(q, k, v, **kw)),
        "plain_ms": cuda_ms(lambda: fm.flash_mha_plain(q, k, v, **kw),
                            iters=3),
        "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, scale=0.125)),
        "bound_ms": ms_bound, "bound_by": by}
    log(f"[backbone-kernels] flash_mha [8, 16, 1568, 64] bf16: kernel "
        f"{report['flash_mha']['ms']:.4f} ms, plain "
        f"{report['flash_mha']['plain_ms']:.4f} ms, "
        f"scaled_dot_product_attention {report['flash_mha']['library_ms']:.4f}"
        f" ms (max abs diff to the kernel {lib_err:.3e}), bound "
        f"{ms_bound:.4f} ms ({by})")
    del q, k, v
    torch.cuda.empty_cache()
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
    gpu_model = backbone(name, "float32", "cuda")
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
            and sum(launches.values()) == launches[kernel],
            f"{name} extraction launches {launches}, expected 24 x "
            f"{forwards} of {kernel}")
    return launches, {
        "clips": EXTRACT_CLIPS, "batches": forwards, "device_ms": device_ms,
        "device_clips_per_s": EXTRACT_CLIPS / (device_ms / 1e3),
        "wall_s": wall, "wall_clips_per_s": EXTRACT_CLIPS / wall,
        "launches_per_forward": launches[kernel] / forwards,
        "bf16_vs_fp32_rel": rel}


def phase_backbones(gen):
    """Phases 9-11; returns (kernel report, launches by path)."""
    report = phase_backbone_kernels(gen)
    by_path = {}
    for name in BACKBONES:
        rng = np.random.default_rng(SEED)
        clips = rng.normal(size=(2, *BACKBONES[name][1])).astype(np.float32)
        fp32_feats, err = phase_backbone_slice_fp32(name, clips)
        launches, m = phase_extract(name, fp32_feats, clips)
        m["fp32_card_vs_cpu"] = err
        log(f"[extract-{name}] summary {json.dumps(m)}")
        by_path[f"extract-{name}"] = launches
        torch.cuda.empty_cache()
    return report, by_path


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
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {kind} x{torch.cuda.device_count()}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")

    from tim_tpu_torch import _build
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    log(f"[build] {lib} in {time.perf_counter() - t0:.2f} s")

    kernel_report = phase_kernels()
    rng = np.random.default_rng(SEED)
    state_dict, batch2, fp32_out = phase_slice_fp32(rng)
    from tim_tpu_torch import config as C
    video = synthetic_video(C.epic_detection(), rng)
    launches_bf16, serving, out16, threshold = phase_serve_bf16(
        state_dict, batch2, fp32_out, video)
    log(f"[serve-bf16] summary {json.dumps(serving)}")
    err8, cal_rel = phase_int8_slice_fp32(state_dict, batch2)
    launches_int8, serving8 = phase_serve_int8(
        "serve-int8", state_dict, batch2, out16, video, threshold, False)
    serving8.update(int8_fp32_card_vs_cpu=err8, calibration_rel=cal_rel)
    log(f"[serve-int8] summary {json.dumps(serving8)}")
    launches_fast, serving_fast = phase_serve_int8(
        "serve-int8-fast-scores", state_dict, batch2, out16, video,
        threshold, True)
    log(f"[serve-int8-fast-scores] summary {json.dumps(serving_fast)}")
    del state_dict, batch2, fp32_out, out16
    torch.cuda.empty_cache()

    backbone_report, backbone_paths = phase_backbones(
        torch.Generator(device="cuda").manual_seed(SEED))
    kernel_report.update(backbone_report)
    by_path = {"serve-bf16": launches_bf16, "serve-int8": launches_int8,
               "serve-int8-fast-scores": launches_fast, **backbone_paths}
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
                             "tim_tpu/ops/pallas_swin.py:207",
                             "extract-omnivore"),
        "flash_mha": ("tim_tpu_torch/csrc/flash_mha.cu",
                      "tim_tpu/ops/flash.py:82", "extract-videomae"),
    }
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": by_path[path][name], "path": path,
         "launches_by_path": {p: counts[name] for p, counts in
                              by_path.items()},
         **kernel_report[name]}
        for name, (src, rep, path) in sources.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
