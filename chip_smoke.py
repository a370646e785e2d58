#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``tim_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):
  1. device: a CUDA card is required; prints nvidia-smi's name and power
     limit; TF32 off for matmuls and cuDNN;
  2. build: compiles the CUDA kernels from ``tim_tpu_torch/csrc``;
  3. kernels: each kernel against its plain PyTorch version on the card,
     fp32 and bf16 at batch 16, then timed (CUDA events) at the serving
     shapes (bf16, batch 128);
  4. fp32 slice: ``make_inference_step`` of a full-width EPIC detection
     TimDetection (random weights from a seeded generator) on 2 windows,
     on the card with the kernels and on the CPU with the plain versions;
  5. serving: ``DetectionServer.detect_video`` in bf16 (batch 128, top-8)
     over a synthetic 300 s video; both kernels must have launched once per
     encoder layer per batch; bf16 vs fp32 scores on 2 windows.
The line before the last is the kernels' JSON; the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
# Random heads give scores whose spread no fixed threshold fits: the serving
# phase thresholds at the score that about this many candidates clear,
# read off the 2-window run (keeps Soft-NMS to seconds).
TARGET_CANDIDATES = 5000
TOL = {("query_block_attention", "float32"): 1e-4,
       ("query_block_attention", "bfloat16"): 5e-2,
       ("fused_post_attention", "float32"): 2e-4,
       ("fused_post_attention", "bfloat16"): 5e-2}
SLICE_TOL = 1e-3         # fp32 card vs fp32 CPU, whole slice
BF16_SCORE_TOL = 0.1     # bf16 vs fp32 sigmoid scores


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


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def kernel_close(got, want, tol: float) -> bool:
    """Every |got - want| <= tol; for bf16 outputs, <= max(tol, two bf16
    spacings at |want|). Two correct implementations that sum in different
    orders flip bf16 roundings, and a flip carried through LN2 reaches two
    spacings, 0.0625 at |z| in [4, 8), about once in 10^7 outputs (seen on
    the card at batch 16 and 64), so a flat 5e-2 cannot hold at serving
    sizes; below |z| = 4 the flat bound is the binding one."""
    err = (got.float() - want.float()).abs()
    bound = torch.full_like(err, tol)
    if got.dtype == torch.bfloat16:
        mag = want.float().abs().clamp_min(2.0 ** -126)
        spacing = torch.exp2(torch.floor(torch.log2(mag)) - 7)
        bound = torch.maximum(bound, 2 * spacing)
    return bool((err <= bound).all())


def qkv_views(batch, dtype, gen):
    """q/k/v of one layer as the model hands them to attention: strided
    [B, H, S, dh] views of one packed projection."""
    from tim_tpu import config as C
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
        del got, want
        ms = cuda_ms(lambda: kernel(*args))
        plain_ms = cuda_ms(lambda: plain(*args))
        log(f"[kernels] {name} bf16 B=128: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, max_abs_err={err:.3e}")
        report[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        if name == "fused_post_attention":
            report[name]["unfused_bf16_ms"] = cuda_ms(
                lambda: unfused_tail(*args))
            log(f"[kernels] {name} bf16 B=128: unfused library-GEMM tail "
                f"{report[name]['unfused_bf16_ms']:.4f} ms")
        del args
        torch.cuda.empty_cache()
    return report


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


def phase_slice_fp32(rng):
    from tim_tpu import config as C
    from tim_tpu_torch.models import TimDetection
    from tim_tpu_torch.train.detection import make_inference_step

    cfg = C.epic_detection(compute_dtype="float32", use_fused_ffn=True)
    t0 = time.perf_counter()
    cpu_model = TimDetection(cfg, generator=torch.Generator().manual_seed(SEED))
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
    require(sorted(gpu_out) == sorted(cpu_out), "output keys differ")
    for key in sorted(cpu_out):
        g, c = gpu_out[key].cpu(), cpu_out[key]
        require(tuple(g.shape) == tuple(c.shape) and bool(torch.isfinite(g).all()),
                f"{key}: shape {tuple(g.shape)} vs {tuple(c.shape)} or "
                f"non-finite")
        err = max_err(g, c)
        log(f"[slice-fp32] {key} {tuple(g.shape)}: max_abs_err={err:.3e}")
        require(err <= SLICE_TOL, f"{key}: card vs CPU {err} > {SLICE_TOL}")
    return state_dict, batch, gpu_out


def phase_serve_bf16(state_dict, batch2, fp32_out, rng):
    from tim_tpu import config as C
    import tim_tpu_torch.serve as serve_mod
    from tim_tpu_torch.ops import fused_post_attention as fpa
    from tim_tpu_torch.ops import query_block_attention as qba
    from tim_tpu_torch.train.detection import make_inference_step

    cfg = C.epic_detection(compute_dtype="bfloat16", use_fused_ffn=True)
    server = serve_mod.DetectionServer(cfg, state_dict, device="cuda",
                                       batch_size=128, top_k=8)

    # bf16 vs fp32 scores on the 2 windows of the fp32 phase
    out16 = make_inference_step(server.model, cfg)(to_torch(batch2, "cuda"))
    diff = max(max_err(out16[k], fp32_out[k]) for k in ("v_scores", "a_scores"))
    log(f"[serve-bf16] bf16 vs fp32 sigmoid scores, 2 windows: max abs "
        f"diff {diff:.4e} (tol {BF16_SCORE_TOL})")
    require(diff <= BF16_SCORE_TOL, f"bf16 scores drift {diff}")
    top = torch.sort(out16["v_scores"].flatten(), descending=True).values
    n_windows_est = len(server._window_starts(300.0))
    per_window = TARGET_CANDIDATES / n_windows_est
    threshold = top[int(per_window * len(batch2["times"]))].item()
    log(f"[serve-bf16] score threshold {threshold:.6f}: the score "
        f"{TARGET_CANDIDATES} candidates over {n_windows_est} windows would "
        f"clear if every window scored like these 2")

    # ~300 s video, a feature every 0.2 s, feat_stride 3 (30 s windows)
    duration, gap = 300.0, 0.2
    steps = int(duration / gap)
    starts = (np.arange(steps) * gap).astype(np.float32)
    feat_times = np.stack([starts, starts + 1.0], -1)
    v = rng.normal(size=(steps, cfg.visual_input_dim)).astype(np.float32)
    a = rng.normal(size=(steps, cfg.audio_input_dim)).astype(np.float32)
    n_windows = len(server._window_starts(duration))
    n_batches = -(-n_windows // server.batch_size)

    events = []
    infer = server._infer

    def timed_infer(batch):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = infer(batch)
        end.record()
        events.append((start, end))
        return out

    candidates = []
    threshold_topk = serve_mod.threshold_predictions_topk

    def counting_threshold(*args, **kwargs):
        cands = threshold_topk(*args, **kwargs)
        candidates.append(sum(len(c["scores"]) for c in cands.values()))
        return cands

    server._infer = timed_infer
    serve_mod.threshold_predictions_topk = counting_threshold
    server.detect_video(v, a, feat_times, duration,
                        score_threshold=threshold)   # warm-up
    events.clear()
    candidates.clear()

    qba.query_block_attention.launches = 0
    fpa.fused_post_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dets = server.detect_video(v, a, feat_times, duration,
                               score_threshold=threshold)
    wall = time.perf_counter() - t0
    launches = {"query_block_attention": qba.query_block_attention.launches,
                "fused_post_attention": fpa.fused_post_attention.launches}
    serve_mod.threshold_predictions_topk = threshold_topk

    device_ms = sum(s.elapsed_time(e) for s, e in events)
    log(f"[serve-bf16] {n_windows} windows in {n_batches} batches of "
        f"{server.batch_size}: device part {device_ms:.3f} ms = "
        f"{n_windows / (device_ms / 1e3):.2f} windows/s "
        f"({n_batches * server.batch_size / (device_ms / 1e3):.2f} incl. "
        f"padding); detect_video wall {wall:.3f} s = "
        f"{n_windows / wall:.2f} windows/s")
    log(f"[serve-bf16] candidates {candidates[0]}, detections "
        f"{len(dets['scores'])}, launches {launches}")
    require(len(dets["scores"]) > 0, "no detections")
    segs = dets["segments"]
    require(bool(np.isfinite(segs).all() and np.isfinite(dets["scores"]).all()),
            "non-finite detections")
    require(bool((segs[:, 1] > segs[:, 0]).all()), "empty segments")
    require(bool((np.diff(dets["scores"]) <= 1e-6).all()),
            "detections not score-sorted")
    for name, count in launches.items():
        require(count == cfg.num_layers * n_batches,
                f"{name} launched {count} times, expected "
                f"{cfg.num_layers} x {n_batches} batches")
    return launches, {"windows": n_windows, "device_ms": device_ms,
                      "windows_per_s": n_windows / (device_ms / 1e3),
                      "wall_s": wall, "bf16_vs_fp32": diff,
                      "candidates": candidates[0],
                      "detections": len(dets["scores"])}


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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
    launches, serving = phase_serve_bf16(state_dict, batch2, fp32_out, rng)
    log(f"[serve-bf16] summary {json.dumps(serving)}")

    sources = {
        "query_block_attention": ("tim_tpu_torch/csrc/query_block_attention.cu",
                                  "tim_tpu/ops/pallas_attention.py:54"),
        "fused_post_attention": ("tim_tpu_torch/csrc/fused_post_attention.cu",
                                 "tim_tpu/ops/pallas_fused.py:109"),
    }
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], **kernel_report[name]}
        for name, (src, rep) in sources.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
