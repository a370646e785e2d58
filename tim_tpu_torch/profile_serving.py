"""Where the device time of one dense-detection serving batch, of one
backbone forward, or of one backbone training step goes, on the CUDA card:

    python -m tim_tpu_torch.profile_serving
        [--mode bf16|int8|int8-fast|swin|vit|slowfast|vit-train|
                swin-train|mae|det-train|det-val]
        [--batch N] [--steps 3]

Detection modes build the full-width EPIC-KITCHENS-100 detection model
(random weights from seed 0; ``int8`` modes through
``DetectionServer.quantized``, calibrated on 2 random windows, with the
fused int8 heads; ``int8-fast`` adds bf16 attention scores) and run
``make_inference_step`` (top-8 dump) on one random batch (default 128
windows). ``swin`` and ``vit`` build the Omnivore Swin-B or VideoMAE
ViT-L backbone in bf16 (random weights from seed 0, as the extraction
CLI) and run its forward on random clips (default 8; 32 x 224^2 and
16 x 224^2); ``slowfast`` builds full-size Auditory SlowFast in fp32
(random weights from seed 0) and runs it on random spectrograms (default
8; [1, 200, 128], through ``pack_pathways``). ``vit-train`` and
``swin-train`` run one finetune step of
``TwoHeadViT`` over the same trunks in bf16 (ViT-L: the LLRD AdamW of
``BackboneFinetuneRunner``, Swin-B: AdamW(1e-4, wd 0.05), mixup 0.8), and
``mae`` one step of ``BackbonePretrainRunner`` over ``PretrainVideoMAE``
(mask ratio 0.9). ``det-train`` runs one train step of the full-width
EPIC detection model in bf16 (``make_train_step`` with the TIM optimizer,
every dropout on; default batch 64) and ``det-val`` one validation batch
(``make_val_step``), on random windows with GT segments; ``det-train``
also times two of its parts alone, forward and backward: the smoothed
focal loss over the visual logits and one layer's attention on the
training route. Each runs 3
warm-up steps, then ``torch.profiler`` over
``--steps`` steps. Prints the card's name and power limit, the device
milliseconds per step (CUDA events), the share of it in which a kernel
ran, and the kernels by device time per step; the last line is one JSON
object with the same numbers.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from tim_tpu_torch import config as C
from tim_tpu_torch.models import TimDetection
from tim_tpu_torch.models.queries import generate_query_pyramid
from tim_tpu_torch.serve import DetectionServer

MODES = {"bf16": {}, "int8": {"quant_pallas_heads": True},
         "int8-fast": {"quant_pallas_heads": True, "fast_scores": True}}
# backbone modes: (module, factory, clip shape)
BACKBONE_MODES = {"swin": ("swin3d", "omnivore_swinB_epic", (32, 224, 224, 3)),
                  "vit": ("vit", "videomae_vit_large", (16, 224, 224, 3))}
TRAIN_MODES = {"vit-train": "vit", "swin-train": "swin", "mae": "vit"}
DETECTION_TRAIN_MODES = ("det-train", "det-val")


def random_batch(cfg, n: int, rng) -> dict:
    f = cfg.num_feats
    batch = {
        "v_feats": rng.normal(size=(n, f, cfg.visual_input_dim)),
        "a_feats": rng.normal(size=(n, f, cfg.audio_input_dim)),
        "times": np.sort(rng.uniform(0, 1, size=(n, cfg.num_context, 2)), -1),
        "window_start": np.arange(n, dtype=np.float64),
        "window_size": np.full(n, 30.0),
    }
    return {k: torch.from_numpy(np.asarray(v, np.float32)).cuda()
            for k, v in batch.items()}


def random_train_batch(cfg, n: int, rng) -> dict:
    """``random_batch`` plus 8 GT segments a window (3-27% of it, 6 real)
    with random labels, the keys ``make_train_step`` reads."""
    out = random_batch(cfg, n, rng)
    start = rng.uniform(0.0, 0.7, (n, 8))
    seg = np.stack([start, start + rng.uniform(0.03, 0.27, (n, 8))], -1)
    seg[:, 6:] = 0.0
    labels = {"verb": 97, "noun": 300, "action": cfg.visual_classes[-1],
              "class_id": cfg.audio_classes}
    for key, classes in labels.items():
        lab = rng.integers(0, classes, (n, 8))
        lab[:, 6:] = -1
        out[key] = torch.from_numpy(lab).cuda()
    for key in ("v_gt_segments", "a_gt_segments"):
        out[key] = torch.from_numpy(seg.astype(np.float32)).cuda()
    return out


def build_detection_training(mode: str, batch: int):
    """(step, batch) of one bf16 detection train step or validation batch
    on the card."""
    from tim_tpu_torch.train import detection as det
    from tim_tpu_torch.train.optim import make_optimizer
    from tim_tpu_torch.train.state import create_train_state
    cfg, tcfg = C.epic_detection(), C.TrainConfig(batch_size=batch)
    model = TimDetection(cfg, device="cuda",
                         generator=torch.Generator().manual_seed(0))
    state = create_train_state(model, make_optimizer(
        model.parameters(), tcfg.lr, tcfg.weight_decay, 100, 10),
        normaliser=tcfg.normaliser_init)
    data = random_train_batch(cfg, batch, np.random.default_rng(0))
    if mode == "det-train":
        step = det.make_train_step(model, cfg, tcfg)
    else:
        step = det.make_val_step(model, cfg, tcfg)
    return (lambda b: step(state, b)), data


def _events_ms(fn, reps: int = 5, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def detection_components(batch: int) -> dict:
    """Device ms of two parts of the bf16 detection train step at its
    shapes, forward and backward each: the smoothed focal loss over the
    [batch x 399, 3806] visual logits (fp32 math), and one encoder layer's
    attention on the training route ([batch, 8, 898, 128], dropout 0.1
    with uint8 masks)."""
    from tim_tpu_torch.ops.attention import tim_attention
    from tim_tpu_torch.ops.losses import sigmoid_focal_loss_smoothed
    cfg = C.epic_detection()
    g = torch.Generator(device="cuda").manual_seed(0)
    nq = generate_query_pyramid(cfg.inference_query_size).shape[0]
    n, c = batch * nq, cfg.visual_classes[-1]
    bf16 = torch.bfloat16
    logits = torch.randn(n, c, device="cuda", generator=g,
                         dtype=bf16).requires_grad_()
    labels = torch.randint(-1, c, (n,), device="cuda", generator=g)
    weights = torch.rand(n, device="cuda", generator=g)
    shape = (batch, cfg.nhead, cfg.seq_len(nq, nq),
             cfg.encoder_width // cfg.nhead)
    q, k, v = (torch.randn(shape, device="cuda", generator=g, dtype=bf16)
               .requires_grad_() for _ in range(3))
    grad_out = torch.randn(shape, device="cuda", generator=g, dtype=bf16)

    def focal():
        sigmoid_focal_loss_smoothed(logits, labels, cfg.label_smoothing,
                                    weights=weights).backward()

    def attention():
        tim_attention(q, k, v, cfg.num_context, deterministic=False,
                      dropout_rate=cfg.enc_dropout,
                      dropout_bits=cfg.dropout_bits,
                      generator=g).backward(grad_out)

    return {"focal_visual_fwd_bwd_ms": _events_ms(focal),
            "attention_train_fwd_bwd_ms_per_layer": _events_ms(attention)}


def build(mode: str, batch: int):
    cfg = C.epic_detection(compute_dtype="bfloat16", use_fused_ffn=True,
                           **MODES[mode])
    state_dict = TimDetection(
        C.epic_detection(compute_dtype="float32"), device="cpu",
        generator=torch.Generator().manual_seed(0)).state_dict()
    rng = np.random.default_rng(0)
    if mode == "bf16":
        server = DetectionServer(cfg, state_dict, device="cuda", top_k=8)
    else:
        server = DetectionServer.quantized(cfg, state_dict,
                                           [random_batch(cfg, 2, rng)],
                                           device="cuda", top_k=8)
    return server, random_batch(cfg, batch, rng)


def build_backbone(mode: str, batch: int):
    """(forward, clips) of a bf16 backbone on the card."""
    import importlib
    module, factory, shape = BACKBONE_MODES[mode]
    mod = importlib.import_module(f"tim_tpu_torch.models.backbones.{module}")
    model = getattr(mod, factory)(dtype="bfloat16", device="cuda",
                                  generator=torch.Generator().manual_seed(0))
    clips = torch.randn(batch, *shape, device="cuda",
                        generator=torch.Generator(device="cuda")
                        .manual_seed(0))
    return model, clips


def build_slowfast(batch: int):
    """(forward, spectrograms) of full-size Auditory SlowFast in fp32 on
    the card."""
    from tim_tpu_torch.models.backbones.slowfast import (
        AuditorySlowFast, pack_pathways)
    model = AuditorySlowFast(device="cuda",
                             generator=torch.Generator().manual_seed(0))
    spec = torch.randn(batch, 1, 200, 128, device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(0))
    return (lambda x: model(*pack_pathways(x, model.alpha))), spec


def build_training(mode: str, batch: int):
    """(step, batch) of one bf16 training step on the card."""
    from tim_tpu_torch.runner import backbone as rb
    shape = BACKBONE_MODES[TRAIN_MODES[mode]][2]
    gen = torch.Generator().manual_seed(0)
    clips = torch.randn(batch, *shape, device="cuda",
                        generator=torch.Generator(device="cuda")
                        .manual_seed(0))
    if mode == "mae":
        from tim_tpu_torch.extract.masking import batch_mask_indices
        from tim_tpu_torch.models.backbones.mae import PretrainVideoMAE
        model = PretrainVideoMAE(dtype="bfloat16", device="cuda",
                                 generator=gen)
        runner = rb.BackbonePretrainRunner(model, None, mask_ratio=0.9)
        state = runner.init_state()
        vis, msk = (torch.from_numpy(m).cuda() for m in batch_mask_indices(
            runner.masking, batch, np.random.default_rng(0)))
        return (lambda video: runner._step_fn(state, video, vis, msk)), clips
    trunk, _ = build_backbone(TRAIN_MODES[mode], 1)
    model = rb.TwoHeadViT(trunk, generator=gen)
    labels = {"verb": torch.randint(0, 97, (batch,), device="cuda"),
              "noun": torch.randint(0, 300, (batch,), device="cuda")}
    if mode == "vit-train":
        runner = rb.BackboneFinetuneRunner(model, [None] * batch, None,
                                           batch_size=batch)
        state, step = runner.init_state(), runner._step_fn
    else:
        from tim_tpu_torch.train.state import TrainState
        state = TrainState(model, torch.optim.AdamW(
            model.parameters(), lr=1e-4, weight_decay=0.05))
        step = rb.make_two_head_step(model)
    return (lambda video: step(state, {"video": video, **labels})), clips


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--mode", choices=sorted([*MODES, *BACKBONE_MODES,
                                                  "slowfast", *TRAIN_MODES,
                                                  *DETECTION_TRAIN_MODES]),
                        default="bf16")
    parser.add_argument("--batch", type=int, default=None,
                        help="windows (default 128; det-train, det-val: "
                             "64) or clips (default 8)")
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--top", type=int, default=20)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_serving: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)

    if args.mode in DETECTION_TRAIN_MODES:
        args.batch = args.batch or 64
        step, batch = build_detection_training(args.mode, args.batch)
    elif args.mode in TRAIN_MODES:
        args.batch = args.batch or 8
        step, batch = build_training(args.mode, args.batch)
    elif args.mode in BACKBONE_MODES:
        args.batch = args.batch or 8
        step, batch = build_backbone(args.mode, args.batch)
    elif args.mode == "slowfast":
        args.batch = args.batch or 8
        step, batch = build_slowfast(args.batch)
    else:
        args.batch = args.batch or 128
        server, batch = build(args.mode, args.batch)
        step = server._infer
    for _ in range(3):
        step(batch)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(args.steps):
            step(batch)
        end.record()
        torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / args.steps
    # A record_function range (e.g. the optimizer's step) also shows up on
    # the device timeline, spanning the kernels it launched: leave it out,
    # or those kernels would count twice.
    kernels = sorted(
        ((e.key, e.self_device_time_total / 1e3 / args.steps, e.count)
         for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA
         and not getattr(e, "is_user_annotation", False)
         and e.self_device_time_total > 0),
        key=lambda r: -r[1])
    busy_ms = sum(ms for _, ms, _ in kernels)
    print(f"mode {args.mode}, batch {args.batch}: {step_ms:.3f} ms per step "
          f"(CUDA events), kernels {busy_ms:.3f} ms "
          f"({100 * busy_ms / step_ms:.1f}% busy)")
    for name, ms, count in kernels[:args.top]:
        print(f"{ms:9.3f} ms  {count // args.steps:4d}x  {name[:110]}")
    components = {}
    if args.mode == "det-train":
        components = detection_components(args.batch)
        print(f"parts alone, forward + backward: {json.dumps(components)}")
    print(json.dumps({
        "card": card, "mode": args.mode, "batch": args.batch,
        "step_ms": step_ms, "kernel_ms": busy_ms, **components,
        "kernels": [{"name": n[:200], "ms_per_step": ms,
                     "calls_per_step": c // args.steps}
                    for n, ms, c in kernels[:args.top]]}))


if __name__ == "__main__":
    main()
