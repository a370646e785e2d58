"""Where the device time of one dense-detection serving batch, or of one
backbone forward, goes, on the CUDA card:

    python -m tim_tpu_torch.profile_serving
        [--mode bf16|int8|int8-fast|swin|vit] [--batch N] [--steps 3]

Detection modes build the full-width EPIC-KITCHENS-100 detection model
(random weights from seed 0; ``int8`` modes through
``DetectionServer.quantized``, calibrated on 2 random windows, with the
fused int8 heads; ``int8-fast`` adds bf16 attention scores) and run
``make_inference_step`` (top-8 dump) on one random batch (default 128
windows). ``swin`` and ``vit`` build the Omnivore Swin-B or VideoMAE
ViT-L backbone in bf16 (random weights from seed 0, as the extraction
CLI) and run its forward on random clips (default 8; 32 x 224^2 and
16 x 224^2). Each runs 3 warm-up steps, then ``torch.profiler`` over
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
from tim_tpu_torch.serve import DetectionServer

MODES = {"bf16": {}, "int8": {"quant_pallas_heads": True},
         "int8-fast": {"quant_pallas_heads": True, "fast_scores": True}}
# backbone modes: (module, factory, clip shape)
BACKBONE_MODES = {"swin": ("swin3d", "omnivore_swinB_epic", (32, 224, 224, 3)),
                  "vit": ("vit", "videomae_vit_large", (16, 224, 224, 3))}


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


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--mode", choices=sorted([*MODES, *BACKBONE_MODES]),
                        default="bf16")
    parser.add_argument("--batch", type=int, default=None,
                        help="windows (default 128) or clips (default 8)")
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

    if args.mode in BACKBONE_MODES:
        args.batch = args.batch or 8
        step, batch = build_backbone(args.mode, args.batch)
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
    kernels = sorted(
        ((e.key, e.self_device_time_total / 1e3 / args.steps, e.count)
         for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA
         and e.self_device_time_total > 0),
        key=lambda r: -r[1])
    busy_ms = sum(ms for _, ms, _ in kernels)
    print(f"mode {args.mode}, batch {args.batch}: {step_ms:.3f} ms per step "
          f"(CUDA events), kernels {busy_ms:.3f} ms "
          f"({100 * busy_ms / step_ms:.1f}% busy)")
    for name, ms, count in kernels[:args.top]:
        print(f"{ms:9.3f} ms  {count // args.steps:4d}x  {name[:110]}")
    print(json.dumps({
        "card": card, "mode": args.mode, "batch": args.batch,
        "step_ms": step_ms, "kernel_ms": busy_ms,
        "kernels": [{"name": n[:200], "ms_per_step": ms,
                     "calls_per_step": c // args.steps}
                    for n, ms, c in kernels[:args.top]]}))


if __name__ == "__main__":
    main()
