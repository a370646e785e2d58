"""Feature-extraction CLI, visual half: counterpart of
``tim_tpu/extract/cli.py`` for ``--backbone omnivore|videomae``.

    python -m tim_tpu_torch.extract.cli --backbone omnivore \\
        --frames_dir ... --feature_times ctx.pkl --checkpoint swinB.torch \\
        --out_dir feats/omnivore --split train

The parser has the JAX CLI's flags. The backbone runs on the CUDA card
(``device="cuda"``, the default of ``make_visual_apply`` and ``main``;
raises without one) or, when asked, on the CPU. On the card the attention
cores always launch kernels 4 (Swin) and 5 (ViT): ``--flash_attention
auto|on`` are accepted and ``off`` raises there, since the card has no
plain path; on the CPU the plain versions run whatever the flag says.
Not ported yet (ROADMAP.md, "Still to port"): ``--backbone slowfast`` (the
audio CLI), ``--quantize_backbone on`` (int8 backbones; ``auto`` means off
away from a TPU, as in the JAX CLI) and ``--num_aug > 1`` (the RandAugment
sets of ``extract/autoaug.py``); they raise ``NotImplementedError``.
Without ``--checkpoint`` the weights are random, from a generator seeded
0.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch

from tim_tpu_torch.models.tim import resolve_device

_ROADMAP = "ROADMAP.md, 'Still to port'"


def build_parser():
    p = argparse.ArgumentParser(description="TIM feature extraction "
                                            "(PyTorch port)")
    p.add_argument("--backbone", required=True,
                   choices=["omnivore", "videomae", "slowfast"])
    p.add_argument("--frames_dir", default="",
                   help="<frames_dir>/<video_id>/*.jpg")
    p.add_argument("--audio_hdf5", default="",
                   help="HDF5 with one float waveform dataset per video")
    p.add_argument("--audio_dir", default="",
                   help="directory of <video_id>.wav files")
    p.add_argument("--feature_times", required=True,
                   help="feature-time table pickle (make_framepickle format)")
    p.add_argument("--checkpoint", default="",
                   help="released torch checkpoint to load")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--split", default="train")
    p.add_argument("--num_aug", type=int, default=1)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--fps", type=float, default=50.0)
    p.add_argument("--sampling_rate", type=int, default=24000)
    p.add_argument("--num_frames", type=int, default=32)
    p.add_argument("--frame_stride", type=int, default=2)
    p.add_argument("--crop_size", type=int, default=224)
    p.add_argument("--num_shards", type=int, default=1)
    p.add_argument("--shard_id", type=int, default=0)
    p.add_argument("--compute_dtype", default="bfloat16")
    p.add_argument("--flash_attention", default="auto",
                   choices=["auto", "on", "off"],
                   help="the hand-written window (Swin) and flash (ViT) "
                        "attention kernels; the card always runs them "
                        "(off raises there)")
    p.add_argument("--quantize_backbone", default="off",
                   choices=["auto", "on", "off"],
                   help="int8 backbones: not ported (on raises; auto is "
                        "off away from a TPU)")
    return p


def check_supported(args, device: torch.device) -> None:
    """Raise for what the port does not run (see the module docstring)."""
    if args.backbone not in ("omnivore", "videomae"):
        raise NotImplementedError(
            f"--backbone {args.backbone}: the Auditory SlowFast backbone and "
            f"the audio CLI are not ported yet ({_ROADMAP})")
    if args.quantize_backbone == "on":
        raise NotImplementedError(
            f"--quantize_backbone on: int8 backbones "
            f"(quantize_backbone_params) are not ported yet ({_ROADMAP})")
    if args.num_aug > 1:
        raise NotImplementedError(
            f"--num_aug {args.num_aug}: the RandAugment sets "
            f"(extract/autoaug.py) are not ported yet ({_ROADMAP})")
    if device.type == "cuda" and args.flash_attention == "off":
        raise ValueError("--flash_attention off: on the card the attention "
                         "cores always run the hand-written kernels (no "
                         "plain path there)")


class VisualApply:
    """Batched clips [B, T, H, W, 3] -> fp32 features [B, D] through the
    backbone; ``device`` is where the clips must go."""

    def __init__(self, model: torch.nn.Module, device: torch.device):
        self.model = model
        self.device = device

    def __call__(self, clips: torch.Tensor) -> torch.Tensor:
        return self.model(clips.to(self.device)).float()


def make_visual_apply(args, device=None) -> VisualApply:
    """The backbone of ``args.backbone`` (Swin-B for omnivore, ViT-L for
    videomae) in ``args.compute_dtype``, with the ``--checkpoint`` weights
    or random ones (generator seeded 0), on ``device`` (the card by
    default)."""
    device = resolve_device(device)
    check_supported(args, device)
    from tim_tpu_torch.convert import load_backbone_state, load_torch_checkpoint
    from tim_tpu_torch.models.backbones import swin3d, vit

    gen = torch.Generator().manual_seed(0)
    if args.backbone == "omnivore":
        model = swin3d.omnivore_swinB_epic(dtype=args.compute_dtype,
                                           device=device, generator=gen)
    else:
        model = vit.videomae_vit_large(dtype=args.compute_dtype,
                                       device=device, generator=gen)
    if args.checkpoint:
        load_backbone_state(model, load_torch_checkpoint(args.checkpoint))
    model.eval()
    return VisualApply(model, device)


def extract_visual(args, table, video_ids, device=None):
    from PIL import Image

    from tim_tpu_torch.extract.pipeline import (
        extract_features_for_video, omnivore_frame_indices,
        omnivore_test_transform, preprocess_video_clip, save_feature_bank)

    apply_fn = make_visual_apply(args, device)
    for vid in video_ids:
        frame_files = sorted(glob.glob(
            os.path.join(args.frames_dir, vid, "*.jpg")))
        if not frame_files:
            print(f"skipping {vid}: no frames")
            continue
        rows = table[table["video_id"] == vid].sort_values("start_sec")

        def clip_fn(t, a):
            row = rows.iloc[t]
            # 'like omnivore' segment-center sampling; indices are 1-based
            # frame numbers (reference jpg naming)
            idx = omnivore_frame_indices(
                int(row["stop_frame"]) - int(row["start_frame"]),
                int(row["start_frame"]), len(frame_files),
                args.num_frames)
            frames = np.stack([
                np.asarray(Image.open(frame_files[i - 1]).convert("RGB"))
                for i in idx])
            if args.backbone == "omnivore":
                # the reference loads frames with cv2 (BGR) and runs the
                # pixel block on that order, flipping to RGB inside it
                return omnivore_test_transform(
                    frames[..., ::-1], size=args.crop_size, input_bgr=True)
            return preprocess_video_clip(frames, size=args.crop_size)

        bank = extract_features_for_video(
            clip_fn, len(rows), args.num_aug, apply_fn,
            batch_size=args.batch_size)
        save_feature_bank(args.out_dir, args.split, vid, bank)
        print(f"{vid}: {bank.shape}")


def main(argv=None, *, device=None):
    import pandas as pd

    args = build_parser().parse_args(argv)
    table = pd.read_pickle(args.feature_times)
    video_ids = sorted(table["video_id"].unique().tolist())
    video_ids = video_ids[args.shard_id::args.num_shards]
    extract_visual(args, table, video_ids, device=device)


if __name__ == "__main__":
    main()
