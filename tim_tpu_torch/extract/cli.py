"""Feature-extraction CLI: counterpart of ``tim_tpu/extract/cli.py``.

    python -m tim_tpu_torch.extract.cli --backbone omnivore \\
        --frames_dir ... --feature_times ctx.pkl --checkpoint swinB.torch \\
        --out_dir feats/omnivore --split train

    python -m tim_tpu_torch.extract.cli --backbone slowfast \\
        --audio_dir wavs/ --feature_times a_ctx.pkl --out_dir feats/audio

The parser has the JAX CLI's flags. The backbone runs on the CUDA card
(``device="cuda"``, the default of ``make_visual_apply``,
``make_audio_apply`` and ``main``; raises without one) or, when asked, on
the CPU. On the card the visual attention cores always launch kernels 4
(Swin) and 5 (ViT): ``--flash_attention auto|on`` are accepted and
``off`` raises there, since the card has no plain path; on the CPU the
plain versions run whatever the flag says. ``--backbone slowfast`` runs
Auditory SlowFast in fp32 (cuDNN's convolutions, TF32 off; no TPU kernel
there) over log-mel spectrograms of the records in ``--audio_hdf5``
(``h5py``, imported only then) or ``--audio_dir`` (WAV through
``scipy.io.wavfile``); its augmentation sets after the first are
SpecAugment. Not ported yet (ROADMAP.md, "Still to port"):
``--quantize_backbone on`` (int8 backbones; ``auto`` means off away from
a TPU, as in the JAX CLI) and, for the visual backbones, ``--num_aug > 1``
(the RandAugment sets of ``extract/autoaug.py``); they raise
``NotImplementedError``. Without ``--checkpoint`` the weights are random,
from a generator seeded 0. ``pandas`` is imported by ``main`` (the
feature-time table) and PIL by the visual transforms.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch

from tim_tpu_torch.models.backbones.slowfast import pack_pathways
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
    if args.quantize_backbone == "on":
        raise NotImplementedError(
            f"--quantize_backbone on: int8 backbones "
            f"(quantize_backbone_params) are not ported yet ({_ROADMAP})")
    if args.backbone == "slowfast":
        return
    if args.num_aug > 1:
        raise NotImplementedError(
            f"--num_aug {args.num_aug}: the RandAugment sets "
            f"(extract/autoaug.py) are not ported yet ({_ROADMAP})")
    if device.type == "cuda" and args.flash_attention == "off":
        raise ValueError("--flash_attention off: on the card the attention "
                         "cores always run the hand-written kernels (no "
                         "plain path there)")


def _require_backbone(args, backbones, other: str) -> None:
    if args.backbone not in backbones:
        raise ValueError(f"--backbone {args.backbone} is built by {other}")


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
    _require_backbone(args, ("omnivore", "videomae"), "make_audio_apply")
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


class AudioApply:
    """Batched spectrograms [B, T, F, 1] (``extract_audio``'s clip layout,
    the JAX package's) -> fp32 features [B, D]: NCHW [B, 1, T, F], the two
    pathways (``pack_pathways``), the backbone's pooled feature."""

    def __init__(self, model: torch.nn.Module, device: torch.device):
        self.model = model
        self.device = device

    def __call__(self, spectrograms: torch.Tensor) -> torch.Tensor:
        x = spectrograms.to(self.device, torch.float32).permute(0, 3, 1, 2)
        _, feats = self.model(*pack_pathways(x, alpha=self.model.alpha))
        return feats.float()


def make_audio_apply(args, device=None) -> AudioApply:
    """Auditory SlowFast at the EPIC-Sounds defaults (2304-d feature) in
    fp32, with the ``--checkpoint`` weights (its class count read off
    ``head.projection``) or random ones (generator seeded 0), on
    ``device`` (the card by default)."""
    device = resolve_device(device)
    _require_backbone(args, ("slowfast",), "make_visual_apply")
    check_supported(args, device)
    from tim_tpu_torch.convert import load_backbone_state, load_torch_checkpoint
    from tim_tpu_torch.models.backbones import slowfast as sf

    state, kw = None, {}
    if args.checkpoint:
        state = load_torch_checkpoint(args.checkpoint)
        kw["num_classes"] = int(state["head.projection.weight"].shape[0])
    model = sf.AuditorySlowFast(device=device,
                                generator=torch.Generator().manual_seed(0),
                                **kw)
    if state is not None:
        load_backbone_state(model, state)
    model.eval()
    return AudioApply(model, device)


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


def audio_clip_fn(samples: np.ndarray, start_sec: np.ndarray,
                  stop_sec: np.ndarray, sampling_rate: int, num_aug: int):
    """``clip_fn(t, a)`` of ``extract_features_for_video`` over one
    waveform: record t's spectrogram [T, F, 1] (200 x 128), its a-th
    uniform temporal crop (``epicsounds.py:76-88`` temporal_sample_index),
    SpecAugment on every set but the clean first one."""
    from tim_tpu_torch.extract.audio import (
        extract_clip_spectrogram, record_clip_bounds)
    from tim_tpu_torch.extract.augment import spec_augment

    sr = sampling_rate
    clip_size = int(round(0.999 * sr))

    def clip_fn(t, a):
        start, end = record_clip_bounds(
            int(round(float(start_sec[t]) * sr)),
            int(round(float(stop_sec[t]) * sr)), clip_size, a, num_aug)
        spec = extract_clip_spectrogram(
            samples, start, min(end, len(samples)), sampling_rate=sr)
        if a > 0:
            spec = spec_augment(spec)
        return spec[..., None]  # [T, F, 1]

    return clip_fn


def extract_audio(args, table, video_ids, device=None):
    from tim_tpu_torch.extract.pipeline import (
        extract_features_for_video, save_feature_bank)

    apply_fn = make_audio_apply(args, device)
    sr = args.sampling_rate

    def load_waveform(vid) -> np.ndarray:
        if args.audio_hdf5:
            import h5py
            with h5py.File(args.audio_hdf5, "r") as f:
                return np.asarray(f[vid], np.float32)
        from scipy.io import wavfile
        rate, data = wavfile.read(
            os.path.join(args.audio_dir, f"{vid}.wav"))
        if rate != sr:
            raise ValueError(f"{vid}.wav: sampling rate {rate}, expected "
                             f"--sampling_rate {sr}")
        if data.dtype.kind == "i":
            data = data.astype(np.float32) / np.iinfo(data.dtype).max
        if data.ndim > 1:
            data = data.mean(axis=1)
        return data.astype(np.float32)

    for vid in video_ids:
        rows = table[table["video_id"] == vid].sort_values("start_sec")
        starts = rows["start_sec"].to_numpy(np.float64)
        stops = (rows["stop_sec"].to_numpy(np.float64) if "stop_sec" in rows
                 else starts + 1.1)
        bank = extract_features_for_video(
            audio_clip_fn(load_waveform(vid), starts, stops, sr,
                          args.num_aug),
            len(rows), args.num_aug, apply_fn, batch_size=args.batch_size)
        save_feature_bank(args.out_dir, args.split, vid, bank)
        print(f"{vid}: {bank.shape}")


def main(argv=None, *, device=None):
    import pandas as pd

    args = build_parser().parse_args(argv)
    device = resolve_device(device)     # before reading any data
    table = pd.read_pickle(args.feature_times)
    video_ids = sorted(table["video_id"].unique().tolist())
    video_ids = video_ids[args.shard_id::args.num_shards]
    if args.backbone in ("omnivore", "videomae"):
        extract_visual(args, table, video_ids, device=device)
    else:
        extract_audio(args, table, video_ids, device=device)


if __name__ == "__main__":
    main()
