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
(read by the port's own HDF5 reader, ``utils.hdf5``; no h5py) or
``--audio_dir`` (WAV through ``scipy.io.wavfile``); its augmentation sets
after the first are SpecAugment. The visual backbones read their JPEG
frames with the port's own decoder (``utils.jpeg.read_jpegs``, one call a
clip, Pillow's pixels: the Exif orientation is not applied) and resize
them with its copies of Pillow's and cv2's uint8 resizes
(``extract.image``). ``--num_aug > 1`` adds RandAugment sets
(``extract/autoaug.py`` over ``extract.imageops``, Pillow's ops of the
port's own): ``omnivore_clip_augment`` on the BGR frames for Swin,
``VideoRandAugment("rand-m7-n4-mstd0.5-inc1")`` (bicubic) for the ViT.
No route loads PIL or cv2.
``--quantize_backbone on`` builds the int8 backbone (``quantized=True``)
from the fp32 weights, random or ``--checkpoint``
(``ops.quant.quantize_backbone_state_dict``), with dynamic per-row
activation scales; ``auto`` means off away from a TPU, as in the JAX CLI.
SlowFast has no int8 layout: ``--backbone slowfast --quantize_backbone on``
raises ``ValueError`` (the JAX CLI ignores the flag there and runs fp32).
Without ``--checkpoint`` the weights are random, from a generator seeded
0. ``main`` reads the feature-time table with the port's own DataFrame
pickle reader (``utils.pdpickle``, no pandas).
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch

from tim_tpu_torch.models.backbones.slowfast import pack_pathways
from tim_tpu_torch.models.tim import resolve_device

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
                   help="int8 backbones (Swin, ViT) with dynamic per-row "
                        "activation scales; auto is off away from a TPU; "
                        "SlowFast has no int8 layout (on raises)")
    return p


def check_supported(args, device: torch.device) -> None:
    """Raise for what the port does not run (see the module docstring)."""
    if args.backbone == "slowfast":
        if args.quantize_backbone == "on":
            raise ValueError(
                "--quantize_backbone on: Auditory SlowFast has no int8 "
                "layout (the JAX CLI ignores the flag for slowfast and runs "
                "fp32); drop the flag")
        return
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
    default). With ``--quantize_backbone on`` the fp32 weights are built
    on the CPU, quantized and loaded into the int8 backbone on
    ``device``."""
    device = resolve_device(device)
    _require_backbone(args, ("omnivore", "videomae"), "make_audio_apply")
    check_supported(args, device)
    from tim_tpu_torch.convert import load_backbone_state, load_torch_checkpoint
    from tim_tpu_torch.models.backbones import swin3d, vit
    from tim_tpu_torch.ops.quant import quantize_backbone_state_dict

    factory = (swin3d.omnivore_swinB_epic if args.backbone == "omnivore"
               else vit.videomae_vit_large)
    quant_on = args.quantize_backbone == "on"
    model = factory(dtype=args.compute_dtype,
                    device="cpu" if quant_on else device,
                    generator=torch.Generator().manual_seed(0))
    if args.checkpoint:
        load_backbone_state(model, load_torch_checkpoint(args.checkpoint))
    if quant_on:
        state = quantize_backbone_state_dict(model.state_dict())
        model = factory(dtype=args.compute_dtype, device=device,
                        generator=torch.Generator().manual_seed(0),
                        quantized=True)
        model.load_state_dict(state, strict=True)
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


def rand_augment(args):
    """The RandAugment of the augmentation sets after the first (uint8
    frames [T, H, W, 3] in and out): ``epickitchens.py:107-123``'s fresh
    rand-m15-mstd0.5-inc1 transform per frame with one clip seed, fill
    the ImageNet mean, for omnivore; ``feature_extraction.py:104-112``'s
    one timm transform per clip, bicubic, for videomae."""
    from tim_tpu_torch.extract.autoaug import (
        VideoRandAugment, omnivore_clip_augment)

    if args.backbone == "omnivore":
        def ra(frames):
            return omnivore_clip_augment(
                frames, crop_size=args.crop_size,
                mean=(0.485, 0.456, 0.406))
        return ra
    return VideoRandAugment("rand-m7-n4-mstd0.5-inc1",
                            crop_size=args.crop_size,
                            interpolation="bicubic")


def extract_visual(args, table, video_ids, device=None):
    ra = rand_augment(args) if args.num_aug > 1 else None
    from tim_tpu_torch.extract.pipeline import (
        extract_features_for_video, omnivore_frame_indices,
        omnivore_test_transform, preprocess_video_clip, save_feature_bank)
    from tim_tpu_torch.utils.jpeg import read_jpegs

    apply_fn = make_visual_apply(args, device)
    for vid in video_ids:
        frame_files = sorted(glob.glob(
            os.path.join(args.frames_dir, vid, "*.jpg")))
        if not frame_files:
            print(f"skipping {vid}: no frames")
            continue
        rows = table.where(table["video_id"] == vid).sort_by("start_sec")
        start_frames, stop_frames = rows["start_frame"], rows["stop_frame"]

        def clip_fn(t, a):
            # 'like omnivore' segment-center sampling; indices are 1-based
            # frame numbers (reference jpg naming)
            idx = omnivore_frame_indices(
                int(stop_frames[t]) - int(start_frames[t]),
                int(start_frames[t]), len(frame_files), args.num_frames)
            # each distinct frame decoded once, with Pillow's pixels (no
            # Exif orientation), as the JAX CLI's Image.open(...).convert
            uniq, inverse = np.unique(idx, return_inverse=True)
            frames = read_jpegs([frame_files[i - 1] for i in uniq],
                                apply_orientation=False)[inverse]
            if args.backbone == "omnivore":
                # the reference loads frames with cv2 (BGR) and runs both
                # RandAugment and the pixel block on that order, flipping
                # to RGB inside the pixel block
                frames = frames[..., ::-1]
                if a > 0:
                    frames = ra(frames)
                return omnivore_test_transform(
                    frames, size=args.crop_size, input_bgr=True)
            if a > 0:
                frames = ra(frames)
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
        """The video's samples as float32. From ``--audio_hdf5`` they are
        what the JAX CLI's ``np.asarray(h5py.File(...)[vid], np.float32)``
        gives, quirks kept for parity: an integer dataset is cast
        unscaled (the WAV route divides by the integer maximum) and a 2-D
        dataset stays 2-D (the WAV route averages the channels)."""
        if args.audio_hdf5:
            from tim_tpu_torch.utils.hdf5 import File
            with File(args.audio_hdf5) as f:
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
        rows = table.where(table["video_id"] == vid).sort_by("start_sec")
        starts = rows["start_sec"].astype(np.float64)
        stops = (rows["stop_sec"].astype(np.float64) if "stop_sec" in rows
                 else starts + 1.1)
        bank = extract_features_for_video(
            audio_clip_fn(load_waveform(vid), starts, stops, sr,
                          args.num_aug),
            len(rows), args.num_aug, apply_fn, batch_size=args.batch_size)
        save_feature_bank(args.out_dir, args.split, vid, bank)
        print(f"{vid}: {bank.shape}")


def main(argv=None, *, device=None):
    from tim_tpu_torch.utils.pdpickle import read_pickle

    args = build_parser().parse_args(argv)
    device = resolve_device(device)     # before reading any data
    table = read_pickle(args.feature_times)
    video_ids = sorted(table.unique("video_id").tolist())
    video_ids = video_ids[args.shard_id::args.num_shards]
    if args.backbone in ("omnivore", "videomae"):
        extract_visual(args, table, video_ids, device=device)
    else:
        extract_audio(args, table, video_ids, device=device)


if __name__ == "__main__":
    main()
