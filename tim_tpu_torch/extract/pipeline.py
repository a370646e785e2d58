"""Feature extraction pipelines: clips -> backbone -> per-video npy banks.

The port's copy of ``tim_tpu/extract/pipeline.py``: clips for every
feature interval stream through a backbone in fixed-size batches, land in
a ``[T, num_aug, D]`` array per video, and save straight into the layout
``FeatureStore.from_npy_dir`` reads. Batches go to the apply function's
device as torch tensors. The two transforms resize uint8 frames with the
port's own copies of Pillow's BILINEAR and cv2's INTER_LINEAR
(``extract.image``, bit for bit); neither PIL nor cv2 is imported.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional

import numpy as np
import torch


def extract_features_for_video(
    clip_fn: Callable[[int, int], np.ndarray],
    num_intervals: int,
    num_aug: int,
    apply_fn: Callable[[torch.Tensor], torch.Tensor],
    *,
    batch_size: int = 8,
) -> np.ndarray:
    """Run ``apply_fn`` (a backbone forward) over every
    (interval, augmentation-set) clip.

    Args:
      clip_fn: (interval_index, aug_index) -> clip array (any fixed shape).
      num_intervals: feature rows T for this video.
      num_aug: augmentation sets A (set 0 is clean, like the reference).
      apply_fn: batched clips [B, ...] -> features [B, D]; its ``device``
        attribute (the CPU when it has none) is where the batch goes.

    Returns [T, A, D] float32.
    """
    device = getattr(apply_fn, "device", torch.device("cpu"))
    jobs = [(t, a) for t in range(num_intervals) for a in range(num_aug)]
    feats: Dict = {}
    for i in range(0, len(jobs), batch_size):
        chunk = jobs[i:i + batch_size]
        clips = np.stack([clip_fn(t, a) for t, a in chunk])
        pad = batch_size - len(chunk)
        if pad:
            clips = np.concatenate([clips, clips[-1:].repeat(pad, 0)])
        out = apply_fn(torch.from_numpy(clips).to(device))
        out = out.float().cpu().numpy()
        for (t, a), row in zip(chunk, out):
            feats[(t, a)] = row
    dim = next(iter(feats.values())).shape[-1]
    bank = np.zeros((num_intervals, num_aug, dim), np.float32)
    for (t, a), row in feats.items():
        bank[t, a] = row
    return bank


def save_feature_bank(out_dir: str, split: str, video_id: str,
                      bank: np.ndarray) -> str:
    os.makedirs(os.path.join(out_dir, split), exist_ok=True)
    path = os.path.join(out_dir, split, f"{video_id}.npy")
    np.save(path, bank.astype(np.float32))
    return path


def merge_feature_dirs(
    path_a: str, path_b: str, out_path: str,
    expected_dim: Optional[int] = 1024,
) -> int:
    """Concatenate two feature banks channel-wise per video
    (``merge_features.py:12-86``: Omnivore ‖ VideoMAE -> 2048-d). Returns
    the number of merged files."""
    splits = sorted(set(os.listdir(path_a)) & set(os.listdir(path_b)))
    assert splits, (
        "No matching splits; expected <backbone>/{train,val}/<video>.npy")
    count = 0
    for split in splits:
        files_a = set(os.listdir(os.path.join(path_a, split)))
        files_b = set(os.listdir(os.path.join(path_b, split)))
        os.makedirs(os.path.join(out_path, split), exist_ok=True)
        for fname in sorted(files_a & files_b):
            if not fname.endswith(".npy"):
                continue
            a = np.load(os.path.join(path_a, split, fname))
            b = np.load(os.path.join(path_b, split, fname))
            if a.ndim == 2:
                a = a[:, None]
            if b.ndim == 2:
                b = b[:, None]
            assert a.shape[1] == b.shape[1], (fname, a.shape, b.shape)
            if expected_dim:
                assert a.shape[-1] == expected_dim, (fname, a.shape)
                assert b.shape[-1] == expected_dim, (fname, b.shape)
            np.save(os.path.join(out_path, split, fname),
                    np.concatenate([a, b], axis=-1))
            count += 1
    return count


# ---------------------------------------------------------------------------
# Omnivore-style video clip preprocessing (eval path)
# ---------------------------------------------------------------------------

OMNIVORE_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
OMNIVORE_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


def preprocess_video_clip(
    frames: np.ndarray,
    *,
    size: int = 224,
) -> np.ndarray:
    """uint8 RGB frames [T, H, W, 3] -> normalized float clip
    [T, size, size, 3]: short-side resize + center crop + ImageNet
    normalize (the VideoMAE extractor's eval transform,
    ``VideoMAE/feature_extraction.py:88-96``). The resize is Pillow's
    ``BILINEAR`` on uint8 (``extract.image.resize_pil_bilinear_u8``)."""
    from tim_tpu_torch.extract.image import resize_pil_bilinear_u8

    t, h, w, _ = frames.shape
    scale = size / min(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    top = (nh - size) // 2
    left = (nw - size) // 2
    resized = resize_pil_bilinear_u8(frames, nw, nh)
    out = resized[:, top:top + size, left:left + size].astype(
        np.float32) / 255.0
    return (out - OMNIVORE_MEAN) / OMNIVORE_STD


def omnivore_test_transform(
    frames: np.ndarray,
    *,
    size: int = 224,
    input_bgr: bool = True,
    spatial_idx: int = 1,
) -> np.ndarray:
    """Exact port of the omnivore test-mode pixel block
    (``epickitchens.py:126-155``, identical in perception.py / ave.py):
    HEIGHT-based cv2 scaling (``scale = crop/frames.shape[1]``, cv2's
    uint8 ``INTER_LINEAR``: ``extract.image.resize_cv2_linear_u8``), channel
    flip (the reference's cv2 frame loader yields BGR — pass frames in
    BGR with ``input_bgr=True`` to match it bit-for-bit), /255, ImageNet
    normalize, then ``uniform_crop`` with CEIL offsets
    (``transform.py:141-180``). ``spatial_idx`` follows the reference:
    1 = center (NUM_SPATIAL_CROPS=1, the feature configs), 0/2 = the
    left/right crop on landscape frames or top/bottom on portrait
    (NUM_SPATIAL_CROPS=3 path of ``epickitchens.py:89-95``).

    uint8 [T, H, W, 3] -> float32 [T, size, size, 3] (channels-last; the
    reference permutes to C T H W for torch, our backbones take
    channels-last)."""
    from tim_tpu_torch.extract.image import resize_cv2_linear_u8

    assert spatial_idx in (0, 1, 2)
    scale = size / frames.shape[1]
    resized = resize_cv2_linear_u8(frames, scale, scale)
    if input_bgr:
        resized = resized[..., ::-1]
    out = resized.astype(np.float32) / 255.0
    out = (out - OMNIVORE_MEAN) / OMNIVORE_STD
    h, w = out.shape[1:3]
    top = int(np.ceil((h - size) / 2))
    left = int(np.ceil((w - size) / 2))
    if h > w:
        top = {0: 0, 1: top, 2: h - size}[spatial_idx]
    else:
        left = {0: 0, 1: left, 2: w - size}[spatial_idx]
    return np.ascontiguousarray(
        out[:, top:top + size, left:left + size])


def sample_clip_frames(
    num_frames_available: int,
    start_frame: int,
    stop_frame: int,
    num_samples: int = 32,
    stride: int = 2,
) -> np.ndarray:
    """Frame indices at fixed ``stride`` centered on the interval (a
    simple alternative sampler; the reference extraction uses
    ``omnivore_frame_indices`` below)."""
    span = num_samples * stride
    center = (start_frame + stop_frame) // 2
    start = center - span // 2
    idx = start + stride * np.arange(num_samples)
    return np.clip(idx, 0, num_frames_available - 1)


def omnivore_frame_indices(
    record_num_frames: int,
    start_frame: int,
    num_frames_video: int,
    num_samples: int = 32,
) -> np.ndarray:
    """The reference's 'like omnivore' sampling
    (``omnivore/omnivore/datasets/frame_loader.py:52-60``): split the
    record's [start, end) frame span into ``num_samples`` segments and
    take each segment's center. Returns 1-BASED frame numbers clamped to
    [1, num_frames_video] (the reference's jpg naming is 1-based)."""
    seg_size = float(record_num_frames - 1) / num_samples
    seq = []
    for i in range(num_samples):
        start = int(np.round(seg_size * i))
        end = int(np.round(seg_size * (i + 1)))
        seq.append((start + end) // 2)
    idx = start_frame + np.asarray(seq)
    return np.clip(idx, 1, num_frames_video)
