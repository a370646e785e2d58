"""VideoMAE pretraining mask generators: a copy of
``tim_tpu/extract/masking.py`` (numpy only).

Numpy rebuild of ``feature_extractors/VideoMAE/masking_generator.py`` with
explicit ``np.random.Generator`` threading (the reference draws from the
global ``np.random`` state). Every generator produces a FIXED number of
masked positions per sample, so batches of
visible/masked token indices stack to fixed shapes.

Masks are flat [T' * H' * W'] float arrays, 1 = masked, where T' is the
temporal patch count (frames / tubelet) and H'/W' the spatial patch grid
(14x14 for 224/16).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _rng(rng: Optional[np.random.Generator]) -> np.random.Generator:
    return rng if rng is not None else np.random.default_rng()


class RandomMasking:
    """Uniform masking over all tubes (``masking_generator.py:39-62``)."""

    def __init__(self, input_size: Tuple[int, int, int], mask_ratio: float):
        self.frames, self.height, self.width = input_size
        self.num_patches = self.frames * self.height * self.width
        self.num_mask = int(mask_ratio * self.num_patches)

    def __call__(self, rng: Optional[np.random.Generator] = None):
        mask = np.hstack([
            np.zeros(self.num_patches - self.num_mask),
            np.ones(self.num_mask),
        ])
        _rng(rng).shuffle(mask)
        return mask


class TubeMasking:
    """Temporal-consistency ("tube") masking — one spatial mask shared by
    every frame (``TemporalConsistencyMaskingGenerator``,
    ``masking_generator.py:146-173``). The VideoMAE pretraining default."""

    def __init__(self, input_size: Tuple[int, int, int], mask_ratio: float):
        self.frames, self.height, self.width = input_size
        self.num_patches_per_frame = self.height * self.width
        self.num_masks_per_frame = int(
            mask_ratio * self.num_patches_per_frame)
        self.total_masks = self.frames * self.num_masks_per_frame

    def __call__(self, rng: Optional[np.random.Generator] = None):
        per_frame = np.hstack([
            np.zeros(self.num_patches_per_frame - self.num_masks_per_frame),
            np.ones(self.num_masks_per_frame),
        ])
        _rng(rng).shuffle(per_frame)
        return np.tile(per_frame, (self.frames, 1)).flatten()


class TemporalProgressiveMasking:
    """Keep-count decays linearly over time; one shared random field ranks
    patches so later frames keep a subset of earlier frames' patches
    (``TemporalProgressiveMaskingGenerator``,
    ``masking_generator.py:176-205``)."""

    def __init__(self, input_size: Tuple[int, int, int], mask_ratio: float):
        self.frames, self.height, self.width = input_size
        self.num_patches_per_frame = self.height * self.width
        max_keep = int((1 - mask_ratio) * self.num_patches_per_frame)
        min_keep = int(0.05 * self.num_patches_per_frame)
        self.keep_patches_list = np.linspace(
            max_keep, min_keep, self.frames).astype(int)
        # The reference masks everything <= the keep-th largest value
        # INCLUSIVE (``masking_generator.py:199-203``), so it actually
        # keeps keep-1 patches per frame; its ``total_masks`` attribute
        # disagrees with its own masks. Ours reports the true count —
        # downstream static shapes depend on it.
        self.total_masks = (self.frames * self.num_patches_per_frame
                            - (self.keep_patches_list - 1).sum())

    def __call__(self, rng: Optional[np.random.Generator] = None):
        rand = _rng(rng).standard_normal(self.num_patches_per_frame)
        order = np.sort(rand)[::-1]           # descending
        mask = np.zeros((self.frames, self.num_patches_per_frame), bool)
        for i, keep in enumerate(self.keep_patches_list):
            # reference semantics: the keep-th largest is itself masked
            mask[i] = rand <= order[keep - 1]
        return mask.flatten().astype(float)


class TemporalCenteringProgressiveMasking:
    """Keep-count bottoms at the clip boundaries and peaks at the center
    frames (``TemporalCenteringProgressiveMaskingGenerator``,
    ``masking_generator.py:208-235``: a reversed + forward linspace,
    so min_keep sits at both ends and max_keep in the middle)."""

    def __init__(self, input_size: Tuple[int, int, int], mask_ratio: float):
        self.frames, self.height, self.width = input_size
        # the mirrored keep list has 2*(frames//2) entries; the reference
        # indexes it for every frame, so odd frame counts are out of its
        # domain (it would IndexError) — fail loudly instead of leaving
        # the last frame silently unmasked
        assert self.frames % 2 == 0, (
            "TemporalCenteringProgressiveMasking requires an even frame "
            f"count (got {self.frames}); VideoMAE tubelets are size 2")
        self.num_patches_per_frame = self.height * self.width
        max_keep = int((1 - mask_ratio) * self.num_patches_per_frame)
        min_keep = int((1 - 0.95) * self.num_patches_per_frame)
        half = np.linspace(max_keep, min_keep,
                           self.frames // 2).astype(int).tolist()
        self.keep_patches_list = list(reversed(half)) + half
        # same inclusive-boundary semantics as TemporalProgressiveMasking:
        # each frame actually keeps keep-1 patches
        self.total_masks = (self.frames * self.num_patches_per_frame
                            - sum(k - 1 for k in self.keep_patches_list))

    def __call__(self, rng: Optional[np.random.Generator] = None):
        rand = _rng(rng).standard_normal(self.num_patches_per_frame)
        order = np.sort(rand)[::-1]
        mask = np.zeros((self.frames, self.num_patches_per_frame), bool)
        for i, keep in enumerate(self.keep_patches_list):
            mask[i] = rand <= order[keep - 1]
        return mask.flatten().astype(float)


def mask_to_indices(mask: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Flat 0/1 mask -> (visible_idx, masked_idx) int32 arrays. Counts are
    constant per generator, so batches of indices stack to fixed shapes."""
    mask = np.asarray(mask)
    return (np.flatnonzero(mask == 0).astype(np.int32),
            np.flatnonzero(mask != 0).astype(np.int32))


def batch_mask_indices(generator, batch_size: int,
                       rng: Optional[np.random.Generator] = None):
    """Sample a batch of masks -> (visible_idx [B, Nv], masked_idx [B, Nm])."""
    rng = _rng(rng)
    vis, msk = [], []
    for _ in range(batch_size):
        v, m = mask_to_indices(generator(rng))
        vis.append(v)
        msk.append(m)
    return np.stack(vis), np.stack(msk)
