"""Visual feature backbones: counterparts of ``tim_tpu/models/backbones``
(Omnivore Swin-B, VideoMAE ViT-L; forward only)."""

from tim_tpu_torch.models.backbones.swin3d import (
    SwinTransformer3D, omnivore_swinB_epic)
from tim_tpu_torch.models.backbones.vit import VideoMAEViT, videomae_vit_large

__all__ = ["SwinTransformer3D", "VideoMAEViT", "omnivore_swinB_epic",
           "videomae_vit_large"]
