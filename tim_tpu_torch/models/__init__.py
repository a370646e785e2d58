from tim_tpu_torch.models.tim import TimDetection

__all__ = ["TimDetection"]
