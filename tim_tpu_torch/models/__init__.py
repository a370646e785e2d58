from tim_tpu_torch.models.tim import TimDetection, TimRecognition

__all__ = ["TimDetection", "TimRecognition"]
