"""Feature extraction: counterparts of ``tim_tpu/extract`` (clips or
audio records -> backbone -> per-video npy banks)."""
