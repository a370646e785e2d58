"""Feature extraction: counterparts of ``tim_tpu/extract`` (the visual
half: clips -> backbone -> per-video npy banks)."""
