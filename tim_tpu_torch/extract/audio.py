"""Audio frontend: waveform -> log-mel spectrogram. A copy of
``tim_tpu/extract/audio.py`` (numpy only; a test pins it to the original).

Numpy re-implementation of the reference's librosa pipeline
(``auditory_slowfast/slowfast/datasets/audio_loader_epic.py:51-89``):
STFT with n_fft 2048, periodic Hann of ``window_size`` ms, hop
``step_size`` ms, constant (zero) center padding; HTK mel filterbank
(128 mels, no norm); log(mel + 1e-6); transposed to [T, n_mels].

librosa conventions replicated: the signal is padded by n_fft//2 on both
sides, frames start at hop boundaries, and the window is zero-padded
symmetrically to n_fft (librosa.util.pad_center).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Tuple

import numpy as np


def hann_periodic(m: int) -> np.ndarray:
    """Periodic (fftbins=True) Hann window, scipy/librosa default."""
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(m) / m)


def hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


@lru_cache(maxsize=8)
def mel_filterbank(sr: int, n_fft: int = 2048, n_mels: int = 128,
                   fmin: float = 0.0, fmax: Optional[float] = None
                   ) -> np.ndarray:
    """HTK mel filterbank, no normalization (librosa ``filters.mel(...,
    htk=True, norm=None)``). Returns [n_mels, 1 + n_fft//2]."""
    fmax = fmax if fmax is not None else sr / 2.0
    fft_freqs = np.linspace(0, sr / 2.0, 1 + n_fft // 2)
    mel_pts = np.linspace(hz_to_mel_htk(fmin), hz_to_mel_htk(fmax),
                          n_mels + 2)
    hz_pts = mel_to_hz_htk(mel_pts)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    return weights.astype(np.float32)


def stft_magnitude(
    audio: np.ndarray,
    n_fft: int = 2048,
    hop_length: int = 80,
    win_length: int = 160,
) -> np.ndarray:
    """|STFT| with librosa center=True, pad_mode='constant'. Returns
    [1 + n_fft//2, n_frames]."""
    audio = np.asarray(audio, np.float64)
    pad = n_fft // 2
    padded = np.pad(audio, (pad, pad), mode="constant")

    window = hann_periodic(win_length)
    # librosa pads the window symmetrically to n_fft
    lpad = (n_fft - win_length) // 2
    win_full = np.zeros(n_fft)
    win_full[lpad:lpad + win_length] = window

    n_frames = 1 + (len(padded) - n_fft) // hop_length
    idx = (np.arange(n_fft)[None, :]
           + hop_length * np.arange(n_frames)[:, None])
    frames = padded[idx] * win_full[None, :]
    spec = np.fft.rfft(frames, n=n_fft, axis=1)
    return np.abs(spec).T.astype(np.float32)


def log_mel_spectrogram(
    audio: np.ndarray,
    sampling_rate: int = 24000,
    window_size_ms: float = 10.0,
    step_size_ms: float = 5.0,
    n_fft: int = 2048,
    n_mels: int = 128,
    eps: float = 1e-6,
) -> np.ndarray:
    """[samples] -> [T, n_mels] log-mel spectrogram
    (``audio_loader_epic.py:51-72``)."""
    win = int(round(window_size_ms * sampling_rate / 1e3))
    hop = int(round(step_size_ms * sampling_rate / 1e3))
    mag = stft_magnitude(audio, n_fft=n_fft, hop_length=hop, win_length=win)
    mel = mel_filterbank(sampling_rate, n_fft, n_mels) @ mag
    return np.log(mel + eps).T.astype(np.float32)


def extract_clip_spectrogram(
    samples: np.ndarray,
    start_idx: int,
    end_idx: int,
    *,
    sampling_rate: int = 24000,
    num_frames: int = 200,
    window_size_ms: float = 10.0,
    step_size_ms: float = 5.0,
) -> np.ndarray:
    """Clip -> fixed-[num_frames, 128] spectrogram with edge padding when
    the recording is shorter than the clip
    (``audio_loader_epic.py:74-89``)."""
    clip = samples[start_idx:end_idx]
    spec = log_mel_spectrogram(
        clip, sampling_rate, window_size_ms, step_size_ms)
    if spec.shape[0] < num_frames:
        spec = np.pad(spec, ((0, num_frames - spec.shape[0]), (0, 0)),
                      mode="edge")
    return spec[:num_frames]


def uniform_clip_indices(
    num_samples: int,
    clip_samples: int,
    clip_index: int,
    num_clips: int,
    start_sample: int = 0,
    rng=None,
) -> Tuple[int, int]:
    """Exact ``get_start_end_idx`` semantics
    (``audio_loader_epic.py:6-34``): clip_index >= 0 picks
    ``linspace(0, delta, num_clips)[clip_index]`` (note num_clips == 1
    lands at 0, not the center); clip_index == -1 draws a random start in
    [0, delta] (training). The returned slice bounds reproduce the
    reference's ``samples[int(start):int(start + clip_size - 1)]`` —
    clip_size - 1 samples, truncated ints."""
    delta = max(num_samples - clip_samples, 0)
    if clip_index == -1:
        rng = rng if rng is not None else np.random.default_rng()
        start = rng.uniform(0, delta)
    else:
        start = np.linspace(0, delta, num=num_clips)[clip_index]
    end = start + clip_samples - 1
    return start_sample + int(start), start_sample + int(end)


def record_clip_bounds(
    rec_start: int,
    rec_stop: int,
    clip_samples: int,
    clip_index: int,
    num_clips: int,
    rng=None,
) -> Tuple[int, int]:
    """Sample bounds for one (record, clip_index) pair, including the
    short-record rule of ``_extract_sound_feature``
    (``audio_loader_epic.py:74-83``, identical in
    ``audio_loader_aveperception.py:98-113``): a record shorter than the
    clip yields the record itself — never audio past its end — and the
    spectrogram is edge-padded downstream."""
    if rec_stop - rec_start < clip_samples:
        return rec_start, rec_stop
    return uniform_clip_indices(
        rec_stop - rec_start, clip_samples, clip_index, num_clips,
        start_sample=rec_start, rng=rng)
