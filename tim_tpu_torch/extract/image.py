"""The two uint8 resizes of the visual transforms, bit for bit, without PIL
or cv2.

- ``resize_pil_bilinear_u8(frames, width, height)``: what
  ``Image.fromarray(f).resize((width, height), Image.BILINEAR)`` gives for
  each RGB frame (Pillow's ``Resample.c``: a horizontal pass, then a
  vertical one over its uint8 result; triangle taps whose support grows
  with the scale, normalised in double and rounded to 22 fraction bits).
  VideoMAE's eval transform (``pipeline.preprocess_video_clip``).
- ``resize_cv2_linear_u8(frames, fx, fy)``: what ``cv2.resize(f, (0, 0),
  fx=fx, fy=fy)`` gives (``INTER_LINEAR`` on ``CV_8UC3``: 11-bit taps, the
  horizontal sums exact in int32, the vertical pass in the 16-bit
  arithmetic of OpenCV's SIMD lanes; at ``fx == fy == 0.5`` OpenCV takes
  its ``INTER_AREA`` 2x2 path, and so does this). The omnivore test
  transform (``pipeline.omnivore_test_transform``).

Both take uint8 [T, H, W, 3] and run as one C++ loop over the clip in the
host library of ``utils.jpeg`` (``csrc/host/jpeg.cc``). Each has a plain
numpy version of the same integer arithmetic (``*_plain``), which the
tests hold the C++ loop to; no path of the port runs the plain versions.
"""

from __future__ import annotations

import numpy as np

from tim_tpu_torch.utils.jpeg import library, u8_pointer

PRECISION_BITS = 32 - 8 - 2      # Pillow's 8-bit fixed point
COEF_SCALE = 2048                # OpenCV's INTER_RESIZE_COEF_SCALE


def _frames(frames: np.ndarray, name: str) -> np.ndarray:
    frames = np.asarray(frames)
    if frames.dtype != np.uint8 or frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError(f"{name}: expected uint8 [T, H, W, 3] frames, got "
                         f"{frames.dtype} {frames.shape}")
    if min(frames.shape[1:3]) < 1:
        raise ValueError(f"{name}: empty frames {frames.shape}")
    return np.ascontiguousarray(frames)


def cv2_output_size(h: int, w: int, fx: float, fy: float):
    """``cv::resize``'s size for ``dsize=(0, 0)``: (round(h * fy), round(w
    * fx)), rounded half to even as ``cvRound`` rounds."""
    if not (fx > 0 and fy > 0):
        raise ValueError(f"resize_cv2_linear_u8: fx, fy must be > 0, got "
                         f"{fx}, {fy}")
    oh, ow = round(h * float(fy)), round(w * float(fx))
    if oh < 1 or ow < 1:
        raise ValueError(f"resize_cv2_linear_u8: {h}x{w} at fx={fx}, "
                         f"fy={fy} is empty ({oh}x{ow})")
    return oh, ow


def _cv2_area2(fx: float, fy: float) -> bool:
    """OpenCV turns INTER_LINEAR into its fast INTER_AREA at scale 2."""
    sx, sy = 1.0 / fx, 1.0 / fy
    eps = np.finfo(np.float64).eps
    return (round(sx) == 2 and round(sy) == 2 and abs(sx - 2) < eps
            and abs(sy - 2) < eps)


def resize_pil_bilinear_u8(frames: np.ndarray, width: int,
                           height: int) -> np.ndarray:
    """uint8 [T, H, W, 3] -> uint8 [T, height, width, 3], Pillow's
    BILINEAR, in the host library."""
    frames = _frames(frames, "resize_pil_bilinear_u8")
    if width < 1 or height < 1:
        raise ValueError(f"resize_pil_bilinear_u8: size {width}x{height}")
    t, h, w, _ = frames.shape
    out = np.empty((t, height, width, 3), np.uint8)
    library().resize_pil_bilinear_u8(u8_pointer(frames), t, h, w,
                                     u8_pointer(out), height, width)
    return out


def resize_cv2_linear_u8(frames: np.ndarray, fx: float,
                         fy: float) -> np.ndarray:
    """uint8 [T, H, W, 3] -> uint8 [T, round(H fy), round(W fx), 3],
    ``cv2.resize(f, (0, 0), fx=fx, fy=fy)``, in the host library."""
    frames = _frames(frames, "resize_cv2_linear_u8")
    t, h, w, _ = frames.shape
    oh, ow = cv2_output_size(h, w, fx, fy)
    out = np.empty((t, oh, ow, 3), np.uint8)
    library().resize_cv2_linear_u8(u8_pointer(frames), t, h, w,
                                   u8_pointer(out), oh, ow, float(fx),
                                   float(fy))
    return out


# ---------------------------------------------------------------------------
# plain numpy versions (the tests' reference for the C++ loops)
# ---------------------------------------------------------------------------

def pil_taps(in_size: int, out_size: int):
    """Pillow's ``precompute_coeffs`` + ``normalize_coeffs_8bpc`` for the
    triangle filter: (first source index [out], int32 taps [out, ksize]),
    taps past a window's end 0."""
    scale = float(np.float32(in_size)) / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64),
                      in_size) - xmin
    x = np.arange(ksize)
    a = np.abs(((x[None, :] + xmin[:, None]) - center[:, None] + 0.5)
               * (1.0 / filterscale))
    w = np.where(a < 1.0, 1.0 - a, 0.0)
    w = np.where(x[None, :] < xmax[:, None], w, 0.0)
    ww = np.zeros(out_size)
    for j in range(ksize):          # Pillow's sequential sum
        ww = ww + w[:, j]
    k = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None],
                 w)
    scaled = k * (1 << PRECISION_BITS)
    taps = np.where(k < 0, np.trunc(-0.5 + scaled),
                    np.trunc(0.5 + scaled)).astype(np.int64)
    return xmin, taps


def _pil_pass(a: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    a = np.moveaxis(a, axis, 0).astype(np.int64)
    xmin, taps = pil_taps(a.shape[0], out_size)
    idx = np.minimum(xmin[:, None] + np.arange(taps.shape[1]),
                     a.shape[0] - 1)
    s = np.full((out_size,) + a.shape[1:], 1 << (PRECISION_BITS - 1),
                np.int64)
    for j in range(taps.shape[1]):
        kj = taps[:, j].reshape((-1,) + (1,) * (a.ndim - 1))
        s = s + a[idx[:, j]] * kj
    out = np.where(s >= (1 << PRECISION_BITS << 8), 255,
                   np.where(s <= 0, 0, s >> PRECISION_BITS))
    return np.moveaxis(out.astype(np.uint8), 0, axis)


def resize_pil_bilinear_u8_plain(frames: np.ndarray, width: int,
                                 height: int) -> np.ndarray:
    """``resize_pil_bilinear_u8`` in numpy."""
    frames = _frames(frames, "resize_pil_bilinear_u8_plain")
    x = frames
    if width != frames.shape[2]:
        x = _pil_pass(x, width, 2)
    if height != frames.shape[1]:
        x = _pil_pass(x, height, 1)
    return np.ascontiguousarray(x)


def cv2_taps(in_size: int, out_size: int, scale: float, clamp: bool):
    """OpenCV's linear taps: (source index, next index, a0, a1), the
    fraction zeroed past the edges where ``clamp`` (the horizontal taps),
    else only the indices clipped (the vertical ones)."""
    f = ((np.arange(out_size) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    s0, s1 = s, s + 1
    if clamp:
        low, high = s < 0, s >= in_size - 1
        f = np.where(low | high, np.float32(0), f)
        s0 = np.where(low, 0, np.where(high, in_size - 1, s0))
        s1 = s0 + 1
    a0 = np.rint((np.float32(1) - f) * np.float32(COEF_SCALE)).astype(np.int64)
    a1 = np.rint(f * np.float32(COEF_SCALE)).astype(np.int64)
    return (np.clip(s0, 0, in_size - 1), np.clip(s1, 0, in_size - 1), a0, a1)


def resize_cv2_linear_u8_plain(frames: np.ndarray, fx: float,
                               fy: float) -> np.ndarray:
    """``resize_cv2_linear_u8`` in numpy."""
    frames = _frames(frames, "resize_cv2_linear_u8_plain")
    t, h, w, c = frames.shape
    oh, ow = cv2_output_size(h, w, fx, fy)
    if (oh, ow) == (h, w):
        return frames.copy()
    im = frames.astype(np.int64)
    if _cv2_area2(fx, fy):
        pad = np.zeros((t, 2 * oh, 2 * ow, c), np.int64)
        cnt = np.zeros((2 * oh, 2 * ow), np.int64)
        hh, wc = min(h, 2 * oh), min(w, 2 * ow)
        pad[:, :hh, :wc] = im[:, :hh, :wc]
        cnt[:hh, :wc] = 1
        s = pad.reshape(t, oh, 2, ow, 2, c).sum(axis=(2, 4))
        n = cnt.reshape(oh, 2, ow, 2).sum(axis=(1, 3))[None, :, :, None]
        whole = (s + 2) >> 2
        part = np.rint(s.astype(np.float32) / n.astype(np.float32))
        return np.where(n == 4, whole, part).astype(np.uint8)
    x0, x1, a0, a1 = cv2_taps(w, ow, 1.0 / fx, True)
    y0, y1, b0, b1 = cv2_taps(h, oh, 1.0 / fy, False)
    hs = (im[:, :, x0] * a0[None, None, :, None]
          + im[:, :, x1] * a1[None, None, :, None])        # [T, H, ow, 3]
    b0 = b0[None, :, None, None]
    b1 = b1[None, :, None, None]
    v = ((((hs[:, y0] >> 4) * b0) >> 16) + (((hs[:, y1] >> 4) * b1) >> 16)
         + 2) >> 2
    return np.clip(v, 0, 255).astype(np.uint8)
