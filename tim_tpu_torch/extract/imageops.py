"""Pillow's uint8 RGB image ops of RandAugment, bit for bit, without PIL.

Every op takes a uint8 frame [H, W, 3] or a clip [T, H, W, 3] (anything
``np.asarray`` turns into one) and returns a new array of the same shape;
on a clip it is the op applied to each frame alone (each frame's own
histogram, mean or fill). The arithmetic is Pillow's (9 to 12, the Python
layer ``ImageOps``/``ImageEnhance``/``Image`` and libImaging under it):

- point ops, one 256-entry table per band and frame, in numpy:
  ``autocontrast`` (cutoff 0), ``equalize``, ``invert``, ``posterize``,
  ``solarize`` and ``solarize_add`` (timm's SolarizeAdd table; Pillow's
  ``point`` clips a table to [0, 255]);
- ``to_l`` (``convert("L")``: ITU-R 601-2 in 16-bit fixed point), and the
  enhancers ``color``, ``contrast``, ``brightness``, ``sharpness``: each
  ``blend(degenerate, image, factor)`` as ``Image.blend`` computes it (a C
  float factor; inside [0, 1] truncated, outside it clipped to [0, 255]
  and truncated);
- ``affine`` (``Image.transform(size, AFFINE, matrix, resample,
  fillcolor=fill)``) and ``rotate`` (``Image.rotate(angle, resample,
  fillcolor=fill)``: the angle mod 360, copies and transposes at 0, 180 and,
  on square frames, 90 and 270, else the 15-digit matrix about the centre),
  at NEAREST, BILINEAR or BICUBIC; other resample codes raise
  ``ValueError`` as Pillow does (after ``rotate``'s shortcuts, as there).

``affine`` and ``smooth`` (``ImageFilter.SMOOTH``, the degenerate of
``sharpness``) run as C++ loops over a whole clip in the host library of
``utils.jpeg`` (``csrc/host/imageops.cc``). Each has a plain numpy version
of the same arithmetic (``affine_plain``, ``smooth_plain``), which the
tests hold the C++ loop to; no path of the port runs the plain versions.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence

import numpy as np

from tim_tpu_torch.utils.jpeg import library, u8_pointer

# Pillow's Image.Resampling values
NEAREST, LANCZOS, BILINEAR, BICUBIC, BOX, HAMMING = 0, 1, 2, 3, 4, 5
_TRANSFORM_FILTERS = (NEAREST, BILINEAR, BICUBIC)
_FILTER_NAMES = {NEAREST: "NEAREST", LANCZOS: "LANCZOS", BILINEAR: "BILINEAR",
                 BICUBIC: "BICUBIC", BOX: "BOX", HAMMING: "HAMMING"}
_IDENTITY = np.arange(256, dtype=np.int64)


def as_frames(img) -> np.ndarray:
    """uint8 [H, W, 3] or [T, H, W, 3] (a list of frames is stacked)."""
    if isinstance(img, (list, tuple)):
        img = np.stack([np.asarray(f) for f in img])
    a = np.asarray(img)
    if a.dtype != np.uint8 or a.ndim not in (3, 4) or a.shape[-1] != 3:
        raise ValueError(f"expected uint8 RGB [H, W, 3] or [T, H, W, 3], got "
                         f"{a.dtype} {a.shape}")
    return a


def _clip(img):
    """(the frames as a contiguous clip, whether one frame was given)."""
    a = as_frames(img)
    return np.ascontiguousarray(a[None] if a.ndim == 3 else a), a.ndim == 3


def _like(clip: np.ndarray, single: bool) -> np.ndarray:
    return clip[0] if single else clip


# ---------------------------------------------------------------------------
# Point ops
# ---------------------------------------------------------------------------


def _apply_luts(clip: np.ndarray, luts: np.ndarray) -> np.ndarray:
    """``Image.point`` with one table per frame and band, luts int
    [T, 3, 256] (clipped to [0, 255] as ``point`` clips)."""
    luts = np.clip(luts, 0, 255).astype(np.uint8)
    out = np.empty_like(clip)
    for t in range(clip.shape[0]):
        for b in range(3):
            out[t, ..., b] = np.take(luts[t, b], clip[t, ..., b])
    return out


def _point(img, lut) -> np.ndarray:
    """One table for every band and frame (``ImageOps._lut``)."""
    clip, single = _clip(img)
    luts = np.broadcast_to(np.asarray(lut, np.int64), (clip.shape[0], 3, 256))
    return _like(_apply_luts(clip, luts), single)


def _histograms(clip: np.ndarray) -> np.ndarray:
    """``Image.histogram``: int64 [T, 3, 256]."""
    band = np.arange(3, dtype=np.int64) * 256
    return np.stack([
        np.bincount((f.reshape(-1, 3) + band).ravel(),
                    minlength=768).reshape(3, 256) for f in clip])


def _autocontrast_lut(h: np.ndarray) -> np.ndarray:
    nz = np.flatnonzero(h)
    if len(nz) == 0 or nz[-1] <= nz[0]:
        return _IDENTITY
    lo, hi = int(nz[0]), int(nz[-1])
    scale = 255.0 / (hi - lo)
    offset = -lo * scale
    return np.trunc(_IDENTITY * scale + offset).astype(np.int64)


def autocontrast(img) -> np.ndarray:
    """``ImageOps.autocontrast(img)``: each band stretched from its lowest
    to its highest value (``int(ix * scale + offset)``); a band of one
    value is left as it is."""
    clip, single = _clip(img)
    luts = np.stack([[_autocontrast_lut(h) for h in hs]
                     for hs in _histograms(clip)])
    return _like(_apply_luts(clip, luts), single)


def _equalize_lut(h: np.ndarray) -> np.ndarray:
    histo = h[h > 0]
    if len(histo) <= 1:
        return _IDENTITY
    step = (int(histo.sum()) - int(histo[-1])) // 255
    if not step:
        return _IDENTITY
    n = step // 2 + np.concatenate([[0], np.cumsum(h[:-1])])
    return n // step


def equalize(img) -> np.ndarray:
    """``ImageOps.equalize(img)``: Pillow's ``step`` and ``n // step``
    table per band; a band of one value, or one whose ``step`` is 0, is
    left as it is."""
    clip, single = _clip(img)
    luts = np.stack([[_equalize_lut(h) for h in hs]
                     for hs in _histograms(clip)])
    return _like(_apply_luts(clip, luts), single)


def invert(img) -> np.ndarray:
    """``ImageOps.invert``."""
    return _point(img, 255 - _IDENTITY)


def posterize(img, bits: int) -> np.ndarray:
    """``ImageOps.posterize``: ``i & ~(2 ** (8 - bits) - 1)``."""
    return _point(img, _IDENTITY & ~(2 ** (8 - int(bits)) - 1))


def solarize(img, threshold: int) -> np.ndarray:
    """``ImageOps.solarize``: values at or above ``threshold`` inverted."""
    return _point(img, np.where(_IDENTITY < threshold, _IDENTITY,
                                255 - _IDENTITY))


def solarize_add(img, add: int) -> np.ndarray:
    """timm's SolarizeAdd: ``min(255, i + add)`` below 128 through
    ``point`` (which clips below 0). For every integer ``add`` this is also
    ``augment.py``'s ``np.where(i < 128, clip(i + add, 0, 255), i)``."""
    return _point(img, np.where(_IDENTITY < 128,
                                np.minimum(255, _IDENTITY + int(add)),
                                _IDENTITY))


# ---------------------------------------------------------------------------
# Enhancers
# ---------------------------------------------------------------------------


def to_l(img) -> np.ndarray:
    """``convert("L")``: ``(R 19595 + G 38470 + B 7471 + 0x8000) >> 16``;
    uint8 [..., H, W]."""
    a = as_frames(img).astype(np.int32)
    return ((a[..., 0] * 19595 + a[..., 1] * 38470 + a[..., 2] * 7471
             + 0x8000) >> 16).astype(np.uint8)


def blend(degenerate, image, factor: float) -> np.ndarray:
    """``Image.blend(degenerate, image, factor)``: ``in1 + alpha * (in2 -
    in1)`` in C float with ``alpha = (float) factor``; truncated for alpha
    in [0, 1], else clipped to [0, 255] and truncated; alpha 0 and 1 copy
    an input."""
    a, b = as_frames(degenerate), as_frames(image)
    if a.shape != b.shape:
        raise ValueError(f"blend: shapes {a.shape} and {b.shape} differ")
    alpha = np.float32(factor)
    if alpha == 0.0:
        return a.copy()
    if alpha == 1.0:
        return b.copy()
    x1 = a.astype(np.float32)
    v = x1 + alpha * (b.astype(np.float32) - x1)
    if not 0.0 <= alpha <= 1.0:
        v = np.clip(v, 0.0, 255.0)
    return v.astype(np.uint8)


def color(img, factor: float) -> np.ndarray:
    """``ImageEnhance.Color(img).enhance(factor)``: blend with L as RGB."""
    a = as_frames(img)
    return blend(np.repeat(to_l(a)[..., None], 3, -1), a, factor)


def contrast(img, factor: float) -> np.ndarray:
    """``ImageEnhance.Contrast(img).enhance(factor)``: blend with a flat
    frame at ``int(mean of L + 0.5)`` (``ImageStat``'s float mean)."""
    clip, single = _clip(img)
    lum = to_l(clip).reshape(clip.shape[0], -1)
    means = [int(float(int(row.sum(dtype=np.int64))) / row.size + 0.5)
             for row in lum]
    flat = np.broadcast_to(np.asarray(means, np.uint8)[:, None, None, None],
                           clip.shape)
    return _like(blend(flat, clip, factor), single)


def brightness(img, factor: float) -> np.ndarray:
    """``ImageEnhance.Brightness(img).enhance(factor)``: blend with black."""
    a = as_frames(img)
    return blend(np.zeros_like(a), a, factor)


def sharpness(img, factor: float) -> np.ndarray:
    """``ImageEnhance.Sharpness(img).enhance(factor)``: blend with
    ``smooth``."""
    a = as_frames(img)
    return blend(smooth(a), a, factor)


def smooth(img) -> np.ndarray:
    """``img.filter(ImageFilter.SMOOTH)``, in the host library."""
    clip, single = _clip(img)
    t, h, w, _ = clip.shape
    out = np.empty_like(clip)
    library().smooth_u8(u8_pointer(clip), t, h, w, u8_pointer(out))
    return _like(out, single)


def smooth_plain(img) -> np.ndarray:
    """``smooth`` in numpy: Pillow's float32 3x3 sums (weights 1/13 and
    5/13, 0.5 added), rows y+1, y, y-1 in that order, truncated; border
    kept; frames under 3 x 3 copied."""
    clip, single = _clip(img)
    out = clip.copy()
    t, h, w, _ = clip.shape
    if h < 3 or w < 3:
        return _like(out, single)
    edge, centre = np.float32(1) / np.float32(13), np.float32(5) / np.float32(13)
    f = clip.astype(np.float32)
    s = np.full((t, h - 2, w - 2, 3), np.float32(0.5), np.float32)
    for rows, k in ((f[:, 2:], (edge, edge, edge)),
                    (f[:, 1:-1], (edge, centre, edge)),
                    (f[:, :-2], (edge, edge, edge))):
        s = s + ((rows[:, :, :-2] * k[0] + rows[:, :, 1:-1] * k[1])
                 + rows[:, :, 2:] * k[2])
    out[:, 1:-1, 1:-1] = np.clip(s, 0.0, 255.0).astype(np.uint8)
    return _like(out, single)


# ---------------------------------------------------------------------------
# Geometric ops
# ---------------------------------------------------------------------------


def _check_resample(resample: int) -> int:
    """``Image.transform``'s check: NEAREST, BILINEAR or BICUBIC, else
    ``ValueError`` in Pillow's words."""
    if resample in _TRANSFORM_FILTERS:
        return int(resample)
    if resample in (BOX, HAMMING, LANCZOS):
        msg = (f"Image.Resampling.{_FILTER_NAMES[resample]} ({resample}) "
               f"cannot be used.")
    else:
        msg = f"Unknown resampling filter ({resample})."
    raise ValueError(msg + " Use Image.Resampling.NEAREST (0), "
                     "Image.Resampling.BILINEAR (2) or "
                     "Image.Resampling.BICUBIC (3)")


def _fill(fill: Optional[Sequence[int]]) -> np.ndarray:
    if fill is None:
        return np.zeros(3, np.uint8)
    values = [int(v) for v in fill]
    if len(values) != 3 or not all(0 <= v <= 255 for v in values):
        raise ValueError(f"fill: three values in [0, 255], got {fill}")
    return np.asarray(values, np.uint8)


def _matrix(matrix) -> np.ndarray:
    m = np.asarray([float(v) for v in matrix[:6]], np.float64)
    if m.shape != (6,):
        raise ValueError(f"affine: six coefficients, got {matrix}")
    return m


def affine(img, matrix, resample: int = NEAREST, fill=None) -> np.ndarray:
    """``Image.transform(size, AFFINE, matrix, resample, fillcolor=fill)``
    of each frame (``fill`` None: black), in the host library."""
    resample = _check_resample(resample)
    clip, single = _clip(img)
    t, h, w, _ = clip.shape
    m, colour = _matrix(matrix), _fill(fill)
    out = np.empty_like(clip)
    library().affine_u8(u8_pointer(clip), t, h, w, u8_pointer(out),
                        m.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                        resample, u8_pointer(colour))
    return _like(out, single)


def _accumulate(start: float, step: float, n: int) -> np.ndarray:
    """``start, start + step, (start + step) + step, ...``: C's running
    double sum."""
    return np.add.accumulate(np.concatenate([[start], np.full(n - 1, step)]))


def _coord(v: np.ndarray) -> np.ndarray:
    """Geometry.c's ``COORD``: -1 below 0, else truncated."""
    return np.where(v < 0.0, -1, np.trunc(np.maximum(v, 0.0))).astype(np.int64)


def _cubic(v1, v2, v3, v4, d):
    p1 = v2
    p2 = -v1 + v3
    p3 = 2 * (v1 - v2) + v3 - v4
    p4 = -v1 + v2 - v3 + v4
    return p1 + d * (p2 + d * (p3 + d * p4))


def _affine_frame_plain(img, a, resample, out):
    h, w, _ = img.shape
    if resample == NEAREST:
        if a[1] == 0 and a[3] == 0:                 # ImagingScaleAffine
            xin = _coord(_accumulate(a[2] + a[0] * 0.5, a[0], w))
            inside_x = (xin >= 0) & (xin < w)
            cols, xin = np.flatnonzero(inside_x), np.where(inside_x, xin, 0)
            yin = _coord(_accumulate(a[5] + a[4] * 0.5, a[4], h))
            if len(cols):
                x0, x1 = cols[0], cols[-1] + 1
                rows = np.flatnonzero((yin >= 0) & (yin < h))
                out[rows, x0:x1] = img[yin[rows]][:, xin[x0:x1]]
            return

        def inside(x, y):
            return (abs(x * a[0] + y * a[1] + a[2]) < 32768.0
                    and abs(x * a[3] + y * a[4] + a[5]) < 32768.0)

        if all(inside(x, y) for x, y in ((0, 0), (w, h), (0, h), (w, 0))):
            def fix(v):                             # affine_fixed: 16.16
                return math.floor(v * 65536.0 + 0.5)
            a0, a1, a3, a4 = (fix(a[i]) for i in (0, 1, 3, 4))
            a2 = fix(a[2] + a[0] * 0.5 + a[1] * 0.5)
            a5 = fix(a[5] + a[3] * 0.5 + a[4] * 0.5)
            ys, xs = np.arange(h)[:, None], np.arange(w)[None, :]
            xi = (a2 + ys * a1 + xs * a0) >> 16
            yi = (a5 + ys * a4 + xs * a3) >> 16
        else:                                       # the double loop
            xo = _accumulate(a[2] + a[1] * 0.5 + a[0] * 0.5, a[1], h)
            yo = _accumulate(a[5] + a[4] * 0.5 + a[3] * 0.5, a[4], h)
            steps = np.ones((h, w))
            xi = _coord(np.add.accumulate(
                np.concatenate([xo[:, None], a[0] * steps[:, 1:]], 1), 1))
            yi = _coord(np.add.accumulate(
                np.concatenate([yo[:, None], a[3] * steps[:, 1:]], 1), 1))
        ok = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        out[ok] = img[yi[ok], xi[ok]]
        return
    ys, xs = np.meshgrid(np.arange(h, dtype=np.float64) + 0.5,
                         np.arange(w, dtype=np.float64) + 0.5, indexing="ij")
    xin = a[0] * xs + a[1] * ys + a[2]
    yin = a[3] * xs + a[4] * ys + a[5]
    ok = (xin >= 0.0) & (xin < w) & (yin >= 0.0) & (yin < h)
    xin, yin = xin[ok] - 0.5, yin[ok] - 0.5
    x, y = np.floor(xin).astype(np.int64), np.floor(yin).astype(np.int64)
    dx, dy = (xin - x)[:, None], (yin - y)[:, None]
    src = img.reshape(-1, 3).astype(np.float64)     # exact: small integers

    def taps(row, x):
        return src[np.clip(row, 0, h - 1) * w + np.clip(x, 0, w - 1)]

    if resample == BILINEAR:
        def horizontal(row):
            p0, p1 = taps(row, x), taps(row, x + 1)
            return p0 + (p1 - p0) * dx
        v1 = horizontal(y)
        below = ((y + 1 >= 0) & (y + 1 < h))[:, None]
        v2 = np.where(below, horizontal(y + 1), v1)
        out[ok] = (v1 + (v2 - v1) * dy).astype(np.uint8)
        return
    x, y = x - 1, y - 1
    vs = [_cubic(*(taps(y, x + k) for k in range(4)), dx)]
    for r in (1, 2, 3):
        row = y + r
        inside = ((row >= 0) & (row < h))[:, None]
        vs.append(np.where(
            inside, _cubic(*(taps(row, x + k) for k in range(4)), dx),
            vs[-1]))
    v = _cubic(*vs, dy)
    out[ok] = np.where(v <= 0.0, 0, np.where(v >= 255.0, 255, v)) \
        .astype(np.uint8)


def affine_plain(img, matrix, resample: int = NEAREST,
                 fill=None) -> np.ndarray:
    """``affine`` in numpy, each of libImaging's routes (scale table, 16.16
    fixed point, double loop, the BILINEAR/BICUBIC generic transform)
    computed as its C loop computes it."""
    resample = _check_resample(resample)
    clip, single = _clip(img)
    a, colour = [float(v) for v in _matrix(matrix)], _fill(fill)
    out = np.empty_like(clip)
    out[...] = colour
    for f, o in zip(clip, out):
        _affine_frame_plain(f, a, resample, o)
    return _like(out, single)


def rotation_matrix(width: int, height: int, angle: float) -> list:
    """``Image.rotate``'s inverse affine matrix for ``angle`` (degrees,
    counter-clockwise, already taken mod 360) about the frame's centre:
    cos and sin rounded to 15 digits."""
    cx, cy = width / 2, height / 2
    rad = -math.radians(angle)
    m = [round(math.cos(rad), 15), round(math.sin(rad), 15), 0.0,
         round(-math.sin(rad), 15), round(math.cos(rad), 15), 0.0]
    m[2] = m[0] * -cx + m[1] * -cy + m[2]
    m[5] = m[3] * -cx + m[4] * -cy + m[5]
    m[2] += cx
    m[5] += cy
    return m


def rotate(img, angle: float, resample: int = NEAREST,
           fill=None) -> np.ndarray:
    """``Image.rotate(angle, resample, fillcolor=fill)`` of each frame (no
    expand): a copy at 0, a transpose at 180 and, on square frames, at 90
    and 270, else ``affine``."""
    clip, single = _clip(img)
    h, w = clip.shape[1:3]
    angle = float(angle) % 360.0
    if angle == 0:
        out = clip.copy()
    elif angle == 180:
        out = clip[:, ::-1, ::-1].copy()
    elif angle in (90, 270) and w == h:
        out = np.ascontiguousarray(
            np.rot90(clip, 1 if angle == 90 else -1, axes=(1, 2)))
    else:
        out = affine(clip, rotation_matrix(w, h, angle), resample, fill)
    return _like(out, single)
