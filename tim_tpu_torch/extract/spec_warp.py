"""Exact port of the reference SpecAugment time warp. A copy of
``tim_tpu/extract/spec_warp.py`` (numpy only; a test pins it to the
original).

Numpy rebuild of ``auditory_slowfast/slowfast/datasets/sparse_image_warp.py``
(+ ``spec_augment.py:time_warp``), reproducing the reference MATH exactly —
including its three quirks, because training-data parity means matching the
distribution the reference actually trains on, not the SpecAugment paper:

1. ``time_warp`` picks ``point_to_warp`` as the spectrogram VALUE at a
   random time index, not the index itself (``spec_augment.py:14``), so the
   warp's control x-coordinate is a log-mel amplitude;
2. ``cross_squared_distance_matrix`` uses the TOTAL sum of squares of all
   points as the per-row norms (``sparse_image_warp.py:133-140``), shifting
   every pairwise distance by a global constant;
3. the polyharmonic solve pads the lower-right block with ~N(0, 1e-20)
   noise instead of zeros (``sparse_image_warp.py:104``), making the
   one-control-point system (which is singular with exact zeros) solvable —
   at the cost of the result depending on that random draw. The reference
   is therefore NOT reproducible run-to-run even with fixed control points
   (measured flow deltas up to ~18 px across jitter draws); parity is
   distributional by construction, pinned by the statistical test in
   ``tests/test_spec_warp.py``.

All draws thread an explicit ``np.random.Generator``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

_EPS = 1e-10


def _phi(r: np.ndarray, order: int) -> np.ndarray:
    """Polyharmonic kernel (``sparse_image_warp.py:145-171``)."""
    if order == 1:
        return np.sqrt(np.maximum(r, _EPS))
    if order == 2:
        return 0.5 * r * np.log(np.maximum(r, _EPS))
    if order == 4:
        return 0.5 * np.square(r) * np.log(np.maximum(r, _EPS))
    if order % 2 == 0:
        r = np.maximum(r, _EPS)
        return 0.5 * np.power(r, 0.5 * order) * np.log(r)
    return np.power(np.maximum(r, _EPS), 0.5 * order)


def _cross_squared_distance(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """The reference's buggy pairwise distance: row norms replaced by the
    TOTAL sum of squares (a scalar), shifting all entries by a constant."""
    x_norm = np.sum(x * x)
    y_norm = np.sum(y * y)
    return (x_norm - 2.0 * (x @ y.T) + y_norm).astype(np.float32)


def _solve_interpolation(train_points, train_values, order,
                         rng: np.random.Generator):
    n, d = train_points.shape
    k = train_values.shape[-1]
    c = train_points.astype(np.float32)
    f = train_values.astype(np.float32)

    matrix_a = _phi(_cross_squared_distance(c, c), order)      # [n, n]
    matrix_b = np.concatenate(
        [c, np.ones((n, 1), np.float32)], axis=1)              # [n, d+1]
    left = np.concatenate([matrix_a, matrix_b.T], axis=0)
    # the reference uses ~N(0, 1e-20) here instead of zeros ("Pytorch gesv
    # fails with zeros"); with one control point the zero system is
    # singular, so this jitter is what makes the warp exist at all
    jitter = rng.standard_normal((d + 1, d + 1)).astype(np.float32) / 1e10
    right = np.concatenate([matrix_b, jitter], axis=0)
    lhs = np.concatenate([left, right], axis=1)                # [n+d+1, .]
    rhs = np.concatenate([f, np.zeros((d + 1, k), np.float32)], axis=0)
    sol = np.linalg.solve(lhs, rhs)
    return sol[:n], sol[n:]


def _apply_interpolation(query_points, train_points, w, v, order):
    pairwise = _cross_squared_distance(query_points.astype(np.float32),
                                       train_points.astype(np.float32))
    rbf = _phi(pairwise, order) @ w
    q_pad = np.concatenate(
        [query_points,
         np.ones((query_points.shape[0], 1), query_points.dtype)], axis=1)
    return rbf + q_pad.astype(np.float32) @ v


def _interpolate_bilinear(image: np.ndarray,
                          queries: np.ndarray) -> np.ndarray:
    """image [H, W]; queries [N, 2] (y, x) — boundary-clamped bilinear
    (``sparse_image_warp.py:260-357`` semantics)."""
    h, w = image.shape
    floors = []
    alphas = []
    for dim, size in ((0, h), (1, w)):
        q = queries[:, dim]
        floor = np.clip(np.floor(q), 0.0, size - 2)
        alpha = np.clip(q - floor, 0.0, 1.0)
        floors.append(floor.astype(np.int64))
        alphas.append(alpha)
    y0, x0 = floors
    ay, ax = alphas
    top_left = image[y0, x0]
    top_right = image[y0, x0 + 1]
    bottom_left = image[y0 + 1, x0]
    bottom_right = image[y0 + 1, x0 + 1]
    interp_top = ax * (top_right - top_left) + top_left
    interp_bottom = ax * (bottom_right - bottom_left) + bottom_left
    return ay * (interp_bottom - interp_top) + interp_top


def sparse_image_warp(
    image: np.ndarray,            # [H, W]
    source_points: np.ndarray,    # [n, 2] (y, x)
    dest_points: np.ndarray,      # [n, 2]
    *,
    interpolation_order: int = 2,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (warped [H, W], dense_flows [H, W, 2])."""
    rng = rng if rng is not None else np.random.default_rng()
    h, w = image.shape
    flows = (dest_points - source_points).astype(np.float32)

    yy, xx = np.meshgrid(np.arange(h, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing="ij")
    grid = np.stack([yy, xx], axis=-1).reshape(h * w, 2)

    w_c, v_c = _solve_interpolation(dest_points.astype(np.float32), flows,
                                    interpolation_order, rng)
    dense = _apply_interpolation(grid, dest_points.astype(np.float32),
                                 w_c, v_c, interpolation_order)
    dense = dense.reshape(h, w, 2)

    queries = grid - dense.reshape(h * w, 2)
    warped = _interpolate_bilinear(image.astype(np.float32),
                                   queries).reshape(h, w)
    return warped, dense


def time_warp_exact(spec: np.ndarray, W: int = 5,
                    rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """``spec_augment.py:time_warp`` on a [F, T] spectrogram: one control
    point at the center mel row whose x-coordinate is the spectrogram
    VALUE at a random time index (reference quirk #1), displaced by a
    uniform integer in [-W, W)."""
    rng = rng if rng is not None else np.random.default_rng()
    f, t = spec.shape
    y = f // 2
    point_to_warp = float(spec[y, int(rng.integers(W, t - W))])
    dist = int(rng.integers(-W, W))
    src = np.asarray([[y, point_to_warp]], np.float32)
    dst = np.asarray([[y, point_to_warp + dist]], np.float32)
    warped, _ = sparse_image_warp(spec, src, dst, rng=rng)
    return warped.astype(spec.dtype)
