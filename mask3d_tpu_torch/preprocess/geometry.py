"""Vectorized 2D polygon geometry (shapely replacement): the two functions
of mask3d_tpu/preprocess/geometry.py that the baseline reads.
"""

from __future__ import annotations

import numpy as np


# from mask3d_tpu/preprocess/geometry.py:18 polygon_area
def polygon_area(poly: np.ndarray) -> float:
    """Shoelace area (positive) of [K, 2] vertices."""
    x, y = poly[:, 0], poly[:, 1]
    return float(
        0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))
    )


# from mask3d_tpu/preprocess/geometry.py:26 points_in_polygon
def points_in_polygon(points: np.ndarray, poly: np.ndarray) -> np.ndarray:
    """Crossing-number containment test. points [N, 2], poly [K, 2] -> bool[N]."""
    x, y = points[:, 0], points[:, 1]
    x0, y0 = poly[:, 0], poly[:, 1]
    x1, y1 = np.roll(x0, -1), np.roll(y0, -1)
    # Edge straddles the horizontal ray at y (half-open to avoid double count)
    straddle = (y0[None, :] > y[:, None]) != (y1[None, :] > y[:, None])
    dy = y1 - y0
    dy = np.where(dy == 0, 1e-30, dy)
    x_cross = x0[None, :] + (y[:, None] - y0[None, :]) * (
        (x1 - x0)[None, :] / dy[None, :]
    )
    hits = straddle & (x[:, None] < x_cross)
    return (hits.sum(axis=1) % 2) == 1
