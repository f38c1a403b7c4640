"""Vectorized 2D polygon geometry (shapely replacement): a copy of
mask3d_tpu/preprocess/geometry.py.

The reference buffers each floor polygon by 15 mm and runs a per-point
`Polygon.contains`; here a point matches a polygon iff it is inside
(crossing number) or within `buffer` of the boundary.
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


# from mask3d_tpu/preprocess/geometry.py:42 points_to_polygon_distance
def points_to_polygon_distance(points: np.ndarray, poly: np.ndarray
                               ) -> np.ndarray:
    """Min distance from each point to the polygon boundary. [N], [K,2]."""
    p0 = poly
    p1 = np.roll(poly, -1, axis=0)
    d = p1 - p0  # [K, 2]
    len2 = np.maximum((d * d).sum(-1), 1e-30)  # [K]
    # t = clamp(((p - p0) . d) / |d|^2, 0, 1) per (point, edge)
    diff = points[:, None, :] - p0[None, :, :]  # [N, K, 2]
    t = np.clip((diff * d[None]).sum(-1) / len2[None], 0.0, 1.0)
    proj = p0[None] + t[..., None] * d[None]
    dist = np.linalg.norm(points[:, None, :] - proj, axis=-1)
    return dist.min(axis=1)


# from mask3d_tpu/preprocess/geometry.py:57 points_match_polygon
def points_match_polygon(points: np.ndarray, poly: np.ndarray,
                         buffer: float = 0.0, chunk: int = 200_000
                         ) -> np.ndarray:
    """Inside OR within `buffer` of the boundary, chunked over points."""
    out = np.zeros(len(points), bool)
    for s in range(0, len(points), chunk):
        pts = points[s:s + chunk]
        m = points_in_polygon(pts, poly)
        if buffer > 0:
            near = points_to_polygon_distance(pts[~m], poly) <= buffer
            mm = m.copy()
            mm[np.nonzero(~m)[0][near]] = True
            m = mm
        out[s:s + chunk] = m
    return out
