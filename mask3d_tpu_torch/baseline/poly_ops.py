"""A copy of mask3d_tpu/baseline/poly_ops.py.

Polygon utilities (reference `RoomFormer/util/poly_ops.py` + the
polygon-extraction step of `RoomFormer/engine.py:292-317`)."""

from __future__ import annotations

from typing import List

import numpy as np

from mask3d_tpu_torch.preprocess.geometry import polygon_area


# from mask3d_tpu/baseline/poly_ops.py:13 is_clockwise
def is_clockwise(points: np.ndarray) -> bool:
    """Shoelace orientation (reference `poly_ops.py:8-16`)."""
    p1 = points
    p2 = np.roll(points, -1, axis=0)
    return float(np.sum((p2[:, 0] - p1[:, 0]) * (p2[:, 1] + p1[:, 1]))) > 0.0


# from mask3d_tpu/baseline/poly_ops.py:20 resort_corners
def resort_corners(corners: np.ndarray) -> np.ndarray:
    """Start from the upper-left-most corner, counterclockwise in image
    coordinates (reference `poly_ops.py:18-32`)."""
    c = corners.reshape(-1, 2)
    start = int(np.argmin((c**2).sum(-1)))
    c = np.concatenate([c[start:], c[:start]])
    if not is_clockwise(c):
        c[1:] = np.flip(c[1:], 0)
    return c.reshape(-1)


# from mask3d_tpu/baseline/poly_ops.py:31 all_cyclic_orders
def all_cyclic_orders(corners: np.ndarray) -> np.ndarray:
    """All cyclic rotations of a flat [2K] corner vector
    (reference `get_all_order_corners`, `poly_ops.py:35-40`)."""
    k = len(corners) // 2
    return np.stack([np.roll(corners, i * 2) for i in range(k)])


# from mask3d_tpu/baseline/poly_ops.py:38 extract_room_polygons
def extract_room_polygons(
    corner_probs: np.ndarray,  # [P, Qp] sigmoid corner-validity probs
    pred_coords: np.ndarray,  # [P, Qp, 2] normalized [0, 1]
    prob_threshold: float = 0.5,
    min_corners: int = 4,
    min_area: float = 100.0,
    image_size: int = 256,
) -> List[np.ndarray]:
    """Per-room polygon extraction (reference `engine.py:292-317`): keep the
    corners whose validity prob exceeds 0.5, scale by 255 and round, drop
    polygons with <4 corners or area < 100 px^2."""
    polys = []
    for j in range(corner_probs.shape[0]):
        keep = corner_probs[j] > prob_threshold
        corners = pred_coords[j][keep]
        if len(corners) == 0:
            continue
        corners = np.around(corners * (image_size - 1)).astype(np.int32)
        if len(corners) >= min_corners and polygon_area(
            corners.astype(np.float64)
        ) >= min_area:
            polys.append(corners)
    return polys


# from mask3d_tpu/baseline/poly_ops.py:63 pad_polygons
def pad_polygons(polys: List[np.ndarray], num_queries_per_poly: int,
                 image_size: int = 256):
    """Targets for the matcher/criterion (reference `pad_gt_polys`,
    `poly_ops.py:43-80`): coords normalized to [0,1], zero-padded to Qp;
    labels 1 for real corners. Returns dict of arrays padded over polys too.
    """
    qp = num_queries_per_poly
    coords = np.zeros((max(len(polys), 1), qp * 2), np.float32)
    labels = np.zeros((max(len(polys), 1), qp), np.float32)
    lengths = np.zeros(max(len(polys), 1), np.int32)
    for i, poly in enumerate(polys):
        flat = np.clip(poly.reshape(-1).astype(np.float32), 0,
                       image_size - 1) / (image_size - 1)
        n = min(len(flat), qp * 2)
        coords[i, :n] = flat[:n]
        labels[i, : n // 2] = 1.0
        lengths[i] = n
    return {
        "coords": coords,
        "labels": labels,
        "lengths": lengths,
        "num_polys": len(polys),
    }
