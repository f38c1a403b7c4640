"""Point-cloud augmentations (volumentations replacement).

A copy of mask3d_tpu/data/augment.py: the same seed gives the same draws.

The reference drives `volumentations` from YAML configs
(`mask3d/conf/augmentation/volumentations_aug_stru3d.yaml` etc., loaded at
`mask3d/datasets/semseg_structured3d.py:69`). The library is tiny for the
subset used; this module re-implements exactly those transforms:

- stru3d preset: Scale3d +-0.1 p=0.5; RotateAroundAxis3d z +-pi p=0.5;
  y +-pi/24 p=0.5; x +-pi/24 p=0.5
- s3dis / matterport3d presets: RandomDropout3d 0.1 p=0.5; Scale3d +-0.3
  p=0.75; rotate z +-pi p=0.75; y +-pi/12 p=0.5; x +-pi/12 p=0.5
  (`volumentations_aug_s3dis.yaml`, `volumentations_aug_matterport3d.yaml`)

Rotations are about the cloud centroid (the downstream pipeline is
translation invariant: voxelization re-shifts to non-negative and the PE
normalizes per-item min/max).
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

Transform = Tuple[float, Callable]  # (probability, fn(rng, pts, feats, labels))


# from mask3d_tpu/data/augment.py:29 scale3d
def scale3d(limits: Sequence[Tuple[float, float]]):
    def fn(rng, pts, feats, labels):
        s = np.array(
            [1.0 + rng.uniform(lo, hi) for lo, hi in limits], np.float32
        )
        return pts * s, feats, labels

    return fn


# from mask3d_tpu/data/augment.py:39 rotate_around_axis
def rotate_around_axis(axis: Sequence[float], limit: Tuple[float, float]):
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)

    def fn(rng, pts, feats, labels):
        theta = rng.uniform(*limit)
        k = axis
        kx, ky, kz = k
        ct, st = math.cos(theta), math.sin(theta)
        K = np.array([[0, -kz, ky], [kz, 0, -kx], [-ky, kx, 0]])
        R = np.eye(3) + st * K + (1 - ct) * (K @ K)
        center = pts.mean(axis=0, keepdims=True)
        return ((pts - center) @ R.T + center).astype(pts.dtype), feats, labels

    return fn


# from mask3d_tpu/data/augment.py:56 random_dropout
def random_dropout(ratio: float):
    def fn(rng, pts, feats, labels):
        keep = rng.random(len(pts)) >= ratio
        if not keep.any():
            return pts, feats, labels
        # 4th element: keep-mask so callers can subset parallel arrays
        # (raw_coordinates etc.) consistently — volumentations keeps all
        # arrays aligned by transforming them together; here Compose
        # threads the cumulative kept-row indices instead.
        return pts[keep], feats[keep], labels[keep], keep

    return fn


# from mask3d_tpu/data/augment.py:70 Compose
class Compose:
    def __init__(self, transforms: List[Transform],
                 seed: Optional[int] = None):
        self.transforms = transforms
        self.rng = np.random.default_rng(seed)

    def __call__(self, points, features, labels):
        kept = np.arange(len(points))
        for p, fn in self.transforms:
            if self.rng.random() < p:
                out = fn(self.rng, points, features, labels)
                if len(out) == 4:  # row-dropping transform: cumulate keep
                    points, features, labels, keep = out
                    kept = kept[keep]
                else:
                    points, features, labels = out
        return {
            "points": points,
            "features": features,
            "labels": labels,
            "kept_indices": kept,
        }


PI = math.pi


# from mask3d_tpu/data/augment.py:97 make_augmentation
def make_augmentation(name: Optional[str], seed: Optional[int] = None
                      ) -> Optional[Compose]:
    if name in (None, "none", ""):
        return None
    if name == "stru3d":
        return Compose(
            [
                (0.5, scale3d([(-0.1, 0.1)] * 3)),
                (0.5, rotate_around_axis((0, 0, 1), (-PI, PI))),
                (0.5, rotate_around_axis((0, 1, 0), (-PI / 24, PI / 24))),
                (0.5, rotate_around_axis((1, 0, 0), (-PI / 24, PI / 24))),
            ],
            seed,
        )
    if name in ("s3dis", "matterport3d"):
        return Compose(
            [
                (0.5, random_dropout(0.1)),
                (0.75, scale3d([(-0.3, 0.3)] * 3)),
                (0.75, rotate_around_axis((0, 0, 1), (-PI, PI))),
                (0.5, rotate_around_axis((0, 1, 0), (-PI / 12, PI / 12))),
                (0.5, rotate_around_axis((1, 0, 0), (-PI / 12, PI / 12))),
            ],
            seed,
        )
    raise ValueError(f"unknown augmentation preset: {name}")


# from mask3d_tpu/data/augment.py:125 make_crops
def make_crops(items, rng: Optional[np.random.Generator] = None):
    """Quadrant crops of each scene (reference `make_crops`,
    `mask3d/datasets/utils.py:332-383`, enabled by the latent
    `small_crops`/`very_small_crops` collation options): center the cloud,
    add one guard point per quadrant, emit the four xy-quadrants re-centered.
    """
    out = []
    for item in items:
        pts = np.asarray(item["coordinates"], np.float32).copy()
        feats = np.asarray(item["features"]).copy()
        labels = np.asarray(item["labels"]).copy()
        pts -= pts.mean(0)
        guards = np.array(
            [[0.1, 0.1, 0.1], [0.1, -0.1, 0.1],
             [-0.1, 0.1, 0.1], [-0.1, -0.1, 0.1]], np.float32
        )
        pts = np.vstack([pts, guards])
        feats = np.vstack([feats, np.zeros((4, feats.shape[1]), feats.dtype)])
        labels = np.vstack(
            [labels, np.full((4, labels.shape[1]), 255, labels.dtype)]
        )
        for sx, sy in ((1, 1), (1, -1), (-1, 1), (-1, -1)):
            sel = (pts[:, 0] * sx > 0) & (pts[:, 1] * sy > 0)
            if sel.sum() <= 1:
                continue
            crop_pts = pts[sel] - pts[sel].mean(0)
            out.append(
                {
                    **item,
                    "coordinates": crop_pts,
                    "features": feats[sel],
                    "labels": labels[sel],
                    "raw_coordinates": crop_pts.copy(),
                    "raw_features": feats[sel].copy(),
                    "raw_labels": labels[sel].copy(),
                }
            )
    return out


# from mask3d_tpu/data/augment.py:165 RandomCuboid
class RandomCuboid:
    """RandomCuboid crop (reference `mask3d/datasets/random_cuboid.py:17-96`,
    latent behind the `cropping` config; DepthContrast augmentation).

    Returns a bool keep-mask over the points, like the reference: an
    xy window of side `crop_length` around the cloud's xy center jittered
    by +-range/4 per axis (`version1=True`, the reference's only shipped
    mode; version1=False jitters across the full span minus a margin),
    retried up to 100 times until >= `min_points` survive; clouds already
    under `min_points`, and exhausted retries, keep everything.
    """

    def __init__(self, min_points: int, crop_length: float = 6.0,
                 version1: bool = True):
        self.min_points = min_points
        self.crop_length = crop_length
        self.version1 = version1

    def __call__(self, point_cloud: np.ndarray,
                 rng: Optional[np.random.Generator] = None) -> np.ndarray:
        rng = rng or np.random.default_rng()
        n = point_cloud.shape[0]
        if n < self.min_points:
            return np.ones(n, dtype=bool)
        xy = point_cloud[:, :2]
        range_xy = xy.max(axis=0) - xy.min(axis=0)
        for _ in range(100):
            center = xy.min(axis=0) + range_xy / 2
            if self.version1:
                off = rng.uniform(-range_xy / 4, range_xy / 4)
            else:
                half = range_xy / 2 - self.crop_length / 4
                off = rng.uniform(-half, half)
            center = center + off
            lo = center - self.crop_length / 2
            hi = center + self.crop_length / 2
            sel = np.all((xy >= lo) & (xy <= hi), axis=1)
            if sel.sum() >= self.min_points:
                return sel
        return np.ones(n, dtype=bool)
