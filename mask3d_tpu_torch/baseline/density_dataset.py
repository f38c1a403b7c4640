"""A copy of mask3d_tpu/baseline/density_dataset.py.

2D floorplan dataset: density maps + polygon targets (R6).

Rebuild of the RoomFormer data pipeline (`RoomFormer/datasets/poly_data.py` +
`RoomFormer/data_preprocess/stru3d`): 256x256 top-down point-density images
with ground-truth room polygons in the density frame. Instead of offline
COCO-format annotation files, polygons come straight from the scene's
`annotation_3d.json` (same extraction as the 3D preprocessing) projected with
the RoomFormer normalization.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np

from mask3d_tpu_torch.baseline.poly_ops import pad_polygons, resort_corners
from mask3d_tpu_torch.baseline.roomformer_bridge import (
    density_normalization,
    map_points_to_density,
    points_to_density_map,
)
from mask3d_tpu_torch.data.datasets import Structured3DSegmentationDataset
from mask3d_tpu_torch.data.ply import read_ply


# from mask3d_tpu/baseline/density_dataset.py:29 FloorplanDataset
class FloorplanDataset:
    """Per scene: (density image, padded polygon targets, gt polygons)."""

    def __init__(
        self,
        data_root: str,
        mode: str = "train",
        rasterization_factor: int = 150,
        num_queries_per_poly: int = 40,
        max_polys: int = 20,
        valid_scenes_file_path: Optional[str] = None,
    ):
        self.ds3d = Structured3DSegmentationDataset(
            data_root, mode=mode, rasterization_factor=rasterization_factor,
            valid_scenes_file_path=valid_scenes_file_path,
        )
        self.data_root = data_root
        self.qp = num_queries_per_poly
        self.max_polys = max_polys

    def __len__(self):
        return len(self.ds3d)

    def gt_polygons_density_frame(self, scene: str, coords: np.ndarray
                                  ) -> List[np.ndarray]:
        """Floor polygons (annotation_3d.json) projected into the density
        frame of this scene's point cloud."""
        from mask3d_tpu_torch.preprocess.stru3d import extract_floor_polygons

        ann_path = os.path.join(self.data_root, scene, "annotation_3d.json")
        with open(ann_path) as f:
            polys = extract_floor_polygons(json.load(f))
        norm = density_normalization(coords)
        out = []
        for p in polys:
            if p["room_id"] <= 0:
                continue
            px = map_points_to_density(
                np.concatenate(
                    [p["coords2d"], np.zeros((len(p["coords2d"]), 1))], axis=1
                ),
                norm,
            )
            out.append(resort_corners(px.astype(np.float64)).reshape(-1, 2))
        return out[: self.max_polys]

    def __getitem__(self, idx: int) -> dict:
        scene = self.ds3d.data[idx]
        v = read_ply(self.ds3d._artifact_path(scene))
        coords = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float64)
        density = points_to_density_map(coords)[..., None].astype(np.float32)
        gt_polys = self.gt_polygons_density_frame(scene, coords)
        targets = pad_polygons(gt_polys, self.qp)
        return {
            "density": density,
            "targets": targets,
            "gt_polys": gt_polys,
            "scene": scene,
            "coords": coords,
        }


# from mask3d_tpu/baseline/density_dataset.py:91 collate_floorplan
def collate_floorplan(items: List[dict], max_polys: int) -> dict:
    """Stack padded targets over the batch."""
    b = len(items)
    qp2 = items[0]["targets"]["coords"].shape[1]
    qp = qp2 // 2
    coords = np.zeros((b, max_polys, qp2), np.float32)
    labels = np.zeros((b, max_polys, qp), np.float32)
    lengths = np.zeros((b, max_polys), np.int32)
    poly_valid = np.zeros((b, max_polys), bool)
    density = np.stack([it["density"] for it in items])
    for i, it in enumerate(items):
        t = it["targets"]
        n = min(t["num_polys"], max_polys)
        if n:
            coords[i, :n] = t["coords"][:n]
            labels[i, :n] = t["labels"][:n]
            lengths[i, :n] = t["lengths"][:n]
            poly_valid[i, :n] = True
    return {
        "density": density,
        "targets": {
            "coords": coords,
            "labels": labels,
            "lengths": lengths,
            "poly_valid": poly_valid,
        },
        "scenes": [it["scene"] for it in items],
        "gt_polys": [it["gt_polys"] for it in items],
    }
