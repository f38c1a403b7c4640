"""A copy of mask3d_tpu/baseline/roomformer_bridge.py.

RoomFormer -> Mask3D evaluation bridge (vectorized).

Rebuild of `RoomFormer/mask3d_evaluator/roomformer_to_mask3d.py:12-156`: a
floorplan baseline predicts 2D room polygons in the 256x256 density-map
frame; the bridge maps every 3D point of the Mask3D-format scene into that
frame (RoomFormer's normalization: min/max over points with a 10% margin,
`roomformer_to_mask3d.py:49-66`) and synthesizes per-room binary point masks
(score 1.0) that the Mask3D evaluator can score directly — the
apples-to-apples comparison path of the paper (`RoomFormer/engine.py:381-385`).

The reference labels each point against each polygon with per-point shapely
calls under a multiprocessing pool ("incredibly slow", its own comment at
`:35`); here it is one vectorized crossing-number test per room.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from mask3d_tpu_torch.preprocess.geometry import points_in_polygon

IMAGE_RES = np.array([256, 256])


# from mask3d_tpu/baseline/roomformer_bridge.py:27 density_normalization
def density_normalization(coords: np.ndarray) -> Dict[str, np.ndarray]:
    """Normalization dict of the RoomFormer stru3d preprocessing
    (`roomformer_to_mask3d.py:49-66`): min/max of xy with 10% margin."""
    xy = coords[:, :2]
    max_c = xy.max(axis=0)
    min_c = xy.min(axis=0)
    margin = 0.1 * (max_c - min_c)
    return {
        "min_coords": min_c - margin,
        "max_coords": max_c + margin,
        "image_res": IMAGE_RES.copy(),
    }


# from mask3d_tpu/baseline/roomformer_bridge.py:41 map_points_to_density
def map_points_to_density(coords: np.ndarray, norm: Dict[str, np.ndarray]
                          ) -> np.ndarray:
    """Project xy into the density frame (`map_point_to_density`, `:12-27`)."""
    xy = coords[:, :2]
    span = norm["max_coords"] - norm["min_coords"]
    span = np.where(span == 0, 1.0, span)
    p = np.round((xy - norm["min_coords"]) / span * norm["image_res"])
    p = np.clip(p, 0, norm["image_res"] - 1)
    return p.astype(np.int32)


# from mask3d_tpu/baseline/roomformer_bridge.py:52 points_to_density_map
def points_to_density_map(coords: np.ndarray,
                          norm: Dict[str, np.ndarray] = None) -> np.ndarray:
    """256x256 normalized top-down point-density image — the RoomFormer
    input modality (`RoomFormer/data_preprocess/stru3d` generate_density)."""
    norm = norm or density_normalization(coords)
    px = map_points_to_density(coords, norm)
    img = np.zeros(tuple(norm["image_res"]), np.float64)
    np.add.at(img, (px[:, 0], px[:, 1]), 1.0)
    if img.max() > 0:
        img /= img.max()
    return img


# from mask3d_tpu/baseline/roomformer_bridge.py:65 polygons_to_mask3d_prediction
def polygons_to_mask3d_prediction(
    coords: np.ndarray,
    room_polys: Sequence[np.ndarray],
    scene: str,
    room_class_id: int = 1,
) -> dict:
    """Room polygons (density frame) -> evaluator-ready prediction dict.

    Every prediction gets confidence 1.0 and the `is_room` class, matching
    `roomformer_to_mask3d.py:125-150`.
    """
    norm = density_normalization(coords)
    px = map_points_to_density(coords, norm).astype(np.float64)
    n = len(coords)
    m = len(room_polys)
    pred_masks = np.zeros((n, m), np.float32)
    for k, poly in enumerate(room_polys):
        poly = np.asarray(poly, np.float64)
        if len(poly) < 3:
            continue
        pred_masks[:, k] = points_in_polygon(px, poly)
    return {
        "pred_classes": np.full(m, room_class_id, np.int32),
        "pred_masks": pred_masks,
        "pred_scores": np.ones(m, np.float32),
        "scene": scene,
    }


# from mask3d_tpu/baseline/roomformer_bridge.py:94 evaluate_roomformer_scene
def evaluate_roomformer_scene(
    item: dict,
    room_polys: Sequence[np.ndarray],
    evaluator,
    log_prefix: str = "test",
) -> dict:
    """Score one scene's polygon predictions with the Mask3D evaluator.

    `item` is a dataset item dict (see `Structured3DSegmentationDataset`);
    targets are built from its labels like `create_batch_target`.
    """
    from mask3d_tpu_torch.data.collate import build_item_target

    labels = np.asarray(item["labels"])
    t_labels, t_masks, _ = build_item_target(
        labels, filter_out_classes=(0, 17, 18, 19, 21),
        filter_out_instance_ids=(-1, 0),
    )
    pred = polygons_to_mask3d_prediction(
        np.asarray(item["coordinates"]), room_polys, item["scene"]
    )
    targets = [{
        "labels": np.asarray(t_labels, np.int32),
        "masks": np.stack(t_masks) if t_masks else np.zeros((0, len(labels)), bool),
    }]
    return evaluator.evaluate([pred], targets, log_prefix)
