"""A copy of mask3d_tpu/baseline/floorplan_eval.py.

Floorplan metrics: room / corner / angle precision-recall (R5).

Rebuild of the original RoomFormer evaluation
(`RoomFormer/s3d_floorplan_eval/Evaluator/Evaluator.py:11-12,112-430`):
- rooms match greedily by rasterized-mask IoU > 0.5 (`:403-416`)
- corners of matched rooms match within 10 px (`corner_metric_thresh`, `:11`)
- angles at matched corners within 5 degrees (`angle_metric_thresh`, `:12`)
Precision = TP/preds, recall = TP/gt per category.

Polygons are integer corner arrays [K, 2] in the 256x256 density frame (the
evaluate_scene contract, `engine.py:320-328`).
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

from mask3d_tpu_torch.preprocess.geometry import points_in_polygon

CORNER_THRESH = 10.0
ANGLE_THRESH = 5.0
IMAGE_SIZE = 256


# from mask3d_tpu/baseline/floorplan_eval.py:28 rasterize_polygon
def rasterize_polygon(poly: np.ndarray, size: int = IMAGE_SIZE) -> np.ndarray:
    ys, xs = np.meshgrid(
        np.arange(size) + 0.5, np.arange(size) + 0.5, indexing="ij"
    )
    pts = np.stack([xs.ravel(), ys.ravel()], axis=1)
    return points_in_polygon(pts, np.asarray(poly, np.float64)).reshape(
        size, size
    )


# from mask3d_tpu/baseline/floorplan_eval.py:38 corner_angles
def corner_angles(poly: np.ndarray) -> np.ndarray:
    """Interior angle (degrees) at each corner."""
    p = np.asarray(poly, np.float64)
    v1 = np.roll(p, 1, axis=0) - p
    v2 = np.roll(p, -1, axis=0) - p
    cos = (v1 * v2).sum(-1) / (
        np.linalg.norm(v1, axis=-1) * np.linalg.norm(v2, axis=-1) + 1e-9
    )
    return np.degrees(np.arccos(np.clip(cos, -1.0, 1.0)))


# from mask3d_tpu/baseline/floorplan_eval.py:49 _eroded_overlaps
def _eroded_overlaps(masks: List[np.ndarray], kernel: int) -> List[bool]:
    """Reference room-metric overlap penalty
    (`scenecad_eval/Evaluator.py:132-160`, `s3d_floorplan_eval` same): each
    pred mask is eroded by a `kernel`x`kernel` structuring element and any
    pairwise intersection >= 1 px flags BOTH predictions."""
    from scipy.ndimage import binary_erosion

    struct = np.ones((kernel, kernel), bool)
    eroded = [binary_erosion(m, structure=struct) for m in masks]
    flags = [False] * len(masks)
    for i in range(len(masks) - 1):
        for j in range(i + 1, len(masks)):
            if np.logical_and(eroded[i], eroded[j]).sum() >= 1:
                flags[i] = True
                flags[j] = True
    return flags


# from mask3d_tpu/baseline/floorplan_eval.py:67 FloorplanEvaluator
class FloorplanEvaluator:
    """Accumulates room/corner/angle TP counts over scenes.

    `dataset_type` follows the reference protocol switch
    (`scenecad_eval/Evaluator.py:118,131`): "s3d" erodes pred masks with a
    5x5 kernel for the overlap penalty, "scenecad" with 3x3.
    """

    def __init__(self, dataset_type: str = "s3d"):
        self.erosion_kernel = 5 if dataset_type == "s3d" else 3
        self.reset()

    def reset(self):
        self.counts = {
            k: {"tp": 0, "pred": 0, "gt": 0}
            for k in ("room", "corner", "angle")
        }

    def evaluate_scene(self, room_polys: List[np.ndarray],
                       gt_polys: List[np.ndarray]) -> Dict[str, float]:
        c = self.counts
        c["room"]["pred"] += len(room_polys)
        c["room"]["gt"] += len(gt_polys)
        c["corner"]["pred"] += sum(len(p) for p in room_polys)
        c["corner"]["gt"] += sum(len(p) for p in gt_polys)
        c["angle"]["pred"] += sum(len(p) for p in room_polys)
        c["angle"]["gt"] += sum(len(p) for p in gt_polys)

        gt_masks = [rasterize_polygon(p) for p in gt_polys]
        pred_masks = [rasterize_polygon(p) for p in room_polys]
        overlaps = _eroded_overlaps(pred_masks, self.erosion_kernel)
        used = set()
        scene = {"room_tp": 0, "corner_tp": 0, "angle_tp": 0}
        for pi, pred in enumerate(room_polys):
            pm = pred_masks[pi]
            best_iou, best_j = 0.5, -1
            for j, gm in enumerate(gt_masks):
                if j in used:
                    continue
                inter = np.logical_and(pm, gm).sum()
                union = np.logical_or(pm, gm).sum()
                iou = inter / (union + 1)
                if iou > best_iou:
                    best_iou, best_j = iou, j
            if best_j < 0:
                continue
            # A matched room only counts if it does not overlap another
            # prediction (reference `get_room_metric`,
            # `scenecad_eval/Evaluator.py:132-161`).
            if overlaps[pi]:
                continue
            used.add(best_j)
            scene["room_tp"] += 1
            gt = np.asarray(gt_polys[best_j], np.float64)
            pred_f = np.asarray(pred, np.float64)
            pa = corner_angles(pred_f)
            ga = corner_angles(gt)
            taken = set()
            for vi, v in enumerate(pred_f):
                d = np.linalg.norm(gt - v, axis=1)
                d[[j for j in taken]] = np.inf
                gi = int(np.argmin(d))
                if d[gi] <= CORNER_THRESH:
                    taken.add(gi)
                    scene["corner_tp"] += 1
                    if abs(pa[vi] - ga[gi]) <= ANGLE_THRESH:
                        scene["angle_tp"] += 1
        for k in ("room", "corner", "angle"):
            c[k]["tp"] += scene[f"{k}_tp"]
        return scene

    def evaluate_scene_masks(self, pred_masks: List[np.ndarray],
                             gt_masks: List[np.ndarray],
                             degree: float = 0.01) -> Dict[str, float]:
        """End-to-end protocol from room MASKS: polygonize every pred and
        gt mask exactly like the reference (largest contour +
        approxPolyDP with epsilon = degree * perimeter,
        `s3d_floorplan_eval/Evaluator/Evaluator.py:25-60` /
        `DataRW/S3DRW.py:79-115`), then run the polygon metric. Empty
        polygonizations (blank masks) are dropped on both sides, matching
        the reference's behavior of never producing them."""
        from mask3d_tpu_torch.baseline.polygonize import polygonize_mask

        def polys(masks):
            out = []
            for m in masks:
                p = polygonize_mask(np.asarray(m), degree, return_mask=False)
                if len(p) >= 3:
                    out.append(p)
            return out

        return self.evaluate_scene(polys(pred_masks), polys(gt_masks))

    def summarize(self) -> Dict[str, float]:
        out = {}
        for k, v in self.counts.items():
            prec = v["tp"] / v["pred"] if v["pred"] else 0.0
            rec = v["tp"] / v["gt"] if v["gt"] else 0.0
            f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
            out[f"{k}_prec"] = prec
            out[f"{k}_rec"] = rec
            out[f"{k}_f1"] = f1
        return out


# from mask3d_tpu/baseline/floorplan_eval.py:172 SceneCADEvaluator
class SceneCADEvaluator(FloorplanEvaluator):
    """SceneCAD-protocol variant (`RoomFormer/scenecad_eval/Evaluator.py`):
    the same room/corner/angle metric family with the 3x3 overlap-erosion
    kernel (`Evaluator.py:143-146`)."""

    def __init__(self):
        super().__init__(dataset_type="scenecad")
